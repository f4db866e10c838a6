"""Deterministic synthetic data pipelines.

Images — "real" class: procedural natural-statistics images (1/f power
spectra + geometric structure); "fake" class comes from actual toy diffusion
models (or a degraded generator for fast tests). The discriminator trains on
exactly the paper's task: real-vs-generated.

Tokens — seeded Zipfian stream with short-range structure for LM smoke
training; prompts — token bags for the diffusion text conditioning.

PyTorch-port copy of ``repro/training/data.py`` (framework-free numpy),
held to the original by ``tests/test_torch_training.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


def natural_images(rng: np.random.Generator, n: int, size: int = 32,
                   channels: int = 3) -> np.ndarray:
    """'Real' images: 1/f^alpha spectra + random shapes, in [-1, 1]."""
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    radius = np.sqrt(fy ** 2 + fx ** 2)
    radius[0, 0] = 1.0
    out = np.empty((n, size, size, channels), np.float32)
    for i in range(n):
        alpha = rng.uniform(0.8, 1.4)
        amp = radius ** (-alpha)
        img = np.empty((size, size, channels), np.float32)
        for c in range(channels):
            phase = rng.uniform(0, 2 * np.pi, (size, size))
            spec = amp * np.exp(1j * phase)
            img[..., c] = np.real(np.fft.ifft2(spec))
        # add a few solid shapes (edges/objects — generated images tend to
        # miss crisp structure)
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.integers(0, size, 2)
            r = rng.integers(2, size // 4)
            yy, xx = np.ogrid[:size, :size]
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
            img[mask] += rng.uniform(-1.5, 1.5)
        img -= img.mean()
        img /= (img.std() + 1e-6)
        out[i] = np.clip(img * 0.5, -1, 1)
    return out


def degraded_images(rng: np.random.Generator, n: int, size: int = 32,
                    channels: int = 3, blur: float = 1.0,
                    artifact: float = 0.3) -> np.ndarray:
    """Fast 'fake' stand-in: natural images blurred + blocky artifacts —
    mimics light-diffusion failure modes (soft texture, artifacts)."""
    imgs = natural_images(rng, n, size, channels)
    k = int(max(1, round(blur * 2)))
    for i in range(n):
        img = imgs[i]
        for _ in range(k):             # box blur ~ gaussian
            img = (np.roll(img, 1, 0) + np.roll(img, -1, 0)
                   + np.roll(img, 1, 1) + np.roll(img, -1, 1) + img) / 5.0
        if artifact > 0:               # 8x8 blockiness (decoder artifacts)
            b = 8
            small = img[::b, ::b]
            blocky = np.repeat(np.repeat(small, b, 0), b, 1)[:size, :size]
            img = (1 - artifact) * img + artifact * blocky
        imgs[i] = np.clip(img, -1, 1)
    return imgs


def prompt_tokens(rng: np.random.Generator, n: int, length: int = 8,
                  vocab: int = 1024) -> np.ndarray:
    return rng.integers(0, vocab, size=(n, length)).astype(np.int32)


def zipf_tokens(rng: np.random.Generator, batch: int, seq: int,
                vocab: int) -> Tuple[np.ndarray, np.ndarray]:
    """LM smoke-training stream: Zipfian unigrams + local bigram structure
    (so loss actually decreases). Returns (inputs, labels)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
    # inject determinism: token t follows (t*7+3)%vocab 50% of the time
    follow = (toks * 7 + 3) % vocab
    mask = rng.random((batch, seq + 1)) < 0.5
    toks[:, 1:] = np.where(mask[:, 1:], follow[:, :-1], toks[:, 1:])
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


@dataclasses.dataclass
class DiscriminatorBatcher:
    """Balanced real/fake batches with labels (1=real, 0=fake).

    real_fn overrides the 'real' class source (paper Fig. 7 ablation:
    'EfficientNet w Fake' trains with heavy-model generations as 'real')."""
    rng: np.random.Generator
    size: int = 32
    image_size: int = 32
    fake_fn: object = None             # callable(n) -> images, else degraded
    real_fn: object = None             # callable(n) -> images, else natural

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            half = self.size // 2
            if self.real_fn is not None:
                real = np.asarray(self.real_fn(half))
            else:
                real = natural_images(self.rng, half, self.image_size)
            if self.fake_fn is not None:
                fake = np.asarray(self.fake_fn(half))
            else:
                fake = degraded_images(self.rng, half, self.image_size)
            x = np.concatenate([real, fake], axis=0)
            y = np.concatenate([np.ones(half), np.zeros(half)]).astype(np.int32)
            perm = self.rng.permutation(self.size)
            yield x[perm], y[perm]
