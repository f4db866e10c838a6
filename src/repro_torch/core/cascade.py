"""Model cascade (the paper's core object), PyTorch.

Port of ``DiffusionCascade`` in ``repro/core/cascade.py``. A cascade is an
ordered list of (config, params) UNet stages plus a discriminator.
``run_batch`` executes the real pipeline: stage-0 generation ->
discriminator confidence -> threshold -> next-stage generation for the
deferred queries, down the cascade. ``LMCascade`` (paper §5) is the same
host logic over LM step callables; ``greedy_lm_step`` builds one from
the port's serve steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.config.base import DiffusionConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import impls as kimpls
from repro_torch.launch.steps import serve_decode, serve_prefill
from repro_torch.models import diffusion as diff
from repro_torch.models.kvcache import init_cache
from repro_torch.models.efficientnet import (DiscriminatorConfig,
                                             apply_discriminator)

Stage = Tuple[DiffusionConfig, object]        # (config, params)
# noise_fn(stage_index, shape) -> standard-normal latent on the device
NoiseFn = Callable[[int, Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass
class CascadeResult:
    outputs: np.ndarray            # final images per query
    confidences: np.ndarray        # stage-0 discriminator scores
    deferred: np.ndarray           # bool mask: sent past stage 0
    light_outputs: np.ndarray      # stage-0 generations
    stage_index: Optional[np.ndarray] = None   # final stage per query
    boundary_confidences: Optional[List[np.ndarray]] = None


def _normalize_thresholds(thresholds: Union[float, Sequence[float]],
                          num_boundaries: int) -> Tuple[float, ...]:
    if isinstance(thresholds, (int, float)):
        return (float(thresholds),) * num_boundaries
    ts = tuple(float(t) for t in thresholds)
    if len(ts) != num_boundaries:
        raise ValueError(f"need {num_boundaries} thresholds, got {len(ts)}")
    return ts


def _pad_rows(x: torch.Tensor, m: int) -> torch.Tensor:
    n = x.shape[0]
    if m == n:
        return x
    return torch.cat([x, x.new_zeros((m - n,) + tuple(x.shape[1:]))])


class DiffusionCascade:
    """Real-execution diffusion cascade on one device.

    ``stages`` is an ordered sequence of (DiffusionConfig, params) pairs,
    cheapest first, with params on ``device``; queries defer stage i ->
    i+1 when the discriminator scores stage i's output below
    ``thresholds[i]``. The discriminator scores the latents themselves
    (the JAX cascade's default identity ``latent_to_image``). Starting latents are drawn at bucket shape from
    the cascade's seeded ``torch.Generator`` on the device, unless a
    ``noise_fn(stage_index, shape)`` supplies them.
    """

    def __init__(self, stages: Sequence[Stage],
                 disc_cfg: DiscriminatorConfig, disc_params,
                 kernel_impl: str = "auto",
                 batch_buckets: Sequence[int] = (),
                 device: DeviceLike = None, seed: int = 0,
                 noise_fn: Optional[NoiseFn] = None):
        self.stages: Tuple[Stage, ...] = tuple(stages)
        if len(self.stages) < 2:
            raise ValueError("a cascade needs >= 2 stages")
        self.device = resolve_device(device)
        self.disc_cfg, self.disc_params = disc_cfg, disc_params
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.noise_fn: NoiseFn = noise_fn or self._draw_noise
        # distinct batch shapes run per stage sampler, then the scorer
        self._shapes: List[Set[int]] = [set() for _ in range(
            len(self.stages) + 1)]
        self.kernel_impl: Optional[str] = None
        self.batch_buckets: Tuple[int, ...] = ()
        self.configure_kernels(kernel_impl, batch_buckets)

    def _draw_noise(self, stage: int, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

    def configure_kernels(self, kernel_impl: str = "auto",
                          batch_buckets: Sequence[int] = ()) -> None:
        """(Re)build the stage samplers under a kernel plan:
        ``kernel_impl`` routes model math ("fused" through
        ``kernels/ops.py``, "unfused" the per-op baseline, "auto" =
        "fused"); ``batch_buckets`` pads batches up the bucket ladder so
        each stage runs O(#buckets) distinct shapes."""
        impl = kimpls.resolve_kernel_impl(kernel_impl)
        buckets = tuple(int(b) for b in batch_buckets)
        if (impl, buckets) == (self.kernel_impl, self.batch_buckets):
            return
        self.kernel_impl, self.batch_buckets = impl, buckets
        self._samplers = [self._make_sampler(i, cfg)
                          for i, (cfg, _) in enumerate(self.stages)]

    def bucket_for(self, n: int) -> int:
        return kimpls.bucket_for(n, self.batch_buckets)

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks) if not torch.is_tensor(toks)
                               else toks).to(self.device, torch.int64)

    def _make_sampler(self, index: int, cfg: DiffusionConfig) -> Callable:
        """Stage fn ``(params, toks) -> latents``: pads the batch to its
        bucket, draws the starting latent at bucket shape, runs DDIM, and
        slices the output back to the true batch."""
        shapes = self._shapes[index]

        def sample(params, toks):
            toks = self._tokens(toks)
            n = toks.shape[0]
            m = self.bucket_for(n)
            toks = _pad_rows(toks, m)
            noise = self.noise_fn(
                index, (m, cfg.image_size, cfg.image_size, cfg.in_channels))
            shapes.add(m)
            out = diff.ddim_sample(params, cfg, toks, noise,
                                   impl=self.kernel_impl)
            return out[:n]
        return sample

    def shape_counts(self) -> List[int]:
        """Distinct batch shapes run per stage sampler (in order), then
        the discriminator scorer: the counterpart of the JAX package's
        ``compile_counts``. A batch sweep adds at most one per bucket."""
        return [len(s) for s in self._shapes]

    def stage_fns(self):
        """(config, sampler, params) per stage (cluster mode measures
        per-stage execution profiles through these)."""
        return [(cfg, fn, params) for (cfg, params), fn in
                zip(self.stages, self._samplers)]

    def _score(self, imgs: torch.Tensor) -> torch.Tensor:
        logits, _ = apply_discriminator(self.disc_params, self.disc_cfg,
                                        imgs, impl=self.kernel_impl)
        return torch.softmax(logits, dim=-1)[:, 1]

    def confidence(self, images) -> np.ndarray:
        imgs = torch.as_tensor(images).to(self.device, torch.float32)
        n = imgs.shape[0]
        m = self.bucket_for(n)
        self._shapes[-1].add(m)
        # GroupNorm statistics are per sample, so padded rows cannot leak
        # into real scores; their scores are dropped here
        return self._score(_pad_rows(imgs, m))[:n].cpu().numpy()

    def run_batch(self, prompt_tokens,
                  thresholds: Union[float, Sequence[float]]) -> CascadeResult:
        """Execute the full cascade: a scalar threshold broadcasts to all
        boundaries."""
        n = len(self.stages)
        ths = _normalize_thresholds(thresholds, n - 1)
        first = self._samplers[0](self.stages[0][1], prompt_tokens)
        conf0 = self.confidence(first)
        outputs = first.cpu().numpy()
        light_outputs = outputs.copy()
        stage_idx = np.zeros(len(conf0), dtype=np.int64)
        boundary_confs: List[np.ndarray] = [conf0]
        active = conf0 < ths[0]
        for i in range(1, n):
            if not bool(active.any()):
                break
            imgs = self._samplers[i](self.stages[i][1], prompt_tokens)
            outputs = np.where(active[:, None, None, None],
                               imgs.cpu().numpy(), outputs)
            stage_idx = np.where(active, i, stage_idx)
            if i < n - 1:
                conf = self.confidence(imgs)
                boundary_confs.append(conf)
                active = active & (conf < ths[i])
            else:
                active = np.zeros_like(active)
        return CascadeResult(outputs=outputs, confidences=conf0,
                             deferred=stage_idx > 0,
                             light_outputs=light_outputs,
                             stage_index=stage_idx,
                             boundary_confidences=boundary_confs)


class LMCascade:
    """LM cascade (paper §5): an ordered list of same-family LM step
    callables; confidence = mean top-token probability of each stage's
    generation. A copy of the JAX package's ``LMCascade``: host logic
    over the steps, which may run anywhere."""

    def __init__(self, *steps: Callable):
        """Each step(prompt_tokens) -> (tokens, logprobs) host callable,
        cheapest first."""
        if len(steps) == 1 and isinstance(steps[0], (list, tuple)):
            steps = tuple(steps[0])
        if len(steps) < 2:
            raise ValueError("an LM cascade needs >= 2 stages")
        self.steps: Tuple[Callable, ...] = tuple(steps)

    @property
    def light_step(self) -> Callable:
        return self.steps[0]

    @property
    def heavy_step(self) -> Callable:
        return self.steps[-1]

    def run_batch(self, prompt_tokens,
                  thresholds: Union[float, Sequence[float]]) -> CascadeResult:
        n = len(self.steps)
        ths = _normalize_thresholds(thresholds, n - 1)
        tokens, logprobs = self.steps[0](prompt_tokens)
        conf0 = np.exp(np.asarray(logprobs)).mean(axis=-1)
        outputs = np.asarray(tokens)
        light_outputs = np.asarray(tokens)
        stage_idx = np.zeros(len(conf0), dtype=np.int64)
        active = conf0 < ths[0]
        for i in range(1, n):
            if not bool(active.any()):
                break
            toks_i, logp_i = self.steps[i](prompt_tokens)
            outputs = np.where(active[:, None], np.asarray(toks_i), outputs)
            stage_idx = np.where(active, i, stage_idx)
            if i < n - 1:
                conf = np.exp(np.asarray(logp_i)).mean(axis=-1)
                active = active & (conf < ths[i])
            else:
                active = np.zeros_like(active)
        return CascadeResult(outputs=outputs, confidences=conf0,
                             deferred=stage_idx > 0,
                             light_outputs=light_outputs,
                             stage_index=stage_idx)


def greedy_lm_step(params, cfg, new_tokens: int,
                   device: DeviceLike = None) -> Callable:
    """An ``LMCascade`` step over the port's serve steps (the port's own:
    the JAX package leaves the steps to the caller): ``step(prompts)``
    takes (B, S) token ids, prefills a fresh cache on ``device`` (CUDA
    unless the caller passes "cpu"; ``params`` live there), decodes
    ``new_tokens`` tokens greedily and returns numpy (tokens (B, N),
    log-probabilities of the chosen tokens (B, N), float32)."""
    dev = resolve_device(device)

    def step(prompt_tokens):
        toks = torch.as_tensor(np.asarray(prompt_tokens)
                               if not torch.is_tensor(prompt_tokens)
                               else prompt_tokens).to(dev, torch.int64)
        Bq, S = toks.shape
        cache = init_cache(cfg, Bq, S + new_tokens, dev)
        logits, cache = serve_prefill(params, cfg, cache, toks)
        chosen, logps = [], []
        for i in range(new_tokens):
            lp = torch.log_softmax(logits.float(), dim=-1)
            nxt = lp.argmax(dim=-1, keepdim=True)
            chosen.append(nxt)
            logps.append(lp.gather(-1, nxt))
            if i + 1 < new_tokens:
                logits, cache = serve_decode(params, cfg, cache, nxt, S + i)
        return (torch.cat(chosen, dim=1).cpu().numpy(),
                torch.cat(logps, dim=1).cpu().numpy())
    return step
