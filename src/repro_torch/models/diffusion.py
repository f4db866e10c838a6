"""Diffusion process: cosine schedule, forward noising, DDIM and Euler
samplers.

Port of ``repro/models/diffusion.py`` (``q_sample``, ``ddim_sample``,
``euler_sample``). The sampler loops are Python loops over a host-side
timestep table; each step runs the UNet on the device. The training
loss comes with the training slice.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.config.base import DiffusionConfig
from repro_torch.models.unet import apply_unet

NUM_TRAIN_STEPS = 1000


@functools.lru_cache()
def _schedule_np(n: int = NUM_TRAIN_STEPS) -> np.ndarray:
    t = np.arange(n + 1, dtype=np.float32) / n
    f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
    alphas_bar = f / f[0]
    return np.clip(alphas_bar, 1e-5, 1.0)


def ddim_timesteps(steps: int) -> np.ndarray:
    """The JAX package's ``jnp.linspace(999, 0, steps).astype(int32)``,
    which matches neither ``np.linspace`` nor ``torch.linspace`` (at 4
    steps it gives 665/332): the same float32 arithmetic, floored."""
    s = np.arange(steps, dtype=np.float32) \
        * (np.float32(1) / np.float32(max(steps - 1, 1)))
    ts = np.floor(np.float32(NUM_TRAIN_STEPS - 1)
                  * (np.float32(1) - s)).astype(np.int64)
    if steps > 1:
        ts[-1] = 0
    return ts


def q_sample(x0, t, noise):
    """Forward process: x_t = sqrt(ab_t) x0 + sqrt(1-ab_t) eps."""
    ab = torch.as_tensor(_schedule_np(), device=x0.device)[t]
    ab = ab[:, None, None, None]
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def ddim_sample(params, cfg: DiffusionConfig, prompt_tokens, init_noise,
                num_steps: Optional[int] = None, impl: str = "fused"):
    """Deterministic DDIM (eta=0). num_steps=1 reproduces the distilled
    'turbo' execution profile. ``init_noise`` is the standard-normal
    starting latent (B,H,W,C), drawn by the caller (the cascade draws it
    from its seeded generator)."""
    steps = num_steps or cfg.num_steps
    B = prompt_tokens.shape[0]
    x = init_noise
    ab = _schedule_np()
    ts = ddim_timesteps(steps)
    one = np.float32(1)
    for i in range(steps):
        t = int(ts[i])
        ab_t = ab[t]
        ab_n = ab[int(ts[i + 1])] if i + 1 < steps else one
        eps = apply_unet(params, cfg, x,
                         torch.full((B,), t, device=x.device), prompt_tokens,
                         impl=impl)
        # coefficients in float32, as the JAX loop computes them
        x0 = (x - float(np.sqrt(one - ab_t)) * eps) / float(np.sqrt(ab_t))
        x0 = x0.clamp(-3.0, 3.0)
        x = float(np.sqrt(ab_n)) * x0 + float(np.sqrt(one - ab_n)) * eps
    return x.clamp(-1.0, 1.0)


def euler_sample(params, cfg: DiffusionConfig, prompt_tokens, init_noise,
                 num_steps: Optional[int] = None, impl: str = "fused"):
    """Euler ODE sampler over sigma = sqrt((1 - ab) / ab) (the DDIM
    alternative). ``init_noise`` is the standard-normal starting latent
    (B,H,W,C), drawn by the caller; the scaling by sigma at the first
    timestep happens here."""
    steps = num_steps or cfg.num_steps
    B = prompt_tokens.shape[0]
    ab = _schedule_np()
    sigmas = np.sqrt((np.float32(1) - ab) / ab)
    ts = ddim_timesteps(steps)
    x = init_noise * float(sigmas[ts[0]])
    for i in range(steps):
        t = int(ts[i])
        sig = sigmas[t]
        sig_next = sigmas[int(ts[i + 1])] if i + 1 < steps else \
            np.float32(0)
        xin = x / float(np.sqrt(sig * sig + np.float32(1)))
        eps = apply_unet(params, cfg, xin,
                         torch.full((B,), t, device=x.device), prompt_tokens,
                         impl=impl)
        x = x + eps * float(sig_next - sig)
    return x.clamp(-1.0, 1.0)
