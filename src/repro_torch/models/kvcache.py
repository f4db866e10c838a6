"""Caches for serving the LM (port of ``repro/models/kvcache.py``): one
entry per layer of ``cfg.flat_pattern()``, by mixer kind, as the JAX
package's ``_entry_specs`` builds it:

  * ``attn``: ``{"k", "v"}`` of (B, T_max, KH, hd) in the cache dtype;
  * ``mamba``: ``{"conv": (B, d_conv - 1, E)}`` in the cache dtype and
    ``{"h": (B, E, N)}`` float32;
  * ``mlstm``: ``conv`` as above and ``C`` (B, H, dh, dh), ``n`` (B, H,
    dh), ``m`` (B, H) float32;
  * ``slstm``: ``c``, ``n``, ``m``, ``h`` of (B, D) float32.

Every entry starts at zero except the stabilisers ``m``, which start at
-inf (the JAX package's ``fix_m``). The forward writes into the entries
in place. MLA latent caches come with their model (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """KV caches are bf16 for bf16 models (the serving memory budget);
    fp32 models (CPU test scale) cache in fp32 so decode equals the
    teacher-forced forward."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def entry_specs(cfg: ModelConfig, spec, batch: int, max_len: int):
    """{name: (shape, dtype)} of one layer's cache entry."""
    mixer, _ = spec
    dt = cache_dtype(cfg)
    if mixer == "attn":
        shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k": (shape, dt), "v": (shape, dt)}
    if mixer == "mamba":
        return SSM.mamba_state_specs(cfg, batch, dt)
    if mixer == "mlstm":
        return XL.mlstm_state_specs(cfg, batch, dt)
    if mixer == "slstm":
        return XL.slstm_state_specs(cfg, batch)
    if mixer == "mla":
        raise NotImplementedError("no cache for the 'mla' mixer in the "
                                  "port yet (ROADMAP.md)")
    raise ValueError(f"unknown mixer {mixer!r}")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None):
    """The cache for ``batch`` sequences of up to ``max_len`` tokens on
    ``device`` (CUDA unless the caller passes "cpu"): a list with one
    entry per layer."""
    dev = resolve_device(device)
    cache = []
    for spec in cfg.flat_pattern():
        entry = {}
        for name, (shape, dt) in entry_specs(cfg, spec, batch,
                                             max_len).items():
            fill = float("-inf") if name == "m" else 0.0
            entry[name] = torch.full(shape, fill, dtype=dt, device=dev)
        cache.append(entry)
    return cache
