"""KV caches for serving the LM (port of ``repro/models/kvcache.py`` for
attention mixers). The cache is a list with one ``{"k", "v"}`` entry per
layer, each (B, T_max, KH, hd) and zero at the start; the forward writes
into it in place. MLA latent caches and recurrent states come with
their models (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """KV caches are bf16 for bf16 models (the serving memory budget);
    fp32 models (CPU test scale) cache in fp32 so decode equals the
    teacher-forced forward."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None):
    """Zero cache for ``batch`` sequences of up to ``max_len`` tokens on
    ``device`` (CUDA unless the caller passes "cpu")."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = []
    for mixer, _ in cfg.flat_pattern():
        if mixer != "attn":
            raise NotImplementedError(f"no cache for mixer {mixer!r} in "
                                      "the port yet")
        cache.append({"k": torch.zeros(shape, dtype=cache_dtype(cfg),
                                       device=dev),
                      "v": torch.zeros(shape, dtype=cache_dtype(cfg),
                                       device=dev)})
    return cache
