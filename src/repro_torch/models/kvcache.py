"""Caches for serving the LM (port of ``repro/models/kvcache.py``): one
entry per layer of ``cfg.flat_pattern()``, by mixer kind, as the JAX
package's ``_entry_specs`` builds it:

  * ``attn``: ``{"k", "v"}`` of (B, T_max, KH, hd) in the cache dtype;
  * ``mamba``: ``{"conv": (B, d_conv - 1, E)}`` in the cache dtype and
    ``{"h": (B, E, N)}`` float32;
  * ``mlstm``: ``conv`` as above and ``C`` (B, H, dh, dh), ``n`` (B, H,
    dh), ``m`` (B, H) float32;
  * ``slstm``: ``c``, ``n``, ``m``, ``h`` of (B, D) float32;
  * ``mla``: the latent ``{"c_kv": (B, T_max, kv_lora_rank), "k_rope":
    (B, T_max, qk_rope_head_dim)}`` in the cache dtype.

Every entry starts at zero except the stabilisers ``m``, which start at
-inf (the JAX package's ``fix_m``). The forward writes into the entries
in place. ``cache_specs`` gives the same list as ``meta`` tensors (shapes
and dtypes only), ``cache_pspecs`` its partition specs and
``cache_bytes`` its size.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mla as MLA
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.parallel.sharding import MeshAxes, P


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
        return MLA.mla_cache_specs(cfg, batch, max_len, dt)
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


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The cache ``init_cache`` builds, as ``meta`` tensors: shapes and
    dtypes, no data (the JAX package's ShapeDtypeStruct tree)."""
    return [{name: torch.empty(shape, dtype=dt, device="meta")
             for name, (shape, dt) in entry_specs(cfg, spec, batch,
                                                  max_len).items()}
            for spec in cfg.flat_pattern()]


# Partition layouts by leaf name and ndim (the JAX package's, without its
# leading period axis: the port's cache is a list of layers). KV caches
# shard heads on the model axis where it divides them, else the sequence
# dim; MLA's latent cache has no head dim and is always sequence-sharded.
_BASE_SPECS = {
    ("c_kv", 3): ("batch", "cache_seq", None),
    ("k_rope", 3): ("batch", "cache_seq", None),
    ("conv", 3): ("batch", None, "ffn"),       # (B, W-1, E)
    ("h", 3): ("batch", "ffn", None),          # mamba (B, E, N)
    ("C", 4): ("batch", "heads", None, None),  # mlstm (B, H, dk, dv)
    ("n", 3): ("batch", "heads", None),        # mlstm (B, H, dk)
    ("m", 2): ("batch", None),                 # mlstm (B, H)
    ("c", 2): ("batch", None),                 # slstm (B, D)
    ("n", 2): ("batch", None),
    ("h", 2): ("batch", None),
}


def cache_pspecs(cache, rules: Dict[str, MeshAxes],
                 model_axis_size: int = 0):
    """PartitionSpecs for a cache list (of tensors of any device).
    ``model_axis_size`` (if given) selects head- against
    sequence-sharding for attention K/V."""
    def one(name, leaf):
        ndim = leaf.ndim
        if name in ("k", "v") and ndim == 4:
            kv_heads = leaf.shape[-2]
            if model_axis_size and kv_heads % model_axis_size == 0:
                logical = ("batch", None, "kv_heads", None)
            else:
                logical = ("batch", "cache_seq", None, None)
        else:
            logical = _BASE_SPECS.get((name, ndim),
                                      ("batch",) + (None,) * (ndim - 1))
        return P(*[rules.get(a) if a else None for a in logical])
    return [{name: one(name, leaf) for name, leaf in entry.items()}
            for entry in cache]


def cache_bytes(cache) -> int:
    """Bytes of a cache list (of tensors of any device)."""
    return sum(leaf.numel() * leaf.element_size()
               for entry in cache for leaf in entry.values())
