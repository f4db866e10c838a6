"""Decoder-only LM (port of ``repro/models/transformer.py`` for the dense
("attn", "mlp") stack).

Parameters: ``{"embed": {"embedding"}, "layers": [block, ...],
"final_norm", "lm_head"}`` with one block per layer of
``cfg.flat_pattern()``; the JAX package's scan over stacked periods is a
Python loop over this list. ``forward`` runs in three modes, as there:

  * ``train``   — the full sequence, no cache;
  * ``prefill`` — the full sequence, written into the cache from 0;
  * ``decode``  — S new tokens (1 when served) at ``cache_index``.

Per forward with RMSNorm and SwiGLU, the kernels launch once per layer
each for ``ln1`` (RMSNorm), ``ln2`` fused with the attention residual
add, SwiGLU and attention (flash in train/prefill, decode attention at
S = 1), plus one RMSNorm for the final norm. Remat and the multi-token
prediction head (training only) are not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

MODES = ("train", "prefill", "decode")


def _check_spec(spec) -> None:
    mixer, ffn = spec
    if mixer != "attn" or ffn not in ("mlp", None):
        raise NotImplementedError(
            f"block {spec!r}: the port runs ('attn', 'mlp') stacks; other "
            "mixers and MoE are listed in ROADMAP.md")


def block_init(gen, cfg: ModelConfig, spec, device=None) -> Dict[str, Any]:
    _check_spec(spec)
    p: Dict[str, Any] = {"ln1": L.norm_init(cfg.norm, cfg.d_model, device),
                         "attn": L.attn_init(gen, cfg, device)}
    if spec[1] is not None:
        p["ln2"] = L.norm_init(cfg.norm, cfg.d_model, device)
        p["ffn"] = L.mlp_init(gen, cfg, device=device)
    return p


def block_apply(params, cfg: ModelConfig, spec, x, *, positions,
                cache_entry, cache_index):
    """Returns (x, cache_entry). The residual add after attention is
    fused into the ``ln2`` norm: ``(h, x) = norm(y, residual=x)``."""
    h = L.norm_apply(params["ln1"], x, cfg.norm, cfg.norm_eps)
    y, entry = L.attn_apply(params["attn"], cfg, h, positions=positions,
                            cache=cache_entry, cache_index=cache_index)
    if spec[1] is None:
        return x + y, entry
    h, x = L.norm_apply(params["ln2"], y, cfg.norm, cfg.norm_eps,
                        residual=x)
    return x + L.mlp_apply(params["ffn"], cfg, h), entry


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters (the JAX package's structure and distributions)
    from a seeded ``torch.Generator`` on ``device`` (CUDA unless the
    caller passes "cpu")."""
    if cfg.input_mode != "tokens" or cfg.mtp_depth:
        raise NotImplementedError("the port's LM takes tokens and has no "
                                  "multi-token prediction head")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg, dev),
        "layers": [block_init(gen, cfg, spec, dev)
                   for spec in cfg.flat_pattern()],
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                    scale=cfg.d_model ** -0.5,
                                    dtype=L.torch_dtype(cfg.dtype),
                                    device=dev)
    return p


def _default_positions(batch: int, seq: int, cache_index, device):
    """(B, S) int64 positions ``cache_index + arange(S)``; a tensor
    ``cache_index`` stays on the device (no host sync)."""
    pos = torch.arange(seq, device=device) + cache_index
    return pos[None, :].expand(batch, seq)


def forward(params, cfg: ModelConfig, tokens, *, cache=None, cache_index=0,
            mode: str = "train"):
    """tokens: (B, S) int. ``cache``: the list of ``init_cache``, needed
    in ``prefill`` and ``decode`` and written in place; ``cache_index``:
    the position of the first token, an int or a 0-d device tensor.
    Returns (logits (B, S, V), cache)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if (cache is None) != (mode == "train"):
        raise ValueError(f"mode {mode!r} with cache={cache is not None}: "
                         "train takes no cache, prefill and decode need one")
    B, S = tokens.shape
    positions = _default_positions(B, S, cache_index, tokens.device)
    x = L.embed_apply(params["embed"], cfg, tokens, positions)
    for i, (spec, lp) in enumerate(zip(cfg.flat_pattern(),
                                       params["layers"])):
        x, _ = block_apply(lp, cfg, spec, x, positions=positions,
                           cache_entry=None if cache is None else cache[i],
                           cache_index=cache_index)
    x = L.norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].T
    else:
        logits = x @ params["lm_head"]
    return logits, cache


def _norm_size(kind: str, dim: int) -> int:
    return {"rmsnorm": dim, "layernorm": 2 * dim, "nonparam_ln": 0}[kind]


def count_params(cfg: ModelConfig) -> int:
    """Parameters of ``init_params(cfg)``, from the config alone."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n = V * D + _norm_size(cfg.norm, D)
    if cfg.pos_emb == "learned":
        n += cfg.max_position * D
    if not cfg.tie_embeddings:
        n += D * V
    for spec in cfg.flat_pattern():
        _check_spec(spec)
        n += _norm_size(cfg.norm, D) + 2 * D * H * hd + 2 * D * KH * hd
        if spec[1] is not None:
            n += _norm_size(cfg.norm, D) \
                + (3 if cfg.mlp == "swiglu" else 2) * D * F
    return n
