"""Decoder-only LM (port of ``repro/models/transformer.py``).

Each block is (mixer, ffn) with mixer in {attn, mamba, mlstm, slstm} and
ffn in {mlp, moe, None}; the "mla" mixer is not ported yet (ROADMAP.md).
Parameters: ``{"embed": {"embedding"}, "layers": [block, ...],
"final_norm", "lm_head"}`` with one block per layer of
``cfg.flat_pattern()``; the JAX package's scan over stacked periods is a
Python loop over this list. ``forward`` runs in three modes, as there:

  * ``train``   — the full sequence, no cache;
  * ``prefill`` — the full sequence, written into the cache from 0;
  * ``decode``  — S new tokens (1 when served) at ``cache_index``.

Kernels per forward (``kernels/ops.py``): with RMSNorm, one launch a
layer for ``ln1``, one for ``ln2`` fused with the mixer's residual add
(blocks with an FFN), and one for the final norm; SwiGLU once per MLP or
MoE layer; attention once per attention layer (flash in train/prefill,
decode attention at S = 1); ``mamba_scan`` once per Mamba layer and
``mlstm_chunk`` once per mLSTM layer. LayerNorm (xLSTM) and the sLSTM
are plain PyTorch. Remat and the multi-token prediction head (training
only) are not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL

MODES = ("train", "prefill", "decode")


_MIXERS = {"mamba": (SSM.mamba_init, SSM.mamba_apply),
           "mlstm": (XL.mlstm_init, XL.mlstm_apply),
           "slstm": (XL.slstm_init, XL.slstm_apply)}


def _check_spec(spec) -> None:
    mixer, ffn = spec
    if mixer == "mla":
        raise NotImplementedError(
            f"block {spec!r}: the 'mla' mixer is not ported yet "
            "(ROADMAP.md)")
    if mixer != "attn" and mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn not in ("mlp", "moe", None):
        raise ValueError(f"unknown ffn {ffn!r}")


def block_init(gen, cfg: ModelConfig, spec, device=None) -> Dict[str, Any]:
    _check_spec(spec)
    mixer, ffn = spec
    p: Dict[str, Any] = {"ln1": L.norm_init(cfg.norm, cfg.d_model, device)}
    if mixer == "attn":
        p["attn"] = L.attn_init(gen, cfg, device)
    else:
        p["mixer"] = _MIXERS[mixer][0](gen, cfg, device)
    if ffn is not None:
        p["ln2"] = L.norm_init(cfg.norm, cfg.d_model, device)
        p["ffn"] = (L.moe_init(gen, cfg, device) if ffn == "moe"
                    else L.mlp_init(gen, cfg, device=device))
    return p


def block_apply(params, cfg: ModelConfig, spec, x, *, positions,
                cache_entry, cache_index):
    """Returns (x, cache_entry); the entry, when given, is written in
    place. The residual add after the mixer is fused into the ``ln2``
    norm: ``(h, x) = norm(y, residual=x)``."""
    mixer, ffn = spec
    h = L.norm_apply(params["ln1"], x, cfg.norm, cfg.norm_eps)
    if mixer == "attn":
        y, entry = L.attn_apply(params["attn"], cfg, h, positions=positions,
                                cache=cache_entry, cache_index=cache_index)
    else:
        y, entry = _MIXERS[mixer][1](params["mixer"], cfg, h,
                                     state=cache_entry)
    if ffn is None:
        return x + y, entry
    h, x = L.norm_apply(params["ln2"], y, cfg.norm, cfg.norm_eps,
                        residual=x)
    if ffn == "moe":
        y, _ = L.moe_apply(params["ffn"], cfg, h)
    else:
        y = L.mlp_apply(params["ffn"], cfg, h)
    return x + y, entry


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


def _mixer_size(cfg: ModelConfig, mixer: str) -> int:
    D = cfg.d_model
    if mixer == "attn":
        H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        return 2 * D * H * hd + 2 * D * KH * hd
    if mixer == "mamba":
        E, N, R = SSM._dims(cfg)
        W = cfg.ssm.d_conv
        # in_proj, conv kernel + bias, x_proj, dt_proj + dt_bias, A_log,
        # D, out_proj
        return D * 2 * E + W * E + E + E * (R + 2 * N) + R * E + E \
            + E * N + E + E * D
    if mixer == "mlstm":
        E, H, _ = XL._mlstm_dims(cfg)
        W = cfg.xlstm.conv_kernel
        # wi_up, conv kernel + bias, wq/wk/wv, w_if, i/f biases, ogate
        # scale, out_proj
        return D * 2 * E + W * E + E + 3 * E * E + E * 2 * H + 2 * H + E \
            + E * D
    up = XL.slstm_up_dim(cfg)                      # slstm
    dh = D // cfg.num_heads
    return D * 4 * D + cfg.num_heads * dh * 4 * dh + 4 * D + 2 * D * up


def _ffn_size(cfg: ModelConfig, ffn: str) -> int:
    D = cfg.d_model
    mats = 3 if cfg.mlp == "swiglu" else 2
    if ffn == "mlp":
        return mats * D * cfg.d_ff
    m = cfg.moe
    Fd = m.d_ff or cfg.d_ff
    n = D * m.num_experts + 3 * m.num_experts * D * Fd
    if m.num_shared_experts:
        n += mats * D * Fd * m.num_shared_experts
    return n


def count_params(cfg: ModelConfig) -> int:
    """Parameters of ``init_params(cfg)``, from the config alone."""
    D, V = cfg.d_model, cfg.vocab_size
    n = V * D + _norm_size(cfg.norm, D)
    if cfg.pos_emb == "learned":
        n += cfg.max_position * D
    if not cfg.tie_embeddings:
        n += D * V
    for spec in cfg.flat_pattern():
        _check_spec(spec)
        mixer, ffn = spec
        n += _norm_size(cfg.norm, D) + _mixer_size(cfg, mixer)
        if ffn is not None:
            n += _norm_size(cfg.norm, D) + _ffn_size(cfg, ffn)
    return n
