"""Multi-head Latent Attention, DeepSeek-V2/V3 (port of
``repro/models/mla.py``).

KV is compressed into a per-token latent ``c_kv`` (``kv_lora_rank``)
plus one shared RoPE key (``qk_rope_head_dim``); the cache keeps only
those two, ``{"c_kv": (B, T, r), "k_rope": (B, T, dr)}``. Prefill
materialises per-head K/V from the latent; decode uses the absorbed
form, W_uk folded into the query and W_uv into the output, so it reads
the latent cache as it is.

The JAX package computes MLA's attention as plain ``jnp`` (its
``gqa_attention`` at prefill, einsums at decode) and no Pallas kernel
covers it; its query/key head dim (nope + rope, 192 at full width)
differs from its value head dim (128), which no flash route takes. It
stays plain PyTorch here. The query and latent norms go through
``layers.norm_apply``, so the RMSNorm kernel runs on them on CUDA.
Parameters are in the JAX layouts (``w_uq`` (r_q, H, dn + dr),
``w_uk`` (r, H, dn), ``w_uv`` (r, H, dv), ``wo`` (H, dv, D)).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import (apply_rope, dense_init, gqa_attention,
                                       norm_apply, norm_init, proj_heads,
                                       rope_angles, slots_for, torch_dtype)


def mla_init(gen, cfg, device=None):
    D, H = cfg.d_model, cfg.num_heads
    m = cfg.mla
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                     m.v_head_dim, m.kv_lora_rank)
    dt = torch_dtype(cfg.dtype)

    def w(shape, scale=None):
        return dense_init(gen, shape, scale=scale, dtype=dt, device=device)
    p = {
        "w_dkv": w((D, r)),
        "kv_norm": norm_init("rmsnorm", r, device),
        "w_uk": w((r, H, dn)),
        "w_uv": w((r, H, dv)),
        "w_kr": w((D, dr)),
        "wo": w((H, dv, D), scale=1.0 / math.sqrt(H * dv)),
    }
    if m.q_lora_rank:
        p["w_dq"] = w((D, m.q_lora_rank))
        p["q_norm"] = norm_init("rmsnorm", m.q_lora_rank, device)
        p["w_uq"] = w((m.q_lora_rank, H, dn + dr))
    else:
        p["w_uq"] = w((D, H, dn + dr))
    return p


def _queries(params, cfg, x, impl):
    """(B, S, H, dn + dr) queries, through the low-rank path where the
    config has a query rank."""
    if cfg.mla.q_lora_rank:
        cq = x @ params["w_dq"]
        cq = norm_apply(params["q_norm"], cq, "rmsnorm", cfg.norm_eps,
                        impl=impl)
        return proj_heads(cq, params["w_uq"])
    return proj_heads(x, params["w_uq"])


def _rope_pos(positions):
    return positions if positions.ndim == 2 else positions[0]


def _latent(params, cfg, x, cos, sin, impl):
    """The new tokens' normalised latent and rotated shared key."""
    c_kv = norm_apply(params["kv_norm"], x @ params["w_dkv"], "rmsnorm",
                      cfg.norm_eps, impl=impl)
    k_rope = apply_rope((x @ params["w_kr"])[:, :, None, :], cos,
                        sin)[:, :, 0, :]
    return c_kv, k_rope


def _write(cache, c_kv, k_rope, cache_index, S):
    """Writes the new rows into the cache in place at ``cache_index``
    (an int or a 0-d device tensor)."""
    rows = slots_for(S, cache_index, c_kv.device)
    cache["c_kv"].index_copy_(1, rows, c_kv.to(cache["c_kv"].dtype))
    cache["k_rope"].index_copy_(1, rows, k_rope.to(cache["k_rope"].dtype))


def mla_prefill(params, cfg, x, positions, cache=None, cache_index=0,
                impl: str = "fused"):
    """Full-sequence MLA with per-head K/V materialised from the latent.
    ``cache`` (optional) is written in place at ``cache_index``. As in
    the JAX package, attention runs over the S fresh rows only, causal
    by the query positions: at ``cache_index`` > 0 every fresh row lies
    at or below every query's position. Returns (y, cache)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = _queries(params, cfg, x, impl)
    pos = _rope_pos(positions)
    cos, sin = rope_angles(pos, dr, cfg.rope_theta)
    q_full = torch.cat([q[..., :dn], apply_rope(q[..., dn:], cos, sin)],
                       dim=-1)
    c_kv, k_rope = _latent(params, cfg, x, cos, sin, impl)
    k = torch.cat([proj_heads(c_kv, params["w_uk"]),
                   k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    v = proj_heads(c_kv, params["w_uv"])
    out = gqa_attention(q_full, k, v, causal=True, q_positions=pos)
    wo = params["wo"]
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    if cache is not None:
        _write(cache, c_kv, k_rope, cache_index, S)
    return y, cache


def mla_decode(params, cfg, x, positions, cache, cache_index,
               impl: str = "fused"):
    """Absorbed few-token MLA decode against the latent cache, which is
    written in place at ``cache_index``: scores ``(q_nope W_uk) . c_kv +
    q_rope . k_rope`` in float32 over the rows at or below each query's
    position and below ``cache_index + S``, the context taken in the
    latent and carried out through W_uv. Returns (y, cache)."""
    m = cfg.mla
    B, S, _ = x.shape
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = _queries(params, cfg, x, impl)
    pos = _rope_pos(positions)
    cos, sin = rope_angles(pos, dr, cfg.rope_theta)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], cos, sin)
    c_new, k_rope_new = _latent(params, cfg, x, cos, sin, impl)
    _write(cache, c_new, k_rope_new, cache_index, S)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
    s_nope = torch.einsum("bshr,btr->bhst", q_abs.float(), c_kv.float())
    s_rope = torch.einsum("bshk,btk->bhst", q_rope.float(), k_rope.float())
    scores = (s_nope + s_rope) / math.sqrt(dn + dr)          # (B,H,S,T)
    T = c_kv.shape[1]
    kv_pos = torch.arange(T, device=x.device)[None, None, None, :]
    valid = (kv_pos <= pos[:, None, :, None]) \
        & (kv_pos < cache_index + S)
    scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,btr->bshr", probs, c_kv.to(x.dtype))
    out = torch.einsum("bshr,rhv->bshv", ctx, params["w_uv"])
    wo = params["wo"]
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return y, cache


def mla_cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """{name: (shape, dtype)} of one MLA layer's latent cache."""
    m = cfg.mla
    return {"c_kv": ((batch, max_len, m.kv_lora_rank), dtype),
            "k_rope": ((batch, max_len, m.qk_rope_head_dim), dtype)}
