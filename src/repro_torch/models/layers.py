"""Building blocks of the decoder-only LM (port of
``repro/models/layers.py``: norms, RoPE, GQA attention, MLPs, the
capacity-dispatched mixture of experts, embedding).

Parameters are nested dicts of tensors in the JAX package's layouts
(``wq`` (D, H, hd), ``wo`` (H, hd, D), FFN ``(D, F)``/``(F, D)``, norm
scales float32), so ``models/convert.lm_from_jax`` copies them as they
are. Activations are in the config's dtype; norms, softmax and the
SwiGLU product run in float32 inside their kernels. The kernels are
reached through ``kernels/ops.py``: RMSNorm (plain and with the residual
add), SwiGLU (the MLP's and each expert's), flash attention over fresh
K/V (train and prefill) and decode attention over the cache (S = 1).
LayerNorm, GELU, RoPE, the MoE router and dispatch, and the matmuls
have no kernel in the JAX package and stay plain PyTorch. The JAX
package's sharding constraints have no counterpart on one card.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(fan_in), fan_in the
    product of all but the last dim (the JAX package's rule)."""
    if scale is None:
        fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_init(kind: str, dim: int, device=None):
    if kind == "rmsnorm":
        return {"scale": torch.ones(dim, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(dim, device=device),
                "bias": torch.zeros(dim, device=device)}
    if kind == "nonparam_ln":          # OLMo: no learnable params
        return {}
    raise ValueError(kind)


def _layernorm(params, x, kind: str, eps: float):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        out = out * params["scale"] + params["bias"]
    return out.to(x.dtype)


def norm_apply(params, x, kind: str, eps: float = 1e-5, residual=None):
    """Normalise x over its last dim. With ``residual`` the input is
    ``x + residual`` and the result ``(normed, x + residual)``: for
    RMSNorm one launch of the fused kernel's residual variant, which sums
    in float32 (the JAX model adds in the activation dtype first; in
    bfloat16 the two differ by one rounding of the sum)."""
    if kind == "rmsnorm":
        return ops.fused_rmsnorm(x, params["scale"], residual=residual,
                                 eps=eps)
    if kind not in ("layernorm", "nonparam_ln"):
        raise ValueError(kind)
    if residual is None:
        return _layernorm(params, x, kind, eps)
    s = x + residual
    return _layernorm(params, s, kind, eps), s


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------
def rope_angles(positions, rot_dim: int, theta: float):
    """positions: (B, S) -> cos, sin of shape (B, S, rot_dim/2), float32.
    The inverse frequencies are ``theta ** (arange(half) / half)`` in
    float32, as the JAX package computes them; M-RoPE's (P, B, S)
    positions are not ported (ROADMAP.md)."""
    if positions.ndim != 2:
        raise NotImplementedError("M-RoPE positions (P, B, S) are not "
                                  "ported")
    half = rot_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(
        half, dtype=torch.float32, device=positions.device) / half))
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D), rotate-half convention; cos/sin: (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def gqa_attention(q, k, v, *, causal: bool = True, q_positions=None,
                  kv_valid_len=None):
    """Plain grouped-query attention over a cache. q: (B, S, H, D); k, v:
    (B, T, KH, D), H = KH * G. ``q_positions`` (B, S) are the queries'
    absolute positions for the causal mask (default arange(S));
    ``kv_valid_len`` (B,) masks cache rows at or past it. fp32 softmax.
    The port runs it only where no kernel covers the call: a prompt
    chunk written at ``cache_index > 0`` on a CPU tensor."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        / math.sqrt(D)
    kv_pos = torch.arange(T, device=q.device)
    if q_positions is None:
        q_positions = torch.arange(S, device=q.device).expand(B, S)
    ok = torch.ones((B, 1, S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kv_pos[None, None, None, :]
                   <= q_positions[:, None, :, None])
    if kv_valid_len is not None:
        ok = ok & (kv_pos[None, None, None, :]
                   < kv_valid_len[:, None, None, None])
    probs = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs,
                        v.float()).to(q.dtype)


def attn_init(gen, cfg, device=None):
    D, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    return {
        "wq": dense_init(gen, (D, H, hd), dtype=dt, device=device),
        "wk": dense_init(gen, (D, KH, hd), dtype=dt, device=device),
        "wv": dense_init(gen, (D, KH, hd), dtype=dt, device=device),
        "wo": dense_init(gen, (H, hd, D), scale=1.0 / math.sqrt(H * hd),
                         dtype=dt, device=device),
    }


def _proj(x, w):
    """x (B, S, D) @ w (D, N, hd) -> (B, S, N, hd)."""
    D, N, hd = w.shape
    return (x @ w.reshape(D, N * hd)).view(*x.shape[:-1], N, hd)


def attn_apply(params, cfg, x, *, positions, cache=None, cache_index=0):
    """GQA attention block. x: (B, S, D); positions: (B, S) int64, the
    tokens' absolute positions ``cache_index + arange(S)``.

    ``cache``: ``{"k", "v"}`` of shape (B, T_max, KH, hd) or None. The
    new K/V rows are written into it in place at the positions (the
    counterpart of the JAX step's donated cache). Attention runs as:
      * no cache, or a cache filled from the int ``cache_index`` 0:
        the flash kernel, causal over the S fresh K/V rows (what the JAX
        package computes over the padded cache with ``kv_valid_len =
        S``);
      * S = 1 against a cache: the decode kernel over the cache with
        ``valid_len = position + 1``, a device tensor (no host sync);
      * S > 1 at any other ``cache_index`` (a chunked prefill, which
        the served path never takes; a tensor index is not read on the
        host): the plain ``gqa_attention`` on a CPU tensor; on CUDA no
        kernel covers it and it raises.
    Returns (out, cache)."""
    B, S, _ = x.shape
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE is not ported")
    if cfg.rope != "none":
        cos, sin = rope_angles(positions, cfg.resolved_head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    fresh = isinstance(cache_index, int) and cache_index == 0
    if cache is None:
        out = ops.flash_attention(q, k, v, causal=True)
    else:
        ck, cv = cache["k"], cache["v"]
        rows = positions[0]
        ck.index_copy_(1, rows, k.to(ck.dtype))
        cv.index_copy_(1, rows, v.to(cv.dtype))
        if S == 1:
            valid = (positions[:, 0] + 1).to(torch.int32)
            out = ops.decode_attention(q[:, 0], ck, cv, valid)[:, None]
        elif fresh:
            out = ops.flash_attention(q, k, v, causal=True)
        elif x.is_cuda:
            raise NotImplementedError(
                "a prompt chunk of S > 1 at cache_index > 0 has no kernel "
                "on CUDA (ROADMAP.md)")
        else:
            out = gqa_attention(q, ck, cv, causal=True, q_positions=positions,
                                kv_valid_len=positions[:, -1] + 1)
    wo = params["wo"]
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return y, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_init(gen, cfg, d_ff: Optional[int] = None, device=None):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    p = {"wi": dense_init(gen, (D, Fd), dtype=dt, device=device)}
    if cfg.mlp == "swiglu":
        p["wg"] = dense_init(gen, (D, Fd), dtype=dt, device=device)
    p["wo_mlp"] = dense_init(gen, (Fd, D), dtype=dt, device=device)
    return p


def mlp_apply(params, cfg, x):
    """SwiGLU through the kernel (``silu(x @ wg) * (x @ wi)``); GELU
    (tanh form, as ``jax.nn.gelu``) plain."""
    h = x @ params["wi"]
    if cfg.mlp == "swiglu":
        h = ops.swiglu(x @ params["wg"], h)
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params["wo_mlp"]


# ---------------------------------------------------------------------------
# Mixture of experts (GShard-style capacity dispatch)
# ---------------------------------------------------------------------------
def moe_init(gen, cfg, device=None):
    D = cfg.d_model
    m = cfg.moe
    Fd = m.d_ff or cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    p = {"router": dense_init(gen, (D, m.num_experts), device=device),
         "e_wi": dense_init(gen, (m.num_experts, D, Fd), dtype=dt,
                            device=device),
         "e_wg": dense_init(gen, (m.num_experts, D, Fd), dtype=dt,
                            device=device),
         "e_wo": dense_init(gen, (m.num_experts, Fd, D), dtype=dt,
                            device=device)}
    if m.num_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=Fd * m.num_shared_experts,
                               device=device)
    return p


def moe_capacity(tokens: int, cfg) -> int:
    """Slots per expert: ``max(ceil(T K cf / E), 4)``."""
    m = cfg.moe
    return max(int(math.ceil(tokens * m.top_k * m.capacity_factor
                             / m.num_experts)), 4)


def moe_apply(params, cfg, x):
    """Top-k routing with a per-expert capacity; overflow is dropped.

    The JAX package's dispatch: a float32 router softmax, top-k gates
    renormalised to sum 1, each (token, k) pair's slot its expert's count
    of earlier pairs in the row-major (T * K) order (an exclusive
    cumsum), pairs at or past the capacity dropped (their gate weight
    0). The experts run as batched matmuls over (E, capacity, D) buffers,
    with ``silu(g) * h`` through the SwiGLU kernel. Returns (y, aux), aux
    the Switch-style load-balance loss."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    xt = x.reshape(T, D)
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)     # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = moe_capacity(T, cfg)

    flat_expert = expert_idx.reshape(T * K)
    onehot = F.one_hot(flat_expert, E)                       # (TK, E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    keep = pos < cap
    dst = torch.where(keep, flat_expert * cap + pos,
                      torch.full_like(pos, E * cap))         # drop bucket
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf.index_add_(0, dst, xt.repeat_interleave(K, dim=0))
    ebuf = buf[:-1].view(E, cap, D)
    h = ops.swiglu(torch.bmm(ebuf, params["e_wg"]),
                   torch.bmm(ebuf, params["e_wi"]))
    eout = torch.bmm(h, params["e_wo"])
    flat_out = torch.cat([eout.reshape(E * cap, D),
                          torch.zeros((1, D), dtype=x.dtype,
                                      device=x.device)])
    w = gate_vals.reshape(T * K, 1).to(x.dtype) * keep[:, None].to(x.dtype)
    y = (flat_out[dst] * w).reshape(T, K, D).sum(dim=1)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], cfg, x).reshape(T, D)
    frac_tokens = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0)) \
        * m.router_aux_coef
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------
def embed_init(gen, cfg, device=None):
    dt = torch_dtype(cfg.dtype)
    p = {"embedding": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                 scale=0.02, dtype=dt, device=device)}
    if cfg.pos_emb == "learned":
        p["pos_embedding"] = dense_init(
            gen, (cfg.max_position, cfg.d_model), scale=0.02, dtype=dt,
            device=device)
    return p


def embed_apply(params, cfg, tokens, positions=None):
    x = params["embedding"][tokens]
    if cfg.pos_emb == "learned" and positions is not None:
        x = x + params["pos_embedding"][positions]
    return x
