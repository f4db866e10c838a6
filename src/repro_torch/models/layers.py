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
package's sharding constraints are ``parallel/sharding.constrain`` at
the same points (a no-op without rules; under a step built on a mesh,
``launch/steps.py``, a redistribution of the DTensor activations), and
the cache writes go through ``parallel/local_calls`` (in place on a
DTensor's local shard).

Every function that reaches a kernel takes ``impl`` (``kernels/impls.py``):
``fused`` (the default) goes through ``ops``, ``unfused`` takes each
kernel's plain version on any device, the route autograd differentiates
(the train steps').
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.impls import resolve_kernel_impl
from repro_torch.kernels.ref import query_chunks
from repro_torch.parallel.local_calls import (maybe_local, replicated_call,
                                              rows_product, split_by_rows,
                                              vocab_parallel_embedding,
                                              vocab_split, write_rows)
from repro_torch.parallel.sharding import (as_replicated, constrain,
                                           foldable_grad, gather_last,
                                           is_dtensor, placed_grad,
                                           splittable, splittable_grad)

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


def norm_apply(params, x, kind: str, eps: float = 1e-5, residual=None,
               impl: str = "fused"):
    """Normalise x over its last dim. With ``residual`` the input is
    ``x + residual`` and the result ``(normed, x + residual)``: for
    RMSNorm one launch of the fused kernel's residual variant, which sums
    in float32 (the JAX model adds in the activation dtype first; in
    bfloat16 the two differ by one rounding of the sum)."""
    if kind == "rmsnorm":
        return ops.pick("fused_rmsnorm", impl)(x, params["scale"],
                                               residual=residual, eps=eps)
    if kind not in ("layernorm", "nonparam_ln"):
        raise ValueError(kind)
    if residual is None:
        return _layernorm(params, x, kind, eps)
    s = x + residual
    return _layernorm(params, s, kind, eps), s


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------
def rope_angles(positions, rot_dim: int, theta: float,
                sections: Tuple[int, ...] = ()):
    """positions: (B, S), or (P, B, S) for M-RoPE -> cos, sin of shape
    (B, S, rot_dim/2), float32. The inverse frequencies are ``theta **
    (arange(half) / half)`` in float32, as the JAX package computes
    them. M-RoPE splits the half into ``sections`` (one per position
    axis, summing to the half; default: all to the first axis, as there):
    section i's frequencies take axis i's positions."""
    half = rot_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(
        half, dtype=torch.float32, device=positions.device) / half))
    if positions.ndim == 3:
        if not sections:
            sections = (half,) + (0,) * (positions.shape[0] - 1)
        if sum(sections) != half or len(sections) > positions.shape[0]:
            raise ValueError(f"M-RoPE sections {tuple(sections)} do not "
                             f"split {half} frequencies over "
                             f"{positions.shape[0]} position axes")
        parts, start = [], 0
        for i, sec in enumerate(sections):
            if sec == 0:
                continue
            parts.append(positions[i][..., None].float()
                         * inv_freq[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)
    else:
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
    (B, T, KH, Dv), H = KH * G. ``q_positions`` (B, S) are the queries'
    absolute positions for the causal mask (default arange(S));
    ``kv_valid_len`` (B,) masks cache rows at or past it. fp32 softmax.
    The port runs it where no kernel covers the call: MLA's prefill (its
    query/key head dim differs from its value head dim), and a prompt
    chunk written at a 0-d tensor ``cache_index`` (a CPU tensor, or the
    ``unfused`` route). On DTensors it runs on local shards
    (``local_calls``, as the attention kernels do): DTensor would fold
    (B, H) with the heads split ahead of its products, which torch 2.11
    refuses."""
    return maybe_local("gqa_attention", _gqa_attention)(
        q, k, v, causal=causal, q_positions=q_positions,
        kv_valid_len=kv_valid_len)


def _gqa_attention(q, k, v, *, causal: bool = True, q_positions=None,
                   kv_valid_len=None):
    B, S = q.shape[:2]
    if q_positions is None:
        q_positions = torch.arange(S, device=q.device).expand(B, S)

    def rows(qc, k, v, r0):
        return _gqa_rows(qc, k, v, causal=causal,
                         q_positions=q_positions[:, r0:r0 + qc.shape[1]],
                         kv_valid_len=kv_valid_len)
    # query chunks under checkpoint where autograd records (the JAX
    # package's chunks; S is the call's own rows: see ``query_chunks``)
    return query_chunks(rows, q, k, v)


def _gqa_rows(q, k, v, *, causal, q_positions, kv_valid_len):
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        / math.sqrt(D)
    if T == S:
        # fresh K/V: head-sharded scores (a cache stays unconstrained)
        scores = constrain(scores, "batch", "heads", None, None)
    kv_pos = torch.arange(T, device=q.device)
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


def proj_heads(x, w):
    """x (..., D) @ w (D, N, hd) -> (..., N, hd). On DTensors the product's
    output and the flat weight's gradient are each gathered where the
    mesh splits their N * hd dim over more parts than N
    (``splittable``, ``splittable_grad``)."""
    D, N, hd = w.shape
    w2 = splittable_grad(w.reshape(D, N * hd), -1, N)
    return splittable(x @ w2, -1, N).view(*x.shape[:-1], N, hd)


def merge_heads(out, wo):
    """out (B, S, N, hd) @ wo (N, hd, D) -> (B, S, D), the heads merged.
    On DTensors the gradients of the merged output and of the flat weight
    are gathered where the backward's views could not split them back
    into N heads (``splittable_grad``: 28 heads on 16). An ``out`` split
    by query rows (attention's row plan, ``local_calls``) is multiplied
    on each rank's own rows (``local_calls.rows_product``), as XLA
    computes the JAX package's product under its sequence split: the
    output comes back split by rows, and no rank multiplies every row."""
    B, S, N = out.shape[:3]
    if split_by_rows(out):
        return rows_product(out.reshape(B, S, -1),
                            wo.reshape(-1, wo.shape[-1]))
    flat = splittable_grad(out.reshape(B, S, -1), -1, N)
    return flat @ splittable_grad(wo.reshape(-1, wo.shape[-1]), 0, N)


def slots_for(seq: int, cache_index, device):
    """(S,) int64 sequence slots ``cache_index + arange(S)``: the cache
    rows a forward of S tokens writes, and the positions its causal mask
    and decode lengths follow. A tensor ``cache_index`` stays on the
    device (no host sync)."""
    return torch.arange(seq, device=device) + cache_index


def query_positions(positions):
    """(B, S) int32 positions of the causal mask (the JAX package's
    ``qpos_1d``): M-RoPE's t axis, the first of (P, B, S), else the
    (B, S) positions."""
    pos = positions[0] if positions.ndim == 3 else positions
    return pos.to(torch.int32).contiguous()


def decode_valid_len(slots, batch: int, q_positions=None):
    """(B,) int32 live cache rows after writing the token at ``slots``
    (S = 1): ``slot + 1`` for every sequence, or, with the token's query
    positions t_b ((B, 1), ``query_positions``), ``min(slot + 1, t_b +
    1)``: the JAX package lets the token see the keys at or below t_b and
    below ``cache_index + 1``. On the device (no host sync)."""
    vl = (slots + 1).to(torch.int32).expand(batch)
    if q_positions is not None:
        vl = torch.minimum(vl, q_positions[:, -1].to(torch.int32) + 1)
    return vl.contiguous()


def rope_positions(cfg, positions):
    """cos, sin of the rotary angles of ``positions`` for ``cfg``'s
    rope: M-RoPE over the (P, B, S) axes, else plain RoPE over (B, S)
    (the first axis of a (P, B, S) tensor)."""
    if cfg.rope == "mrope":
        return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                           cfg.mrope_sections)
    pos = positions[0] if positions.ndim == 3 else positions
    return rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta)


def attn_apply(params, cfg, x, *, positions, cache=None, cache_index=0,
               slots=None, valid_len=None, q_positions=None,
               slot_mask: bool = False, impl: str = "fused"):
    """GQA attention block. x: (B, S, D); positions: (B, S), or (P, B, S)
    with M-RoPE, the rotary positions. ``slots``: (S,), the sequence
    slots ``cache_index + arange(S)`` (``slots_for``), where the cache is
    written; ``q_positions``: (B, S) int32, the positions of the causal
    mask (``query_positions(positions)``); ``valid_len``: (B,) int32, the
    live cache rows of a decode step (``decode_valid_len``); each
    computed here when not given (a forward computes them once for all
    its layers).

    The causal mask follows the query positions, as the JAX package's
    does: key j is visible to a query at position t where j <= t (and j
    lies below ``cache_index + S``). M-RoPE's t axis is not the sequence
    on an image prompt (every patch at t = 0), so there a query sees key
    0 only. ``slot_mask=True`` says the positions are the slots (a
    forward given no positions), so the mask is the plain causal one with
    a query offset.

    ``cache``: ``{"k", "v"}`` of shape (B, T_max, KH, hd) or None. The
    new K/V rows are written into it in place at the slots (the
    counterpart of the JAX step's donated cache). Attention runs as:
      * no cache, or a cache filled from the int ``cache_index`` 0:
        the flash kernel over the S fresh K/V rows (what the JAX package
        computes over the padded cache with ``kv_valid_len = S``);
      * S = 1 against a cache: the decode kernel over the cache with
        ``valid_len = min(slot + 1, t + 1)`` (``slot + 1`` under
        ``slot_mask``), a device tensor (no host sync);
      * S > 1 at an int ``cache_index`` > 0 (a prompt chunk): the flash
        kernel over the cache's rows with ``kv_len = cache_index + S``,
        the query positions or, under ``slot_mask``, the query offset
        ``cache_index`` (every flash route takes both);
      * S > 1 at a 0-d tensor ``cache_index`` (not read on the host): on
        CUDA the flash kernel's position route over the whole cache, the
        positions ``min(t, slots[-1])`` (t the query positions, or the
        slots under ``slot_mask``), all computed on the device: the JAX
        package's "key <= t and key < cache_index + S" is "key <= min(t,
        cache_index + S - 1)"; on the CPU and on the ``unfused`` route
        the plain ``gqa_attention``.
    Returns (out, cache)."""
    B, S, _ = x.shape
    q = constrain(proj_heads(x, params["wq"]), "batch", None, "heads", None)
    k = constrain(proj_heads(x, params["wk"]), "batch", None, "kv_heads",
                  None)
    v = proj_heads(x, params["wv"])
    if cfg.rope != "none":
        cos, sin = rope_positions(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    qpos = None
    if not slot_mask:
        qpos = query_positions(positions) if q_positions is None \
            else q_positions
    flash = ops.pick("flash_attention", impl)

    if cache is None:
        out = flash(q, k, v, causal=True, q_positions=qpos)
    else:
        if slots is None:
            slots = slots_for(S, cache_index, x.device)
        ck, cv = cache["k"], cache["v"]
        write_rows(ck, 1, slots, k)
        write_rows(cv, 1, slots, v)
        if S == 1:
            if valid_len is None:
                valid_len = decode_valid_len(slots, B, qpos)
            out = ops.pick("decode_attention", impl)(
                q[:, 0], ck, cv, valid_len)[:, None]
        elif isinstance(cache_index, int):
            if cache_index == 0:
                out = flash(q, k, v, causal=True, q_positions=qpos)
            else:
                out = flash(q, ck, cv, causal=True, kv_len=cache_index + S,
                            q_offset=cache_index, q_positions=qpos)
        elif resolve_kernel_impl(impl) == "fused" and ops._device_type(
                x, "flash_attention") == "cuda":
            seen = slots.expand(B, S) if qpos is None else qpos
            last = slots[-1:].to(torch.int32)
            out = flash(q, ck, cv, causal=True,
                        q_positions=torch.minimum(seen.to(torch.int32),
                                                  last).contiguous())
        else:
            out = gqa_attention(
                q, ck, cv, causal=True,
                q_positions=slots.expand(B, S) if qpos is None else qpos,
                kv_valid_len=(slots[-1] + 1).expand(B))
    if not split_by_rows(out):
        out = constrain(out, "batch", None, "heads", None)
    y = merge_heads(out, params["wo"])
    return constrain(y, "batch", "seq", "act_embed"), cache


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


def mlp_apply(params, cfg, x, impl: str = "fused"):
    """SwiGLU through the kernel (``silu(x @ wg) * (x @ wi)``); GELU
    (tanh form, as ``jax.nn.gelu``) plain."""
    h = constrain(x @ params["wi"], "batch", None, "ffn")
    if cfg.mlp == "swiglu":
        h = ops.pick("swiglu", impl)(x @ params["wg"], h)
    else:
        h = F.gelu(h, approximate="tanh")
    return constrain(h @ params["wo_mlp"], "batch", "seq", "act_embed")


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


def moe_apply(params, cfg, x, impl: str = "fused"):
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
    cap = moe_capacity(T, cfg)
    ebuf, dst, w, frac_tokens = replicated_call(
        lambda a, b: _moe_dispatch(a, b, K, cap), xt, probs)
    ebuf = constrain(ebuf, "experts", "expert_cap", None)
    h = ops.pick("swiglu", impl)(torch.bmm(ebuf, params["e_wg"]),
                                 torch.bmm(ebuf, params["e_wi"]))
    eout = constrain(torch.bmm(h, params["e_wo"]), "experts", "expert_cap",
                     None)
    y = replicated_call(lambda e, d, g: _moe_combine(e, d, g, K), eout,
                        dst, w)
    # the tokens back to (B, S, D), their gradient foldable for the
    # reshape's backward (it meets the sequence-split residual)
    y = foldable_grad(y.reshape(B, S, D))
    if "shared" in params:
        y = y + mlp_apply(params["shared"], cfg, x, impl)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0)) \
        * m.router_aux_coef
    return y, aux


def _moe_dispatch(xt, probs, K: int, cap: int):
    """The capacity dispatch of ``moe_apply`` over all T tokens: returns
    the (E, cap, D) expert buffers, each (token, k) pair's slot ``dst``
    (E * cap for a dropped pair), its gate weight ``w`` (T * K, 1) (0
    when dropped) and each expert's share of first choices. On a mesh
    it runs on the gathered tokens (``replicated_call``): the slots
    count earlier pairs of the whole batch."""
    T, D = xt.shape
    E = probs.shape[-1]
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)     # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_expert = expert_idx.reshape(T * K)
    onehot = F.one_hot(flat_expert, E)                       # (TK, E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    keep = pos < cap
    dst = torch.where(keep, flat_expert * cap + pos,
                      torch.full_like(pos, E * cap))         # drop bucket
    buf = torch.zeros((E * cap + 1, D), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, dst, xt.repeat_interleave(K, dim=0))
    w = gate_vals.reshape(T * K, 1).to(xt.dtype) * keep[:, None].to(xt.dtype)
    frac_tokens = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    return buf[:-1].view(E, cap, D), dst, w, frac_tokens


def _moe_combine(eout, dst, w, K: int):
    """Each token's gate-weighted sum over its K pairs' expert outputs
    (T, D), from the (E, cap, D) outputs (a dropped pair's weight is 0)."""
    E, cap, D = eout.shape
    flat_out = torch.cat([eout.reshape(E * cap, D),
                          torch.zeros((1, D), dtype=eout.dtype,
                                      device=eout.device)])
    return (flat_out[dst] * w).reshape(-1, K, D).sum(dim=1)


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


def lookup(tokens, table):
    """``F.embedding(tokens, table)`` (``jnp.take`` in the JAX package).
    On a mesh the tokens are laid out by batch first (replicated ones,
    plain tensors among them, are cut locally) and the table's embedding
    dim is gathered (the FSDP all-gather: DTensor mismasks a lookup into
    a table split over the mesh dim that splits the tokens' batch); a
    table whose rows a mesh dim splits is looked up on each rank's own
    rows (``local_calls.vocab_parallel_embedding``: the rows come back
    split as the tokens are, a partial sum over the vocabulary's mesh
    dims, and the table's gradient is each rank's own rows), any other
    through DTensor's ``F.embedding``."""
    if is_dtensor(table):
        tokens = constrain(as_replicated(tokens, table.device_mesh),
                           "batch", None)
    table = gather_last(table)
    if vocab_split(table, 0):
        return vocab_parallel_embedding(tokens, table)
    return F.embedding(tokens, table)


def embed_apply(params, cfg, tokens, positions=None):
    """Rows of the embedding table (``lookup``) as ``F.embedding``:
    DTensor propagates it with the batch split over two mesh axes (the
    multi-pod mesh), where indexing raises in some torch versions. No
    rank looks up the whole batch."""
    x = lookup(tokens, params["embedding"])
    if cfg.pos_emb == "learned" and positions is not None:
        pos = positions if positions.ndim == 2 else positions[0]
        x = x + lookup(pos, params["pos_embedding"])
    return placed_grad(constrain(x, "batch", None, "act_embed"))
