"""Plain PyTorch versions of the serving path's kernels.

They repeat the arithmetic of the JAX package's oracles
(``repro/kernels/ref.py``) and are the ground truth the Hopper kernels
are held against on the card. On a CPU tensor ``kernels/ops.py`` runs
them; on a CUDA tensor it never does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def group_count(groups: int, channels: int) -> int:
    """``groups`` shrunk to the largest divisor of ``channels`` at or
    below it (the JAX package's ``efficientnet.groupnorm`` rule)."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        kv_len: Optional[int] = None, q_offset: int = 0,
                        q_positions=None):
    """q: (B,Sq,H,D); k,v: (B,Sk,KH,D) with H = KH*G. fp32 softmax; the
    causal mask places query row r at position ``q_offset + r`` (0: the
    same-position mask), or, with ``q_positions`` (B, Sq) ints, query
    row r of sequence b at ``q_positions[b, r]``: key column c is masked
    where c > that position. ``kv_len`` masks k/v rows at or past that
    index. Output in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(D)
    if causal and q_positions is not None:
        cols = torch.arange(Sk, device=q.device)
        mask = cols[None, None, :] <= q_positions.to(q.device)[:, :, None]
        s = s.masked_fill(~mask[:, None, None], float("-inf"))
    elif causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(int(q_offset))
        s = s.masked_fill(~mask, float("-inf"))
    if kv_len is not None:
        valid = torch.arange(Sk, device=q.device) < kv_len
        s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def groupnorm_silu_ref(x, scale, bias, *, groups: int, eps: float = 1e-5,
                       act: bool = True):
    """GroupNorm(+SiLU): fp32 mean and population variance per (sample,
    group) over all spatial positions and the group's channels, then
    per-channel scale/bias, then an optional SiLU. x: (B, ..., C)."""
    shape = x.shape
    B, C = shape[0], shape[-1]
    g = group_count(groups, C)
    xg = x.reshape(B, -1, g, C // g).float()
    mu = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mu).square().mean(dim=(1, 3), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    out = xg.reshape(B, -1, C) * scale.float() + bias.float()
    if act:
        out = torch.nn.functional.silu(out)
    return out.reshape(shape).to(x.dtype)


def decode_attention_ref(q, k, v, valid_len):
    """One new token per sequence against a KV cache. q: (B,H,D);
    k, v: (B,T,KH,D) with H = KH*G; valid_len: (B,) int, the live cache
    entries of each sequence (columns at or past it are masked). fp32
    scores and softmax, output ``acc / max(l, 1e-30)`` in q's dtype: the
    TPU kernel's arithmetic, so a sequence with ``valid_len = 0`` gets
    zeros (the JAX package's jnp oracle gives NaN there)."""
    B, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) / math.sqrt(D)
    pos = torch.arange(T, device=q.device)
    live = pos[None, :] < valid_len.to(q.device).reshape(B, 1)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    acc = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    o = acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, H, D).to(q.dtype)


def rmsnorm_ref(x, scale, *, eps: float = 1e-5, residual=None):
    """RMSNorm x scale over the last dim in fp32, output in x's dtype.
    With ``residual`` the input is ``x + residual`` summed in fp32 and
    the result is ``(normed, (x + residual) in x's dtype)``, the two
    outputs of the TPU kernel's residual variant."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
    if residual is None:
        return out
    return out, xf.to(x.dtype)


def swiglu_ref(gate, up):
    """silu(gate) * up in fp32, output in gate's dtype."""
    g = gate.float()
    return (g * torch.sigmoid(g) * up.float()).to(gate.dtype)


# steps whose inputs the plain recurrences prepare at once (the JAX
# package's scan chunk): within a chunk only the recurrence itself runs
# step by step, so a step is a few operations, and the chunk bounds the
# prepared buffers to chunk x state
SCAN_CHUNK = 256


def _chunks(T: int):
    return [(t0, min(t0 + SCAN_CHUNK, T)) for t0 in range(0, T, SCAN_CHUNK)]


def mlstm_chunk_ref(q, k, v, i_pre, f_pre, C, n, m):
    """Stabilised exponential-gated mLSTM recurrence, one step at a time
    in float32 (the arithmetic of the JAX package's ``mlstm_scan``).
    q, k, v: (B, T, H, dh); i_pre, f_pre: (B, T, H); q is scaled by
    dh^-1/2 here (k comes pre-scaled). State ``C`` (B, H, dk, dv), ``n``
    (B, H, dk), ``m`` (B, H), float32, read as the initial state and
    overwritten with the final one; from C = n = 0, m = -inf it computes
    what the TPU kernel computes from its zero state. Returns h (B, T,
    H, dv) in v's dtype.

    Each chunk of steps runs the stabiliser chain m_t = max(lf_t +
    m_{t-1}, i_t) step by step, then takes its gates and the gated outer
    products k_t v_t^T at once, then runs C_t = fg_t C_{t-1} + ig_t k_t
    v_t^T and n_t likewise step by step, and reads every h_t from the
    stacked states: the same values, operation for operation, as one
    step at a time."""
    T, dk = q.shape[1], q.shape[-1]
    qf = q.float() * dk ** -0.5
    kf, vf = k.float(), v.float()
    logf = torch.nn.functional.logsigmoid(f_pre.float())
    ipre = i_pre.float()
    # from copies: the state tensors are overwritten at the end, and
    # autograd still needs the initial state the first step read
    Ct, nt, mt = C.clone(), n.clone(), m.clone()
    hs = []
    for t0, t1 in _chunks(T):
        lf_m, ms = [], []
        for lf, ii in zip(logf[:, t0:t1].unbind(1), ipre[:, t0:t1].unbind(1)):
            a = lf + mt
            mt = torch.maximum(a, ii)
            lf_m.append(a)
            ms.append(mt)
        m_new = torch.stack(ms, dim=1)                      # (B, L, H)
        fg = torch.exp(torch.stack(lf_m, dim=1) - m_new)
        ig = torch.exp(ipre[:, t0:t1] - m_new)
        kc = kf[:, t0:t1]
        kv = ig[..., None, None] * (kc[..., :, None] * vf[:, t0:t1, :, None, :])
        ik = ig[..., None] * kc
        Cs, ns = [], []
        for f4, a, f3, b in zip(fg[..., None, None].unbind(1), kv.unbind(1),
                                fg[..., None].unbind(1), ik.unbind(1)):
            Ct = f4 * Ct + a
            nt = f3 * nt + b
            Cs.append(Ct)
            ns.append(nt)
        qc = qf[:, t0:t1]
        num = torch.einsum("blhd,blhde->blhe", qc, torch.stack(Cs, dim=1))
        den = torch.maximum(
            torch.abs(torch.einsum("blhd,blhd->blh", qc,
                                   torch.stack(ns, dim=1))),
            torch.exp(-m_new))
        hs.append(num / den[..., None])
    C.copy_(Ct)
    n.copy_(nt)
    m.copy_(mt)
    return torch.cat(hs, dim=1).to(v.dtype)


def mamba_scan_ref(u, dt, A, B, C, D, h):
    """Selective scan, one step at a time in float32 (the arithmetic of
    the JAX package's ``selective_scan``): ``h <- exp(dt A) h + (dt u) B``,
    ``y = h . C + D u``. u, dt: (Bt, T, E); A: (E, N); B, C: (Bt, T, N);
    D: (E,); ``h`` (Bt, E, N) float32 is read as the initial state and
    overwritten with the final one. Returns y (Bt, T, E) in u's dtype,
    D u added in float32 before the cast. Each chunk of steps takes its
    decays and inputs at once and reads its outputs from the stacked
    states; only the update runs step by step (the same values as one
    step at a time)."""
    uf, dtf = u.float(), dt.float()
    Bf, Cf, Af = B.float(), C.float(), A.float()
    ht = h.clone()         # h is overwritten at the end (see mlstm)
    ys = []
    for t0, t1 in _chunks(u.shape[1]):
        dtc = dtf[:, t0:t1]
        dA = torch.exp(dtc[..., None] * Af)                  # (Bt, L, E, N)
        dBu = (dtc * uf[:, t0:t1])[..., None] * Bf[:, t0:t1, None, :]
        hs = []
        for a, b in zip(dA.unbind(1), dBu.unbind(1)):
            ht = a * ht + b
            hs.append(ht)
        ys.append(torch.einsum("blen,bln->ble", torch.stack(hs, dim=1),
                               Cf[:, t0:t1]))
    h.copy_(ht)
    y = torch.cat(ys, dim=1) + uf * D.float()
    return y.to(u.dtype)
