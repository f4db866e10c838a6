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
                        kv_len: Optional[int] = None):
    """q: (B,Sq,H,D); k,v: (B,Sk,KH,D) with H = KH*G. fp32 softmax,
    same-position causal mask; ``kv_len`` masks k/v rows at or past that
    index. Output in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
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


def mlstm_chunk_ref(q, k, v, i_pre, f_pre, C, n, m):
    """Stabilised exponential-gated mLSTM recurrence, one step at a time
    in float32 (the arithmetic of the JAX package's ``mlstm_scan``).
    q, k, v: (B, T, H, dh); i_pre, f_pre: (B, T, H); q is scaled by
    dh^-1/2 here (k comes pre-scaled). State ``C`` (B, H, dk, dv), ``n``
    (B, H, dk), ``m`` (B, H), float32, read as the initial state and
    overwritten with the final one; from C = n = 0, m = -inf it computes
    what the TPU kernel computes from its zero state. Returns h (B, T,
    H, dv) in v's dtype."""
    T, dk = q.shape[1], q.shape[-1]
    qf = q.float() * dk ** -0.5
    kf, vf = k.float(), v.float()
    logf = torch.nn.functional.logsigmoid(f_pre.float())
    ipre = i_pre.float()
    Ct, nt, mt = C, n, m
    hs = []
    for t in range(T):
        m_new = torch.maximum(logf[:, t] + mt, ipre[:, t])
        fg = torch.exp(logf[:, t] + mt - m_new)
        ig = torch.exp(ipre[:, t] - m_new)
        kt = kf[:, t]
        Ct = fg[..., None, None] * Ct \
            + ig[..., None, None] * (kt[..., :, None] * vf[:, t, :, None, :])
        nt = fg[..., None] * nt + ig[..., None] * kt
        num = torch.einsum("bhd,bhde->bhe", qf[:, t], Ct)
        den = torch.maximum(
            torch.abs(torch.einsum("bhd,bhd->bh", qf[:, t], nt)),
            torch.exp(-m_new))
        hs.append(num / den[..., None])
        mt = m_new
    C.copy_(Ct)
    n.copy_(nt)
    m.copy_(mt)
    return torch.stack(hs, dim=1).to(v.dtype)


def mamba_scan_ref(u, dt, A, B, C, D, h):
    """Selective scan, one step at a time in float32 (the arithmetic of
    the JAX package's ``selective_scan``): ``h <- exp(dt A) h + (dt u) B``,
    ``y = h . C + D u``. u, dt: (Bt, T, E); A: (E, N); B, C: (Bt, T, N);
    D: (E,); ``h`` (Bt, E, N) float32 is read as the initial state and
    overwritten with the final one. Returns y (Bt, T, E) in u's dtype,
    D u added in float32 before the cast."""
    T = u.shape[1]
    uf, dtf = u.float(), dt.float()
    Bf, Cf, Af = B.float(), C.float(), A.float()
    ht = h
    ys = []
    for t in range(T):
        dA = torch.exp(dtf[:, t, :, None] * Af)
        ht = dA * ht + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("ben,bn->be", ht, Cf[:, t]))
    h.copy_(ht)
    y = torch.stack(ys, dim=1) + uf * D.float()
    return y.to(u.dtype)
