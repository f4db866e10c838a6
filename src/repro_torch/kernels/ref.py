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
