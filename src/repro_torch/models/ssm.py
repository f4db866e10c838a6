"""Mamba (selective state space) block (port of ``repro/models/ssm.py``).

The recurrence goes through ``ops.mamba_scan``: the hand-written kernel
on a CUDA tensor, its plain version on a CPU tensor (the JAX package's
model path runs its XLA scan and reaches no kernel). The decode state is
``{"conv": (B, d_conv - 1, E), "h": (B, E, N)}``, O(1) in the sequence
length; given a state, ``mamba_apply`` writes the new one into it in
place, the counterpart of the JAX step's donated cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, torch_dtype
from repro_torch.parallel.local_calls import copy_into
from repro_torch.parallel.sharding import constrain


def _dims(cfg):
    E = cfg.ssm.expand * cfg.d_model
    N = cfg.ssm.d_state
    R = cfg.ssm.dt_rank or max(cfg.d_model // 16, 1)
    return E, N, R


def mamba_init(gen, cfg, device=None):
    D = cfg.d_model
    E, N, R = _dims(cfg)
    dt = torch_dtype(cfg.dtype)
    W = cfg.ssm.d_conv
    # S4D-real initialisation of A; dt_bias the inverse softplus of a
    # log-uniform dt in [1e-3, 1e-1]
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(E, 1)
    u = torch.rand(E, generator=gen, dtype=torch.float32, device=device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    return {
        "in_proj": dense_init(gen, (D, 2 * E), dtype=dt, device=device),
        "conv_kernel": dense_init(gen, (W, E), scale=1.0 / math.sqrt(W),
                                  dtype=dt, device=device),
        "conv_bias": torch.zeros(E, device=device),
        "x_proj": dense_init(gen, (E, R + 2 * N), dtype=dt, device=device),
        "dt_proj": dense_init(gen, (R, E), scale=R ** -0.5, dtype=dt,
                              device=device),
        "dt_bias": dt_init + torch.log1p(-torch.exp(-dt_init)),
        "A_log": torch.log(A),
        "D": torch.ones(E, device=device),
        "out_proj": dense_init(gen, (E, D), dtype=dt, device=device),
    }


def _causal_conv(x, kernel, bias, state=None):
    """Depthwise causal conv over time. x: (B, S, E); kernel: (W, E);
    state: (B, W - 1, E), the trailing context (decode). Returns (y,
    new_state), the JAX package's sum of W shifted products in x's
    dtype."""
    W = kernel.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S + W - 1, E)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * kernel[i] for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else pad
    return y + bias.to(x.dtype), new_state


def selective_scan(u, dt, A, B, C, D, h0=None, impl: str = "fused"):
    """``y_t = C_t . h_t + D u_t``, ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t
    u_t``. u, dt: (Bt, S, E); A: (E, N); B, C: (Bt, S, N); D: (E,).
    ``h0`` (Bt, E, N) float32 is the initial state, overwritten with the
    final one (zeros when None). Returns (y in u's dtype, h)."""
    Bt, _, E = u.shape
    if h0 is None:
        h0 = torch.zeros((Bt, E, A.shape[1]), dtype=torch.float32,
                         device=u.device)
    y = ops.pick("mamba_scan", impl)(u, dt, A, B, C, D, h0)
    return y, h0


def mamba_apply(params, cfg, x, *, state=None, impl: str = "fused"):
    """x: (B, S, D). ``state``: ``{"conv", "h"}`` or None; when given it
    is updated in place. Returns (y, state)."""
    _, N, R = _dims(cfg)
    xz = constrain(x @ params["in_proj"], "batch", None, "ffn")
    xin, z = xz.chunk(2, dim=-1)
    xc, new_conv = _causal_conv(xin, params["conv_kernel"],
                                params["conv_bias"],
                                None if state is None else state["conv"])
    xc = F.silu(xc)
    proj = xc @ params["x_proj"]
    dt_r, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus((dt_r @ params["dt_proj"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, h = selective_scan(xc, dt, A, Bm, Cm, params["D"],
                          h0=None if state is None else state["h"],
                          impl=impl)
    y = y * F.silu(z)
    out = y @ params["out_proj"]
    out = constrain(out, "batch", "seq", "act_embed")
    if state is None:
        return out, {"conv": new_conv, "h": h}
    copy_into(state["conv"], new_conv)
    return out, state


def mamba_state_specs(cfg, batch: int, dtype: torch.dtype):
    """{name: (shape, dtype)} of one layer's decode state; the conv
    context in ``dtype`` (the cache dtype), h in float32."""
    E, N, _ = _dims(cfg)
    return {"conv": ((batch, cfg.ssm.d_conv - 1, E), dtype),
            "h": ((batch, E, N), torch.float32)}
