"""xLSTM blocks (port of ``repro/models/xlstm.py``): the mLSTM (matrix
memory, exponential gating) and the sLSTM (scalar memory, recurrent
gating).

The mLSTM recurrence goes through ``ops.mlstm_chunk``: the hand-written
kernel on a CUDA tensor, its plain version on a CPU tensor (the JAX
package's model path runs its XLA scan and reaches no kernel). The sLSTM
has no kernel in the JAX package and stays plain PyTorch: a host loop
over time of a few small launches a step. Decode states are O(1) in the
sequence length; given a state, ``mlstm_apply`` and ``slstm_apply`` write
the new one into it in place, the counterpart of the JAX step's donated
cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, torch_dtype
from repro_torch.models.ssm import _causal_conv
from repro_torch.parallel.local_calls import copy_into, maybe_local
from repro_torch.parallel.sharding import (constrain, splittable,
                                           splittable_grad)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _mlstm_dims(cfg):
    E = int(cfg.xlstm.proj_factor * cfg.d_model)
    H = cfg.num_heads
    return E, H, E // H


def mlstm_init(gen, cfg, device=None):
    D = cfg.d_model
    E, H, _ = _mlstm_dims(cfg)
    dt = torch_dtype(cfg.dtype)
    W = cfg.xlstm.conv_kernel
    return {
        "wi_up": dense_init(gen, (D, 2 * E), dtype=dt, device=device),
        "conv_kernel": dense_init(gen, (W, E), scale=W ** -0.5, dtype=dt,
                                  device=device),
        "conv_bias": torch.zeros(E, device=device),
        "wq_m": dense_init(gen, (E, E), dtype=dt, device=device),
        "wk_m": dense_init(gen, (E, E), dtype=dt, device=device),
        "wv_m": dense_init(gen, (E, E), dtype=dt, device=device),
        # scalar input and forget gates per head, from the x branch
        "w_if": dense_init(gen, (E, 2 * H), dtype=dt, device=device),
        "i_bias": torch.zeros(H, device=device),
        "f_bias": torch.linspace(3.0, 6.0, H, dtype=torch.float32,
                                 device=device),
        "ogate_scale": torch.ones(E, device=device),    # learnable skip
        "out_proj": dense_init(gen, (E, D), dtype=dt, device=device),
    }


def mlstm_scan(q, k, v, i_pre, f_pre, state=None, impl: str = "fused"):
    """The stabilised exponential-gated matrix-memory recurrence. q, k, v:
    (B, S, H, dh); i_pre, f_pre: (B, S, H). ``state``: ``{"C": (B, H, dh,
    dh), "n": (B, H, dh), "m": (B, H)}`` float32, overwritten with the
    final state (zeros and m = -inf when None). Returns (h (B, S, H, dh)
    in v's dtype, state)."""
    if state is None:
        B, _, H, dh = q.shape
        z = dict(dtype=torch.float32, device=q.device)
        state = {"C": torch.zeros((B, H, dh, v.shape[-1]), **z),
                 "n": torch.zeros((B, H, dh), **z),
                 "m": torch.full((B, H), float("-inf"), **z)}
    h = ops.pick("mlstm_chunk", impl)(q, k, v, i_pre, f_pre, state["C"],
                                      state["n"], state["m"])
    return h, state


def mlstm_apply(params, cfg, x, *, state=None, impl: str = "fused"):
    """x: (B, S, D). ``state``: ``{"conv", "C", "n", "m"}`` or None; when
    given it is updated in place. Returns (y, state)."""
    B, S, _ = x.shape
    E, H, dh = _mlstm_dims(cfg)
    up = constrain(x @ params["wi_up"], "batch", None, "ffn")
    xb, z = up.chunk(2, dim=-1)
    xc, new_conv = _causal_conv(xb, params["conv_kernel"],
                                params["conv_bias"],
                                None if state is None else state["conv"])
    xc = F.silu(xc)
    q = splittable(xc @ params["wq_m"], -1, H).reshape(B, S, H, dh)
    k = splittable(xc @ params["wk_m"], -1, H).reshape(B, S, H, dh) \
        * dh ** -0.5
    v = splittable(xb @ params["wv_m"], -1, H).reshape(B, S, H, dh)
    gates = splittable(xc @ params["w_if"], -1, H).reshape(B, S, H, 2)
    i_pre = gates[..., 0] + params["i_bias"]
    f_pre = gates[..., 1] + params["f_bias"]
    h, mstate = mlstm_scan(q, k, v, i_pre, f_pre, None if state is None
                           else {key: state[key] for key in ("C", "n", "m")},
                           impl=impl)
    h = splittable_grad(h.reshape(B, S, E), -1, H).to(x.dtype)
    h = h + xc * params["ogate_scale"].to(x.dtype)          # learnable skip
    out = (h * F.silu(z)) @ params["out_proj"]
    out = constrain(out, "batch", "seq", "act_embed")
    if state is None:
        return out, {"conv": new_conv, **mstate}
    copy_into(state["conv"], new_conv)
    return out, state


def mlstm_state_specs(cfg, batch: int, dtype: torch.dtype):
    """{name: (shape, dtype)} of one mLSTM layer's decode state; the conv
    context in ``dtype`` (the cache dtype), C, n, m in float32."""
    E, H, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {"conv": ((batch, cfg.xlstm.conv_kernel - 1, E), dtype),
            "C": ((batch, H, dh, dh), f32), "n": ((batch, H, dh), f32),
            "m": ((batch, H), f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_up_dim(cfg) -> int:
    """Width of the sLSTM's up projection: ``int(4/3 * D)``, truncated as
    the JAX package truncates it (1024 at D = 768, 85 at D = 64)."""
    return int(cfg.xlstm.slstm_proj_factor * cfg.d_model)


def slstm_init(gen, cfg, device=None):
    D = cfg.d_model
    H = cfg.num_heads
    dh = D // H
    dt = torch_dtype(cfg.dtype)
    up = slstm_up_dim(cfg)
    return {
        # gates (i, f, z, o) from the input, and block-diagonal recurrent
        # weights per head
        "w_gates": dense_init(gen, (D, 4 * D), dtype=dt, device=device),
        "r_gates": dense_init(gen, (H, dh, 4 * dh), scale=dh ** -0.5,
                              dtype=dt, device=device),
        "i_bias": torch.zeros(D, device=device),
        "f_bias": torch.full((D,), 3.0, device=device),
        "z_bias": torch.zeros(D, device=device),
        "o_bias": torch.zeros(D, device=device),
        "up_proj": dense_init(gen, (D, up), dtype=dt, device=device),
        "down_proj": dense_init(gen, (up, D), dtype=dt, device=device),
    }


def slstm_scan(gx, rw, c, n, m, h):
    """The sLSTM recurrence in float32 over the gate inputs ``gx`` (B, S,
    4D) (input products and biases), with the per-head recurrent weights
    ``rw`` (H, dh, 4 dh) from the states c, n, m, h (B, D). Returns (the
    hidden states (B, S, D), c, n, m, h). On DTensors it runs on local
    batch shards (``local_calls``): a step is a few small operations,
    which DTensor would dispatch one by one."""
    B, D = h.shape
    H, dh = rw.shape[0], rw.shape[1]
    hs = []
    for g in gx.unbind(1):
        rec = torch.einsum("bhd,hdg->bhg", h.reshape(B, H, dh),
                           rw).reshape(B, 4 * D)
        ip, fp, zp, op = (g + rec).chunk(4, dim=-1)
        lf = -F.softplus(-fp)          # log_sigmoid, as JAX defines it
        m_new = torch.maximum(lf + m, ip)
        ig = torch.exp(ip - m_new)
        fg = torch.exp(lf + m - m_new)
        c = fg * c + ig * torch.tanh(zp)
        n = fg * n + ig
        h = torch.sigmoid(op) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), c, n, m, h


def slstm_apply(params, cfg, x, *, state=None, impl: str = "fused"):
    """Scalar-memory LSTM with exponential gating and per-head
    recurrence, then a GELU (tanh form) up/down projection. ``state``:
    ``{"c", "n", "m", "h"}`` each (B, D) float32, or None; when given it
    is updated in place. No kernel: ``impl`` (the mixers' common
    signature) changes nothing. Returns (y, state)."""
    B, S, D = x.shape
    if state is None:
        z = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        c, n, m, h = z, z, torch.full_like(z, float("-inf")), z
    else:
        c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    gx = (x @ params["w_gates"]).float() + torch.cat(
        [params["i_bias"], params["f_bias"], params["z_bias"],
         params["o_bias"]])
    y, c, n, m, h = maybe_local("slstm_scan", slstm_scan)(
        gx, params["r_gates"].float(), c, n, m, h)
    y = y.to(x.dtype)
    y = F.gelu(y @ params["up_proj"], approximate="tanh") \
        @ params["down_proj"]
    y = constrain(y, "batch", "seq", "act_embed")
    if state is None:
        return y, {"c": c, "n": n, "m": m, "h": h}
    for key, val in zip(("c", "n", "m", "h"), (c, n, m, h)):
        copy_into(state[key], val)
    return y, state


def slstm_state_specs(cfg, batch: int):
    """{name: (shape, dtype)} of one sLSTM layer's decode state."""
    s = ((batch, cfg.d_model), torch.float32)
    return {"c": s, "n": s, "m": s, "h": s}
