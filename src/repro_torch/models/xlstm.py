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

Both recurrences are handed their operands as the projections give them,
heads folded into the last dim, so that on a mesh each runs on the
shards the model axis splits (``parallel/local_calls.py``, whose module
note gives the plans): the mLSTM by heads or by head and value columns,
the sLSTM by hidden units. On plain tensors they give the values they
gave with the heads unfolded here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, torch_dtype
from repro_torch.models.ssm import _causal_conv
from repro_torch.parallel.local_calls import copy_into, maybe_local
from repro_torch.parallel.sharding import (batch_full, constrain,
                                           gather_last, idle_product,
                                           part_products, placed_grad,
                                           splittable)


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


def _heads_unfolded(fn):
    """``fn`` (the mLSTM kernel's call on q, k (B, T, H, dk) and v (B, T,
    H, dv)) on q, k, v with their heads folded into the last dim, H read
    from the gates (B, T, H); h comes back folded, (B, T, H dv)."""
    def run(q, k, v, i_pre, f_pre, C, n, m):
        B, T, H = i_pre.shape
        h = fn(*(t.reshape(B, T, H, -1) for t in (q, k, v)), i_pre, f_pre,
               C, n, m)
        return h.reshape(B, T, -1)
    return run


def mlstm_scan(q, k, v, i_pre, f_pre, state=None, impl: str = "fused"):
    """The stabilised exponential-gated matrix-memory recurrence. q, k:
    (B, S, H dk), v: (B, S, H dv), the heads folded into the last dim;
    i_pre, f_pre: (B, S, H). ``state``: ``{"C": (B, H, dk, dv), "n": (B,
    H, dk), "m": (B, H)}`` float32, overwritten with the final state
    (zeros and m = -inf when None). Returns (h (B, S, H dv) in v's dtype,
    state)."""
    if state is None:
        B, _, H = i_pre.shape
        dk = q.shape[-1] // H
        state = {"C": batch_full(q, (B, H, dk, v.shape[-1] // H), 0.0),
                 "n": batch_full(q, (B, H, dk), 0.0),
                 "m": batch_full(q, (B, H), float("-inf"))}
    h = ops.pick("mlstm_chunk", impl, adapt=_heads_unfolded)(
        q, k, v, i_pre, f_pre, state["C"], state["n"], state["m"])
    return h, state


def mlstm_apply(params, cfg, x, *, state=None, impl: str = "fused"):
    """x: (B, S, D). ``state``: ``{"conv", "C", "n", "m"}`` or None; when
    given it is updated in place. Returns (y, state)."""
    B, S, _ = x.shape
    _, H, dh = _mlstm_dims(cfg)
    xb, z = (constrain(t, "batch", None, "ffn")
             for t in part_products(x, params["wi_up"], 2))
    xc, new_conv = _causal_conv(xb, params["conv_kernel"],
                                params["conv_bias"],
                                None if state is None else state["conv"])
    xc = F.silu(xc)
    # the projections' inputs whole on the model axis (the x branch comes
    # split by E), so that q, k, v come out split by their columns
    xcw, xbw = gather_last(xc), gather_last(xb)
    q = idle_product(xcw, params["wq_m"])
    k = idle_product(xcw, params["wk_m"]) * dh ** -0.5
    v = idle_product(xbw, params["wv_m"])
    # 2 H gate columns: a mesh that splits them unevenly over the heads
    # has them gathered (they are not split at 4 heads on 16)
    gates = splittable(xcw @ params["w_if"], -1, H).reshape(B, S, H, 2)
    i_pre = gates[..., 0] + params["i_bias"]
    f_pre = gates[..., 1] + params["f_bias"]
    h, mstate = mlstm_scan(q, k, v, i_pre, f_pre, None if state is None
                           else {key: state[key] for key in ("C", "n", "m")},
                           impl=impl)
    h = h.to(x.dtype)
    h = h + xc * params["ogate_scale"].to(x.dtype)          # learnable skip
    out = (h * F.silu(z)) @ params["out_proj"]
    # its gradient reduced here (it may come back a partial sum), so that
    # the projection's backward contracts on each rank's columns of E
    out = placed_grad(constrain(out, "batch", "seq", "act_embed"))
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


def slstm_scan(x, w, b, rw, c, n, m, h, *, units=None, gather=None):
    """The sLSTM recurrence in float32 over the gate inputs ``x @ w + b``
    (x (B, S, D), w (D, 4D), b (4D,): the gates i, f, z, o in turn), with
    the per-head recurrent weights ``rw`` (H, dh, 4 dh) from the states c,
    n, m, h (B, D). Returns (the hidden states (B, S, D), c, n, m, h).

    With ``units`` (u0, Dl) it computes hidden units u0 .. u0 + Dl of
    every gate alone (a model rank's share, ``local_calls``): c, n, m, h
    and the output are those units' (B, Dl); each gate's recurrent input
    there is one head's product (the recurrent product's 4D outputs are
    the gates in turn, and each gate's Dl lie within one head's 4 dh), of
    that head's part of the whole h, which ``gather`` makes from the
    units' h at each step."""
    B, S, D = x.shape
    H, dh = rw.shape[0], rw.shape[1]
    if units is None:
        gx = (x @ w).float() + b

        def rec(hh):
            return torch.einsum("bhd,hdg->bhg", hh.reshape(B, H, dh),
                                rw).reshape(B, 4, D)
    else:
        u0, Dl = units
        own = slice(u0, u0 + Dl)
        gx = (x @ w.view(D, 4, D)[:, :, own].reshape(D, 4 * Dl)).float() \
            + b.view(4, D)[:, own].reshape(4 * Dl)
        heads, at = zip(*(divmod(g * D + u0, 4 * dh) for g in range(4)))
        rwl = torch.stack([rw[hd, :, a:a + Dl] for hd, a in zip(heads, at)])
        pick = None if heads == tuple(range(H)) else \
            torch.tensor(heads, device=x.device)   # at 4 heads gate g's is g

        def rec(hh):
            hh = gather(hh).reshape(B, H, dh)
            if pick is not None:
                hh = hh.index_select(1, pick)
            return torch.einsum("bgd,gdc->bgc", hh, rwl)
    hs = []
    for g in gx.reshape(B, S, 4, -1).unbind(1):
        ip, fp, zp, op = (g + rec(h)).unbind(1)
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
        z = batch_full(x, (B, D), 0.0)
        c, n, m, h = z, z, batch_full(x, (B, D), float("-inf")), z
    else:
        c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    b = torch.cat([params["i_bias"], params["f_bias"], params["z_bias"],
                   params["o_bias"]])
    y, c, n, m, h = maybe_local("slstm_scan", slstm_scan)(
        x, params["w_gates"], b, params["r_gates"].float(), c, n, m, h)
    y = y.to(x.dtype)
    # on a mesh the recurrence's output comes split by hidden units, the up
    # projection's a partial sum: reduced whole, as XLA reduces the JAX
    # package's, so that the down projection runs whole on each rank
    u = constrain(y @ params["up_proj"], "batch", None, None)
    y = F.gelu(u, approximate="tanh") @ params["down_proj"]
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
