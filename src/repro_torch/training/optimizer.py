"""AdamW with optional block-quantized 8-bit moments, PyTorch.

Port of ``repro/training/optimizer.py``: the same interface (``init(params)
-> state``, ``update(grads, state, params) -> (new_params, new_state,
metrics)``) as functional updates over a parameter tree of tensors
(``repro_torch/tree.py``), under ``torch.no_grad()``. The step count is
an int32 tensor and the learning rate and bias corrections are float32
tensors computed from it, as in the JAX package.

8-bit moments block over a leaf's last axis *in the JAX package's
layout*. The port keeps conv weights as OIHW where the JAX package holds
HWIO (``models/convert.py``), so a 4-D leaf's moments are quantized, and
stored, in HWIO: blocks run over output channels as they do there, and
the state equals the JAX package's leaf for leaf. Every 4-D leaf of the
port's trees is a conv weight (the converter's rule). ``opt_state_pspecs``
gives the state's partition specs from the parameters'.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.convert import hwio_to_oihw, oihw_to_hwio
from repro_torch.parallel.sharding import is_dtensor, splittable
from repro_torch.tree import leaves, map_tree, unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    eight_bit_moments: bool = False
    quant_block: int = 128


def cosine_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``end_lr_frac``: a float32
    tensor from an integer step (tensor or int)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.end_lr_frac + (1 - cfg.end_lr_frac) * cos
    return cfg.peak_lr * warm * frac


# ---------------------------------------------------------------------------
# Block-wise int8 quantization (for moments)
# ---------------------------------------------------------------------------
def _blocked_shape(shape, block) -> Tuple[Tuple[int, ...], int]:
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    if last % block == 0 and last >= block:
        return shape[:-1] + (last // block,), block
    return shape[:-1] + (1,), last     # per-row scale fallback


def _blocks(x: torch.Tensor, sshape, eff_block: int) -> torch.Tensor:
    """x as (..., blocks, block) over the global last axis, as in the JAX
    package. A DTensor whose last axis the mesh splits over a product
    that does not divide the block count has it gathered first (7168 =
    56 x 128 on a 16-way FSDP axis): DTensor refuses that view."""
    return splittable(x, -1, sshape[-1]).reshape(sshape + (eff_block,))


def _placed_like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``y`` back on ``x``'s placements, a partial sum there
    replicated (a plain ``y``, or one already there, passes)."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return y if tuple(y.placements) == pl else \
        y.redistribute(y.device_mesh, pl)


def quantize8(x: torch.Tensor, block: int):
    """int8 blocks of ``block`` over the last axis, each with its absmax
    / 127 scale (float32); the codes keep ``x``'s placements on a
    mesh."""
    shape = tuple(x.shape)
    sshape, eff_block = _blocked_shape(shape, block)
    xb = _blocks(x, sshape, eff_block)
    scale = torch.clamp(xb.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return _placed_like(q.reshape(shape), x), \
        scale.squeeze(-1).to(torch.float32)


def dequantize8(q: torch.Tensor, scale: torch.Tensor, block: int):
    """The float32 moment of ``quantize8``'s codes and scales, on the
    codes' placements on a mesh."""
    shape = tuple(q.shape)
    sshape, eff_block = _blocked_shape(shape, block)
    xb = _blocks(q, sshape, eff_block).to(torch.float32)
    return _placed_like((xb * scale[..., None]).reshape(shape), q)


class AdamWState(NamedTuple):
    count: torch.Tensor
    m: Any
    v: Any
    m_scale: Any     # None unless 8-bit
    v_scale: Any


def make_adamw(cfg: OptimizerConfig):
    """Returns (init_fn, update_fn)."""
    eight = cfg.eight_bit_moments
    blk = cfg.quant_block

    def init(params) -> AdamWState:
        dev = leaves(params)[0].device
        count = torch.zeros((), dtype=torch.int32, device=dev)
        if eight:
            m = map_tree(lambda p: torch.zeros(
                oihw_to_hwio(p).shape, dtype=torch.int8,
                device=p.device), params)
            sc = map_tree(lambda p: torch.zeros(
                _blocked_shape(oihw_to_hwio(p).shape, blk)[0],
                dtype=torch.float32, device=p.device), params)
            return AdamWState(count, m, map_tree(torch.clone, m), sc,
                              map_tree(torch.clone, sc))
        m = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        return AdamWState(count, m, map_tree(torch.clone, m), None, None)

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        count = state.count + 1
        lr = cosine_lr(cfg, count)

        # global-norm clip (fp32)
        gsq = sum(torch.sum(torch.square(g.to(torch.float32)))
                  for g in leaves(grads))
        gnorm = torch.sqrt(gsq)
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0)

        # bias corrections in float32 from the int32 count
        cf = count.to(torch.float32)
        bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32,
                               device=cf.device) ** cf
        bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32,
                               device=cf.device) ** cf

        def upd(p, g, m, v, ms=None, vs=None):
            gf = g.to(torch.float32) * clip
            if eight:
                gf = oihw_to_hwio(gf)
                mf = dequantize8(m, ms, blk)
                # v is stored as sqrt(v): linear int8 of the raw second
                # moment zeroes small entries (huge dynamic range)
                vf = torch.square(dequantize8(v, vs, blk))
            else:
                mf, vf = m, v
            mf = cfg.b1 * mf + (1 - cfg.b1) * gf
            vf = cfg.b2 * vf + (1 - cfg.b2) * torch.square(gf)
            step = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
            if eight:
                step = hwio_to_oihw(step).contiguous()
            pf = p.to(torch.float32)
            new_p = (pf - lr * (step + cfg.weight_decay * pf)).to(p.dtype)
            if eight:
                mq, msn = quantize8(mf, blk)
                vq, vsn = quantize8(torch.sqrt(vf), blk)
                return new_p, mq, vq, msn, vsn
            return new_p, mf, vf

        args = [leaves(params), leaves(grads), leaves(state.m),
                leaves(state.v)]
        if eight:
            args += [leaves(state.m_scale), leaves(state.v_scale)]
        parts = list(zip(*(upd(*a) for a in zip(*args))))
        new = [unflatten(params, list(part)) for part in parts]
        new_state = AdamWState(count, new[1], new[2],
                               new[3] if eight else None,
                               new[4] if eight else None)
        return new[0], new_state, {"lr": lr, "grad_norm": gnorm}

    return init, update


def opt_state_pspecs(state: AdamWState, params_pspecs):
    """Moments shard like their params; 8-bit block scales like the param
    minus the last axis (replicated there); the count replicated."""
    from repro_torch.parallel.sharding import P, is_spec

    def scale_spec(s):
        return P(*(tuple(s)[:-1] + (None,))) if len(s) else P()
    sc = None
    if state.m_scale is not None:
        sc = map_tree(scale_spec, params_pspecs, is_leaf=is_spec)
    return AdamWState(P(), params_pspecs, params_pspecs, sc, sc)
