"""Fused GroupNorm (+ optional SiLU) on Hopper, in Triton.

Replaces the Pallas TPU kernel ``repro/kernels/fused_groupnorm.py:
fused_groupnorm`` (body ``_gn_kernel``): per-sample GroupNorm over
(spatial x C/g) with fp32 mean and population variance, eps 1e-5, then
per-channel scale/bias, then an optional SiLU, on channels-last
``(B, ..., C)``; the group count shrinks to the largest divisor of C.
Its plain PyTorch version is ``kernels/ref.groupnorm_silu_ref``
(``ops.PLAIN``).

Triton fits because the kernel is one reduction (per-(sample, group)
mean and variance) followed by one fused elementwise pass (normalise,
scale/bias, SiLU); there is no matrix product and no async-copy
pipeline to hand-schedule.

Design. The TPU kernel holds a whole sample (HW, C) in VMEM; that is
6.3 MB at (64*64, 384) f32, far above a block's 227 KB of shared memory.
So one program handles one (sample, group) and loops over HW in
(BLOCK_HW, BLOCK_C) tiles twice: the first pass keeps a Welford count,
mean and M2 per tile lane and merges the lanes at the end (the variance
is the mean of squared deviations, not E[x^2] - E[x]^2); the second pass
normalises, applies scale/bias and SiLU, and stores.

Bound on an H100 SXM: bytes. At (8,64,64,384) f32 the function must read
50.3 MB and write 50.3 MB, 30 us at 3.35 TB/s; its ~10 operations per
element are far below the fp32 peak. This version reads x twice (the
statistics pass and the normalise pass), and runs B*g programs (64 at
b=8, g=8), fewer than the card's 132 SMs; splitting HW across programs
is later work.

Triton is imported, and the kernel compiled, at the first launch only:
this module imports on a machine without triton.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import group_count

__all__ = ["fused_groupnorm"]

# triton.language, bound at the first launch; the kernel body reads it
# from this module's globals when triton compiles it
tl = None
_KERNEL = None
TILE = 2048          # elements of one (BLOCK_HW, BLOCK_C) tile


def _groupnorm_kernel(x_ptr, s_ptr, b_ptr, o_ptr, HW, C, CG, eps,
                      ACT: tl.constexpr, BLOCK_HW: tl.constexpr,
                      BLOCK_C: tl.constexpr):
    pid = tl.program_id(0)
    G = C // CG
    base = (pid // G).to(tl.int64) * HW * C + (pid % G) * CG
    rows = tl.arange(0, BLOCK_HW)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < CG
    cnt = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    mean = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    m2 = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
    for start in range(0, HW, BLOCK_HW):
        r = start + rows
        mask = (r < HW)[:, None] & cmask[None, :]
        offs = base + r[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        cnt_new = cnt + mask.to(tl.float32)
        delta = x - mean
        mean = mean + tl.where(mask, delta / tl.maximum(cnt_new, 1.0), 0.0)
        m2 = m2 + tl.where(mask, delta * (x - mean), 0.0)
        cnt = cnt_new
    n = tl.sum(tl.sum(cnt, axis=1), axis=0)
    mu = tl.sum(tl.sum(cnt * mean, axis=1), axis=0) / n
    dev = mean - mu
    var = tl.sum(tl.sum(m2 + cnt * dev * dev, axis=1), axis=0) / n
    rstd = 1.0 / tl.sqrt(var + eps)
    ch = (pid % G) * CG + cols
    scale = tl.load(s_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
    bias = tl.load(b_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
    for start in range(0, HW, BLOCK_HW):
        r = start + rows
        mask = (r < HW)[:, None] & cmask[None, :]
        offs = base + r[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = (x - mu) * rstd * scale[None, :] + bias[None, :]
        if ACT:
            y = y * tl.sigmoid(y)
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)


def _kernel():
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as language
        tl = language
        _KERNEL = triton.jit(_groupnorm_kernel)
    return _KERNEL


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def launch_config(shape, groups: int):
    """(g, HW, CG, BLOCK_HW, BLOCK_C) the kernel runs with for a
    channels-last ``shape``."""
    C = shape[-1]
    hw = 1
    for d in shape[1:-1]:
        hw *= d
    g = group_count(groups, C)
    cg = C // g
    block_c = _next_pow2(cg)
    block_hw = min(_next_pow2(hw), max(TILE // block_c, 1))
    return g, hw, cg, block_hw, block_c


def fused_groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    *, groups: int, act: bool = True,
                    eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on a contiguous channels-last CUDA tensor
    ``x`` (B, ..., C); ``scale``/``bias`` (C,). Raises on anything the
    kernel does not take; never falls back."""
    if not (x.is_cuda and scale.is_cuda and bias.is_cuda):
        raise ValueError("fused_groupnorm kernel: x, scale, bias must be "
                         "CUDA tensors")
    if not x.is_contiguous():
        raise ValueError("fused_groupnorm kernel: x is not contiguous "
                         "(channels-last (B, ..., C) expected)")
    if x.dtype != torch.float32:
        raise ValueError(f"fused_groupnorm kernel: dtype {x.dtype}, only "
                         "float32 (the served path's dtype)")
    C = x.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"fused_groupnorm kernel: scale/bias shape "
                         f"{tuple(scale.shape)}/{tuple(bias.shape)} for C={C}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    g, hw, cg, block_hw, block_c = launch_config(x.shape, groups)
    kernel = _kernel()
    with torch.cuda.device(x.device):
        kernel[(x.shape[0] * g,)](
            x, scale.contiguous(), bias.contiguous(), y, hw, C, cg,
            float(eps), ACT=bool(act), BLOCK_HW=block_hw, BLOCK_C=block_c,
            num_warps=4)
    fused_groupnorm.launches += 1
    fused_groupnorm.specializations.add(
        (x.dtype, hw, C, cg, bool(act), block_hw, block_c))
    return y


fused_groupnorm.launches = 0
# every (dtype, shape, constexpr) combination launched so far: a superset
# of the programs triton has compiled, so a timed run can check that no
# new one appeared
fused_groupnorm.specializations = set()
