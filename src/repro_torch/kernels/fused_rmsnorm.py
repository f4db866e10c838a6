"""Fused (residual add +) RMSNorm on Hopper, in Triton.

Replaces the Pallas TPU kernel ``repro/kernels/fused_rmsnorm.py:
fused_rmsnorm``, both of its calls: ``_rmsnorm_kernel`` (RMSNorm x scale
in fp32) and ``_rmsnorm_res_kernel`` (``x + residual`` summed in fp32
first, returning ``(normed, x + residual)``). Its plain PyTorch version
is ``kernels/ref.rmsnorm_ref`` (``ops.PLAIN``).

Triton fits because the kernel is one row-wise reduction (the mean
square over D) followed by one elementwise scale: no matrix product, no
shared-memory staging or asynchronous copies to schedule by hand.

Design. One program per row holds the whole row in registers
(BLOCK_D = D rounded up to a power of two, 4096 for Yi-9B: 16 fp32
values a thread at 8 warps), so x is read once and each output written
once. The residual variant stores the rounded sum and normalises the
unrounded fp32 sum, as the TPU kernel does.

Bound on an H100 SXM: bytes. Prefill of Yi-9B gives (4*512, 4096) bf16:
the plain variant moves 2 x 16.8 MB (read x, write the output), 10 us
at 3.35 TB/s; the residual variant 4 x 16.8 MB, 20 us. Its ~4
operations an element are far below any compute peak. At decode (4
rows) a launch is bound by its launch cost, not by either.

Triton is imported, and the kernel compiled, at the first launch only:
this module imports on a machine without triton.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["fused_rmsnorm"]

# triton.language, bound at the first launch; the kernel body reads it
# from this module's globals when triton compiles it
tl = None
_KERNEL = None
MAX_D = 1 << 16
_DTYPES = (torch.float32, torch.bfloat16)


def _rmsnorm_kernel(x_ptr, r_ptr, s_ptr, o_ptr, sum_ptr, D, eps,
                    RES: tl.constexpr, BLOCK_D: tl.constexpr):
    row = tl.program_id(0).to(tl.int64) * D
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    x = tl.load(x_ptr + row + cols, mask=mask, other=0.0).to(tl.float32)
    if RES:
        x += tl.load(r_ptr + row + cols, mask=mask,
                     other=0.0).to(tl.float32)
        tl.store(sum_ptr + row + cols, x.to(sum_ptr.dtype.element_ty),
                 mask=mask)
    var = tl.sum(x * x, axis=0) / D
    rstd = 1.0 / tl.sqrt(var + eps)
    scale = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(o_ptr + row + cols, (x * rstd * scale).to(
        o_ptr.dtype.element_ty), mask=mask)


def _kernel():
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as language
        tl = language
        _KERNEL = triton.jit(_rmsnorm_kernel)
    return _KERNEL


def launch_config(D: int):
    """(BLOCK_D, num_warps) for rows of width D."""
    block = 1 << max(D - 1, 0).bit_length()
    return block, min(max(block // 512, 1), 16)


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
                  residual: Optional[torch.Tensor] = None,
                  eps: float = 1e-5):
    """Launch the kernel on a contiguous CUDA tensor ``x`` (..., D) of
    float32 or bfloat16 with ``scale`` (D,). With ``residual`` (x's
    shape and dtype) returns ``(normed, x + residual)``. Raises on
    anything the kernel does not take; never falls back."""
    ins = [("x", x), ("scale", scale)]
    if residual is not None:
        ins.append(("residual", residual))
    for name, t in ins:
        if not t.is_cuda:
            raise ValueError(f"fused_rmsnorm kernel: {name} is not a CUDA "
                             "tensor")
        if not t.is_contiguous():
            raise ValueError(f"fused_rmsnorm kernel: {name} is not "
                             "contiguous")
        if t.device != x.device:
            raise ValueError("fused_rmsnorm kernel: inputs on different "
                             "devices")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_rmsnorm kernel: dtype {x.dtype} not in "
                         f"{list(_DTYPES)}")
    D = x.shape[-1]
    if scale.shape != (D,) or not 0 < D <= MAX_D:
        raise ValueError(f"fused_rmsnorm kernel: scale shape "
                         f"{tuple(scale.shape)} for rows of {D}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError("fused_rmsnorm kernel: residual differs from x in "
                         "shape or dtype")
    out = torch.empty_like(x)
    total = torch.empty_like(x) if residual is not None else out
    rows = x.numel() // D
    if rows:
        block, warps = launch_config(D)
        with torch.cuda.device(x.device):
            _kernel()[(rows,)](
                x, x if residual is None else residual, scale, out, total,
                D, float(eps), RES=residual is not None, BLOCK_D=block,
                num_warps=warps)
        fused_rmsnorm.launches += 1
    return out if residual is None else (out, total)


fused_rmsnorm.launches = 0
