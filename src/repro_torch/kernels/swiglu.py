"""Fused SwiGLU on Hopper, in Triton: ``silu(gate) * up`` in fp32.

Replaces the Pallas TPU kernel ``repro/kernels/swiglu.py:swiglu`` (body
``_swiglu_kernel``). Its plain PyTorch version is
``kernels/ref.swiglu_ref`` (``ops.PLAIN``).

Triton fits because the kernel is a single elementwise pass: masked
block loads and stores say all of it, with nothing to stage in shared
memory and no tensor-core work.

Design. The TPU kernel tiles (rows, F) to fit VMEM blocks; the function
is elementwise, so here one flat index space over the contiguous inputs
is cut into BLOCK-element programs, each reading gate and up once and
writing the output once, with fp32 arithmetic in registers.

Bound on an H100 SXM: bytes. Prefill of Yi-9B gives (4*512, 11008)
bf16: 3 x 45.1 MB moved, 40 us at 3.35 TB/s; ~5 operations an element
are far below any compute peak.

Triton is imported, and the kernel compiled, at the first launch only:
this module imports on a machine without triton.
"""
from __future__ import annotations

import torch

__all__ = ["swiglu"]

# triton.language, bound at the first launch (see fused_rmsnorm.py)
tl = None
_KERNEL = None
BLOCK = 2048
_DTYPES = (torch.float32, torch.bfloat16)


def _swiglu_kernel(g_ptr, u_ptr, o_ptr, N, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < N
    g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    u = tl.load(u_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    tl.store(o_ptr + offs, (g * tl.sigmoid(g) * u).to(
        o_ptr.dtype.element_ty), mask=mask)


def _kernel():
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as language
        tl = language
        _KERNEL = triton.jit(_swiglu_kernel)
    return _KERNEL


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA tensors ``gate`` and ``up``
    of one shape and dtype (float32 or bfloat16). Raises on anything the
    kernel does not take; never falls back."""
    for name, t in (("gate", gate), ("up", up)):
        if not t.is_cuda:
            raise ValueError(f"swiglu kernel: {name} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"swiglu kernel: {name} is not contiguous")
    if gate.shape != up.shape or gate.dtype != up.dtype \
            or gate.device != up.device:
        raise ValueError("swiglu kernel: gate and up differ in shape, "
                         "dtype or device")
    if gate.dtype not in _DTYPES:
        raise ValueError(f"swiglu kernel: dtype {gate.dtype} not in "
                         f"{list(_DTYPES)}")
    out = torch.empty_like(gate)
    n = gate.numel()
    if n:
        with torch.cuda.device(gate.device):
            _kernel()[(-(-n // BLOCK),)](gate, up, out, n, BLOCK=BLOCK,
                                        num_warps=8)
        swiglu.launches += 1
    return out


swiglu.launches = 0
