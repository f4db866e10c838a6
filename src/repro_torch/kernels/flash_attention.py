"""Flash attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:
flash_attention`` (body ``_flash_kernel``). The CUDA C++ kernel is built
by nvcc for ``sm_90a`` into a shared library with a plain C interface
(``kernels/build.py``) and called through ctypes on PyTorch's current
stream. Its plain PyTorch version is ``kernels/ref.flash_attention_ref``
(``ops.PLAIN``).

Bound on an H100 SXM at the UNet's shape (q (8,256,4,128), k/v
(8,264,4,128), f32, non-causal): 1.11 GFLOP at the 67 TFLOP/s fp32
CUDA-core peak, 16.5 us; operations, not bytes (17.0 MB, 5.1 us), bound
it. The kernel keeps scores, probabilities and the accumulator on chip
(registers and shared memory) so device memory sees each operand once;
see the source for its tiling.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None

__all__ = ["flash_attention", "HEAD_DIMS"]


def _forward():
    global _FN
    if _FN is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_forward
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.flash_attention_error_string)
    return _FN


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel. q: (B,Sq,H,D); k, v: (B,Sk,KH,D) with H = KH*G,
    contiguous CUDA tensors of one dtype (float32 or bfloat16).
    ``kv_len`` masks k/v rows at or past it (default Sk). Raises on
    anything the kernel does not take; never falls back."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is not a CUDA "
                             "tensor")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} is not "
                             "contiguous")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention kernel: q, k, v differ in "
                             "dtype or device")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} not in "
                         f"{list(_DTYPES)}")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if H % KH:
        raise ValueError(f"flash_attention kernel: H={H} not a multiple of "
                         f"KH={KH}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    kv = Sk if kv_len is None else int(kv_len)
    if not 0 < kv <= Sk:
        raise ValueError(f"kv_len={kv_len} outside (0, {Sk}]")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn, errstr = _forward()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, KH, D, kv, int(causal),
                 1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + errstr(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
