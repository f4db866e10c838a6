"""Selective scan on Hopper: the wrapper of ``csrc/mamba_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py:mamba_scan``
(body ``_mamba_kernel``): the Mamba recurrence ``h <- exp(dt A) h +
(dt u) B``, ``y = h . C + D u``. Unlike the TPU kernel, which starts from
h = 0 and returns y only, this one reads the state h and writes the final
state back in place: the served model's cache entry. The CUDA C++ kernel
is built by nvcc for ``sm_90a`` into a shared library with a plain C
interface (``kernels/build.py``) and called through ctypes on PyTorch's
current stream. Its plain PyTorch version is
``kernels/ref.mamba_scan_ref`` (``ops.PLAIN``).

Bound on an H100 SXM: bytes. At Jamba's served prefill (Bt 4, T 512,
E 8192, N 16; u, B, C and y bf16, dt fp32) 134 MB move, 40 us at
3.35 TB/s. See the source for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_N = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None

__all__ = ["mamba_scan", "MAX_N"]


def _forward():
    global _FN
    if _FN is None:
        lib = build.load("mamba_scan")
        fn = lib.mamba_scan_forward
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.mamba_scan_error_string)
    return _FN


def _row_stride(t: torch.Tensor):
    """Elements between consecutive (b, t) rows of a (Bt, T, N) tensor
    with unit column stride (a contiguous tensor or a column slice of
    one), or None when its rows are not evenly spaced."""
    Bt, T, N = t.shape
    if N > 1 and t.stride(2) != 1:
        return None
    if T == 1:
        return t.stride(0)
    if Bt > 1 and t.stride(0) != T * t.stride(1):
        return None
    return t.stride(1)


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. u, dt: (Bt, T, E) contiguous; B, C: (Bt, T, N)
    with unit column stride (column slices of one projection are taken
    as they are); each of these float32 or bfloat16. A (E, N), D (E,)
    and the state h (Bt, E, N) float32 contiguous; h is overwritten with
    the final state. All CUDA tensors on one device; N <= 16. Returns y
    (Bt, T, E) in u's dtype. Raises on anything the kernel does not
    take; never falls back."""
    Bt, T, E = u.shape
    N = A.shape[-1]
    want = {"u": (u, (Bt, T, E), _DTYPES), "dt": (dt, (Bt, T, E), _DTYPES),
            "B": (B, (Bt, T, N), _DTYPES), "C": (C, (Bt, T, N), _DTYPES),
            "A": (A, (E, N), (torch.float32,)),
            "D": (D, (E,), (torch.float32,)),
            "h": (h, (Bt, E, N), (torch.float32,))}
    for name, (t, shape, dtypes) in want.items():
        if not t.is_cuda:
            raise ValueError(f"mamba_scan kernel: {name} is not a CUDA "
                             "tensor")
        if t.device != u.device:
            raise ValueError("mamba_scan kernel: inputs on different "
                             "devices")
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba_scan kernel: {name} shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype not in dtypes:
            raise ValueError(f"mamba_scan kernel: {name} dtype {t.dtype} "
                             f"not in {list(dtypes)}")
        if not (_row_stride(t) is not None if name in ("B", "C")
                else t.is_contiguous()):
            raise ValueError(f"mamba_scan kernel: {name} is not "
                             "contiguous")
    if not 0 < N <= MAX_N:
        raise ValueError(f"mamba_scan kernel: N={N} not in 1..{MAX_N}")
    y = torch.empty_like(u)
    if y.numel() == 0:
        return y
    fn, errstr = _forward()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), D.data_ptr(), h.data_ptr(), y.data_ptr(), Bt,
                 T, E, N, _row_stride(B), _row_stride(C), _DTYPES[u.dtype],
                 _DTYPES[dt.dtype], _DTYPES[B.dtype], _DTYPES[C.dtype],
                 stream)
    if err != 0:
        raise RuntimeError("mamba_scan kernel launch failed: "
                           + errstr(err).decode())
    mamba_scan.launches += 1
    return y


mamba_scan.launches = 0
