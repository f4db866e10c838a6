"""Decode attention on Hopper: the wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py:
decode_attention`` (body ``_decode_kernel``): one new token per sequence
against a (B, T, KH, D) KV cache with a per-sequence ``valid_len`` read
from device memory, the G query heads of a KV head together. The CUDA
C++ kernel is built by nvcc for ``sm_90a`` into a shared library with a
plain C interface (``kernels/build.py``) and called through ctypes on
PyTorch's current stream. Its plain PyTorch version is
``kernels/ref.decode_attention_ref`` (``ops.PLAIN``).

Bound on an H100 SXM: bytes, the live rows of K and V read once. One
layer of decode_32k (B 128, 32769 live rows, KH 4, D 128, bf16) is
8.6 GB, 2.56 ms at 3.35 TB/s; the served decode shape (B 4, <= 544 live
rows of T 1024) is 4.5 MB, 1.3 us, where the launch cost bounds it. See
the source for the design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None

__all__ = ["decode_attention", "HEAD_DIMS"]


def _forward():
    global _FN
    if _FN is None:
        lib = build.load("decode_attention")
        fn = lib.decode_attention_forward
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.decode_attention_error_string)
    return _FN


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. q: (B,H,D); k, v: (B,T,KH,D) with H = KH*G,
    G <= 16; contiguous, 16-byte aligned CUDA tensors of one dtype
    (float32 or bfloat16); valid_len: (B,) int32 on the same device.
    Raises on anything the kernel does not take; never falls back."""
    for name, t in (("q", q), ("k", k), ("v", v), ("valid_len", valid_len)):
        if not t.is_cuda:
            raise ValueError(f"decode_attention kernel: {name} is not a "
                             "CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention kernel: {name} is not "
                             "contiguous")
        if t.device != q.device:
            raise ValueError("decode_attention kernel: inputs on different "
                             "devices")
        if name != "valid_len" and t.data_ptr() % 16:
            raise ValueError(f"decode_attention kernel: {name} is not "
                             "16-byte aligned")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention kernel: dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}; one of {list(_DTYPES)}")
    B, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention kernel: shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}")
    if H % KH or not 0 < H // KH <= MAX_GROUP:
        raise ValueError(f"decode_attention kernel: H={H} over KH={KH} is "
                         f"not a group of 1..{MAX_GROUP} heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if valid_len.dtype != torch.int32 or valid_len.shape != (B,):
        raise ValueError(f"decode_attention kernel: valid_len must be "
                         f"int32 of shape ({B},)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn, errstr = _forward()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 valid_len.data_ptr(), out.data_ptr(), B, T, KH, H // KH, D,
                 1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel launch failed: "
                           + errstr(err).decode())
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
