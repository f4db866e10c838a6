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
rows of T 1024) is 4.5 MB, 1.3 us, where the launch cost bounds it. The
kernel splits the cache of each (batch, KV head) across the blocks of a
thread-block cluster and combines their partials on chip, in one launch;
``plan_splits`` (pure Python, tested on the CPU) picks the split from T,
B * KH and the card's SM count, never from ``valid_len``, which stays on
the device. See the source for the design.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16
# the kernel's constants (csrc/decode_attention.cu): split sizes are
# multiples of TILE_ROWS (4 warps x 16 rows); a split is one block of a
# portable cluster of at most MAX_SPLITS
TILE_ROWS = 64
MAX_SPLITS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None

__all__ = ["decode_attention", "plan_splits", "HEAD_DIMS"]


def plan_splits(T: int, pairs: int, sms: int) -> Tuple[int, int]:
    """(splits, rows): the blocks that share one (batch, KV head) and the
    cache rows each takes, split s owning rows [s * rows, (s + 1) * rows).
    ``pairs`` = B * KH. Splits fill only the SMs that one block per pair
    leaves idle, so the grid stays within one block an SM: a cluster's
    blocks are scheduled together, and clusters past the first wave wait
    for whole clusters of the first to finish (on the H100, 32 pairs x 8
    splits ran 1.4x slower than x 4). At most MAX_SPLITS and at most one
    per TILE_ROWS rows; ``rows`` a multiple of TILE_ROWS, and no split
    starts at or past T. Depends on shapes and the card only, never on
    ``valid_len``."""
    tiles = max(1, math.ceil(T / TILE_ROWS))
    splits = max(1, min(MAX_SPLITS, tiles, sms // max(1, pairs)))
    rows = math.ceil(tiles / splits) * TILE_ROWS
    return max(1, math.ceil(T / rows)), rows


def _forward():
    global _FN
    if _FN is None:
        lib = build.load("decode_attention")
        fn = lib.decode_attention_forward
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
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
    splits, rows = plan_splits(T, B * KH, sm_count(q.device))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 valid_len.data_ptr(), out.data_ptr(), B, T, KH, H // KH, D,
                 splits, rows, 1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel launch failed: "
                           + errstr(err).decode())
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
