"""mLSTM recurrence on Hopper: the wrapper of ``csrc/mlstm_chunk.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mlstm_chunk.py:
mlstm_chunk`` (body ``_mlstm_kernel``): the stabilised exponential-gated
matrix-memory recurrence of the xLSTM's mLSTM blocks. Unlike the TPU
kernel, which starts from a zero state and returns h only, this one reads
the state (C, n, m) and writes the final state back in place: the served
model's cache entry. The CUDA C++ kernel is built by nvcc for ``sm_90a``
into a shared library with a plain C interface (``kernels/build.py``)
and called through ctypes on PyTorch's current stream. Its plain PyTorch
version is ``kernels/ref.mlstm_chunk_ref`` (``ops.PLAIN``).

Bound on an H100 SXM: operations at the served prefill of xlstm-125m
(B 4, T 512, 4 heads, dk = dv = 384): 5 dk dv + 5 dk + 2 dv fp32
operations a step and head (an FMA counted as two), 0.090 ms at 67
TFLOP/s; bytes at a decode step, where C is read and written (18.9 MB,
5.6 us). See the source for the design.

The kernel keeps a per-(batch, head) arrival counter in a scratch buffer
this module owns, zero between launches. Launches on one stream run one
after another; each stream gets a scratch of its own, so launches on two
streams at once never share counters.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_DK = 384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None
_ARRIVALS = {}

__all__ = ["mlstm_chunk", "MAX_DK"]


def _forward():
    global _FN
    if _FN is None:
        lib = build.load("mlstm_chunk")
        fn = lib.mlstm_chunk_forward
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mlstm_chunk_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_chunk_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.mlstm_chunk_error_string)
    return _FN


def _arrivals(stream: torch.cuda.Stream, count: int) -> torch.Tensor:
    """A zeroed int32 scratch of at least ``count`` entries for launches
    on ``stream``, kept between them (each launch leaves it zeroed)."""
    key = (stream.device, stream.cuda_stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < count:
        with torch.cuda.stream(stream):
            buf = torch.zeros(max(count, 1024), dtype=torch.int32,
                              device=stream.device)
        _ARRIVALS[key] = buf
    return buf


def _check(name, t, device, dtypes, shape):
    if not t.is_cuda:
        raise ValueError(f"mlstm_chunk kernel: {name} is not a CUDA tensor")
    if not t.is_contiguous():
        raise ValueError(f"mlstm_chunk kernel: {name} is not contiguous")
    if t.device != device:
        raise ValueError("mlstm_chunk kernel: inputs on different devices")
    if t.dtype not in dtypes:
        raise ValueError(f"mlstm_chunk kernel: {name} dtype {t.dtype} not "
                         f"in {list(dtypes)}")
    if tuple(t.shape) != shape:
        raise ValueError(f"mlstm_chunk kernel: {name} shape "
                         f"{tuple(t.shape)}, expected {shape}")


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_pre: torch.Tensor, f_pre: torch.Tensor, C: torch.Tensor,
                n: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. q, k: (B, T, H, dk), v: (B, T, H, dv), float32
    or bfloat16 each; i_pre, f_pre: (B, T, H) of one dtype; state C (B,
    H, dk, dv), n (B, H, dk), m (B, H) float32, overwritten with the
    final state. All contiguous CUDA tensors on one device; dk <= 384.
    Returns h (B, T, H, dv) in v's dtype. Raises on anything the kernel
    does not take; never falls back."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    for name, t, shape in (("q", q, (B, T, H, dk)), ("k", k, (B, T, H, dk)),
                           ("v", v, (B, T, H, dv))):
        _check(name, t, dev, _DTYPES, shape)
    _check("i_pre", i_pre, dev, _DTYPES, (B, T, H))
    _check("f_pre", f_pre, dev, (i_pre.dtype,), (B, T, H))
    for name, t, shape in (("C", C, (B, H, dk, dv)), ("n", n, (B, H, dk)),
                           ("m", m, (B, H))):
        _check(name, t, dev, (torch.float32,), shape)
    if not 0 < dk <= MAX_DK:
        raise ValueError(f"mlstm_chunk kernel: dk={dk} not in 1..{MAX_DK}")
    h = torch.empty_like(v)
    if h.numel() == 0:
        return h
    fn, errstr = _forward()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
                 f_pre.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
                 h.data_ptr(), _arrivals(stream, B * H).data_ptr(), B, T, H,
                 dk, dv, dk ** -0.5, _DTYPES[q.dtype], _DTYPES[k.dtype],
                 _DTYPES[v.dtype], _DTYPES[i_pre.dtype], stream.cuda_stream)
    if err != 0:
        raise RuntimeError("mlstm_chunk kernel launch failed: "
                           + errstr(err).decode())
    mlstm_chunk.launches += 1
    return h


mlstm_chunk.launches = 0
