"""mLSTM recurrence on Hopper: the wrapper of ``csrc/mlstm_chunk.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mlstm_chunk.py:
mlstm_chunk`` (body ``_mlstm_kernel``): the stabilised exponential-gated
matrix-memory recurrence of the xLSTM's mLSTM blocks. Unlike the TPU
kernel, which starts from a zero state and returns h only, this one reads
the state (C, n, m) and writes the final state back in place: the served
model's cache entry. Two CUDA C++ kernels, built by nvcc for ``sm_90a``
into one shared library with a plain C interface (``kernels/build.py``)
and called through ctypes on PyTorch's current stream; ``route`` picks
one from T: a prompt (T > 1) takes ``chunkwise``, the chunkwise-parallel
form on tensor cores (3xTF32 ``mma.sync``, C held in registers across
chunks of ``CHUNK`` steps), a decode step (T = 1) ``recurrent``, one step
with dk split over a cluster (``plan``). Launches are counted in total
(``mlstm_chunk.launches``) and per route
(``mlstm_chunk.route_launches``). Its plain PyTorch version is
``kernels/ref.mlstm_chunk_ref`` (``ops.PLAIN``).

Bound on an H100 SXM at the served prefill of xlstm-125m (B 4, T 512, 4
heads, dk = dv = 384, bfloat16): operations, the recurrence's C update
and read-out (4 dk dv a step and head, 4.83 GFLOP) at float32 accuracy
on TF32 tensor cores, two products each with one exact bfloat16 operand
(three in float32): 19.5 us at 495 TFLOP/s; 0.090 ms on the 67 TFLOP/s
fp32 CUDA cores, the route it replaces. A decode step is bound by C's
bytes, read and written (18.9 MB, 5.6 us). See the source for the design.

The chunkwise kernel keeps a per-(batch, head) arrival counter in a
scratch buffer this module owns, zero between launches. Launches on one
stream run one after another; each stream gets a scratch of its own, so
launches on two streams at once never share counters.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

MAX_DK = 384            # dk and dv, at most
CHUNK = 32              # steps a chunk of the chunkwise kernel (its L)
MAX_CLUSTER = 8         # blocks splitting dk in the recurrent kernel
ROUTES = ("chunkwise", "recurrent")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None
_ARRIVALS = {}

__all__ = ["mlstm_chunk", "route", "plan", "MAX_DK", "ROUTES"]


class Plan(NamedTuple):
    route: str
    cluster: int    # recurrent: blocks of a (batch, head) splitting dk
    vec_qk: bool    # chunkwise: q, k rows copied by cp.async
    vec_v: bool     # chunkwise: v rows by cp.async; recurrent: C and v
                    # read four columns at a time


def route(T: int) -> str:
    """The kernel a call takes, from its length alone: ``recurrent`` for
    one step (decode), ``chunkwise`` for more."""
    return "recurrent" if T == 1 else "chunkwise"


def plan(B: int, T: int, H: int, dk: int, dv: int, itemsize: int,
         aligned: bool = True) -> Plan:
    """The launch of one call. ``itemsize``: bytes of a q/k/v element;
    ``aligned``: every tensor starts on 16 bytes. Chunkwise (a block per
    (batch, head) and 48 columns of C): rows go through cp.async where
    their length is a whole number of 16-byte chunks. Recurrent: a
    cluster of min(8, dk // 16) blocks (at least 1) per (batch, head)
    splits dk (8 x 16 = 128 blocks at xlstm-125m's decode); C and v are
    read four columns at a time where dv allows."""
    if route(T) == "chunkwise":
        return Plan("chunkwise", 1, aligned and dk * itemsize % 16 == 0,
                    aligned and dv * itemsize % 16 == 0)
    return Plan("recurrent", min(MAX_CLUSTER, max(1, dk // 16)), False,
                aligned and dv % 4 == 0)


def _lib():
    global _FN
    if _FN is None:
        lib = build.load("mlstm_chunk")
        chunk = lib.mlstm_chunk_forward
        chunk.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                          + [ctypes.c_float] + [ctypes.c_int] * 4
                          + [ctypes.c_void_p])
        step = lib.mlstm_step_forward
        step.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                         + [ctypes.c_float] + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
        for fn in (chunk, step):
            fn.restype = ctypes.c_int
        lib.mlstm_chunk_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_chunk_error_string.restype = ctypes.c_char_p
        _FN = (chunk, step, lib.mlstm_chunk_error_string)
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
    """Launch the kernel of ``route(T)``. q, k: (B, T, H, dk), v: (B, T,
    H, dv), one dtype, float32 or bfloat16; i_pre, f_pre: (B, T, H) of
    one dtype; state C (B, H, dk, dv), n (B, H, dk), m (B, H) float32,
    overwritten with the final state. All contiguous CUDA tensors on one
    device; dk, dv <= 384. Returns h (B, T, H, dv) in v's dtype. Raises on
    anything the kernels do not take; never falls back."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    for name, t, shape in (("q", q, (B, T, H, dk)), ("k", k, (B, T, H, dk)),
                           ("v", v, (B, T, H, dv))):
        _check(name, t, dev, (q.dtype,) if name != "q" else _DTYPES, shape)
    _check("i_pre", i_pre, dev, _DTYPES, (B, T, H))
    _check("f_pre", f_pre, dev, (i_pre.dtype,), (B, T, H))
    for name, t, shape in (("C", C, (B, H, dk, dv)), ("n", n, (B, H, dk)),
                           ("m", m, (B, H))):
        _check(name, t, dev, (torch.float32,), shape)
    if not (0 < dk <= MAX_DK and 0 < dv <= MAX_DK):
        raise ValueError(f"mlstm_chunk kernel: dk={dk}, dv={dv} not in "
                         f"1..{MAX_DK}")
    h = torch.empty_like(v)
    if h.numel() == 0:
        return h
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, C, h))
    p = plan(B, T, H, dk, dv, q.element_size(), aligned)
    chunk, step, errstr = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
                f_pre.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
                h.data_ptr())
        types = (_DTYPES[q.dtype], _DTYPES[i_pre.dtype])
        if p.route == "chunkwise":
            err = chunk(*head, _arrivals(stream, B * H).data_ptr(), B, T, H,
                        dk, dv, dk ** -0.5, *types, int(p.vec_qk),
                        int(p.vec_v), stream.cuda_stream)
        else:
            err = step(*head, B, H, dk, dv, dk ** -0.5, *types, p.cluster,
                       int(p.vec_v), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunk kernel ({p.route}) launch failed: "
                           + errstr(err).decode())
    mlstm_chunk.launches += 1
    mlstm_chunk.route_launches[p.route] += 1
    return h


mlstm_chunk.launches = 0
mlstm_chunk.route_launches = dict.fromkeys(ROUTES, 0)
