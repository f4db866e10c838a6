"""Selective scan on Hopper: the wrapper of ``csrc/mamba_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py:mamba_scan``
(body ``_mamba_kernel``): the Mamba recurrence ``h <- exp(dt A) h +
(dt u) B``, ``y = h . C + D u``. Unlike the TPU kernel, which starts from
h = 0 and returns y only, this one reads the state h and writes the final
state back in place: the served model's cache entry. Two CUDA C++
kernels, built by nvcc for ``sm_90a`` into one shared library with a
plain C interface (``kernels/build.py``) and called through ctypes on
PyTorch's current stream; ``route`` picks one from T: a prompt (T > 1)
takes ``scan`` (a thread a channel, chunks of steps staged by cp.async
in two stages), a decode step (T = 1) ``step`` (a thread per batch row,
channel and 4 states, 16-byte accesses to h). Launches are counted in total
(``mamba_scan.launches``) and per route (``mamba_scan.route_launches``).
Its plain PyTorch version is ``kernels/ref.mamba_scan_ref``
(``ops.PLAIN``).

Bound on an H100 SXM: bytes. At Jamba's served prefill (Bt 4, T 512,
E 8192, N 16; u, B, C and y bf16, dt fp32) 134 MB move, 40 us at
3.35 TB/s; its 268 M exponentials take the special-function units 64 us
at 1.98 GHz (``sfu_floor_ms``), so the scan computes one of each
channel's 16 on the FMA pipe as a polynomial (``EXP2_POLY``). A decode
step moves h (4.2 MB in and out, 1.25 us). See the source for the design.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

MAX_N = 16
ROUTES = ("scan", "step")
# 2^f = sum_i EXP2_POLY[i] f^i for |f| <= 1/2: a degree-5 minimax fit of
# the relative error with c0 = 1, so that 2^0 is exact and the error has
# no bias near f = 0, where Jamba's dt A lies (1.7e-7 at most in float32
# with FMAs)
EXP2_POLY = (1.0, 0.6931470036506653, 0.24022242426872253,
             0.05550733581185341, 0.009671512991189957,
             0.001326472731307149)
SFU_PER_CLOCK = 16      # exponentials an SM's special-function units give
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None

__all__ = ["mamba_scan", "route", "plan", "sfu_floor_ms", "MAX_N",
           "ROUTES", "EXP2_POLY"]


class Plan(NamedTuple):
    route: str
    vec_u: bool     # scan: u's rows copied by cp.async
    vec_dt: bool    # scan: dt's rows
    vec_bc: bool    # scan: B's and C's rows
    quad: bool      # step: a thread per 4 states, 16-byte h and A


def route(T: int) -> str:
    """The kernel a call takes, from its length alone: ``step`` for one
    step (decode), ``scan`` for more."""
    return "step" if T == 1 else "scan"


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


def plan(u, dt, A, B, C, h) -> Plan:
    """The launch of one call, from the tensors' shapes, dtypes, row
    strides and addresses: a row goes through cp.async where it starts on
    16 bytes and is a whole number of 16-byte chunks (for u and dt the
    block's 64 columns: E a multiple of 16 bytes), else through plain
    loads; a decode step takes the 4-state threads where N = 16 and h, A
    start on 16 bytes."""
    E, N = A.shape

    def rows(t, stride, width):
        return t.data_ptr() % 16 == 0 and \
            (stride * t.element_size()) % 16 == 0 and \
            (width * t.element_size()) % 16 == 0
    T = u.shape[1]
    vec_bc = rows(B, _row_stride(B), N) and rows(C, _row_stride(C), N)
    return Plan(route(T), rows(u, E, E), rows(dt, E, E), vec_bc,
                N == MAX_N and h.data_ptr() % 16 == 0
                and A.data_ptr() % 16 == 0)


def sfu_floor_ms(Bt: int, T: int, E: int, N: int, sms: int,
                 clock_ghz: float) -> float:
    """Least time of the scan's Bt T E N exponentials on the
    special-function units alone (``SFU_PER_CLOCK`` an SM a clock)."""
    return Bt * T * E * N / (SFU_PER_CLOCK * sms * clock_ghz * 1e9) * 1e3


def _lib():
    global _FN
    if _FN is None:
        lib = build.load("mamba_scan")
        scan = lib.mamba_scan_forward
        scan.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                         + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p] * 2)
        step = lib.mamba_step_forward
        step.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                         + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
        for fn in (scan, step):
            fn.restype = ctypes.c_int
        lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        _FN = (scan, step, lib.mamba_scan_error_string,
               (ctypes.c_float * len(EXP2_POLY))(*EXP2_POLY))
    return _FN


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of ``route(T)``. u, dt: (Bt, T, E) contiguous;
    B, C: (Bt, T, N) with unit column stride (column slices of one
    projection are taken as they are); each of these float32 or bfloat16.
    A (E, N), D (E,) and the state h (Bt, E, N) float32 contiguous; h is
    overwritten with the final state. All CUDA tensors on one device;
    N <= 16. Returns y (Bt, T, E) in u's dtype. Raises on anything the
    kernels do not take; never falls back."""
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
    p = plan(u, dt, A, B, C, h)
    scan, step, errstr, coef = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        head = (u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), h.data_ptr(), y.data_ptr())
        types = (_DTYPES[u.dtype], _DTYPES[dt.dtype], _DTYPES[B.dtype],
                 _DTYPES[C.dtype])
        strides = (_row_stride(B), _row_stride(C))
        if p.route == "scan":
            err = scan(*head, Bt, T, E, N, *strides, *types, int(p.vec_u),
                       int(p.vec_dt), int(p.vec_bc), coef, stream)
        else:
            err = step(*head, Bt, E, N, *strides, *types, int(p.quad),
                       stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel ({p.route}) launch failed: "
                           + errstr(err).decode())
    mamba_scan.launches += 1
    mamba_scan.route_launches[p.route] += 1
    return y


mamba_scan.launches = 0
mamba_scan.route_launches = dict.fromkeys(ROUTES, 0)
