"""Fused GroupNorm (+ optional SiLU) on Hopper: the wrapper of
``csrc/fused_groupnorm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/fused_groupnorm.py:
fused_groupnorm`` (body ``_gn_kernel``): per-sample GroupNorm over
(spatial x C/g) with fp32 mean and population variance, eps 1e-5, then
per-channel scale/bias, then an optional SiLU, on channels-last
``(B, ..., C)``; the group count shrinks to the largest divisor of C.
Its plain PyTorch version is ``kernels/ref.groupnorm_silu_ref``
(``ops.PLAIN``).

One CUDA C++ launch a call, built by nvcc for ``sm_90a`` into a shared
library with a plain C interface (``kernels/build.py``) and called
through ctypes on PyTorch's current stream: a thread-block cluster per
(sample, group) whose blocks hold its rows in shared memory, so x is
read from device memory once (see the source's note). ``plan`` sizes the
cluster from the shape alone; it is plain Python, tested on the CPU.

Bound on an H100 SXM: bytes. At (8,64,64,384) f32 the function must read
50.3 MB and write 50.3 MB, 30 us at 3.35 TB/s; its ~12 operations per
element are far below the fp32 peak.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.ref import group_count

__all__ = ["fused_groupnorm", "plan", "GnPlan"]

CLUSTER_SIZES = (1, 2, 4, 8)      # portable thread-block clusters
# dynamic shared memory a block may take: 227 KB less 1 KB for the
# kernel's static part and slack (``SMEM_MAX`` in the source)
SMEM_BYTES = 232448 - 1024
# shared memory of one SM, for how many blocks it holds at once
SM_SMEM_BYTES = 233472
# a block that has the card to itself is split further while it holds
# more than this: one SM's copies alone do not reach the memory's rate
SPLIT_BYTES = 32 * 1024
_FN = None


@dataclasses.dataclass(frozen=True)
class GnPlan:
    """How the kernel runs one call: ``groups`` of ``cg`` channels over
    ``hw`` rows; a cluster of ``cluster`` blocks a (sample, group), each
    owning ``rows`` rows (the last one fewer) of which ``chunk_rows`` fit
    its shared memory; mode ``resident`` (x read once) or ``reread``
    (statistics chunk by chunk, x read again to normalise); ``vec``
    floats a copy (4 where ``cg`` allows 16-byte copies, else 1);
    ``smem`` dynamic shared-memory bytes a block."""
    groups: int
    hw: int
    cg: int
    cluster: int
    rows: int
    chunk_rows: int
    mode: str
    vec: int
    smem: int


def _param_bytes(cg: int) -> int:
    """Shared bytes of the group's scale and bias, padded to 16."""
    return 16 * ((2 * cg + 3) // 4)


def plan(shape, groups: int, sms: int) -> GnPlan:
    """The launch for a channels-last ``shape`` (B, ..., C) on a card of
    ``sms`` SMs. The cluster starts at the fewest blocks a (sample,
    group) whose shares fit ``SMEM_BYTES`` and doubles (up to 8) while
    the blocks need more than one wave of the SMs, or while twice as many
    blocks still fit one block an SM and each holds more than
    ``SPLIT_BYTES``: clusters cost launch time (8 blocks the most), so
    they grow only where the card or the copy rate asks for it. A slice
    that 8 blocks cannot hold takes 8 and the ``reread`` mode."""
    B, C = shape[0], shape[-1]
    hw = math.prod(shape[1:-1])
    g = group_count(groups, C)
    cg = C // g
    room = (SMEM_BYTES - _param_bytes(cg)) // (4 * cg)   # rows that fit
    if room < 1:
        raise ValueError(f"fused_groupnorm: a row of {cg} channels does "
                         "not fit a block's shared memory")
    cs = next((c for c in CLUSTER_SIZES if -(-hw // c) <= room),
              CLUSTER_SIZES[-1])

    def share(c):          # bytes of a block's rows, and blocks an SM
        nbytes = min(-(-hw // c), room) * cg * 4
        return nbytes, SM_SMEM_BYTES // (nbytes + _param_bytes(cg) + 1024)

    while cs < CLUSTER_SIZES[-1]:
        nbytes, per_sm = share(cs)
        if not (B * g * cs > sms * per_sm
                or (2 * B * g * cs <= sms and nbytes > SPLIT_BYTES)):
            break
        cs *= 2
    while cs > 1 and (cs - 1) * -(-hw // cs) >= hw:    # no empty block
        cs //= 2
    rows = -(-hw // cs)
    chunk = min(rows, room)
    return GnPlan(groups=g, hw=hw, cg=cg, cluster=cs, rows=rows,
                  chunk_rows=chunk,
                  mode="resident" if chunk == rows else "reread",
                  vec=4 if cg % 4 == 0 else 1,
                  smem=_param_bytes(cg) + chunk * cg * 4)


def _forward():
    global _FN
    if _FN is None:
        lib = build.load("fused_groupnorm")
        fn = lib.fused_groupnorm_forward
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.fused_groupnorm_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _FN = fn, err
    return _FN


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
    if x.dtype != torch.float32 or scale.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise ValueError(f"fused_groupnorm kernel: dtypes {x.dtype}, "
                         f"{scale.dtype}, {bias.dtype}; only float32 (the "
                         "served path's dtype)")
    C = x.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"fused_groupnorm kernel: scale/bias shape "
                         f"{tuple(scale.shape)}/{tuple(bias.shape)} for C={C}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    p = plan(x.shape, groups, sm_count(x.device))
    # 16-byte copies need 16-byte aligned rows: a view at an odd offset
    # takes 4-byte copies (y, fresh, is aligned)
    vec = p.vec if x.data_ptr() % 16 == 0 else 1
    scale, bias = scale.contiguous(), bias.contiguous()
    fn, errstr = _forward()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), x.shape[0], p.hw, C, p.groups, p.cluster,
                 p.rows, p.chunk_rows, vec, int(act), float(eps), stream)
    if err != 0:
        raise RuntimeError("fused_groupnorm kernel launch failed: "
                           + errstr(err).decode())
    fused_groupnorm.launches += 1
    return y


fused_groupnorm.launches = 0
