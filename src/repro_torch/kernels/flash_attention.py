"""Flash attention on Hopper: the wrapper of ``csrc/flash_attention.cu``,
``csrc/flash_attention_tc.cu`` and ``csrc/flash_attention_tf32.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:
flash_attention`` (body ``_flash_kernel``). Three CUDA C++ kernels, each
built by nvcc for ``sm_90a`` into a shared library with a plain C
interface (``kernels/build.py``) and called through ctypes on PyTorch's
current stream; ``route`` picks one from the dtype and head dim before
the launch. At head dims 64 and 128, bfloat16 (every LM prefill call)
takes ``wgmma``, the bf16 tensor-core kernel fed by TMA, and float32
(every diffusion call, the UNet's) takes ``tf32x3``, tensor cores at
float32 accuracy (each product split into three TF32 products); both
dtypes at head dims 16 and 32 take ``cuda_core``. Launches are counted in
total (``flash_attention.launches``) and per route
(``flash_attention.route_launches``). Its plain PyTorch version is
``kernels/ref.flash_attention_ref`` (``ops.PLAIN``).

A query offset (``q_offset`` > 0) places query row r at absolute
position ``q_offset + r`` against the keys: a prompt chunk written into
a KV cache at ``cache_index = q_offset``, its K/V the cache's rows with
``kv_len = q_offset + Sq``. A query-position tensor (``q_positions``,
int32 (B, Sq)) places query row r of sequence b at ``q_positions[b,
r]``: the JAX package's mask (key <= the query's position, M-RoPE's t
axis or the positions a forward is given), which differs from the slots
on an image prompt (all patches at t = 0) or custom positions. Every
route takes both. On ``wgmma`` and ``tf32x3`` each is its own compiled
instantiation (the same-position code of the diffusion calls is
unchanged), and under positions each query tile's key end and tile skip
come from its rows' largest position, found before the flash kernel by a
small kernel (``csrc/tile_ends.cuh``) into scratch the wrapper
allocates; ``cuda_core`` (head dims 16/32, no served path) masks by
position and reads every key tile below ``kv_len``. Nothing is read on
the host. Offset and position launches are counted apart, in total
(``flash_attention.offset_launches``, ``.position_launches``) and by
route (``.offset_route_launches``, ``.position_route_launches``).

Bound on an H100 SXM at the UNet's shape (q (8,256,4,128), k/v
(8,264,4,128), f32, non-causal): 1.11 GFLOP, taken at fp32 accuracy as
3 x 1.11 GFLOP of TF32 at 495 TFLOP/s, 6.7 us (16.5 us at the 67 TFLOP/s
fp32 CUDA-core peak); operations, not bytes (17.0 MB, 5.1 us), bound it.
At the LM prefill shape (bf16 q (4,512,32,128), k/v (4,512,4,128),
causal) bytes bound it: 37.7 MB, 11.3 us at 3.35 TB/s, against 8.7 us of
bf16 tensor-core operations. Every kernel keeps scores, probabilities
and the accumulator on chip, so device memory sees each operand once;
see the sources for their tiling.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
TC_HEAD_DIMS = (64, 128)
ROUTES = ("wgmma", "tf32x3", "cuda_core")
# key groups of the tf32x3 kernel: a block of 8 warps is 128 / KW query
# rows x KW groups of keys
KEY_GROUPS = (2, 4, 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None
_FN_TC = None
_FN_TF32 = None

__all__ = ["flash_attention", "route", "plan_key_groups", "HEAD_DIMS",
           "ROUTES"]


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a call takes, from its dtype and head dim alone: at head
    dims 64 and 128, ``wgmma`` for bfloat16 and ``tf32x3`` for float32
    (tensor cores, both); else ``cuda_core``."""
    if head_dim in TC_HEAD_DIMS:
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32:
            return "tf32x3"
    return "cuda_core"


def plan_key_groups(B: int, H: int, Sq: int, sms: int) -> int:
    """Key groups KW of the ``tf32x3`` kernel: a block takes 128 / KW
    query rows of one (batch, head), its 8 warps split KW ways over the
    keys. The fewest groups that give at least 3/4 of the SMs a block;
    8 where none does (the UNet at b = 8: 2, 128 blocks; at b = 1: 8, 64
    blocks)."""
    for kw in KEY_GROUPS:
        if B * H * -(-Sq // (128 // kw)) >= 3 * sms // 4:
            return kw
    return KEY_GROUPS[-1]


def _bind(name: str, extra):
    """``<name>_forward(q, k, v, o, B, Sq, Sk, H, KH, D, kv_len, causal,
    scale, *extra, stream)`` and its error-string function."""
    lib = build.load(name)
    fn = getattr(lib, f"{name}_forward")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, *extra, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _forward():
    global _FN
    if _FN is None:
        _FN = _bind("flash_attention",
                    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _FN


def _forward_tc():
    global _FN_TC
    if _FN_TC is None:
        _FN_TC = _bind("flash_attention_tc",
                       [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int])
    return _FN_TC


def _forward_tf32():
    global _FN_TF32
    if _FN_TF32 is None:
        _FN_TF32 = _bind("flash_attention_tf32",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p])
    return _FN_TF32


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: Optional[int] = None,
                    q_offset: int = 0,
                    q_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Launch the kernel. q: (B,Sq,H,D); k, v: (B,Sk,KH,D) with H = KH*G,
    contiguous CUDA tensors of one dtype (float32 or bfloat16).
    ``kv_len`` masks k/v rows at or past it (default Sk); ``q_offset`` is
    the absolute position of query row 0 for the causal mask, and
    ``q_positions`` (B, Sq) int32 on q's device, where given, each query
    row's position (every route, both; the positions must be >= 0).
    Raises on anything the kernel does not take; never falls back."""
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
    way = route(q.dtype, D)
    q_off = int(q_offset) if causal else 0
    if q_off < 0:
        raise ValueError(f"flash_attention kernel: q_offset={q_offset} < 0")
    qpos = None
    if q_positions is not None and causal:
        if (q_positions.dtype != torch.int32 or q_positions.device != q.device
                or tuple(q_positions.shape) != (B, Sq)):
            raise ValueError(
                f"flash_attention kernel: q_positions must be int32 "
                f"({B}, {Sq}) on {q.device}, got {q_positions.dtype} "
                f"{tuple(q_positions.shape)} on {q_positions.device}")
        qpos = q_positions.contiguous()
    if way != "cuda_core":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention kernel: {name} is not "
                                 "16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    # the query tiles' key ends (B * ceil(Sq / tile rows) written; B * Sq
    # bounds it whatever the kernel's tile)
    ends = None if qpos is None or way == "cuda_core" \
        else torch.empty_like(qpos)
    pos_ptr = 0 if qpos is None else qpos.data_ptr()
    ends_ptr = 0 if ends is None else ends.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, H, KH, D, kv, int(causal), 1.0 / math.sqrt(D))
        if way == "wgmma":
            fn, errstr = _forward_tc()
            err = fn(*args, q_off, pos_ptr, ends_ptr, sm_count(q.device),
                     stream)
        elif way == "tf32x3":
            fn, errstr = _forward_tf32()
            err = fn(*args, plan_key_groups(B, H, Sq, sm_count(q.device)),
                     q_off, pos_ptr, ends_ptr, stream)
        else:
            fn, errstr = _forward()
            err = fn(*args, _DTYPES[q.dtype], q_off, pos_ptr, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({way}) launch failed: "
                           + errstr(err).decode())
    flash_attention.launches += 1
    flash_attention.route_launches[way] += 1
    if qpos is not None:
        flash_attention.position_launches += 1
        flash_attention.position_route_launches[way] += 1
    elif q_off:
        flash_attention.offset_launches += 1
        flash_attention.offset_route_launches[way] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
flash_attention.offset_launches = 0
flash_attention.position_launches = 0
flash_attention.offset_route_launches = dict.fromkeys(ROUTES, 0)
flash_attention.position_route_launches = dict.fromkeys(ROUTES, 0)
