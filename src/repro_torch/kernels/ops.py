"""Device dispatch for every kernel of the ported serving paths.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel, or raises. No path falls back from a
kernel to its plain version. Each kernel wrapper keeps a plain integer
launch counter (``<wrapper>.launches``), moved only where the kernel is
launched; ``launch_counts``/``reset_launch_counts`` read and zero them,
and a kernel with more than one route counts per route as well
(``route_counts``). No kernel has a backward, so on CUDA a call that
autograd would differentiate (grad mode on, an input that requires
grad) raises and names the ``"unfused"`` route (``needs_grad``);
``pick(name, impl)`` gives a model the function of that route: the
plain version, which autograd differentiates on any device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_groupnorm as _gn
from repro_torch.kernels import fused_rmsnorm as _rms
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import mlstm_chunk as _mlstm
from repro_torch.kernels import ref
from repro_torch.kernels import swiglu as _swiglu
from repro_torch.kernels.impls import resolve_kernel_impl

KERNELS = {"flash_attention": _flash.flash_attention,
           "fused_groupnorm": _gn.fused_groupnorm,
           "decode_attention": _decode.decode_attention,
           "fused_rmsnorm": _rms.fused_rmsnorm,
           "swiglu": _swiglu.swiglu,
           "mlstm_chunk": _mlstm.mlstm_chunk,
           "mamba_scan": _mamba.mamba_scan}
# the kernels with more than one route, each counting its launches by
# route (``route_counts``)
ROUTED = {"flash_attention": _flash.flash_attention,
          "mlstm_chunk": _mlstm.mlstm_chunk,
          "mamba_scan": _mamba.mamba_scan}
# each kernel's plain PyTorch version: what a CPU tensor runs, and what
# a kernel is held against on the card
PLAIN = {"flash_attention": ref.flash_attention_ref,
         "fused_groupnorm": ref.groupnorm_silu_ref,
         "decode_attention": ref.decode_attention_ref,
         "fused_rmsnorm": ref.rmsnorm_ref,
         "swiglu": ref.swiglu_ref,
         "mlstm_chunk": ref.mlstm_chunk_ref,
         "mamba_scan": ref.mamba_scan_ref}


def _device_type(t: torch.Tensor, kernel: str) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return kind


def needs_grad(*tensors) -> bool:
    """Whether autograd would have to differentiate through a call on
    ``tensors``: grad mode on and an input that requires grad."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)


def _refuse_grad(kernel: str, *tensors) -> None:
    """No kernel has a backward, and a kernel's output has no
    ``grad_fn``: on CUDA, a call that autograd would differentiate
    raises instead of training nothing through it."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward; run the model on "
            "the 'unfused' route (kernel_impl / impl='unfused') to train "
            "through it")


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_len: Optional[int] = None, q_offset: int = 0,
                    q_positions=None):
    """q: (B,Sq,H,D); k, v: (B,Sk,KH,D); query row r at position
    ``q_offset + r``, or at ``q_positions[b, r]`` ((B, Sq) int32) where
    given. See ``ref.flash_attention_ref``."""
    if _device_type(q, "flash_attention") == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                       q_offset=q_offset,
                                       q_positions=q_positions)
    _refuse_grad("flash_attention", q, k, v)
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  kv_len=kv_len, q_offset=q_offset,
                                  q_positions=q_positions)


def fused_groupnorm(x, scale, bias, *, groups: int, act: bool = True,
                    eps: float = 1e-5):
    """x: (B, ..., C) channels-last. See ``ref.groupnorm_silu_ref``."""
    if _device_type(x, "fused_groupnorm") == "cpu":
        return ref.groupnorm_silu_ref(x, scale, bias, groups=groups, eps=eps,
                                      act=act)
    _refuse_grad("fused_groupnorm", x, scale, bias)
    return _gn.fused_groupnorm(x.contiguous(), scale, bias, groups=groups,
                               act=act, eps=eps)


def decode_attention(q, k, v, valid_len):
    """q: (B,H,D) one token; k, v: (B,T,KH,D); valid_len: (B,) int32.
    See ``ref.decode_attention_ref``."""
    if _device_type(q, "decode_attention") == "cpu":
        return ref.decode_attention_ref(q, k, v, valid_len)
    _refuse_grad("decode_attention", q, k, v)
    return _decode.decode_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), valid_len.contiguous())


def fused_rmsnorm(x, scale, *, residual=None, eps: float = 1e-5):
    """x: (..., D). With ``residual``, returns ``(normed, x + residual)``.
    See ``ref.rmsnorm_ref``."""
    if _device_type(x, "fused_rmsnorm") == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps, residual=residual)
    _refuse_grad("fused_rmsnorm", x, scale, residual)
    return _rms.fused_rmsnorm(
        x.contiguous(), scale.contiguous(), eps=eps,
        residual=None if residual is None else residual.contiguous())


def swiglu(gate, up):
    """silu(gate) * up. See ``ref.swiglu_ref``."""
    if _device_type(gate, "swiglu") == "cpu":
        return ref.swiglu_ref(gate, up)
    _refuse_grad("swiglu", gate, up)
    return _swiglu.swiglu(gate.contiguous(), up.contiguous())


def mlstm_chunk(q, k, v, i_pre, f_pre, C, n, m):
    """The mLSTM recurrence from state (C, n, m), which is overwritten
    with the final state; returns h in v's dtype. See
    ``ref.mlstm_chunk_ref``."""
    if _device_type(q, "mlstm_chunk") == "cpu":
        return ref.mlstm_chunk_ref(q, k, v, i_pre, f_pre, C, n, m)
    _refuse_grad("mlstm_chunk", q, k, v, i_pre, f_pre, C, n, m)
    return _mlstm.mlstm_chunk(q.contiguous(), k.contiguous(),
                              v.contiguous(), i_pre.contiguous(),
                              f_pre.contiguous(), C, n, m)


def mamba_scan(u, dt, A, B, C, D, h):
    """The selective scan from state h, which is overwritten with the
    final state; returns y in u's dtype. B and C go to the kernel as they
    are (column slices of one projection are taken without a copy). See
    ``ref.mamba_scan_ref``."""
    if _device_type(u, "mamba_scan") == "cpu":
        return ref.mamba_scan_ref(u, dt, A, B, C, D, h)
    _refuse_grad("mamba_scan", u, dt, A, B, C, D, h)
    return _mamba.mamba_scan(u.contiguous(), dt.contiguous(),
                             A.contiguous(), B, C, D.contiguous(), h)


def pick(name: str, impl: str = "fused"):
    """The function a model's call of kernel ``name`` takes on route
    ``impl`` (``kernels/impls.py``): ``fused`` this module's dispatcher
    (read when called, so a swapped module attribute is seen), ``unfused``
    the plain version (``PLAIN``) on any device. No kernel has a
    backward, so the train steps take ``unfused``: what the JAX package's
    train steps compute, through plain ops that autograd differentiates."""
    if resolve_kernel_impl(impl) == "unfused":
        return PLAIN[name]
    return globals()[name]


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def offset_launches() -> int:
    """Flash attention's launches with a query offset (``q_offset`` > 0,
    a prompt chunk at ``cache_index`` > 0), all on ``wgmma``."""
    return _flash.flash_attention.offset_launches


def position_launches() -> int:
    """Flash attention's launches with a query-position tensor (a
    forward given positions), all on ``wgmma``."""
    return _flash.flash_attention.position_launches


def route_counts(kernel: str = "flash_attention") -> Dict[str, int]:
    """Launches by route of a kernel with more than one (``ROUTED``):
    flash attention's (the default) at head dims 64 and 128 ``wgmma``
    (bf16) and ``tf32x3`` (float32), ``cuda_core`` for the rest; the
    mLSTM's ``chunkwise`` (T > 1) and ``recurrent`` (T = 1); the
    selective scan's ``scan`` (T > 1) and ``step`` (T = 1)."""
    return dict(ROUTED[kernel].route_launches)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in ROUTED.values():
        for way in fn.route_launches:
            fn.route_launches[way] = 0
    _flash.flash_attention.offset_launches = 0
    _flash.flash_attention.position_launches = 0
