"""Device dispatch for every kernel of the ported serving paths.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel, or raises. No path falls back from a
kernel to its plain version. Each kernel wrapper keeps a plain integer
launch counter (``<wrapper>.launches``), moved only where the kernel is
launched; ``launch_counts``/``reset_launch_counts`` read and zero them,
and a kernel with more than one route counts per route as well
(``route_counts``).
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


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_len: Optional[int] = None):
    """q: (B,Sq,H,D); k, v: (B,Sk,KH,D). See ``ref.flash_attention_ref``."""
    if _device_type(q, "flash_attention") == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len)
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  kv_len=kv_len)


def fused_groupnorm(x, scale, bias, *, groups: int, act: bool = True,
                    eps: float = 1e-5):
    """x: (B, ..., C) channels-last. See ``ref.groupnorm_silu_ref``."""
    if _device_type(x, "fused_groupnorm") == "cpu":
        return ref.groupnorm_silu_ref(x, scale, bias, groups=groups, eps=eps,
                                      act=act)
    return _gn.fused_groupnorm(x.contiguous(), scale, bias, groups=groups,
                               act=act, eps=eps)


def decode_attention(q, k, v, valid_len):
    """q: (B,H,D) one token; k, v: (B,T,KH,D); valid_len: (B,) int32.
    See ``ref.decode_attention_ref``."""
    if _device_type(q, "decode_attention") == "cpu":
        return ref.decode_attention_ref(q, k, v, valid_len)
    return _decode.decode_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), valid_len.contiguous())


def fused_rmsnorm(x, scale, *, residual=None, eps: float = 1e-5):
    """x: (..., D). With ``residual``, returns ``(normed, x + residual)``.
    See ``ref.rmsnorm_ref``."""
    if _device_type(x, "fused_rmsnorm") == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps, residual=residual)
    return _rms.fused_rmsnorm(
        x.contiguous(), scale.contiguous(), eps=eps,
        residual=None if residual is None else residual.contiguous())


def swiglu(gate, up):
    """silu(gate) * up. See ``ref.swiglu_ref``."""
    if _device_type(gate, "swiglu") == "cpu":
        return ref.swiglu_ref(gate, up)
    return _swiglu.swiglu(gate.contiguous(), up.contiguous())


def mlstm_chunk(q, k, v, i_pre, f_pre, C, n, m):
    """The mLSTM recurrence from state (C, n, m), which is overwritten
    with the final state; returns h in v's dtype. See
    ``ref.mlstm_chunk_ref``."""
    if _device_type(q, "mlstm_chunk") == "cpu":
        return ref.mlstm_chunk_ref(q, k, v, i_pre, f_pre, C, n, m)
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
    return _mamba.mamba_scan(u.contiguous(), dt.contiguous(),
                             A.contiguous(), B, C, D.contiguous(), h)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


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
