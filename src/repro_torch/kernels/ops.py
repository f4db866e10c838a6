"""Device dispatch for every kernel of the serving path.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel, or raises. No path falls back from a
kernel to its plain version. Each kernel wrapper keeps a plain integer
launch counter (``<wrapper>.launches``), moved only where the kernel is
launched; ``launch_counts``/``reset_launch_counts`` read and zero them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_groupnorm as _gn
from repro_torch.kernels import ref

KERNELS = {"flash_attention": _flash.flash_attention,
           "fused_groupnorm": _gn.fused_groupnorm}


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


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def specialization_count() -> int:
    """Distinct Triton specialisations launched so far (the counterpart
    of an XLA compile); the CUDA C++ kernel is compiled ahead of time."""
    return len(_gn.fused_groupnorm.specializations)
