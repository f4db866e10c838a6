"""Kernel-implementation routes of the model hot path, and the batch
bucket ladder.

``kernel_impl`` selects how UNet attention and every GroupNorm(+SiLU)
execute:

  * ``fused``   — through ``kernels/ops.py``: the hand-written Hopper
                  kernel on a CUDA tensor, its plain PyTorch version on a
                  CPU tensor (the device of the tensor decides, nothing
                  else).
  * ``unfused`` — the per-op PyTorch baseline that bypasses
                  ``kernels/ops.py`` (the JAX package's ``"xla"`` route).
  * ``auto``    — always ``fused``. The JAX package resolves ``auto``
                  per backend because its Pallas kernels need a TPU; the
                  port's dispatch already follows the tensor's device, so
                  ``auto`` has one meaning everywhere.
"""
from __future__ import annotations

from typing import Tuple

# Registry: route name -> what it runs. Named apart from the JAX
# package's ``KERNEL_IMPLS`` so the repo linter's first-definition index
# keeps both.
TORCH_KERNEL_IMPLS = {
    "fused": "kernels/ops.py: Hopper kernel on CUDA, plain version on CPU",
    "unfused": "per-op PyTorch baseline, bypassing kernels/ops.py",
}


def resolve_kernel_impl(name: str) -> str:
    """Map ``auto`` to ``fused``; reject unknown routes."""
    if name == "auto":
        return "fused"
    if name not in TORCH_KERNEL_IMPLS:
        raise ValueError(f"unknown kernel_impl {name!r}; choose from "
                         f"{sorted(TORCH_KERNEL_IMPLS) + ['auto']}")
    return name


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n; past the ladder, round up to a multiple of
    the largest bucket (keeps the number of batch shapes bounded)."""
    if not buckets:
        return n
    for b in buckets:
        if b >= n:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top
