"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. With no
CUDA device and no explicit request they raise: the port has no silent
CPU path. The served path is float32 (``DiffusionConfig.dtype``), so on
CUDA the TF32 shortcuts of cuBLAS and cuDNN are switched off.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]
_SMS: Dict[int, int] = {}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA; raises when CUDA is absent. An explicit
    ``"cpu"`` runs the plain PyTorch versions of every kernel; ``"meta"``
    gives shapes and dtypes only (the step builders' argument shapes,
    ``launch/steps.py``), with no data and nothing computed."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on CUDA by default; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is absent")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def sm_count(device: torch.device) -> int:
    """The CUDA device's SM count, asked once per device (the kernels
    size their grids from it on every launch)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n
