"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. With no
CUDA device and no explicit request they raise: the port has no silent
CPU path. The served path is float32 (``DiffusionConfig.dtype``), so on
CUDA the TF32 shortcuts of cuBLAS and cuDNN are switched off.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA; raises when CUDA is absent. An explicit
    ``"cpu"`` runs the plain PyTorch versions of every kernel."""
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
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
