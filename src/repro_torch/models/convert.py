"""Converts JAX parameter trees (as numpy arrays) into the port's
parameter dicts.

The port has no trained weights; this converter feeds both packages the
same weights in the tests. It covers the trees of the JAX package's
``init_unet`` and ``init_discriminator``:

  * every 4-D array is a convolution weight, HWIO in JAX and OIHW in the
    port (a depthwise ``(3,3,1,mid)`` weight becomes ``(mid,1,3,3)``, the
    layout ``groups=mid`` expects);
  * dense weights ``(cin, cout)``, ``text_embed``, ``fc``/``fc_b`` and
    GroupNorm ``scale``/``bias`` are kept as they are (the port computes
    ``x @ w`` as the JAX package does).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _convert(node, device):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_convert(v, device) for v in node)
    arr = np.asarray(node)
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    return torch.tensor(arr, device=device)


def from_jax(tree, device: DeviceLike = None):
    """A JAX UNet or discriminator parameter tree (leaves anything
    ``np.asarray`` takes) as the port's nested dict of tensors on
    ``device`` (CUDA unless the caller passes "cpu")."""
    return _convert(tree, resolve_device(device))
