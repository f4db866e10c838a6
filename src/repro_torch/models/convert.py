"""Converts JAX parameter trees (as numpy arrays) into the port's
parameter dicts.

The port has no trained weights; this converter feeds both packages the
same weights in the tests. Two tree families, each with its own entry:

  * ``from_jax``: the trees of the JAX package's ``init_unet`` and
    ``init_discriminator``. Every 4-D array is a convolution weight,
    HWIO in JAX and OIHW in the port (a depthwise ``(3,3,1,mid)`` weight
    becomes ``(mid,1,3,3)``, the layout ``groups=mid`` expects); dense
    weights ``(cin, cout)``, ``text_embed``, ``fc``/``fc_b`` and GroupNorm
    ``scale``/``bias`` are kept as they are (the port computes ``x @ w``
    as the JAX package does).
  * ``lm_from_jax``: the tree of the JAX package's LM ``init_params``.
    No array is transposed (the port keeps the JAX layouts); the stacked
    periods under ``"scan"`` are cut into one entry per layer. Its 4-D
    leaves are stacked attention weights, not convolutions, so the
    conv rule must never see them: ``from_jax`` refuses an LM tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

_LM_KEYS = ("scan", "embed")


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


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
    ``device`` (CUDA unless the caller passes "cpu"). Raises on an LM
    tree: use ``lm_from_jax``."""
    if isinstance(tree, dict) and any(k in tree for k in _LM_KEYS):
        raise ValueError("an LM parameter tree (keys 'scan'/'embed'): its "
                         "4-D leaves are not conv weights; use lm_from_jax")
    return _convert(tree, resolve_device(device))


def _leaves(node, fn):
    if isinstance(node, dict):
        return {k: _leaves(v, fn) for k, v in node.items()}
    return fn(node)


def lm_from_jax(tree, cfg: ModelConfig, device: DeviceLike = None):
    """The JAX LM tree ``{"embed", "prefix", "scan": {"b<i>": stacked},
    "final_norm", "lm_head"?}`` (numpy leaves) as the port's
    ``{"embed", "layers": [...], "final_norm", "lm_head"?}`` on
    ``device`` (CUDA unless the caller passes "cpu"). Layer order is
    ``cfg.flat_pattern()``: the prefix, then period by period."""
    dev = resolve_device(device)
    if "scan" not in tree:
        raise ValueError("not a JAX LM parameter tree (no 'scan' key)")
    layers = [_leaves(p, lambda a: _tensor(a, dev)) for p in tree["prefix"]]
    for j in range(cfg.n_periods):
        for i in range(len(cfg.period_pattern)):
            layers.append(_leaves(tree["scan"][f"b{i}"],
                                  lambda a: _tensor(np.asarray(a)[j], dev)))
    out = {"embed": _leaves(tree["embed"], lambda a: _tensor(a, dev)),
           "layers": layers,
           "final_norm": _leaves(tree["final_norm"],
                                 lambda a: _tensor(a, dev))}
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], dev)
    return out
