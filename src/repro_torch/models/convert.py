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
    ``to_jax`` is its exact inverse (checkpoints are written in the JAX
    package's layout through it).
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
from repro_torch.tree import map_tree

_LM_KEYS = ("scan", "embed")


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def hwio_to_oihw(t: torch.Tensor) -> torch.Tensor:
    """The conv layout rule: a 4-D leaf is a conv weight, HWIO in the
    JAX package and OIHW in the port (a view; other leaves as they
    are)."""
    return t.permute(3, 2, 0, 1) if t.ndim == 4 else t


def oihw_to_hwio(t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``hwio_to_oihw`` (a view)."""
    return t.permute(2, 3, 1, 0) if t.ndim == 4 else t


def _refuse_lm(tree) -> None:
    if isinstance(tree, dict) and any(k in tree for k in _LM_KEYS):
        raise ValueError("an LM parameter tree (keys 'scan'/'embed'): its "
                         "4-D leaves are not conv weights; use lm_from_jax")


def from_jax(tree, device: DeviceLike = None):
    """A JAX UNet or discriminator parameter tree (leaves anything
    ``np.asarray`` takes, or CPU tensors) as the port's nested dict of
    tensors on ``device`` (CUDA unless the caller passes "cpu"). Raises
    on an LM tree: use ``lm_from_jax``."""
    _refuse_lm(tree)
    dev = resolve_device(device)

    def leaf(x):
        t = x.detach().clone() if torch.is_tensor(x) else _tensor(x, "cpu")
        return hwio_to_oihw(t).contiguous().to(dev)
    return map_tree(leaf, tree)


def to_jax(tree):
    """The exact inverse of ``from_jax``: the port's UNet or
    discriminator tree in the JAX package's layout (conv weights OIHW ->
    HWIO, a depthwise ``(mid,1,3,3)`` -> ``(3,3,1,mid)``), leaves as
    contiguous CPU tensors (``np.asarray`` of one gives the array
    ``from_jax`` took; a bfloat16 leaf stays a tensor, since numpy has
    no bfloat16 without ``ml_dtypes``). Raises on an LM tree."""
    _refuse_lm(tree)
    return map_tree(lambda x: oihw_to_hwio(
        torch.as_tensor(x).detach().cpu()).contiguous(), tree)


def lm_from_jax(tree, cfg: ModelConfig, device: DeviceLike = None):
    """The JAX LM tree ``{"embed"?, "prefix", "scan": {"b<i>": stacked},
    "final_norm", "lm_head"?, "mtp"?}`` (numpy leaves) as the port's
    ``{"embed"?, "layers": [...], "final_norm", "lm_head"?, "mtp"?}`` on
    ``device`` (CUDA unless the caller passes "cpu"). Layer order is
    ``cfg.flat_pattern()``: the prefix, then period by period. The MLA
    mixer's leaves, an embedding-input model's ``embed`` (learned
    positions only, or none) and the multi-token prediction block are
    copied as they are."""
    dev = resolve_device(device)
    if "scan" not in tree:
        raise ValueError("not a JAX LM parameter tree (no 'scan' key)")

    def leaf(a):
        return _tensor(a, dev)
    layers = [map_tree(leaf, p) for p in tree["prefix"]]
    for j in range(cfg.n_periods):
        for i in range(len(cfg.period_pattern)):
            layers.append(map_tree(lambda a: _tensor(np.asarray(a)[j], dev),
                                   tree["scan"][f"b{i}"]))
    out = {"layers": layers, "final_norm": map_tree(leaf, tree["final_norm"])}
    for key in ("embed", "mtp"):
        if key in tree:
            out[key] = map_tree(leaf, tree[key])
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], dev)
    return out
