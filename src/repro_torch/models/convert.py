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
    conv rule must never see them: ``from_jax`` sends an LM subtree to
    ``lm_from_jax`` when it is given the model's config, and refuses it
    otherwise. ``lm_to_jax`` is its exact inverse: the per-layer list
    stacked back into ``"prefix"`` and ``"scan"`` (``to_jax`` does the
    same with ``cfg``, so LM checkpoints are written through it). Any
    tree of the parameters' structure converts, so AdamW's moments and
    8-bit scales do too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import map_tree

_LM_KEYS = ("scan", "embed")


def _tensor(arr, device) -> torch.Tensor:
    if torch.is_tensor(arr):
        return arr.detach().clone().to(device)
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


def _is_jax_lm(node) -> bool:
    return isinstance(node, dict) and "scan" in node


def _is_port_lm(node) -> bool:
    return isinstance(node, dict) and "layers" in node


def _lm_cfg(cfg):
    if cfg is None:
        raise ValueError("an LM parameter tree: its 4-D leaves are not "
                         "conv weights; pass its ModelConfig (cfg=...) "
                         "or use lm_from_jax / lm_to_jax")
    return cfg


def _refuse_lm(tree, cfg) -> None:
    if cfg is None and isinstance(tree, dict) and any(
            k in tree for k in _LM_KEYS):
        _lm_cfg(cfg)


def from_jax(tree, device: DeviceLike = None, cfg: ModelConfig = None):
    """A JAX UNet or discriminator parameter tree (leaves anything
    ``np.asarray`` takes, or CPU tensors) as the port's nested dict of
    tensors on ``device`` (CUDA unless the caller passes "cpu"). Each LM
    subtree (a dict with ``"scan"``) goes through ``lm_from_jax`` with
    ``cfg``, so an LM's ``(params, opt_state)`` converts whole; without
    ``cfg`` an LM tree raises."""
    _refuse_lm(tree, cfg)
    dev = resolve_device(device)

    def leaf(x):
        if _is_jax_lm(x):
            return lm_from_jax(x, _lm_cfg(cfg), dev)
        return hwio_to_oihw(_tensor(x, "cpu")).contiguous().to(dev)
    return map_tree(leaf, tree, is_leaf=_is_jax_lm)


def to_jax(tree, cfg: ModelConfig = None):
    """The exact inverse of ``from_jax``: the port's tree in the JAX
    package's layout (conv weights OIHW -> HWIO, a depthwise
    ``(mid,1,3,3)`` -> ``(3,3,1,mid)``; each LM subtree, a dict with
    ``"layers"``, stacked by ``lm_stack`` with ``cfg``), leaves as
    contiguous CPU tensors (``np.asarray`` of one gives the array
    ``from_jax`` took; a bfloat16 leaf stays a tensor, since numpy has
    no bfloat16 without ``ml_dtypes``). Without ``cfg`` an LM tree
    raises."""
    _refuse_lm(tree, cfg)

    def leaf(x):
        if _is_port_lm(x):
            return lm_stack(x, _lm_cfg(cfg))
        return oihw_to_hwio(torch.as_tensor(x).detach().cpu()).contiguous()
    return map_tree(leaf, tree, is_leaf=_is_port_lm)


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
            layers.append(map_tree(lambda a: _tensor(a[j], dev),
                                   tree["scan"][f"b{i}"]))
    out = {"layers": layers, "final_norm": map_tree(leaf, tree["final_norm"])}
    for key in ("embed", "mtp"):
        if key in tree:
            out[key] = map_tree(leaf, tree[key])
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], dev)
    return out


def lm_stack(tree, cfg: ModelConfig):
    """The port's LM tree (or any tree of its structure) in the JAX
    package's layout, leaves as contiguous CPU tensors: layers
    ``cfg.prefix_pattern`` under ``"prefix"``, then each period's block i
    stacked over the periods under ``"scan"["b<i>"]``."""
    layers = tree["layers"]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers for a config of "
                         f"{cfg.num_layers}")

    def cpu(t):
        return torch.as_tensor(t).detach().cpu().contiguous()
    n_pre, period = len(cfg.prefix_pattern), len(cfg.period_pattern)
    out = {key: map_tree(cpu, tree[key]) for key in tree if key != "layers"}
    out["prefix"] = [map_tree(cpu, p) for p in layers[:n_pre]]
    out["scan"] = {
        f"b{i}": map_tree(lambda *xs: torch.stack([cpu(x) for x in xs]),
                          *layers[n_pre + i::period])
        for i in range(period)}
    return out


def _numpy(t: torch.Tensor):
    return t if t.dtype == torch.bfloat16 else t.numpy()


def lm_to_jax(tree, cfg: ModelConfig):
    """The exact inverse of ``lm_from_jax``: the port's ``{"embed"?,
    "layers", "final_norm", "lm_head"?, "mtp"?}`` as the JAX package's
    ``{"embed"?, "prefix", "scan", "final_norm", "lm_head"?, "mtp"?}``,
    leaves numpy arrays (a bfloat16 leaf stays a CPU tensor, since numpy
    has no bfloat16 without ``ml_dtypes``)."""
    return map_tree(_numpy, lm_stack(tree, cfg))
