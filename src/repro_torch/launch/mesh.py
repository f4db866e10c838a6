"""Production mesh builders (port of ``repro/launch/mesh.py``).

Each builds a ``DeviceMesh`` with ``init_device_mesh`` over the default
process group, which the caller starts (``torch.distributed.
init_process_group`` with its address, world size and rank): nothing on
a host tells a program of its cluster. A mesh whose size differs from
the group's raises; no builder shrinks a mesh to fit. ``device_type``
is "cuda" unless the caller asks for "cpu" (a gloo group on the CPU).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def _mesh(shape: Sequence[int], axes: Tuple[str, ...],
          device_type: Optional[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call torch."
                           "distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {tuple(shape)} {axes} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(device_type or "cuda", tuple(shape),
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data",
    "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def make_worker_mesh(tp: int = 1, device_type: Optional[str] = None):
    """Serving-cluster worker slice: (n // tp, tp) ("data", "model") over
    the n visible CUDA cards (over the group's ranks on the CPU)."""
    import torch.distributed as dist
    if (device_type or "cuda") == "cuda":
        n = torch.cuda.device_count()
    else:
        n = dist.get_world_size() if dist.is_initialized() else 1
    if n < 1:
        raise RuntimeError("no CUDA card for a worker mesh")
    tp = min(tp, n)
    return _mesh((n // tp, tp), ("data", "model"), device_type)
