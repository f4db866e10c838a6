"""GPipe-style pipeline parallelism (port of
``repro/parallel/pipeline.py``), with point-to-point sends over one axis
of a ``DeviceMesh``.

Each rank of the ``stage`` axis runs one stage; microbatches stream
through the ring, activations hop stage -> stage + 1 each tick. Total
ticks = n_micro + n_stages - 1; bubble fraction = (n_stages - 1) /
ticks. ``torch.distributed.pipelining`` is not used: it takes
``nn.Module`` stages, and a stage here is a function of (params, x).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import _axis, ring_shift
from repro_torch.tree import map_tree


def run_pipeline(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
                 *, mesh, axis: str = "stage") -> torch.Tensor:
    """stage_fn(params_i, x) -> x, applied by every stage in sequence.

    stage_params: a tree with leading axis n_stages (stage i's params,
    the same on every rank; rank i takes slice i). microbatches:
    (n_micro, ...), the same on every rank (outputs of the same shape).
    Returns (n_micro, ...) outputs after all stages, on every rank: at
    tick t stage s runs microbatch t - s (stage 0 feeds it, the others
    take what stage s - 1 sent), the last stage records, and the outputs
    are summed over the ring."""
    n_stages, sid, group = _axis(mesh, axis)
    n_micro = microbatches.shape[0]
    params = map_tree(lambda a: a[sid], stage_params)
    buf = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(n_micro + n_stages - 1):
        mb = t - sid
        y = torch.zeros_like(buf)
        if 0 <= mb < n_micro:
            y = stage_fn(params, microbatches[mb] if sid == 0 else buf)
            if sid == n_stages - 1:
                outs[mb] = y
        buf = ring_shift(y, group, n_stages, sid)
    if n_stages > 1:
        dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs
