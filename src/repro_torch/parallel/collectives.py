"""Latency-hiding collective patterns (port of
``repro/parallel/collectives.py``), on ``torch.distributed`` over one
axis of a ``DeviceMesh``.

``allgather_matmul``: overlap the all-gather of FSDP-sharded weights
with the matmul that consumes them: the weight shards rotate around the
axis's ring (``batch_isend_irecv`` to the next rank, from the previous)
while each hop's partial product accumulates, so the full weight is
never materialised (the collective-matmul pattern).

``reduce_scatter_grads``: the mean of gradients across the axis, each
rank keeping its leading-dim shard (the ZeRO-2 path), composable with
``training/grad_compress``.

Both take each rank's local tensors (the JAX package's shard_map
bodies' view) and return plain tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import map_tree


def _axis(mesh, axis: str):
    """(size, this rank's index, process group) of mesh axis ``axis``."""
    return (mesh.size(list(mesh.mesh_dim_names).index(axis)),
            mesh.get_local_rank(axis), mesh.get_group(axis))


def ring_start(t: torch.Tensor, group, n: int, idx: int):
    """Starts sending ``t`` to the axis's next rank and receiving what
    the previous rank sends (the JAX package's ``ppermute`` over (i, i +
    1 mod n)); returns (the receive buffer, the requests to wait on)."""
    buf = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t.contiguous(),
                   dist.get_global_rank(group, (idx + 1) % n), group),
        dist.P2POp(dist.irecv, buf,
                   dist.get_global_rank(group, (idx - 1) % n), group)])
    return buf, reqs


def ring_shift(t: torch.Tensor, group, n: int, idx: int) -> torch.Tensor:
    """``t`` sent around the ring; returns what the previous rank sent."""
    if n == 1:
        return t
    buf, reqs = ring_start(t, group, n, idx)
    for r in reqs:
        r.wait()
    return buf


def allgather_matmul(x: torch.Tensor, w_shard: torch.Tensor, *, mesh,
                     axis: str) -> torch.Tensor:
    """y = x @ all_gather(w_shard, axis) without materialising the full
    w. x: (..., K), the same on every rank of ``axis``; w_shard:
    (K // n, N), this rank's row shard. At hop i a rank holds shard (idx
    - i) mod n: it multiplies that shard while the next one is in
    flight."""
    n, idx, group = _axis(mesh, axis)
    k_shard = w_shard.shape[0]
    acc = torch.zeros(x.shape[:-1] + (w_shard.shape[1],), dtype=x.dtype,
                      device=x.device)
    w = w_shard.contiguous()
    for i in range(n):
        buf, reqs = ring_start(w, group, n, idx) if i < n - 1 \
            else (None, [])
        src = (idx - i) % n
        acc = acc + x[..., src * k_shard:(src + 1) * k_shard] @ w
        for r in reqs:
            r.wait()
        if buf is not None:
            w = buf
    return acc


def reduce_scatter_grads(grads, *, mesh, axis: str):
    """The mean of ``grads`` (each rank's own tree) across ``axis``, each
    rank keeping its leading-dim shard (rows idx * L / n .. ); every
    leaf's leading dim must divide by the axis size."""
    n, _, group = _axis(mesh, axis)
    # reduce_scatter_single replaces reduce_scatter_tensor in newer torch
    reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor

    def one(g):
        if g.shape[0] % n:
            raise ValueError(f"leading dim {g.shape[0]} does not divide "
                             f"over {n} ranks of axis {axis!r}")
        out = torch.empty((g.shape[0] // n,) + tuple(g.shape[1:]),
                          dtype=g.dtype, device=g.device)
        reduce_scatter(out, g.contiguous(), op=dist.ReduceOp.SUM,
                       group=group)
        return out / n
    return map_tree(one, grads)
