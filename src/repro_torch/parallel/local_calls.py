"""Kernel calls and cache writes on DTensors.

A kernel wrapper takes plain tensors: the CUDA kernels read raw
pointers, and the plain versions reshape heads in ways DTensor's
sharding propagation does not follow (it raises on a view that splits a
sharded dim). So a kernel call that is given a DTensor runs on local
shards (``call``, reached through ``kernels/ops.pick`` on either route).
Two plain computations run there too (``maybe_local``): the plain
attention (``layers.gqa_attention``, planned as flash attention) and the
sLSTM recurrence (``xlstm.slstm_scan``: by batch, its recurrent weight
replicated), whose steps DTensor would dispatch one small op at a time:

  * every operand is redistributed to its plan, the placements the JAX
    package's ``constrain`` gives it: batch on the data axes; for
    attention, heads and KV heads on the model axis where the model
    axis divides both, else both replicated (a rank then computes every
    head, so that its query heads and KV heads match); a
    sequence-sharded cache (``cache_seq``, where the KV heads do not
    divide the model axis) is gathered along the sequence for the call,
    so decode attention moves the layer's whole K/V to every model rank
    once a step; a norm's operands keep their placements with the
    normalised (last) dim gathered; SwiGLU's ``up`` takes ``gate``'s;
    the recurrences' operands are split by batch alone;
  * the kernel (or, on the ``unfused`` route, its plain version, which
    autograd differentiates through ``to_local``/``from_local``) runs
    on the local tensors, one launch a call as on one card;
  * its output comes back as a DTensor with the plan's placements, and
    a state the kernel writes in place (the mLSTM's C, n, m, the scan's
    h) is copied back into the DTensor's own shard where the plan
    moved it.

A plain tensor among the operands stands for a replicated one (as under
``implicit_replication``). A partial sum (``Partial``) is reduced by the
redistribution. Without rules every plan is replicated.

The cache writes (``write_rows``, ``copy_into``) are in place, as on one
card: rows land in the local shard of a cache sharded by batch or heads;
a sequence-sharded cache is rewritten in its local rows wherever a
written slot falls there (a ``where`` over the local rows, no host
read).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from repro_torch.parallel import sharding as S

# attention's operands' logical axes (the JAX package's constrain of q,
# k and v)
_ATTN_Q = ("batch", None, "heads", None)
_ATTN_KV = ("batch", None, "kv_heads", None)


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def has_dtensor(args, kwargs) -> bool:
    DT = _dtensor_type()
    return any(isinstance(a, DT) for a in args) or any(
        isinstance(a, DT) for a in kwargs.values())


def _as_dtensor(x, mesh):
    """A plain tensor as a replicated DTensor (its own storage)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _local(x, pl, grad_pl=None):
    """``x`` (DTensor) redistributed to ``pl`` and its local shard; its
    gradient, where autograd takes one, has placements ``grad_pl``
    (default ``pl``)."""
    if tuple(x.placements) != tuple(pl):
        x = x.redistribute(x.device_mesh, pl)
    return x.to_local(grad_placements=grad_pl)


def _grad_placements(pl, out_pl) -> tuple:
    """An operand replicated on a mesh dim over which the call's output
    is split took part in every shard's local result: its gradient there
    is a partial sum over that dim's ranks."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Partial() if isinstance(p, Replicate) and isinstance(o, Shard)
                 else p for p, o in zip(pl, out_pl))


def _attention_plans(q, k, q_axes, kv_axes):
    """The placements of q and of k, v: heads and KV heads on their axes
    where both divide, else both replicated."""
    qp = S.logical_placements(q, *q_axes)
    kp = S.logical_placements(k, *kv_axes)
    hq, hk = q_axes.index("heads"), kv_axes.index("kv_heads")
    q_heads = [i for i, pl in enumerate(qp) if getattr(pl, "dim", -1) == hq]
    k_heads = [i for i, pl in enumerate(kp) if getattr(pl, "dim", -1) == hk]
    if q_heads != k_heads:
        q_axes = tuple(None if a == "heads" else a for a in q_axes)
        kv_axes = tuple(None if a == "kv_heads" else a for a in kv_axes)
        qp = S.logical_placements(q, *q_axes)
        kp = S.logical_placements(k, *kv_axes)
    return qp, kp


def _plan(name: str, ops: list) -> list:
    """Placements for each operand of kernel ``name`` (all DTensors)."""
    if name in ("flash_attention", "gqa_attention"):
        q, k = ops[0], ops[1]
        qp, kp = _attention_plans(q, k, _ATTN_Q, _ATTN_KV)
        # then q_positions (B, Sq), kv_valid_len (B,): by batch
        return [qp, kp, kp] + [S.logical_placements(t, "batch")
                               for t in ops[3:]]
    if name == "decode_attention":
        q, k = ops[0], ops[1]
        qp, kp = _attention_plans(q, k, ("batch", "heads", None), _ATTN_KV)
        return [qp, kp, kp, S.logical_placements(ops[3], "batch")]
    if name == "fused_rmsnorm":
        x = ops[0]
        pl = S.last_gathered(x)
        return [pl, S.logical_placements(ops[1], None)] + [pl] * (
            len(ops) - 2)
    if name == "swiglu":                       # elementwise
        from torch.distributed.tensor import Replicate, Shard
        pl = tuple(p if isinstance(p, Shard) else Replicate()
                   for p in ops[0].placements)
        return [pl, pl]
    if name == "mamba_scan":
        # u, dt, A, B, C, D, h: A (E, N) and D (E,) carry no batch
        return [S.logical_placements(t, *(("batch",) if i not in (2, 5)
                                          else (None,)))
                for i, t in enumerate(ops)]
    if name == "slstm_scan":
        # gx, rw, c, n, m, h: the recurrent weight (H, dh, 4 dh) carries
        # no batch
        return [S.logical_placements(t, *(("batch",) if i != 1
                                          else (None,)))
                for i, t in enumerate(ops)]
    if name == "fused_groupnorm":              # x; scale, bias (C,)
        return [S.logical_placements(ops[0], "batch")] + [
            S.logical_placements(t, None) for t in ops[1:]]
    # mlstm_chunk: every operand's dim 0 is the batch
    return [S.logical_placements(t, "batch") for t in ops]


# the operands each kernel writes in place (by position)
_IN_PLACE = {"mlstm_chunk": (5, 6, 7), "mamba_scan": (6,)}
# the keyword operands that are tensors, in the order ``_plan`` takes them
_TENSOR_KWARGS = {"flash_attention": ("q_positions",),
                  "gqa_attention": ("q_positions", "kv_valid_len"),
                  "fused_rmsnorm": ("residual",)}


def call(name: str, fn: Callable, args: Sequence, kwargs: Dict):
    """``fn(*args, **kwargs)`` for kernel ``name`` on the local shards of
    its DTensor operands (see the module note); returns DTensors."""
    DTensor = _dtensor_type()
    mesh = next(a for a in (*args, *kwargs.values())
                if isinstance(a, DTensor)).device_mesh
    args = list(args)
    kwargs = dict(kwargs)
    pos = [i for i, a in enumerate(args) if torch.is_tensor(a)]
    keys = [k for k in _TENSOR_KWARGS.get(name, ())
            if kwargs.get(k) is not None]
    operands = [_as_dtensor(args[i], mesh) for i in pos] + \
        [_as_dtensor(kwargs[k], mesh) for k in keys]
    plans = _plan(name, operands)
    out_pl = plans[0]
    locs = [_local(t, pl, _grad_placements(pl, out_pl))
            for t, pl in zip(operands, plans)]
    own = torch.is_grad_enabled()
    if own:
        # under grad a ``to_local`` view may not be written in place: the
        # plain version writes its own copy, copied back below
        for i in _IN_PLACE.get(name, ()):
            locs[i] = locs[i].clone()
    for i, loc in zip(pos, locs):
        args[i] = loc
    for k, loc in zip(keys, locs[len(pos):]):
        kwargs[k] = loc
    out = fn(*args, **kwargs)
    # states written in place: back into the operand's own shard (as
    # data: the call's output carries the gradient)
    for i in _IN_PLACE.get(name, ()):
        t, pl, loc = operands[i], plans[i], locs[i]
        if own or tuple(t.placements) != tuple(pl):
            with torch.no_grad():
                back = DTensor.from_local(loc, mesh, pl, run_check=False)
                t.to_local().copy_(_local(back, t.placements))

    def wrap(o):
        return DTensor.from_local(o, mesh, out_pl, run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(o) for o in out)
    return wrap(out)


def write_rows(dst, dim: int, index, src) -> None:
    """``dst.index_copy_(dim, index, src)`` in place, in ``dst``'s dtype:
    on a DTensor ``dst`` into its local shard (``src`` redistributed to
    ``dst``'s placements with ``dim`` gathered)."""
    DT = _dtensor_type()
    if not isinstance(dst, DT):
        dst.index_copy_(dim, index, src.to(dst.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    along = [isinstance(pl, Shard) and pl.dim == dim for pl in dst.placements]
    pl = tuple(Replicate() if a else p for a, p in zip(along, dst.placements))
    src_l = _local(_as_dtensor(src, mesh), pl).to(dst.dtype)
    idx = index.to_local() if isinstance(index, DT) else index
    loc = dst.to_local()
    if not any(along):
        loc.index_copy_(dim, idx, src_l)
        return
    _, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    rows = torch.arange(loc.shape[dim], device=loc.device) + offset[dim]
    match = rows[:, None] == idx[None, :]           # (local rows, S)
    hit = match.any(dim=1)
    new = src_l.index_select(dim, match.to(torch.int32).argmax(dim=1))
    shape = [1] * loc.ndim
    shape[dim] = loc.shape[dim]
    loc.copy_(torch.where(hit.view(shape), new, loc))


def copy_into(dst, src) -> None:
    """``dst.copy_(src)`` in place; on a DTensor ``dst`` into its local
    shard, ``src`` redistributed to ``dst``'s placements."""
    DT = _dtensor_type()
    if not isinstance(dst, DT):
        dst.copy_(src)
        return
    mesh = dst.device_mesh
    dst.to_local().copy_(_local(_as_dtensor(src, mesh), dst.placements))


def replicated_call(fn: Callable, *tensors):
    """``fn(*tensors)``; on a mesh (any DTensor among them) on the full
    tensors, every DTensor gathered to replicated first, and the outputs
    (a tensor or a tuple) replicated DTensors: for computations that
    need the whole batch at once (the MoE dispatch's slot counts) or
    that DTensor does not propagate (its scatter and gather)."""
    DT = _dtensor_type()
    mesh = next((t.device_mesh for t in tensors if isinstance(t, DT)), None)
    if mesh is None:
        return fn(*tensors)
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * mesh.ndim
    out = fn(*[_local(_as_dtensor(t, mesh), rep) for t in tensors])

    def wrap(o):
        return DTensor.from_local(o, mesh, rep, run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(o) for o in out)
    return wrap(out)


def maybe_local(name: str, fn: Callable) -> Callable:
    """``fn``, or on DTensor operands ``call(name, fn, ...)``."""
    def run(*args, **kwargs):
        if has_dtensor(args, kwargs):
            return call(name, fn, args, kwargs)
        return fn(*args, **kwargs)
    return run
