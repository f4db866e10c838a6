"""Kernel calls and cache writes on DTensors.

A kernel wrapper takes plain tensors: the CUDA kernels read raw
pointers, and the plain versions reshape heads in ways DTensor's
sharding propagation does not follow (it raises on a view that splits a
sharded dim). So a kernel call that is given a DTensor runs on local
shards (``call``, reached through ``kernels/ops.pick`` on either route).
Two plain computations run there too (``maybe_local``): the plain
attention (``layers.gqa_attention``, planned as flash attention) and the
sLSTM recurrence (``xlstm.slstm_scan``), whose steps DTensor would
dispatch one small op at a time:

  * every operand is redistributed to its plan: batch on the data axes,
    as the JAX package's ``constrain`` gives it; a norm's operands keep
    their placements with the normalised (last) dim gathered; SwiGLU's
    ``up`` takes ``gate``'s; the selective scan's operands are split by
    batch alone, the xLSTM recurrences' as below;
  * the kernel (or, on the ``unfused`` route, its plain version, which
    autograd differentiates through ``to_local``/``from_local``) runs
    on the local tensors, one launch a call as on one card;
  * its output comes back as a DTensor with the plan's placements (the
    first operand's), and a state the kernel writes in place (the
    mLSTM's C, n, m, the scan's h) is copied back into the DTensor's own
    shard where the plan moved it.

Attention (``_attention``) splits the work over the model axis as the
JAX package's ``gqa_attention`` does (it repeats the KV heads to the
query heads, so that the heads split, and leaves the scores over a
sequence-sharded cache unsplit), in this order:

  * heads and KV heads both divide the model axis: both split by heads;
  * decode (``decode_attention``) over a cache the sequence split lays
    out (``cache_seq``, where the KV heads do not divide): q whole on
    the model axis, the cache kept split; each rank attends over its own
    rows (``valid_len`` shifted by its row offset and clipped to its
    rows) and returns its output and log-sum-exp, which three small
    all-reduces over the model axis join (``ref.combine_partials``): no
    cache gather;
  * the query heads divide and the KV heads do not: q split by heads,
    K/V whole on the model axis, and each rank index-selects the KV
    heads its query heads read (query head h reads KV head h // G): one
    where its heads lie in one group (local G its head count), its
    groups' where they fall in whole groups (local G = G), else one per
    query head (local G 1). Their gradient is a partial sum over the
    model axis, into which the selection's backward adds. A prompt
    chunk over a sequence-sharded cache gathers the cache first;
  * fresh K/V (``flash_attention`` without ``kv_len`` or ``q_offset``,
    ``gqa_attention`` without ``kv_valid_len``, as many keys as queries)
    whose query rows divide the model axis: q and its positions split by
    rows, K/V whole; a call without positions (the slots' mask) is given
    ``arange(S)``, so each rank's call is the same function of its
    shard; the output comes back split by rows, and the output
    projection (``layers.merge_heads``) multiplies each rank's own rows
    (``rows_product``, a local product with the weight gathered), as
    XLA computes the JAX package's under its sequence split;
  * anything else keeps the replicated plan: q and K/V whole on the
    model axis, every rank computing every head. That is a prompt chunk
    over a cache (``kv_len``, ``q_offset``, ``kv_valid_len``: a
    sequence-sharded cache is gathered for it) whose query heads do not
    divide; decode over a cache left whole (its length does not divide
    the model axis) whose query heads do not divide; fresh K/V whose
    heads and rows do not divide; and ``gqa_attention`` at one query
    over a cache, which no path calls (a decode step takes
    ``decode_attention`` on both routes). On a model axis of one rank
    every call takes this plan or the first, as on one card.

The xLSTM recurrences split over the model axis as the JAX package's
compiled step splits them. Its per-device HLO for xlstm-125m at one
period (6 layers; 16 x 16, the same on 2 x 16 x 16 at half the batch),
B the rank's batch (8 at ``decode_32k``, 2 at ``prefill_32k``, 16 at
``train_4k``, 1 at ``long_500k``):

  * the mLSTM scan's carry is C f32[B,1,384,96], n f32[B,1,96], m
    f32[B,1]: the 16-way model axis splits the flattened E = H dv into
    4 heads x 4 slices of the value columns, and n's dk over a head's 4
    ranks. Each step all-gathers q and k f32[B,1,384] within the head's
    ranks and all-reduces q . n f32[B,1] over them. Afterwards the new
    state is all-gathered back into the cache's replicated layout, C in
    two stages (f32[1,B,1,384,384] over the value columns, then
    f32[1,B,4,384,384] over the heads), n likewise, m f32[1,B,4]. The
    projections' inputs xc and xb are all-gathered f32[B,S,1536]; the
    output projection's partial sum is all-reduced f32[B,S,768]; the up
    projection's halves are moved between ranks (collective-permutes).
    At ``long_500k`` (batch 1, the data axis idle) q, k, v's projections
    contract over the data axis too (96 of 1536 a rank, all-reduced over
    it), and so does the read-out (24 of dk);
  * the sLSTM scan's carry is c, n, m, h f32[B,48] each (D = 768 split
    16 ways: a head's 192 hidden units over its 4 ranks), with the gate
    inputs f32[S,B,192] and the recurrent weight f32[1,192,192] (each
    gate's 48 columns); each step all-gathers h f32[B,1,192] within the
    head's ranks, and the states are all-gathered back f32[1,B,768]. The
    up projection contracts the split units into a partial sum,
    all-reduced f32[B,S,1024], and the down projection runs whole.

The plans (``_mlstm``, ``_mlstm_columns``, ``_slstm``):

  * the mLSTM, q, k, v with their heads folded ((B, T, H d)). Where each
    rank's share of v's columns E (split over the model axis M) is whole
    heads (H % M == 0), every operand is split by heads. Where it is one
    head's dv H / M columns (M % H == 0, dk divisible by the M / H ranks
    of a head: xlstm-125m's 4 heads on 16, dk = dv = 384), a rank gets
    v's and C's columns of its share, q, k and the gates gathered whole
    on the model axis with its head selected locally, and n and m its
    head's whole (computed again on each of its head's ranks). The
    kernel (or its plain version) runs once on contiguous copies of the
    state slices, and the new C, n, m are joined back over the model
    axis (C by columns, n by a 1 / (M / H) slice of dk a rank, m from
    one rank a head) into the cache's own layout. h comes back split by
    columns, so the output projection contracts a split E into a partial
    sum. Unlike XLA's step the kernel reads n whole and q, k once for
    the call. Anything else (a model axis of one rank, a split across
    heads) keeps the batch-only plan;
  * the sLSTM, the gate product inside the call. Where the model axis
    splits the hidden units D (Dl a rank) so that each gate's share lies
    in one head's recurrent outputs, each rank computes the same Dl
    units of every gate: the gate product with its (D, 4 Dl) columns of
    the gathered weight, the states and the output split by units, and
    at each step one all-gather of h over the model axis (a
    reduce-scatter in the backward) for the recurrent product of its 4
    gates' (dh, Dl) columns. Otherwise it runs by batch alone.

An embedding lookup into a table whose rows (the vocabulary) a mesh dim
splits (``vocab_parallel_embedding``) runs on each rank's own rows with
the tokens split by batch: no rank looks up the whole batch, and the
table's gradient is each rank's own rows.

The cross entropy's log-sum-exp and label pick (``vocab_parallel_ce``)
run on each rank's own logits, vocabulary slice and all: the max, the
sum of exponentials and the picked label logit (each rank picks the
labels that fall in its slice, at the slice's offset, and 0 for the
rest) are reduced over the mesh dims that split the vocabulary, three
all-reduces of one value a token. Nothing gathers the vocabulary.

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

from repro_torch.kernels import ref
from repro_torch.parallel import sharding as S

# attention's operands' logical axes (the JAX package's constrain of q,
# k and v; decode's q has no sequence dim), and the cache's under the
# sequence split
_ATTN_Q = ("batch", None, "heads", None)
_DECODE_Q = ("batch", "heads", None)
_ATTN_KV = ("batch", None, "kv_heads", None)
_CACHE_SEQ = ("batch", "cache_seq", None, None)
_ATTENTION = ("flash_attention", "gqa_attention", "decode_attention")


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def has_dtensor(args, kwargs) -> bool:
    DT = _dtensor_type()
    return any(isinstance(a, DT) for a in args) or any(
        isinstance(a, DT) for a in kwargs.values())


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


def _split_dims(pl, dim: int) -> list:
    """The mesh dims on which placements ``pl`` split tensor dim ``dim``."""
    return [i for i, p in enumerate(pl) if getattr(p, "dim", -1) == dim]


def _leading(pl, ndim: int) -> tuple:
    """Placements ``pl`` for a tensor that holds only the first ``ndim``
    dims of the planned one (positions (B, Sq) of q, lengths (B,))."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim < ndim else Replicate()
                 for p in pl)


def _kv_heads_read(q, qp, hq: int, kv_heads: int):
    """The KV heads that this rank's query heads read (q split by heads
    under ``qp``, its head dim ``hq``), as an index tensor: one for heads
    within one group, the groups for heads in whole groups, else one per
    query head. The count is the same on every rank."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, offset = compute_local_shape_and_global_offset(
        q.shape, q.device_mesh, qp)
    n, h0 = local[hq], offset[hq]
    G = q.shape[hq] // kv_heads
    if G % n == 0:
        idx = [h0 // G]
    elif n % G == 0:
        idx = list(range(h0 // G, (h0 + n) // G))
    else:
        idx = [h // G for h in range(h0, h0 + n)]
    return torch.tensor(idx, dtype=torch.int64, device=q.to_local().device)


def _fresh(name: str, q, k, kwargs) -> bool:
    """Attention over fresh K/V: as many keys as queries, no cache mask."""
    if q.shape[1] != k.shape[1] or kwargs.get("kv_valid_len") is not None:
        return False
    return name == "gqa_attention" or (kwargs.get("kv_len") is None
                                       and not kwargs.get("q_offset"))


def _attention(name: str, fn: Callable, mesh, args: list, kwargs: dict):
    """``call`` for attention: the plans of the module note."""
    decode = name == "decode_attention"
    q, k = (S.as_replicated(t, mesh) for t in args[:2])
    q_axes = _DECODE_Q if decode else _ATTN_Q
    hq = q_axes.index("heads")
    qp = S.logical_placements(q, *q_axes)
    kp = S.logical_placements(k, *_ATTN_KV)
    q_heads = _split_dims(qp, hq)
    if q_heads and q_heads == _split_dims(kp, 2):
        return _run_attention(fn, mesh, args, kwargs, qp, kp)
    kp = S.logical_placements(k, "batch", None, None, None)
    whole_q = S.logical_placements(q, *(a if a == "batch" else None
                                        for a in q_axes))
    if decode:
        cp = S.logical_placements(k, *_CACHE_SEQ)
        if _split_dims(cp, 1):
            return _decode_over_rows(fn, mesh, args, whole_q, cp)
    if q_heads:
        return _run_attention(fn, mesh, args, kwargs, qp, kp,
                              select=_kv_heads_read(q, qp, hq, k.shape[2]))
    if not decode and _fresh(name, q, k, kwargs):
        rows = S.logical_placements(q, "batch", "heads", None, None)
        if _split_dims(rows, 1):
            if kwargs.get("q_positions") is None:
                B, Sq = q.shape[:2]
                kwargs["q_positions"] = torch.arange(
                    Sq, dtype=torch.int32,
                    device=q.to_local().device).expand(B, Sq)
            return _run_attention(fn, mesh, args, kwargs, rows, kp)
    return _run_attention(fn, mesh, args, kwargs, whole_q, kp)


def _run_attention(fn: Callable, mesh, args: list, kwargs: dict, qp, kp,
                   select=None):
    """``fn`` on local shards: q (and the output) under ``qp``, K/V under
    ``kp`` with the KV heads ``select`` taken locally where given, the
    positions and lengths under ``qp``'s batch (and row) split."""
    from torch.distributed.tensor import DTensor
    keys = [k for k in ("q_positions", "kv_valid_len")
            if kwargs.get(k) is not None]
    operands = [S.as_replicated(t, mesh) for t in args] + \
        [S.as_replicated(kwargs[k], mesh) for k in keys]
    plans = [qp, kp, kp] + [_leading(qp, t.ndim) for t in operands[3:]]
    locs = [_local(t, pl, _grad_placements(pl, qp))
            for t, pl in zip(operands, plans)]
    if select is not None:
        locs[1] = locs[1].index_select(2, select)
        locs[2] = locs[2].index_select(2, select)
    kwargs.update(zip(keys, locs[len(args):]))
    out = fn(*locs[:len(args)], **kwargs)
    return DTensor.from_local(out, mesh, qp, run_check=False)


def _decode_over_rows(fn: Callable, mesh, args: list, qp, cp):
    """Decode attention over a sequence-sharded cache (under ``cp``):
    each rank over its own rows, its output and log-sum-exp joined by
    all-reduces over the mesh dims that split the rows."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    q, k, v, vl = (S.as_replicated(t, mesh) for t in args)
    k_l, v_l = _local(k, cp), _local(v, cp)
    _, offset = compute_local_shape_and_global_offset(k.shape, mesh, cp)
    vl_l = (_local(vl, _leading(qp, 1)) - offset[1]).clamp(
        0, k_l.shape[1]).to(torch.int32)
    o, lse = fn(_local(q, qp), k_l, v_l, vl_l, with_lse=True)
    dims = _split_dims(cp, 1)

    def over(op):
        def reduce(t):
            for d in dims:
                t = funcol.all_reduce(t, op, (mesh, d))
            return t
        return reduce
    o = ref.combine_partials(o, lse, over("max"), over("sum"))
    return DTensor.from_local(o, mesh, qp, run_check=False)


def _plan(name: str, ops: list) -> list:
    """Placements for each operand of kernel ``name`` (all DTensors)."""
    if name == "rows_product":                 # x (B, S, K) as it is, w
        from torch.distributed.tensor import Replicate
        return [tuple(ops[0].placements),
                (Replicate(),) * ops[1].device_mesh.ndim]
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
    if name == "fused_groupnorm":              # x; scale, bias (C,)
        return [S.logical_placements(ops[0], "batch")] + [
            S.logical_placements(t, None) for t in ops[1:]]
    # the recurrences' batch-only plans: every operand's dim 0 is the
    # batch
    return [S.logical_placements(t, "batch") for t in ops]


# the operands each kernel writes in place (by position)
_IN_PLACE = {"mlstm_chunk": (5, 6, 7), "mamba_scan": (6,)}
# the keyword operands that are tensors, in the order ``_plan`` takes them
_TENSOR_KWARGS = {"fused_rmsnorm": ("residual",)}


def call(name: str, fn: Callable, args: Sequence, kwargs: Dict):
    """``fn(*args, **kwargs)`` for kernel ``name`` on the local shards of
    its DTensor operands (see the module note); returns DTensors."""
    DTensor = _dtensor_type()
    mesh = next(a for a in (*args, *kwargs.values())
                if isinstance(a, DTensor)).device_mesh
    args = list(args)
    kwargs = dict(kwargs)
    if name in _ATTENTION:
        return _attention(name, fn, mesh, args, kwargs)
    if name == "mlstm_chunk":
        return _mlstm(fn, mesh, args)
    if name == "slstm_scan":
        return _slstm(fn, mesh, args)
    return _run(name, fn, mesh, args, kwargs)


def _run(name: str, fn: Callable, mesh, args: list, kwargs: dict,
         plans=None):
    """``call``'s common case: each tensor operand under its plan
    (``plans``, by default ``_plan``'s), the output under the first's."""
    from torch.distributed.tensor import DTensor
    pos = [i for i, a in enumerate(args) if torch.is_tensor(a)]
    keys = [k for k in _TENSOR_KWARGS.get(name, ())
            if kwargs.get(k) is not None]
    operands = [S.as_replicated(args[i], mesh) for i in pos] + \
        [S.as_replicated(kwargs[k], mesh) for k in keys]
    if plans is None:
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


def _mlstm(fn: Callable, mesh, args: list):
    """``call`` for the mLSTM recurrence, q, k, v with their heads folded
    ((B, T, H d)), then i_pre, f_pre (B, T, H) and the state C, n, m: the
    plans of the module note."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    args = [S.as_replicated(t, mesh) for t in args]
    v, C = args[2], args[5]
    dk, dv = C.shape[2], C.shape[3]
    vp = S.logical_placements(v, "batch", None, "heads")
    dims = _split_dims(vp, 2)
    if dims:
        local, offset = compute_local_shape_and_global_offset(v.shape, mesh,
                                                              vp)
        El, e0 = local[2], offset[2]
        if El % dv == 0:                    # whole heads a rank
            axes = [("batch", None, "heads")] * 5 + [("batch", "heads")] * 3
            return _run("mlstm_chunk", fn, mesh, args, {},
                        [S.logical_placements(t, *a)
                         for t, a in zip(args, axes)])
        if dv % El == 0 and dk % (dv // El) == 0:
            return _mlstm_columns(fn, mesh, args, vp, dims, e0, El)
    return _run("mlstm_chunk", fn, mesh, args, {},
                [S.logical_placements(t, "batch") for t in args])


def _mlstm_columns(fn: Callable, mesh, args: list, vp, dims, e0: int,
                   El: int):
    """The mLSTM on this rank's ``El`` value columns of one head (from
    column ``e0`` of the flattened E, split under ``vp`` over the mesh
    dims ``dims``): the column plan of the module note."""
    from torch.distributed.tensor import DTensor
    q, k, v, ip, fp, C, n, m = args
    H, dk, dv = C.shape[1], C.shape[2], C.shape[3]
    head, c0 = divmod(e0, dv)
    R = dv // El                            # ranks a head
    r = c0 // El                            # this rank's place in its head
    bp = S.logical_placements(C, "batch")   # batch only: Shard(0) on data

    def of_head(t, size):
        """``t`` whole on the model axis, its head's ``size`` columns."""
        gp = _grad_placements(bp, vp)
        return _local(t, bp, gp).narrow(-1, head * size, size)

    C_l = copied_slice(_local(C, bp), (1, head, 1), (3, c0, El))
    n_l = copied_slice(_local(n, bp), (1, head, 1))
    m_l = copied_slice(_local(m, bp), (1, head, 1))
    h = fn(of_head(q, dk), of_head(k, dk), _local(v, vp), of_head(ip, 1),
           of_head(fp, 1), C_l, n_l, m_l)
    with torch.no_grad():
        Bl = C_l.shape[0]
        Cf = _join(C_l.reshape(Bl, dk, El), mesh, bp, dims, 2) \
            .view(Bl, dk, H, dv).permute(0, 2, 1, 3)
        cut = dk // R
        nf = _join(n_l.reshape(Bl, dk)[:, r * cut:(r + 1) * cut], mesh, bp,
                   dims, 1).view(Bl, H, dk)
        mf = _join(m_l, mesh, bp, dims, 1).view(Bl, H, R)[..., 0]
        for t, full in ((C, Cf), (n, nf), (m, mf)):
            back = DTensor.from_local(full, mesh, bp, run_check=False)
            t.to_local().copy_(_local(back, t.placements))
    return DTensor.from_local(h, mesh, vp, run_check=False)


def copied_slice(t, *narrows):
    """A contiguous copy of the plain tensor ``t`` narrowed by each (dim,
    start, size): the state slice the mLSTM's column plan hands the
    kernel, which writes it in place."""
    for dim, start, size in narrows:
        t = t.narrow(dim, start, size)
    return t.clone(memory_format=torch.contiguous_format)


def _join(piece, mesh, bp, dims, dim: int):
    """This rank's ``piece`` and the other model ranks' (over the mesh
    dims ``dims``, in rank order) joined along ``dim``; the batch keeps
    its placements ``bp``: one all-gather."""
    from torch.distributed.tensor import DTensor, Shard
    pl = tuple(Shard(dim) if i in dims else p for i, p in enumerate(bp))
    return _local(DTensor.from_local(piece, mesh, pl, run_check=False), bp)


class _GatherUnits(torch.autograd.Function):
    """(B, L) on each of the ``n`` ranks of process group ``group`` ->
    (B, n L), the ranks' in order: one all-gather; the backward takes
    each rank's (B, L) of the summed gradient, one reduce-scatter. The
    functional collectives themselves: a DTensor redistribution a step
    would cost the sLSTM's loop several times their host time."""

    @staticmethod
    def forward(ctx, x, n: int, group: str):
        ctx.n, ctx.group = n, group
        c10d = torch.ops._c10d_functional
        out = c10d.wait_tensor(c10d.all_gather_into_tensor(
            x.contiguous(), n, group))
        return out.view(n, *x.shape).movedim(0, 1).reshape(x.shape[0], -1)

    @staticmethod
    def backward(ctx, grad):
        c10d = torch.ops._c10d_functional
        B = grad.shape[0]
        parts = grad.reshape(B, ctx.n, -1).movedim(1, 0).reshape(
            ctx.n * B, -1)
        return c10d.wait_tensor(c10d.reduce_scatter_tensor(
            parts, "sum", ctx.n, ctx.group)), None, None


def _slstm(fn: Callable, mesh, args: list):
    """``call`` for the sLSTM recurrence (``xlstm.slstm_scan``: x, the
    gate weight and bias, the recurrent weight, then the states c, n, m,
    h): the plans of the module note."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    args = [S.as_replicated(t, mesh) for t in args]
    x, w, b, rw, c = args[:5]
    D = c.shape[1]
    dh = rw.shape[1]
    xp = S.logical_placements(x, "batch")
    whole = [S.logical_placements(t, None) for t in (w, b, rw)]
    up = S.logical_placements(c, "batch", "heads")
    dims = _split_dims(up, 1)
    if len(dims) == 1:
        local, offset = compute_local_shape_and_global_offset(c.shape, mesh,
                                                              up)
        Dl, u0 = local[1], offset[1]
        if all((g * D + u0) // (4 * dh) == (g * D + u0 + Dl - 1) // (4 * dh)
               for g in range(4)):
            yp = tuple(Shard(2) if i in dims else p
                       for i, p in enumerate(xp))
            group = mesh.get_group(dims[0]).group_name

            def gather(hl):
                """(B, Dl) of each rank -> the whole (B, D)."""
                return _GatherUnits.apply(hl, D // Dl, group)
            wl, bl, rwl = (_local(t, pl, _grad_placements(pl, yp))
                           for t, pl in zip((w, b, rw), whole))
            out = fn(_local(x, xp, _grad_placements(xp, yp)), wl, bl, rwl,
                     *(_local(t, up) for t in args[4:]), units=(u0, Dl),
                     gather=gather)
            return (DTensor.from_local(out[0], mesh, yp, run_check=False),
                    *(DTensor.from_local(t, mesh, up, run_check=False)
                      for t in out[1:]))
    return _run("slstm_scan", fn, mesh, args, {},
                [xp, *whole] + [S.logical_placements(t, "batch")
                                for t in args[4:]])


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
    src_l = _local(S.as_replicated(src, mesh), pl).to(dst.dtype)
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
    dst.to_local().copy_(_local(S.as_replicated(src, mesh), dst.placements))


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
    out = fn(*[_local(S.as_replicated(t, mesh), rep) for t in tensors])

    def wrap(o):
        return DTensor.from_local(o, mesh, rep, run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(o) for o in out)
    return wrap(out)


def vocab_parallel_embedding(tokens, table):
    """``F.embedding(tokens, table)`` for DTensor tokens and a table (V,
    D) whose rows (the vocabulary) a mesh dim splits, its embedding dim
    whole (``layers.lookup`` gathers it), on local shards: each rank
    looks up the tokens that fall in its rows, at its rows' offset, and
    0 for the rest; the output keeps the tokens' split and is a partial
    sum over the mesh dims that split the vocabulary (the next layout
    reduces it). The table's gradient is each rank's own rows (a partial
    sum over the mesh dims that split the tokens)."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    tp = tuple(table.placements)
    vdims = _split_dims(tp, 0)
    tokens = S.as_replicated(tokens, mesh)
    kp = tuple(Replicate() if i in vdims else p
               for i, p in enumerate(tokens.placements))
    out_pl = tuple(Partial() if i in vdims else p for i, p in enumerate(kp))
    tab = _local(table, tp, _grad_placements(tp, kp))
    tok = _local(tokens, kp)
    _, offset = compute_local_shape_and_global_offset(table.shape, mesh, tp)
    at = tok.long() - offset[0]
    hit = (at >= 0) & (at < tab.shape[0])
    rows = F.embedding(at.clamp(0, tab.shape[0] - 1), tab)
    rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    return DTensor.from_local(rows, mesh, out_pl, run_check=False)


def vocab_split(x, dim: int = -1) -> bool:
    """Whether ``x`` is a DTensor whose dim ``dim`` (the vocabulary: the
    logits' last, an embedding table's first) a mesh dim splits."""
    return isinstance(x, _dtensor_type()) and bool(
        _split_dims(x.placements, dim % x.ndim))


def vocab_parallel_ce(lg, labels):
    """(lse, ll) of float32 logits ``lg`` (a DTensor (..., V) whose
    vocabulary a mesh dim splits, ``vocab_split``) and int ``labels``
    (...): ``logsumexp(lg, -1)`` in its max-shifted form and the label's
    logit, on each rank's own shard of ``lg`` (a partial sum reduced
    first), reduced over the mesh dims that split the vocabulary (see
    the module note). Both come back as DTensors with ``lg``'s leading
    placements; the labels are laid out to match."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = lg.device_mesh
    v = lg.ndim - 1
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in lg.placements)
    lead = _leading(pl, v)
    vdims = _split_dims(pl, v)
    lg_l = _local(lg, pl)
    lab = _local(S.as_replicated(labels, mesh), lead).long()
    _, offset = compute_local_shape_and_global_offset(lg.shape, mesh, pl)
    n = lg_l.shape[-1]
    m = lg_l.detach().amax(dim=-1)
    for d in vdims:
        m = funcol.all_reduce(m, "max", (mesh, d))
    # as logsumexp: a row whose max is infinite is shifted by 0
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    sumexp = torch.exp(lg_l - m[..., None]).sum(dim=-1)
    at = lab - offset[v]
    hit = (at >= 0) & (at < n)
    pick = torch.gather(lg_l, -1, at.clamp(0, n - 1)[..., None])[..., 0]
    pick = torch.where(hit, pick, torch.zeros_like(pick))
    part = tuple(Partial() if i in vdims else p for i, p in enumerate(lead))

    def reduced(t):
        return DTensor.from_local(t, mesh, part, run_check=False) \
            .redistribute(mesh, lead)
    lse = DTensor.from_local(m, mesh, lead, run_check=False) \
        + torch.log(reduced(sumexp))
    return lse, reduced(pick)


def split_by_rows(x) -> bool:
    """Whether ``x`` is a DTensor split on dim 1: attention's output under
    the row plan."""
    return isinstance(x, _dtensor_type()) and bool(
        _split_dims(x.placements, 1))


def rows_product(x, w):
    """``x @ w`` for an ``x`` (B, S, K) split by rows (and batch), on
    each rank's own rows with ``w`` (K, N) whole (gathered); the output
    keeps ``x``'s placements, and ``w``'s gradient is a partial sum over
    the mesh dims that split ``x``."""
    return call("rows_product", torch.matmul, (x, w), {})


def maybe_local(name: str, fn: Callable) -> Callable:
    """``fn``, or on DTensor operands ``call(name, fn, ...)``."""
    def run(*args, **kwargs):
        if has_dtensor(args, kwargs):
            return call(name, fn, args, kwargs)
        return fn(*args, **kwargs)
    return run
