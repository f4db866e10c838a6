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

  * every operand is redistributed to its plan: batch on the data axes,
    as the JAX package's ``constrain`` gives it; a norm's operands keep
    their placements with the normalised (last) dim gathered; SwiGLU's
    ``up`` takes ``gate``'s; the recurrences' operands are split by
    batch alone;
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
    pos = [i for i, a in enumerate(args) if torch.is_tensor(a)]
    keys = [k for k in _TENSOR_KWARGS.get(name, ())
            if kwargs.get(k) is not None]
    operands = [S.as_replicated(args[i], mesh) for i in pos] + \
        [S.as_replicated(kwargs[k], mesh) for k in keys]
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
