"""Logical-axis sharding (port of ``repro/parallel/sharding.py``).

Models annotate activations with *logical* axis names (``constrain``);
a rules table maps them to mesh axes. Without rules every annotation is
a no-op, as in the JAX package.

PyTorch has no ``PartitionSpec``: ``PartitionSpec`` here is an immutable
tuple with one entry per tensor dim, each a mesh-axis name, ``None`` or
a tuple of names, equal to the JAX package's entry for entry.
``placements`` turns one on a ``DeviceMesh`` into DTensor placements:
``Shard(d)`` on every mesh dim that entry d names, ``Replicate()``
elsewhere. A dim split over two mesh axes (``("data", "model")``, the
serving ``experts`` rule; ``("pod", "data")`` on the multi-pod mesh) is
split major axis first, as JAX splits it: DTensor shards one tensor dim
over several mesh dims in mesh-dim order, so an entry must name its
axes in the mesh's order (every rule table here does; another order
raises).

Usage:
    with sharding_rules(RULES_TP, mesh):
        y = forward(...)         # constrain() calls inside take effect

With rules and a mesh, ``constrain`` redistributes a DTensor to the
rules' placements (with the JAX package's divisibility fallback: a dim
its axes do not divide is replicated, see ``safe_spec``); a plain tensor
passes unchanged, with or without a mesh.

DTensor refuses some views that XLA reshards through: folding (B, S)
with S split (torch 2.11), and splitting a dim whose mesh split does not
divide the parts. ``foldable`` and ``splittable`` gather such a dim
ahead of the view; ``splittable_grad``, ``foldable_grad`` and
``placed_grad`` are identities whose backward lays the gradient out so
that the view's backward can take it (DTensor's implicit
redistributions inside an op are not autograd nodes, so a gradient comes
back in whatever layout the op's backward chose).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, ``None``
    (replicated) or a tuple of names (split over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _current_rules() -> Optional[Mapping[str, MeshAxes]]:
    return getattr(_state, "rules", None)


def _current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def sharding_rules(rules: Mapping[str, MeshAxes], mesh=None):
    prev = (_current_rules(), _current_mesh())
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def logical_to_pspec(logical_axes: Sequence[Optional[str]],
                     rules: Mapping[str, MeshAxes]) -> P:
    return P(*[rules.get(a) if a is not None else None for a in logical_axes])


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def safe_spec(spec, shape: Sequence[int], sizes: Mapping[str, int]) -> P:
    """``spec`` cut or padded to ``len(shape)`` dims, each entry the
    longest suffix of its still-unused axes whose size product (> 1)
    divides the dim, else ``None`` (replicated): 3 KV heads on a 16-way
    model axis are replicated, 16 experts on ("data", "model") = 256
    fall back to ("model",), leaving "data" free for a later dim."""
    parts = list(tuple(spec))
    ndim = len(shape)
    parts = parts[:ndim] + [None] * (ndim - len(parts))
    new, used = [], set()
    for d, entry in enumerate(parts):
        if entry is None:
            new.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        avail = tuple(a for a in axes if a not in used)
        chosen = None
        for start in range(len(avail)):
            sub = avail[start:]
            prod = 1
            for a in sub:
                prod *= sizes[a]
            if prod > 1 and shape[d] % prod == 0:
                chosen = sub if len(sub) > 1 else sub[0]
                used.update(sub)
                break
        new.append(chosen)
    return P(*new)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that entry d names, ``Replicate()`` on the rest. Raises
    where an entry names its axes out of the mesh's order (DTensor
    would split that dim minor axis first) or names one axis twice."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or seen.intersection(idx):
            raise ValueError(f"spec {spec} entry {entry!r} is not in the "
                             f"order of mesh axes {names}, or reuses one")
        seen.update(idx)
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def redistribute_to(x, spec):
    """A DTensor ``x`` redistributed to ``spec`` on its mesh, after the
    divisibility fallback (``safe_spec``); the same object where its
    placements already match."""
    mesh = x.device_mesh
    pl = placements(safe_spec(spec, x.shape, mesh_sizes(mesh)), mesh)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def last_gathered(x) -> tuple:
    """A DTensor's placements with its last dim gathered and partial
    sums reduced."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim != x.ndim - 1
                 else Replicate() for p in x.placements)


def gather_last(x):
    """A DTensor with its last dim gathered and partial sums reduced (a
    plain tensor passes)."""
    if not is_dtensor(x):
        return x
    pl = last_gathered(x)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def splittable(x, dim: int, parts: int):
    """``x`` ready for a view that splits dim ``dim`` into (``parts``,
    -1): a DTensor whose mesh dims shard that dim over a product not
    dividing ``parts`` has them gathered first (DTensor refuses such a
    view: 4 KV heads out of a projection sharded 16 ways); a plain
    tensor, or one split evenly, passes."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    d = dim % x.ndim
    sizes = x.device_mesh.mesh.shape
    on = [i for i, p in enumerate(x.placements)
          if isinstance(p, Shard) and p.dim == d]
    prod = 1
    for i in on:
        prod *= sizes[i]
    if not on or parts % prod == 0:
        return x
    pl = tuple(Replicate() if i in on else p
               for i, p in enumerate(x.placements))
    return x.redistribute(x.device_mesh, pl)


def foldable(x):
    """``x`` ready for a product that folds its leading dims into one (a
    (B, S, D) activation times a weight): a DTensor split on a dim
    between the first and the last has those mesh dims gathered (the
    sequence under sequence parallelism; DTensor refuses to flatten
    (B, S) with S split, as torch 2.11 does), the first and the last
    keep theirs; a plain tensor passes. The gather's backward splits the
    gradient back (a reduce-scatter of a partial one): the all-gather
    before a column-parallel product under sequence parallelism."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if isinstance(p, Shard)
               and 0 < p.dim % x.ndim < x.ndim - 1 else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


class _GradPlaced(torch.autograd.Function):
    """The identity, whose backward lays the gradient out by ``place``."""

    @staticmethod
    def forward(ctx, x, place):
        ctx.place = place
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.place(grad), None


def splittable_grad(x, dim: int, parts: int):
    """``x`` unchanged, its gradient made ``splittable(grad, dim,
    parts)``: for a tensor that a view splits after the product that
    uses it (a projection's (D, N * hd) weight out of (D, N, hd)), whose
    gradient the product's backward may shard over that dim where the
    view's backward cannot split it (4 KV heads on 16). A plain tensor
    passes."""
    if not is_dtensor(x):
        return x
    return _GradPlaced.apply(x, lambda g: splittable(g, dim, parts))


def foldable_grad(x):
    """``x`` unchanged, its gradient made ``foldable``: for the output of
    a reshape that unfolds (B * S) into (B, S), whose gradient the
    sequence-split residual gives the sequence's split, where the
    reshape's backward folds it again. A plain tensor passes."""
    if not is_dtensor(x):
        return x
    return _GradPlaced.apply(x, foldable)


def placed_grad(x):
    """``x`` unchanged, its gradient laid out on ``x``'s own placements (a
    partial sum reduced): for the output of a redistribution from a
    partial sum of another kind (an embedding lookup's masked partial),
    whose backward cannot turn a plain partial sum into it. A plain
    tensor passes."""
    if not is_dtensor(x):
        return x
    pl = tuple(x.placements)
    return _GradPlaced.apply(
        x, lambda g: g if tuple(g.placements) == pl
        else g.redistribute(g.device_mesh, pl))


def constrain(x, *logical_axes: Optional[str]):
    """Pin activation sharding by logical axis names (no-op without
    rules; a plain tensor passes unchanged). Dims not divisible by their
    mesh-axis product fall back to replicated."""
    rules = _current_rules()
    if rules is None or _current_mesh() is None or not is_dtensor(x):
        return x
    return redistribute_to(x, logical_to_pspec(logical_axes, rules))


def logical_placements(x, *logical_axes: Optional[str]) -> tuple:
    """The placements ``constrain(x, *logical_axes)`` would give the
    DTensor ``x`` (all ``Replicate`` without rules)."""
    rules = _current_rules() or {}
    mesh = x.device_mesh
    spec = safe_spec(logical_to_pspec(logical_axes, rules), x.shape,
                     mesh_sizes(mesh))
    return placements(spec, mesh)


# ---------------------------------------------------------------------------
# Standard rule tables.  data axes = ("pod", "data") on the multi-pod mesh.
# ---------------------------------------------------------------------------
def make_rules(*, data_axes: Tuple[str, ...] = ("data",),
               model_axis: str = "model",
               fsdp: bool = False,
               sequence_parallel: bool = False,
               serve: bool = False) -> Mapping[str, MeshAxes]:
    """Logical-axis → mesh-axis mapping.

    batch   — global batch dim                → all data axes
    seq     — sequence dim (activations)      → model axis when SP is on
    embed   — d_model dim of *weights*        → data axes when FSDP is on
    heads/kv_heads/ffn/vocab                  → model axis (tensor parallel)
    experts — model axis for training; ALL axes for serving (full EP: 1
              expert slice per chip, no weight gathering on decode)
    cache_seq — cache sequence dim (sequence-sharded KV for decode)
    """
    da = data_axes if len(data_axes) > 1 else data_axes[0]
    all_axes = tuple(data_axes) + (model_axis,)
    return {
        "batch": da,
        "seq": model_axis if sequence_parallel else None,
        "embed": None if serve else (da if fsdp else None),
        "act_embed": None,
        "heads": model_axis,
        "kv_heads": model_axis,
        "ffn": model_axis,
        "experts": all_axes if serve else model_axis,
        # serving shards expert FFN width over the data axes too; the
        # divisibility fallback keeps E and F disjoint
        "expert_ffn": da if serve else None,
        "vocab": model_axis,
        "expert_cap": None,
        "state": None,
        "cache_seq": model_axis,
    }


def param_pspec(path: str, shape: Tuple[int, ...],
                rules: Mapping[str, MeshAxes]) -> P:
    """Map a parameter (by its tree path) to a PartitionSpec.

    Conventions (the JAX package's, leaf by leaf name):
      embedding table   (V, D)        -> (vocab, embed)
      lm head           (D, V)        -> (embed, vocab)
      attn q/kv proj    (D, H, hd)    -> (embed, heads, None)
      attn out proj     (H, hd, D)    -> (heads, None, embed)
      mla latent projs  (D, r)/(r, ..)-> embed on the d_model-sized dim
      mlp in            (D, F)        -> (embed, ffn)
      mlp out           (F, D)        -> (ffn, embed)
      moe experts       (E, D, F)     -> (experts, embed|None, ffn)
    The port's layers are a list, not a scan-stacked period, so no leaf
    has the JAX package's leading layer axis; a longer leaf gains
    leading ``None`` axes as there.
    """
    leaf = path.split("/")[-1]
    n = len(shape)

    def spec(*axes):
        axes = (None,) * (n - len(axes)) + tuple(axes)
        return P(*[rules.get(a) if a else None for a in axes])

    if leaf in ("scale", "bias", "A_log", "D", "dt_bias", "conv_bias",
                "i_bias", "f_bias", "o_bias", "z_bias"):
        return P(*([None] * n))
    if leaf == "embedding":
        return spec("vocab", "embed")
    if leaf == "pos_embedding":
        return spec(None, "embed")
    if leaf == "lm_head":
        return spec("embed", "vocab")
    if leaf in ("wq", "wk", "wv"):
        return spec("embed", "heads", None)
    if leaf == "wo":
        return spec("heads", None, "embed")
    if leaf in ("w_dq", "w_dkv"):                 # MLA down-projections
        return spec("embed", None)
    if leaf in ("w_uq", "w_uk", "w_uv"):          # MLA up-projections
        return spec(None, "heads", None)
    if leaf == "w_qr":
        return spec(None, "heads", None)
    if leaf == "w_kr":
        return spec("embed", None)
    if leaf in ("wi", "wg"):
        return spec("embed", "ffn")
    if leaf == "wo_mlp":
        return spec("ffn", "embed")
    if leaf == "router":
        return spec("embed", "experts")
    if leaf in ("e_wi", "e_wg"):
        return spec("experts", "embed", "expert_ffn")
    if leaf == "e_wo":
        return spec("experts", "expert_ffn", "embed")
    if leaf in ("in_proj", "x_proj", "dt_proj", "out_proj",
                "wi_up", "wq_m", "wk_m", "wv_m", "w_if", "w_gates"):
        # ssm / xlstm projections: shard the larger (inner) dim
        if n >= 2:
            if leaf in ("out_proj", "wo_m"):
                return spec("ffn", "embed")
            return spec("embed", "ffn")
        return P(*([None] * n))
    return P(*([None] * n))


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts and lists in the order of
    ``repro_torch.tree.leaves``; paths join keys and list indices with
    "/"."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def param_pspecs(params, rules) -> object:
    """PartitionSpec tree matching ``params`` (tensors of any device,
    ``meta`` included)."""
    from repro_torch.tree import unflatten
    specs = [param_pspec(path, tuple(leaf.shape), rules)
             for path, leaf in tree_paths(params)]
    return unflatten(params, specs)


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


class NamedSharding:
    """A spec on a mesh (the JAX package's ``NamedSharding``);
    ``placements`` are its DTensor placements."""
    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, P(*spec)

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSharding) and other.spec == self.spec \
            and other.mesh == self.mesh

    def __hash__(self) -> int:
        return hash(self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def distribute(tree, shardings):
    """A tree of full tensors (the same on every rank) as DTensors laid
    out by a matching tree of ``NamedSharding`` (the counterpart of
    ``jax.device_put`` with ``NamedSharding``s). Each rank keeps its
    shard; the source rank's data is what is scattered."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.tree import map_tree
    return map_tree(lambda t, sh: distribute_tensor(t, sh.mesh,
                                                    sh.placements),
                    tree, shardings)


def redistribute(tree, shardings):
    """A tree of DTensors redistributed to a matching tree of
    ``NamedSharding``s (the counterpart of a jit's out_shardings); plain
    tensors pass unchanged."""
    from repro_torch.tree import map_tree

    def one(t, sh):
        if not is_dtensor(t) or tuple(t.placements) == sh.placements:
            return t
        return t.redistribute(sh.mesh, sh.placements)
    return map_tree(one, tree, shardings)


def full(tree):
    """Every DTensor of a tree gathered to a full plain tensor (plain
    tensors pass)."""
    from repro_torch.tree import map_tree
    return map_tree(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)
