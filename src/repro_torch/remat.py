"""Recomputation in the train step (the JAX package's ``jax.checkpoint``
sites): what the backward keeps of a forward, and what it computes again.

``ModelConfig.remat`` names a policy for each period of the scanned
body (``models/transformer.py``), as the JAX package's table does:

  * ``none``    — no checkpoint: autograd keeps what each op saves;
  * ``full``    — nothing saved but the period's inputs
    (``nothing_saveable``);
  * ``dots``    — the output of every matrix product saved, the rest
    recomputed (``checkpoint_dots``);
  * ``dots_nb`` — only the products with no batch dims saved: the
    weight products; attention's and the recurrences' batched products
    are recomputed with everything else
    (``checkpoint_dots_with_no_batch_dims``).

A product reaches the dispatcher as ``aten.mm``/``addmm`` (a weight
applied to a (B, S, D) activation, folded to 2-D) or as ``aten.bmm``/
``baddbmm``. A ``bmm`` is batched only where its leading dim is more
than 1: ``torch.einsum`` lowers a product with no batch dims, such as
``"bsd,dhk->bshk"``, to a ``bmm`` of batch 1, and attention's to one of
batch B x H. So ``dots_nb`` reads the operands' leading dim, not the
op's name. On DTensors the policy sees the DTensor-level op at global
shapes, and on local shards (the kernels' plain versions under
``parallel/local_calls.py``) the local op; a batched product whose
batch comes to 1 there (one sequence with one head) is saved as a
weight product would be.

``recompute`` is a plain checkpoint without a policy: the chunks of the
plain attention and of the recurrences (``kernels/ref.py``) take it,
nested inside a period's checkpoint as the JAX package nests them.

Everything here acts only where autograd records (``records``): a
forward under ``no_grad``, or with nothing that requires grad, runs its
ops exactly as without it. No op of the port's forwards draws random
numbers, so no RNG state is kept (``preserve_rng_state=False``; it also
spares a ``meta`` or fake device a question about its RNG). A policy
this module does not know raises; nothing runs the step without the
checkpoint it names.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

POLICIES = ("none", "full", "dots", "dots_nb")


def check(remat: str) -> None:
    """Raises for a name ``POLICIES`` lacks (the JAX package's lookup)."""
    if remat not in POLICIES:
        raise ValueError(f"remat {remat!r} not in {POLICIES}")


def records(*trees) -> bool:
    """Whether autograd records a call on these tensors (or nested
    lists, tuples and dicts of them): grad mode is on and one of them
    requires grad."""
    if not torch.is_grad_enabled():
        return False
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            return True
    return False


# the matrix products, each with the position of the operand whose
# leading dim is its batch (None: no batch dim)
_PRODUCTS = {torch.ops.aten.mm: None, torch.ops.aten.addmm: None,
             torch.ops.aten.bmm: 0, torch.ops.aten.baddbmm: 1}


def is_product(op) -> bool:
    """Whether ``op`` (an ``OpOverload``) is a matrix product."""
    return op.overloadpacket in _PRODUCTS


def has_batch_dims(op, *args) -> bool:
    """Whether the product ``op(*args)`` has batch dims: a ``bmm`` or
    ``baddbmm`` whose batch (the leading dim of its first matrix) is
    more than 1. ``mm`` and ``addmm`` have none."""
    at = _PRODUCTS[op.overloadpacket]
    return at is not None and args[at].shape[0] > 1


def _policy(remat: str, ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    save = is_product(op) and (remat == "dots"
                               or not has_batch_dims(op, *args))
    return CheckpointPolicy.MUST_SAVE if save \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _context_fn(remat: str):
    if remat == "full":
        return None
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_policy, remat))


def recompute(fn: Callable, *args, remat: str = "full"):
    """``fn(*args)`` under a non-reentrant checkpoint with policy
    ``remat`` (``full``: a plain checkpoint). The caller decides that
    autograd records (``records``); ``fn`` must write nothing in place
    that was made outside it, since the backward runs it again."""
    from torch.utils.checkpoint import checkpoint
    check(remat)
    if remat == "none":
        raise ValueError("remat 'none' takes no checkpoint")
    ctx = _context_fn(remat)
    kw = {} if ctx is None else {"context_fn": ctx}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)
