"""Parameter trees: nested dicts, lists and tuples of tensors.

The JAX package walks its trees with ``jax.tree_util``; the port's
trees are plain containers, walked here in the same leaf order
(``tree_flatten``'s): dict keys sorted, lists and tuples (named tuples
too) in order, ``None`` an empty subtree. The checkpoint format stores
leaves in this order, so a file either package writes loads in the
other.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence


def _children(node) -> Sequence:
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return node


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def _iter_leaves(node) -> Iterator[Any]:
    if node is None:
        return
    if _is_node(node):
        for child in _children(node):
            yield from _iter_leaves(child)
    else:
        yield node


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten`` order."""
    return list(_iter_leaves(tree))


def _rebuild(node, children):
    if isinstance(node, dict):
        got = dict(zip(sorted(node), children))
        return {k: got[k] for k in node}         # the tree's own key order
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def map_tree(fn: Callable, tree, *rest, is_leaf: Callable = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure); ``None`` subtrees stay ``None``.
    A node of ``tree`` for which ``is_leaf`` holds is passed to ``fn``
    whole, as in ``jax.tree.map``."""
    if tree is None:
        return None
    if _is_node(tree) and not (is_leaf and is_leaf(tree)):
        kids = [_children(t) for t in (tree, *rest)]
        if any(len(k) != len(kids[0]) for k in kids):
            raise ValueError("trees differ in structure")
        return _rebuild(tree, [map_tree(fn, *group, is_leaf=is_leaf)
                               for group in zip(*kids)])
    return fn(tree, *rest)


def unflatten(like, values: Sequence) -> Any:
    """``values`` (in ``leaves`` order) in the structure of ``like``."""
    n = len(leaves(like))
    if len(values) != n:
        raise ValueError(f"{len(values)} values for a tree of {n} leaves")
    it = iter(values)
    return map_tree(lambda _: next(it), like)
