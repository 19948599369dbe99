"""Nested-dict parameter trees: the few pytree operations the port needs.

A tree is a dict (or list) of tensors, nested.  Leaves are visited with
dict keys in sorted order, as ``jax.tree.leaves`` visits them, so a
flattened gradient lines up element for element with the reference's
``kernels.ops.flatten_tree``.
"""
from __future__ import annotations

from typing import Any, Callable, List

PyTree = Any


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return list(node)


def is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves(tree: PyTree) -> List[Any]:
    """The leaves in the reference's order (sorted dict keys)."""
    if not is_node(tree):
        return [tree]
    out: List[Any] = []
    for child in _children(tree):
        out.extend(leaves(child))
    return out


def leaves_like(tree: PyTree, like: PyTree) -> List[Any]:
    """The nodes of ``tree`` at ``like``'s leaf positions, in leaf order
    (a node may be a subtree, as an optimizer's per-leaf slots are)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in leaves_like(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for i, v in enumerate(like)
                for x in leaves_like(tree[i], v)]
    return [tree]


def map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn(leaf, *rest_at_leaf)`` over ``tree``'s structure; each tree of
    ``rest`` is read at the same positions (its node at a leaf of
    ``tree`` may itself be a subtree, as optimizer slots are)."""
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree: PyTree, values: List[Any]) -> PyTree:
    """``tree``'s structure with its leaves replaced by ``values``, given
    in :func:`leaves` order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out
