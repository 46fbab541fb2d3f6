"""Nested dict/list trees of tensors — the port's stand-in for JAX pytrees.

Dict keys are visited in sorted order, list items in order, as
``jax.tree.leaves`` visits the reference's pytrees; anything that is not a
dict, list or tuple is a leaf.  ``path`` strings join the keys and indices
with ``/`` (the checkpoint's leaf names).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_leaves", "tree_leaves_like", "tree_map", "tree_paths",
           "tree_unflatten"]


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_leaves(tree) -> list:
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, sub in kids for leaf in tree_leaves(sub)]


def tree_leaves_like(tree, like) -> list:
    """The subtrees of ``tree`` at the positions of ``like``'s leaves, in
    leaf order (per-parameter state dicts of a params-shaped tree)."""
    kids = _children(like)
    if kids is None:
        return [tree]
    return [x for key, sub in kids for x in tree_leaves_like(tree[key], sub)]


def tree_paths(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` pairs in leaf order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, sub in kids:
        yield from tree_paths(sub, f"{prefix}/{key}" if prefix else str(key))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and the trees in ``rest``
    (same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """The structure of ``like`` with ``leaves`` (in leaf order) in place of
    its leaves."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
