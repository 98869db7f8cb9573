"""Nested dict/list state trees, walked in the reference's leaf order.

The reference's state trees are JAX pytrees: ``jax.tree.flatten`` visits a
dict's values in sorted key order and a list's in position order.  The
port keeps the same trees of tensors, and these helpers walk them in that
order, so a checkpoint's leaves, a global norm's sum and a converted
state line up with the reference's leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def named_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of ``tree`` in :func:`leaves` order; a path
    joins the keys and positions above its leaf with "/"."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in :func:`leaves` order;
    returns a tree like ``tree``, its dicts' keys sorted."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, values) -> Any:
    """A tree shaped like ``like`` holding ``values`` in leaf order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def treedef_str(tree) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` prints it
    (``PyTreeDef({'a': *, 'b': [*]})``) for a tree of dicts and lists."""

    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({walk(tree)})"


__all__ = ["leaves", "named_leaves", "tree_map", "unflatten", "treedef_str"]
