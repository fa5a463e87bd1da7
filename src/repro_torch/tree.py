"""Nested dict/list/tuple trees of tensors, in ``jax.tree`` leaf order.

The reference keeps parameters, gradients and optimizer state as pytrees;
its gradient arena is laid out in ``jax.tree.flatten`` order (dict keys
sorted, sequences in order), which fixes bucket boundaries and so which
entries a drop mask hits. The port keeps the same trees of plain tensors and
flattens them in the same order.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """Rebuild ``like``'s structure from ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Apply ``fn`` leafwise over trees of one structure."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])
