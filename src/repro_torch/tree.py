"""Trees of the port: nested dicts and lists whose leaves are tensors (a
parameter tree, a train state, its gradients)."""
from __future__ import annotations

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and lists) and of the
    trees of the same structure in ``rest``; returns the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out
