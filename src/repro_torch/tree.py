"""Nested dict/list parameter trees: the port's stand-in for JAX pytrees."""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    the same-structured trees in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_structure(tree):
    """A hashable signature of the nesting: dict keys, list and tuple
    lengths, and ``'*'`` for a leaf (two trees of equal signature pair
    their ``tree_leaves`` one for one)."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, tree_structure(tree[k]))
                                 for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(tree_structure(v)
                                              for v in tree)
    return "*"
