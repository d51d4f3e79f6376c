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


def tree_stack_layers(make_layer: Callable, n: int):
    """``n`` trees of ``make_layer()`` stacked ``(n, ...)`` leaf by leaf —
    the reference's ``jax.vmap`` of a layer init — filled one layer at a
    time, so only one layer's temporaries exist at once."""
    stacked = None
    for i in range(n):
        layer = make_layer()
        if stacked is None:
            stacked = tree_map(lambda a: a.new_empty((n,) + a.shape), layer)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
    return stacked


def tree_unstack(stacked) -> list:
    """Every layer of a tree stacked ``(n, ...)`` as views, each leaf
    unbound once: the backward of ``unbind`` stacks the layers' gradients
    once, where a view ``a[i]`` per layer would allocate a zero tensor
    the size of the whole stack for each layer's gradient (3.46 GB of
    ``in_proj`` at mamba2-2.7b's width, 64 times a step)."""
    unbound = tree_map(lambda a: a.unbind(0), stacked)
    n = len(tree_leaves(stacked)[0])
    return [tree_map(lambda _, u: u[i], stacked, unbound) for i in range(n)]
