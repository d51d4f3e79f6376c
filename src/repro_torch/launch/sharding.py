"""Partition specs of the expert-parallel serving mesh (``("expert",
"data")``, ``launch.mesh``), and the cut of a store to a rank's resident
slice.

A spec is a tuple with one entry per dim of a tensor: the mesh axis (or
tuple of axes) that dim splits over, or ``None`` where it is replicated —
the content of the reference's ``PartitionSpec``.  The functions read
only a mesh's ``shape`` (a dict of axis sizes) and ``axis_names``.  A
``NamedSharding`` pairs a spec with its mesh, as the reference's does
(``to_shardings``, ``expert_param_shardings``,
``rolling_state_shardings``); the port places tensors by cutting them
(``shard_store``, the rolling batch's rows), not through DTensor.

The LM half of the reference module (``param_specs``, ``batch_specs``,
``cache_specs`` and the FSDP rules) is not ported here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.param_store import DenseStore, QuantizedStore
from repro_torch.launch.mesh import data_axes
from repro_torch.models.dit import stacked_param_logical_axes
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what the reference's ``NamedSharding`` holds."""

    mesh: Any
    spec: tuple


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def sanitize_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """``spec`` with every axis whose mesh size does not divide its dim
    dropped to ``None`` (replicated), padded or cut to ``len(shape)``."""
    out = []
    for i, axis in enumerate(spec):
        if i >= len(shape):
            break
        if axis is not None and shape[i] % _axis_size(mesh, axis):
            axis = None
        out.append(axis)
    return tuple(out) + (None,) * (len(shape) - len(out))


def _map_store(fn, store, other):
    """``fn(leaf, other_leaf)`` over every tensor of a store (its stacked
    leaves or quantized leaves and scales, and ``valid``) or a raw stacked
    tree, with ``other`` a structure-matching store or tree; returns the
    same kind of object."""
    if isinstance(store, DenseStore):
        return dataclasses.replace(
            store, stacked=tree_map(fn, store.stacked, other.stacked),
            valid=None if store.valid is None else fn(store.valid,
                                                      other.valid))
    if isinstance(store, QuantizedStore):
        return dataclasses.replace(
            store, qvals=tree_map(fn, store.qvals, other.qvals),
            scales=tree_map(fn, store.scales, other.scales),
            valid=None if store.valid is None else fn(store.valid,
                                                      other.valid))
    return tree_map(fn, store, other)


class _Box:
    """A spec held as one leaf (the tree helpers walk into tuples)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def store_spec_leaves(store, specs) -> list:
    """The entries of ``specs`` (say ``expert_param_specs(store, ...)``, or
    ``store`` itself for its tensors) as a list in the reference's flatten
    order: the stacked leaves (dict keys sorted), or the quantized leaves
    then the scales, then ``valid``."""
    boxed = _map_store(lambda _, spec: _Box(spec), store, specs)
    if isinstance(boxed, DenseStore):
        parts = [boxed.stacked, boxed.valid]
    elif isinstance(boxed, QuantizedStore):
        parts = [boxed.qvals, boxed.scales, boxed.valid]
    else:
        parts = [boxed]
    return [b.value for part in parts if part is not None
            for b in tree_leaves(part)]


def expert_param_specs(stacked: Any, mesh, *, logical_axes: Any = None
                       ) -> Any:
    """Specs of stacked expert params (leaves ``(K, ...)``), a store or a
    raw stacked tree: the same kind of object with a spec per tensor.

    ``logical_axes`` (``models.dit.stacked_param_logical_axes`` or a
    store's ``logical_axes()``; by default every leaf's leading axis is
    "expert") names each dim; the names the mesh has become the spec and
    a ``K`` the "expert" axis does not divide falls back to replication
    (``sanitize_spec``).  A quantized store's per-expert scales and an
    elastic store's ``valid`` carry the leading "expert" axis, so they
    shard with the leaves they rescale or gate.
    """
    axes = logical_axes
    if axes is None:
        axes = stacked_param_logical_axes(stacked)

    def leaf(x: torch.Tensor, names) -> tuple:
        if not isinstance(names, tuple) or len(names) != x.dim():
            raise ValueError(
                f"logical_axes does not match the stacked pytree: {names!r} "
                f"for a leaf of shape {tuple(x.shape)}")
        spec = tuple(a if a in mesh.axis_names else None for a in names)
        return sanitize_spec(spec, tuple(x.shape), mesh)

    try:
        return _map_store(leaf, stacked, axes)
    except (AttributeError, KeyError, IndexError, TypeError) as e:
        raise ValueError(
            "logical_axes does not match the stacked pytree") from e


def _map_specs(fn, specs):
    """``fn(spec)`` over a tree of specs (dicts, lists, a store's fields);
    a tuple is one spec, ``None`` (a store without a mask) stays."""
    if isinstance(specs, (DenseStore, QuantizedStore)):
        names = ("stacked",) if isinstance(specs, DenseStore) \
            else ("qvals", "scales")
        return dataclasses.replace(specs, valid=_map_specs(fn, specs.valid),
                                   **{n: _map_specs(fn, getattr(specs, n))
                                      for n in names})
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return None if specs is None else fn(specs)


def to_shardings(mesh, specs: Any) -> Any:
    """Every spec of a tree (see ``_map_specs``) as a ``NamedSharding``
    on ``mesh``."""
    return _map_specs(lambda s: NamedSharding(mesh, tuple(s)), specs)


def expert_param_shardings(stacked: Any, mesh, *, logical_axes: Any = None
                           ) -> Any:
    """``expert_param_specs`` as ``NamedSharding``s: where a rank's
    resident slice of a store comes from (``shard_store``)."""
    return to_shardings(
        mesh, expert_param_specs(stacked, mesh, logical_axes=logical_axes))


def dispatch_plan_sharding(mesh) -> tuple:
    """The spec of every ``core.dispatch.DispatchPlan`` tensor: replicated
    (``()``).  Every rank needs the whole plan — the routed executors
    pick their resident experts' pairs or segments out of it — and its
    tensors are ``O(B·k)`` integers."""
    return ()


def serve_batch_spec(mesh, shape: tuple) -> tuple:
    """A request batch's spec: its leading dim over "data", replicated
    where the "data" size does not divide it; rank-0 and empty tensors
    replicate."""
    shape = tuple(shape)
    if not shape or 0 in shape:
        return (None,) * len(shape)
    return sanitize_spec(("data",) + (None,) * (len(shape) - 1), shape,
                         mesh)


def rolling_state_shardings(mesh, shape: tuple
                            ) -> tuple[NamedSharding, NamedSharding]:
    """The placements of a rolling batch's ``(B_cap, ...)`` buffers
    (``serving.batch.RollingBatch``): the latent (and its conditioning
    rows) like any request batch, its leading dim over "data"
    (``serve_batch_spec``); the per-row state — ``t_idx``, ``slot_idx``,
    ``slot_w`` and the host mirror — replicated, as the plan it feeds.
    Returns ``(latent, row_state)``."""
    return (NamedSharding(mesh, serve_batch_spec(mesh, shape)),
            NamedSharding(mesh, ()))


def dit_batch_specs(mesh, batch: dict) -> dict:
    """A training batch's specs: every tensor's leading dim over the data
    axes."""
    dp = data_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    return {k: (dpa,) + (None,) * (x.dim() - 1) for k, x in batch.items()}


def _cut(mesh, index: dict, device):
    """A leaf's resident block under its spec, copied onto ``device``."""
    def cut(x: torch.Tensor, spec: tuple) -> torch.Tensor:
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = x.shape[dim] // _axis_size(mesh, axis)
            x = x.narrow(dim, index[axis] * n, n)
        return x.to(device if device is not None else x.device, copy=True)
    return cut


def shard_store(store, mesh, *, device=None):
    """This rank's resident slice of a ``DenseStore`` or
    ``QuantizedStore``: every tensor cut to its block under
    ``expert_param_specs`` (the experts ``[lo, hi)`` of
    ``mesh.expert_range``; the scales and ``valid`` with their leaves) and
    copied onto ``device`` (default: where it lies), so nothing of the
    other ranks' experts stays referenced.  ``num_experts`` stays the
    global ``K``; ``first_expert`` records ``lo``; an elastic store's whole
    mask stays whole beside its cut one (``routing_valid``), the mask
    routing reads.  A ``K`` the "expert" axis does not divide replicates:
    the slice is the whole store."""
    placed = expert_param_shardings(store, mesh,
                                    logical_axes=store.logical_axes())
    index = {"expert": mesh.expert_index, "data": mesh.data_index}
    cut = _cut(mesh, index, device)
    out = _map_store(lambda x, sh: cut(x, sh.spec), store, placed)
    lo, _ = mesh.expert_range(store.num_experts)
    whole = store.routing_mask()
    if whole is not None:
        whole = whole.to(device if device is not None else whole.device,
                         copy=True)
    return dataclasses.replace(out, first_expert=lo, routing_valid=whole)
