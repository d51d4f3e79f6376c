"""Partition specs: the LM rules of the production mesh (``("data",
"model")``, ``("pod", "data", "model")``) and the expert-parallel serving
mesh's (``("expert", "data")``, ``launch.mesh``), and the cut of a store
to a rank's resident slice.

A spec is a tuple with one entry per dim of a tensor: the mesh axis (or
tuple of axes) that dim splits over, or ``None`` where it is replicated —
the content of the reference's ``PartitionSpec``.  The functions read
only a mesh's ``shape`` (a dict of axis sizes) and ``axis_names``.  A
``NamedSharding`` pairs a spec with its mesh, as the reference's does
(``to_shardings``, ``expert_param_shardings``,
``rolling_state_shardings``); the port places tensors by cutting them
(``shard_store``, the rolling batch's rows), not through DTensor.

The LM rules are the reference's 2D "FSDP × TP" strategy:

* column-parallel weights (attention q/k/v, FFN up/gate, SSM in_proj,
  MoE up/gate, ``_COL``): last dim on "model", second-to-last on the data
  axes;
* row-parallel weights (attention o, FFN down, SSM out_proj, MoE down,
  ``_ROW``): last dim on the data axes, second-to-last on "model";
* ``unembed`` only on "model" (its vocab dim); embeddings and the conv
  weights' channels on "model"; the MoE router, norms, scalars and small
  tables replicated; a bias follows its weight's last dim;
* without ``fsdp`` every data-axis entry is dropped (TP-only weights);
* batch dims of inputs and caches over ("pod", "data"), and a batch of 1
  (long-context decode) shards a KV cache's sequence axis instead.

``param_specs`` reads the leaf paths of a meta-device tree
(``launch.steps.param_shapes``): the same paths as the reference's
``jax.eval_shape`` tree, so the specs agree leaf for leaf.  The port
executes the data axes only (``launch.fsdp`` cuts and gathers over
them); a "model" axis is reckoned by the dry-run (``launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.param_store import DenseStore, QuantizedStore
from repro_torch.launch.mesh import data_axes
from repro_torch.models.dit import stacked_param_logical_axes
from repro_torch.tree import tree_leaves, tree_map


# Leaf-name → trailing-dims rule (the reference's sets).
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w1", "in_proj", "vision_proj",
        "text_proj", "mlp1", "mlp2", "out", "mod", "cls_head"}
_ROW = {"wo", "w_down", "w2", "out_proj"}
# The unembedding shards only its vocab dim over "model": its d_model
# (contraction) dim on the data axes would collide with the batch there.
_COL_TP_ONLY = {"unembed"}
_OTHER_OWNERS = ("emb", "router", "conv_w", "table", "block_embed")


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


def _path_names(path) -> list[str]:
    """A leaf's path (dict keys and list indices) as strings."""
    return [str(k) for k in path]


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists, the path the
    tuple of keys and indices down to the leaf; the same structure back
    (a leaf's result may be a tuple: a spec)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _pad(spec: tuple, ndim: int, trailing: int) -> tuple:
    return (None,) * (ndim - trailing) + tuple(spec)


def _rule_for(names: list[str], ndim: int, dp) -> tuple:
    """Trailing-dim partition rule of the leaf ``names`` points at (its
    nearest named owner); leading (stacked-layer) dims stay ``None``."""
    dpa = dp if len(dp) > 1 else dp[0]
    owner = None
    for n in reversed(names):
        if n in _COL or n in _ROW or n in _COL_TP_ONLY or n in _OTHER_OWNERS:
            owner = n
            break
    if ndim <= 1:
        return ()
    if owner in ("emb", "conv_w"):
        # embedding and position tables (V, D), conv weights (K, C): the
        # feature dim
        return _pad(("model",), ndim, trailing=1)
    if owner in ("table", "router", "block_embed"):
        return (None,) * ndim
    if owner in _COL_TP_ONLY:
        return _pad((None, "model"), ndim, trailing=2)
    if owner in _COL:
        return _pad((dpa, "model"), ndim, trailing=2)
    if owner in _ROW:
        return _pad(("model", dpa), ndim, trailing=2)
    # biases, norms, A_log, dt_bias, D, unknowns: replicated
    return (None,) * ndim


def param_specs(params_shape: Any, mesh, *, fsdp: bool = False) -> Any:
    """A spec per leaf of a parameter tree (meta tensors will do), in its
    structure.

    ``fsdp=False``: TP-only weight sharding with pure data parallelism.
    ``fsdp=True``: the weight matrices also shard over the data axes; the
    model then runs under ``launch.fsdp``'s gather-before-use policy.
    """
    dp = data_axes(mesh)
    drop = set(dp)

    def leaf(path, x):
        names = _path_names(path)
        if names[-1] == "b":
            # a bias follows its weight's last-dim sharding
            w_spec = _rule_for(names[:-1] + ["w"], 2, dp)
            spec = (w_spec[-1] if w_spec else None,)
        elif names[-1] == "w":
            spec = _rule_for(names[:-1], x.dim(), dp)
        else:
            spec = _rule_for(names, x.dim(), dp)
        if not fsdp:
            spec = tuple(None if (isinstance(a, tuple) or a in drop) else a
                         for a in spec)
        return sanitize_spec(spec, tuple(x.shape), mesh)

    return _map_with_path(leaf, params_shape)


def param_shardings(params_shape: Any, mesh, *, fsdp: bool = False) -> Any:
    return to_shardings(mesh, param_specs(params_shape, mesh, fsdp=fsdp))


def _data_spec(mesh) -> tuple[Any, int]:
    """The data axes as one spec entry, and their size."""
    dp = data_axes(mesh)
    return (dp if len(dp) > 1 else dp[0]), _axis_size(mesh, dp)


def batch_specs(cfg, mesh, batch: dict) -> dict:
    """A batch dict's specs: the leading (batch) dim over the data axes
    where their size divides it, else replicated."""
    del cfg
    dpa, ndev = _data_spec(mesh)

    def leaf(_, x):
        if x.shape[0] % ndev == 0:
            return (dpa,) + (None,) * (x.dim() - 1)
        return (None,) * x.dim()

    return _map_with_path(leaf, batch)


def _first_divisible(shape, dims: list[int], mesh, axis) -> int | None:
    """The first of ``dims`` (by priority) that the mesh axis divides."""
    n = _axis_size(mesh, axis)
    for d in dims:
        if d < len(shape) and shape[d] % n == 0 and shape[d] >= n:
            return d
    return None


def cache_specs(cfg, mesh, cache: dict, batch: int) -> dict:
    """A decode cache's specs.  The batch dim shards over the data axes
    where their size divides ``batch``; otherwise (long_500k, batch 1) a
    KV cache's sequence axis does (sequence-parallel attention over the
    cache).  "model" takes the kv heads, else the sequence, else the head
    dim (GQA with few kv heads); an SSM state its heads, then its head
    dim, then its state dim; a conv tail its channels."""
    del cfg
    dpa, ndev = _data_spec(mesh)
    batch_ok = batch % ndev == 0

    def spec_for(name, x):
        parts: list = [None] * x.dim()
        if name in ("k", "v", "cross_k", "cross_v"):  # (L|G, B, S, H, hd)
            if batch_ok:
                parts[1] = dpa
            elif x.shape[2] % _axis_size(mesh, dpa) == 0:
                parts[2] = dpa
            prio = [3] + ([2] if parts[2] is None else []) + [4]
            d = _first_divisible(x.shape, prio, mesh, "model")
            if d is not None:
                parts[d] = "model"
        elif name == "pos":                      # (B, S)
            if batch_ok:
                parts[0] = dpa
            elif x.shape[1] % _axis_size(mesh, dpa) == 0:
                parts[1] = dpa
        elif name == "ssm":                      # (L, B, H, P, N)
            if batch_ok:
                parts[1] = dpa
            d = _first_divisible(x.shape, [2, 3, 4], mesh, "model")
            if d is not None:
                parts[d] = "model"
        elif name == "conv":                     # (L, B, K-1, C)
            if batch_ok:
                parts[1] = dpa
            if x.shape[3] % _axis_size(mesh, "model") == 0:
                parts[3] = "model"
        return sanitize_spec(tuple(parts), tuple(x.shape), mesh)

    return {k: spec_for(k, v) for k, v in cache.items()}


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
