"""Explicit FSDP: gather the weights right before use (port of
``repro.launch.fsdp``).

Storage sharding for the large configs (``cfg.fsdp_params``) puts the
weight matrices under the block keys (``blocks``, ``enc_blocks``,
``dec_blocks``, ``cross_attn``) on the data axes (``launch.sharding.
param_specs(..., fsdp=True)``).  The models call ``maybe_unshard(
block_params, name)`` on each layer's slice right before using it; by
default it is the identity, and ``clear()`` makes it so again.

Where the reference places a sharding constraint and lets XLA insert the
collective, the port's policy really gathers: under ``install``

* each rank holds its cut of every leaf under the block keys whose spec
  has a data-axis entry (``shard_params``: its block of that dim);
* ``maybe_unshard`` all-gathers one layer's cuts over the mesh's
  ``data_group`` (``_c10d_functional.all_gather_into_tensor``), and the
  gather's backward reduce-scatters the layer's gradient (a sum over the
  ranks), both ops a dispatch mode sees (``launch.op_cost``);
* every other leaf — the embeddings, norms, ``unembed``, the MoE router,
  a hybrid's shared block, a VLM's projector — is held whole on every
  rank, its gradient averaged over the data ranks (``sync_gradients``);
* a rank runs its block of the global batch (``launch.sharding.
  batch_specs``); with equal blocks, the mean of the ranks' token means
  is the global batch's (``mean_loss``), and the gradients become the
  global batch's once the cut ones are divided by the data size and the
  others averaged;
* the MoE load-balance loss takes its batch means over the data ranks
  (``data_mean``), so the step matches the unsharded one; the capacity
  dispatch raises under data sharding (ROADMAP A.19);
* the optimizer's global norm sums the cut leaves' squares over the data
  ranks (``square_sums``).

Under remat the models gather inside the checkpointed function, so the
backward gathers the layer again and no gathered layer is kept across
the step.  A world of one (the ``(1, 1)`` mesh) runs the same
collectives over a group of one: copies, so the step is bitwise the
unsharded one.  Gloo moves CUDA tensors through the host for these
collectives (several ranks sharing one card).  The port executes the data
axes only: installing on a mesh whose "model" axis is over 1 raises,
except on the dry-run's fake world, where nothing is exchanged (ROADMAP
A.18).
"""

from __future__ import annotations

import types

import torch

from repro_torch.tree import tree_leaves, tree_map

#: the installed policy, process-wide: the reference keeps it per thread,
#: but autograd runs a CUDA backward — and with it a remat recompute's
#: gathers — on a thread of its own, which must see the policy too
_state = types.SimpleNamespace(policies=None, mesh=None, cut=None)

#: the collectives the policy has issued since ``reset_counts()``: layer
#: gathers (forward and remat recompute), their gradients'
#: reduce-scatters, and the all-reduces (gradients, norms, the loss, the
#: MoE batch means)
COUNTS = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}

#: the keys whose stacked layers are cut and gathered (the reference's)
BLOCK_KEYS = ("blocks", "enc_blocks", "dec_blocks", "cross_attn")


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def maybe_unshard(tree, name: str = "blocks"):
    policies = _state.policies
    if not policies or name not in policies:
        return tree
    return policies[name](tree)


def _strip_data(axis, drop: set):
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a not in drop)
        return kept if kept else None
    return None if axis in drop else axis


def _data_dim(spec: tuple, drop: set) -> int | None:
    """The dim of ``spec`` that splits over the data axes (``None``: the
    leaf is whole on every data rank).  The port cuts over all of them
    at once, as the LM rules place them."""
    dims = [i for i, a in enumerate(spec) if _strip_data(a, drop) != a]
    if not dims:
        return None
    (d,) = dims
    a = spec[d]
    axes = set(a) if isinstance(a, (tuple, list)) else {a}
    if axes & drop != drop or axes - drop:
        raise NotImplementedError(
            f"spec entry {a!r}: the port cuts a leaf over all the data "
            f"axes {sorted(drop)} at once and over no other axis")
    return d


def _group_name(mesh) -> str:
    return mesh.data_group.group_name


def _staged(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _all_gather0(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's ``t`` concatenated along dim 0."""
    src = t.contiguous()
    src = src.cpu() if _staged(mesh, t) else src
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        src, mesh.data_size, _group_name(mesh))
    COUNTS["all_gather"] += 1
    return torch.ops._c10d_functional.wait_tensor(out).to(t.device)


def _reduce_scatter0(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the data ranks of ``t``, this rank's block of dim 0."""
    src = t.contiguous()
    src = src.cpu() if _staged(mesh, t) else src
    out = torch.ops._c10d_functional.reduce_scatter_tensor(
        src, "sum", mesh.data_size, _group_name(mesh))
    COUNTS["reduce_scatter"] += 1
    return torch.ops._c10d_functional.wait_tensor(out).to(t.device)


def _all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    src = t.contiguous()
    src = src.cpu() if _staged(mesh, t) else src
    out = torch.ops._c10d_functional.all_reduce(src, "sum",
                                                _group_name(mesh))
    COUNTS["all_reduce"] += 1
    return torch.ops._c10d_functional.wait_tensor(out).to(t.device)


def _div(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t / n`` rounded once (by a tensor, as ``ops.true_div``)."""
    return t / t.new_tensor(float(n))


class _Gather(torch.autograd.Function):
    """All-gather of the data ranks' cuts along ``dim``; the backward
    reduce-scatters the gradient back to this rank's cut."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        full = _all_gather0(x.movedim(dim, 0), mesh)
        return full.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        cut = _reduce_scatter0(g.movedim(ctx.dim, 0), ctx.mesh)
        return cut.movedim(0, ctx.dim).contiguous(), None, None


class _DataMean(torch.autograd.Function):
    """The mean over the data ranks; its backward averages the incoming
    gradients the same way (each rank's loss then carries the whole
    term's gradient, as ``sync_gradients`` expects)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _div(_all_reduce_sum(x, mesh), mesh.data_size)

    @staticmethod
    def backward(ctx, g):
        return _div(_all_reduce_sum(g, ctx.mesh), ctx.mesh.data_size), None


def make_policy(mesh, specs_tree, data_axes: tuple[str, ...]):
    """The unshard policy of one stacked-blocks spec subtree: a layer's
    slice (its leaves the stacked ones less the leading dims) with every
    leaf cut over the data axes gathered whole along that dim."""
    drop = set(data_axes)

    def leaf(x, spec):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        d = _data_dim(tuple(spec)[-x.dim():], drop)
        return x if d is None else _Gather.apply(x, d, mesh)

    def policy(tree):
        return tree_map(leaf, tree, specs_tree)

    return policy


def _cut_dims(param_spec_tree: dict, block_keys, drop: set) -> dict:
    """Per leaf of the whole tree: the dim its stacked leaf is cut along
    (``None``: held whole).  Dim 0 is the layer stack's: the rules place
    a per-layer vector's spec (a bias's, ``param_specs``) there, on the
    stack itself, and such a leaf is held whole (its layer slice has no
    data entry for the policy to gather)."""
    def walk(tree, under):
        if isinstance(tree, dict):
            return {k: walk(v, under or k in block_keys)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, under) for v in tree]
        d = _data_dim(tuple(tree), drop) if under else None
        return d if d else None
    return walk(param_spec_tree, False)


def install(mesh, param_spec_tree: dict, data_axes: tuple[str, ...],
            block_keys: tuple[str, ...] = BLOCK_KEYS):
    """Gather-before-use over ``mesh``'s data group for the block keys
    ``param_spec_tree`` (``param_specs(..., fsdp=True)``) holds."""
    if mesh.shape.get("model", 1) > 1 and mesh.backend != "fake":
        raise NotImplementedError(
            f"mesh {mesh.shape}: the port executes the data axes only; a "
            f"'model' axis over 1 is tensor-parallel execution (ROADMAP "
            f"A.18), which only the dry-run reckons")
    drop = set(data_axes)
    policies = {}
    for k in block_keys:
        if isinstance(param_spec_tree, dict) and k in param_spec_tree:
            policies[k] = make_policy(mesh, param_spec_tree[k], data_axes)
    _state.policies = policies
    _state.mesh = mesh
    _state.cut = _cut_dims(param_spec_tree, block_keys, drop)


def clear() -> None:
    _state.policies = None
    _state.mesh = None
    _state.cut = None


def installed_mesh():
    """The mesh of the installed policy, ``None`` where none is."""
    return _state.mesh


def data_size() -> int:
    """The data ranks of the installed policy (1 where none is)."""
    mesh = installed_mesh()
    return 1 if mesh is None else mesh.data_size


def _cut_tree():
    cut = _state.cut
    if cut is None:
        raise RuntimeError("no FSDP policy is installed (fsdp.install)")
    return cut


def shard_params(params):
    """This rank's copy of a whole parameter tree (or of a tree of the
    same structure, say the gradients): every leaf the installed specs
    cut, its ``data_index``-th block along the cut dim; every other leaf
    whole.  Nothing of ``params`` stays referenced."""
    mesh = installed_mesh()
    n, i = mesh.data_size, mesh.data_index

    def cut(x, d):
        if d is None:
            return x.clone()
        size = x.shape[d] // n
        return x.narrow(d, i * size, size).clone()

    return tree_map(cut, params, _cut_tree())


def sync_gradients(grads):
    """The global batch's gradients from this rank's: the cut leaves'
    (summed over the ranks by the gathers' reduce-scatters) divided by
    the data size, every other leaf's averaged over the data ranks.
    The identity where no policy is installed."""
    mesh = installed_mesh()
    if mesh is None:
        return grads
    n = mesh.data_size

    def sync(g, d):
        if d is None:
            g = _all_reduce_sum(g, mesh)
        return _div(g, n)

    return tree_map(sync, grads, _cut_tree())


def square_sums(sums: list) -> list:
    """The optimizer's per-leaf squared-gradient sums (``tree_leaves``
    order) with each cut leaf's summed over the data ranks (one
    all-reduce of them all): the global norm's terms.  Unchanged where no
    policy is installed."""
    mesh = installed_mesh()
    if mesh is None:
        return sums
    cut = [d is not None for d in tree_leaves(_cut_tree())]
    idx = [j for j, c in enumerate(cut) if c]
    if not idx:
        return sums
    total = _all_reduce_sum(torch.stack([sums[j] for j in idx]), mesh)
    out = list(sums)
    for k, j in enumerate(idx):
        out[j] = total[k]
    return out


def mean_loss(loss: torch.Tensor) -> torch.Tensor:
    """The mean of the data ranks' losses (the global batch's token mean
    where the blocks are equal); ``loss`` where no policy is installed."""
    mesh = installed_mesh()
    if mesh is None:
        return loss
    return _div(_all_reduce_sum(loss.detach(), mesh), mesh.data_size)


def data_mean(t: torch.Tensor) -> torch.Tensor:
    """``t``'s mean over the data ranks, differentiable; ``t`` itself
    where no policy is installed."""
    mesh = installed_mesh()
    if mesh is None:
        return t
    return _DataMean.apply(t, mesh)
