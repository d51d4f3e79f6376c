"""Expert dispatch: ``DispatchPlan`` and the executor backends.

Each sampling step turns the fusion weights into a ``DispatchPlan`` — per
sample the routed expert slots and their weights, plus the expert-sorted
*group* view of the same assignments — and an ``ExpertExecutor`` runs the
routed experts, returning the per-slot predictions that the step's fused
kernel consumes.  Four backends:

* ``RaggedExecutor`` — what ``dispatch='auto'`` picks for DiT experts:
  the routed (sample, slot) pairs run as one pair-major forward in which
  every dense layer is a single ragged grouped GEMM over all experts;
* ``GatheredExecutor`` — the assignments sorted by expert, one forward
  per expert with a non-empty segment over exactly its rows; a
  batch-uniform plan (the threshold router) is one scalar gather and one
  forward;
* ``GroupedExecutor`` — the assignments sorted by expert, one forward
  per expert with a non-empty segment over its power-of-two bucket;
* ``DenseExecutor`` — every expert through its own ``apply_fn`` (no
  stacking needed); a uniform plan runs only the chosen expert.

Where the reference picks a bucket or a branch with ``lax.switch``, the
port reads the plan's segment bounds or slot ids to the host once per
step and branches in Python.

Plan invariants (``tests/test_torch_core.py``):

* ``segment_offsets`` is monotone, starts at 0 and ends at ``B·k``;
* ``unsort_order`` is the inverse permutation of ``sort_order``;
* sorted assignment ``r`` belongs to expert ``e`` iff
  ``segment_offsets[e] <= r < segment_offsets[e+1]``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, Sequence, runtime_checkable

import torch

from repro_torch.core.conversion import ConversionConfig
from repro_torch.core.fusion import stable_top_k
from repro_torch.core.param_store import DenseStore, QuantizedStore, as_store
from repro_torch.kernels import ops

#: valid ``SamplerConfig.dispatch`` values of the reference.
DISPATCH_BACKENDS = ("auto", "gathered", "grouped", "ragged", "dense")


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Batch-shaped routing decisions for one sampling step.

    With ``B`` samples, ``k`` slots per sample and ``K`` experts, the
    ``N = B·k`` flat assignments are numbered ``a = s·k + j``.

    Attributes:
      slot_idx: ``(B, k)`` int64 expert id per routed slot.
      slot_w: ``(B, k)`` fusion weight per slot.
      sort_order: ``(N,)`` assignment ids in expert-grouped order (stable).
      unsort_order: ``(N,)`` inverse permutation of ``sort_order``.
      segment_offsets: ``(K+1,)`` expert ``e``'s sorted segment bounds.
      num_experts: ``K``.
      uniform: every sample routes to the same expert(s) (the §3.3
        threshold router), so executors may run one forward for the batch.
    """

    slot_idx: torch.Tensor
    slot_w: torch.Tensor
    sort_order: torch.Tensor
    unsort_order: torch.Tensor
    segment_offsets: torch.Tensor
    num_experts: int
    uniform: bool = False

    @property
    def batch(self) -> int:
        return self.slot_idx.shape[0]

    @property
    def slots_per_sample(self) -> int:
        return self.slot_idx.shape[1]

    @property
    def num_assignments(self) -> int:
        return self.sort_order.shape[0]


def topk_slots(weights: torch.Tensor, k: int):
    """``(slot_idx, slot_w)``, both ``(B, k)``: the ``k`` largest fusion
    weights per row (ties toward the lower expert index)."""
    slot_w, slot_idx = stable_top_k(weights, min(k, weights.shape[-1]))
    return slot_idx, slot_w


def plan_from_slots(slot_idx: torch.Tensor, slot_w: torch.Tensor,
                    num_experts: int, *, uniform: bool = False
                    ) -> DispatchPlan:
    """Build a plan, including the expert-sorted group view, from slots."""
    flat = slot_idx.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    sort_order = torch.argsort(flat, stable=True)
    unsort_order = torch.empty_like(sort_order)
    unsort_order[sort_order] = torch.arange(n, device=flat.device)
    counts = torch.bincount(flat, minlength=num_experts)
    segment_offsets = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=flat.device),
        torch.cumsum(counts, 0),
    ])
    return DispatchPlan(
        slot_idx=slot_idx.to(torch.int64), slot_w=slot_w,
        sort_order=sort_order, unsort_order=unsort_order,
        segment_offsets=segment_offsets, num_experts=num_experts,
        uniform=uniform,
    )


def routed_slots(weights: torch.Tensor, k: int, *, valid=None):
    """Top-``k`` slot selection with the elastic-membership guard.

    ``valid`` (``(K,)`` bool): a slot whose expert is dead — possible only
    when ``k`` exceeds the live count, since masked fusion weights give
    dead slots zero weight — is remapped to the first live expert at
    weight exactly 0, so no plan names a slot whose bytes may be NaN.
    The continuous scheduler carries these ``(slot_idx, slot_w)`` rows
    across steps and rebuilds the plan with ``plan_from_slots``.
    """
    slot_idx, slot_w = topk_slots(weights, k)
    if valid is not None:
        fallback = valid.to(torch.int8).argmax()          # first live slot
        ok = valid[slot_idx]                              # (B, k)
        slot_idx = torch.where(ok, slot_idx, fallback)
        slot_w = torch.where(ok, slot_w, torch.zeros_like(slot_w))
    return slot_idx, slot_w


def make_dispatch_plan(weights: torch.Tensor, k: int, *,
                       uniform: bool = False, valid=None) -> DispatchPlan:
    """Plan for routed execution: top-``k`` slots of the fusion weights,
    dead slots remapped by ``routed_slots``: a dead expert is never
    gathered, dequantized or run."""
    slot_idx, slot_w = routed_slots(weights, k, valid=valid)
    return plan_from_slots(slot_idx, slot_w, weights.shape[-1],
                           uniform=uniform)


def full_dispatch_plan(weights: torch.Tensor) -> DispatchPlan:
    """Plan with one slot per expert (dense execution): ``slot_idx`` is
    ``arange(K)`` per row and ``slot_w`` the whole weight matrix, so slot
    ``j`` is expert ``j`` (an unrouted expert's slot weighs exactly 0)."""
    b, num_experts = weights.shape
    slot_idx = torch.arange(num_experts, device=weights.device)[None]
    return plan_from_slots(slot_idx.expand(b, num_experts), weights,
                           num_experts)


def tile_plan(plan: DispatchPlan, g: int) -> DispatchPlan:
    """Plan for ``g`` stacked guidance branches of the same batch: the
    slots repeat ``g`` times (branch-major) and the group view is rebuilt
    over the ``g·B·k`` assignments."""
    if g == 1:
        return plan
    return plan_from_slots(
        torch.cat([plan.slot_idx] * g, dim=0),
        torch.cat([plan.slot_w] * g, dim=0),
        plan.num_experts, uniform=plan.uniform,
    )


def _tile(a: torch.Tensor, g: int) -> torch.Tensor:
    return a if g == 1 else torch.cat([a] * g, dim=0)


def _flatten_groups(cond_g: dict, g: int) -> dict:
    """``(B, g, ...)`` grouped cond -> ``(g·B, ...)`` branch-major flat."""
    return {
        key: v.movedim(1, 0).reshape((g * v.shape[0],) + tuple(v.shape[2:]))
        for key, v in cond_g.items()
    }


def slot_coef(tab: torch.Tensor, idx_all: torch.Tensor) -> torch.Tensor:
    """Gather the ``(5, K)`` step table into per-slot form ``(5, k, Bx)``
    — the coefficient operand of ``kernels.ops.fused_step`` and
    ``kernels.ops.fused_velocity``."""
    return tab[:, idx_all].movedim(1, 2)


def slot_coef_rows(tabs: torch.Tensor, idx_all: torch.Tensor) -> torch.Tensor:
    """Per-row ``slot_coef`` of a mixed-timestep batch: row ``r`` carries
    its own ``(5, K)`` table (``tabs`` ``(Bx, 5, K)``) and ``out[c, j, r] =
    tabs[r, c, idx_all[r, j]]``, ``(5, k, Bx)``.  With every row's table
    the same it equals ``slot_coef(tab, idx_all)`` bitwise."""
    idx = idx_all[:, None, :].expand(-1, tabs.shape[1], -1)
    return torch.gather(tabs, 2, idx).movedim(0, 2)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@runtime_checkable
class ExpertExecutor(Protocol):
    """A backend that turns a plan and the step inputs into predictions.

    ``predictions`` takes the pre-CFG batch ``x``/``tb`` of ``B`` rows,
    grouped conditioning ``cond_g`` (leaves ``(B, g, ...)``, ``g = 2``
    when the CFG branches are batched) and the step's ``(5, K)``
    coefficient table, and returns the per-slot native predictions
    ``(k, g·B, *latent)`` in ``[cond; uncond]`` branch-major order with the
    tiled fusion weights and slot ids (both ``(g·B, k)``): the operands of
    the fused kernels.  ``velocity`` is the unfused form: ``predictions``
    then ``kernels.ops.fused_velocity``, the fused velocity
    ``(g·B, *latent)``.
    """

    name: str

    def predictions(self, plan: DispatchPlan, x, tb, cond_g: dict, g: int,
                    tab):
        ...

    def velocity(self, plan: DispatchPlan, x, tb, cond_g: dict, g: int,
                 tab) -> torch.Tensor:
        ...


class _FusedVelocity:
    """The shared unfused ``velocity``: ``predictions``, then one
    ``kernels.ops.fused_velocity``."""

    def velocity(self, plan: DispatchPlan, x, tb, cond_g: dict, g: int,
                 tab) -> torch.Tensor:
        preds, w_all, idx_all = self.predictions(plan, x, tb, cond_g, g, tab)
        return ops.fused_velocity(preds, _tile(x, g), w_all,
                                  slot_coef(tab, idx_all),
                                  clamp=self.conv.clamp,
                                  alpha_min=self.conv.alpha_min)


def _segment_predictions(apply_fn, store, plan: DispatchPlan, x, tb,
                         cond_g: dict, g: int, *, pow2: bool):
    """Per-slot predictions from one forward per expert with a non-empty
    segment (``GroupedExecutor`` and ``GatheredExecutor``).

    The ``N = g·B·k`` assignment rows (latents, times and conditioning,
    not parameters) are gathered into expert-sorted order.  The segment
    bounds are read to the host once per step; each expert with a
    non-empty segment runs ONE forward with its parameters from
    ``store.expert(e)`` (an expert with an empty segment skips its
    forward and, on a quantized store, its dequant).  With ``pow2`` the
    rows are zero-padded to the next power of two and each forward runs
    over the power-of-two bucket covering its segment, the rows outside
    the segment dropped; without it each forward runs over exactly its
    segment.  The predictions unsort to slot order ``(k, g·B, ...)``.
    """
    b = x.shape[0]
    k = plan.slots_per_sample
    cond_all = _flatten_groups(cond_g, g)
    p = tile_plan(plan, g)
    n = p.num_assignments                                  # g·B·k
    rows = _next_pow2(n) if pow2 else n

    sample_ids = p.sort_order // k                         # (N,)
    xs = _tile(x, g)[sample_ids]
    ts = _tile(tb, g)[sample_ids]
    cs = {key: v[sample_ids] for key, v in cond_all.items()}
    if rows > n:
        xs, ts = _pad_rows(xs, rows), _pad_rows(ts, rows)
        cs = {key: _pad_rows(v, rows) for key, v in cs.items()}

    # the segment bounds, read to the host once a step
    off = p.segment_offsets.tolist()  # lint: allow-host-sync
    buf = None
    for e in range(p.num_experts):
        lo, hi = off[e], off[e + 1]
        if hi == lo:
            continue                                       # no forward
        size = _next_pow2(hi - lo) if pow2 else hi - lo
        start = min(lo, rows - size)
        pred = apply_fn(
            store.expert(e), xs[start:start + size], ts[start:start + size],
            **{key: v[start:start + size] for key, v in cs.items()})
        if buf is None:
            buf = pred.new_zeros((n,) + tuple(pred.shape[1:]))
        buf[lo:hi] = pred[lo - start:hi - start]
    preds_flat = buf[p.unsort_order]                       # (N, *latent)
    preds = preds_flat.reshape((g * b, k) + tuple(preds_flat.shape[1:]))
    return preds.movedim(1, 0), p.slot_w, p.slot_idx       # (k, g·B, ...)


@dataclasses.dataclass
class GatheredExecutor(_FusedVelocity):
    """One forward per routed expert, over exactly its rows.

    The assignments are sorted by expert and each expert with a
    non-empty segment runs one forward over exactly that segment's rows
    (``_segment_predictions`` without padding), its parameters resolved
    through ``store.expert`` (a dense store's slice, or a quantized
    store's expansion through the dequant kernel) — never a ``(B, ...)``
    copy of the stacked parameters.  A batch-uniform plan resolves its
    one expert the same way and runs one forward over the ``g·B`` batch
    as it stands.
    """

    apply_fn: Callable[..., torch.Tensor]
    store: DenseStore | QuantizedStore
    conv: ConversionConfig
    name: str = "gathered"

    def predictions(self, plan, x, tb, cond_g, g, tab):
        if plan.uniform:
            # The whole batch routes to one expert: one gather, one forward.
            p = self.store.expert(int(plan.slot_idx[0, 0]))
            preds = self.apply_fn(p, _tile(x, g), _tile(tb, g),
                                  **_flatten_groups(cond_g, g))[None]
            return preds, _tile(plan.slot_w, g), _tile(plan.slot_idx, g)
        return _segment_predictions(self.apply_fn, self.store, plan, x, tb,
                                    cond_g, g, pow2=False)


@dataclasses.dataclass
class GroupedExecutor(_FusedVelocity):
    """Assignments sorted by expert; one forward per non-empty segment
    over the power-of-two bucket covering it (``_segment_predictions``
    with padding).  The bucket overshoot wastes fewer rows than the
    segment holds."""

    apply_fn: Callable[..., torch.Tensor]
    store: DenseStore | QuantizedStore
    conv: ConversionConfig
    name: str = "grouped"

    def predictions(self, plan, x, tb, cond_g, g, tab):
        return _segment_predictions(self.apply_fn, self.store, plan, x, tb,
                                    cond_g, g, pow2=True)


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``a`` zero-padded along its leading axis to ``rows``."""
    pad = a.new_zeros((rows - a.shape[0],) + tuple(a.shape[1:]))
    return torch.cat([a, pad])


@dataclasses.dataclass
class RaggedExecutor(_FusedVelocity):
    """Pair-major ragged execution: all experts' segments in one pass.

    The ``g`` guidance replicas of a (sample, slot) assignment share the
    latent, the timestep and the routed expert (``tile_plan`` repeats the
    slots per branch), so the sorted ``N = g·B·k`` rows regroup into
    ``P = B·k`` pairs of ``g`` replicas each.  The executor hands the
    ``ragged_apply_fn`` one representative latent per pair plus the
    per-pair expert ids, in expert-sorted pair order, and scatters the
    ``(P·g)`` predictions back to ``(k, g·B, ...)`` slot-major order.
    The store may be dense or quantized: its ``ragged_view`` goes to the
    forward as it is.
    """

    ragged_apply_fn: Callable[..., torch.Tensor]
    store: DenseStore | QuantizedStore
    conv: ConversionConfig
    name: str = "ragged"

    def predictions(self, plan: DispatchPlan, x, tb, cond_g: dict, g: int,
                    tab):
        """Routed per-slot predictions ``(k, g·B, *latent)`` in
        ``[cond; uncond]`` branch-major order, plus the tiled fusion
        weights and slot ids (both ``(g·B, k)``)."""
        b = x.shape[0]
        k = plan.slots_per_sample
        x_all = _tile(x, g)
        t_all = _tile(tb, g)
        cond_all = _flatten_groups(cond_g, g)
        p = tile_plan(plan, g)
        n = p.num_assignments                              # g·B·k
        npair = n // g                                     # B·k

        # Pair view of the sorted assignments: sorted row r is replica
        # ``gidx`` of pair ``pair`` (sample-major pair ids, slot minor).
        sample_ids = p.sort_order // k                     # (N,) in [0, g·B)
        gidx = sample_ids // b                             # guidance branch
        base = sample_ids % b                              # sample in [0, B)
        slot = p.sort_order % k
        pair = base * k + slot                             # (N,) pair id
        # pg_pos[q, j] = sorted position of pair q's replica j — exists and
        # is unique because tile_plan repeats each slot per branch.
        pg_pos = torch.zeros((npair, g), dtype=torch.int64, device=x.device)
        pg_pos[pair, gidx] = torch.arange(n, device=x.device)
        rep = pg_pos[:, 0]                                 # representative
        row_e = p.slot_idx.reshape(-1)[p.sort_order]       # (N,) expert/row
        pe = row_e[rep]                                    # (P,) expert/pair

        xs = x_all[sample_ids][rep]                        # (P, *latent)
        ts = t_all[sample_ids][rep]                        # (P,)
        cs = {key: v[sample_ids][pg_pos] for key, v in cond_all.items()}

        view = self.store.ragged_view()
        out = self.ragged_apply_fn(view, xs, ts, cs, pe, g)  # (P·g, ...)
        out = out.reshape((npair, g) + tuple(out.shape[1:]))
        preds_sorted = out[pair, gidx]                     # (N, *latent)
        preds_flat = preds_sorted[p.unsort_order]
        preds = preds_flat.reshape((g * b, k) + tuple(preds_flat.shape[1:]))
        return preds.movedim(1, 0), p.slot_w, p.slot_idx   # (k, g·B, ...)


@dataclasses.dataclass
class DenseExecutor(_FusedVelocity):
    """Every expert through its own ``apply_fn`` and parameters (no
    stacking), stacked in expert order — the slots of
    ``full_dispatch_plan``.  A batch-uniform plan runs only the routed
    expert (its id read to the host once per step)."""

    apply_fns: Sequence[Callable[..., torch.Tensor]]
    params: Sequence
    conv: ConversionConfig
    name: str = "dense"

    def predictions(self, plan, x, tb, cond_g, g, tab):
        x_all = _tile(x, g)
        t_all = _tile(tb, g)
        cond_all = _flatten_groups(cond_g, g)
        w_all = _tile(plan.slot_w, g)
        idx_all = _tile(plan.slot_idx, g)
        if plan.uniform:
            e = int(plan.slot_idx[0, 0])
            preds = self.apply_fns[e](self.params[e], x_all, t_all,
                                      **cond_all)[None]
        else:
            preds = torch.stack([
                fn(p, x_all, t_all, **cond_all)
                for fn, p in zip(self.apply_fns, self.params)])
        return preds, w_all, idx_all


def resolve_dispatch(dispatch: str, mode: str, stackable: bool,
                     uniform: bool = False, ragged_ok: bool = False) -> str:
    """Map a ``SamplerConfig.dispatch`` request to a concrete backend.

    ``mode`` is the resolved engine mode (``'routed'`` or ``'dense'``);
    ``stackable``: stacked parameters (or a store) are available;
    ``uniform``: the plan is batch-uniform (the threshold router);
    ``ragged_ok``: every expert publishes one shared ``ragged_apply_fn``.

    ``auto`` prefers ragged where it can run (stackable, per-sample
    routing, a shared ragged forward), then grouped, gathered for uniform
    plans, and dense for expert sets that do not stack.  An explicit
    backend whose preconditions fail raises ``ValueError``.
    """
    if dispatch not in DISPATCH_BACKENDS:
        raise ValueError(
            f"unknown dispatch backend {dispatch!r}; "
            f"expected one of {DISPATCH_BACKENDS}"
        )
    if mode == "dense":
        if dispatch in ("gathered", "grouped", "ragged"):
            raise ValueError(
                f"dispatch={dispatch!r} requires routed execution "
                f"(strategy in top1/topk/threshold with a routable expert "
                f"set); this configuration resolved to the dense engine"
            )
        return "dense"
    if dispatch == "auto":
        if not stackable:
            return "dense"
        if uniform:
            return "gathered"
        return "ragged" if ragged_ok else "grouped"
    if dispatch in ("gathered", "grouped", "ragged") and not stackable:
        raise ValueError(
            f"dispatch={dispatch!r} needs a shared apply_fn with stackable "
            f"params (see models.dit.stack_expert_params); heterogeneous "
            f"expert sets must use dispatch='dense'"
        )
    if dispatch == "ragged" and not ragged_ok:
        raise ValueError(
            "dispatch='ragged' needs a shared ragged_apply_fn on every "
            "ExpertSpec (see models.dit.make_ragged_expert_apply) and "
            "per-sample routing; this expert set does not publish one"
        )
    return dispatch


def make_executor(
    backend: str,
    *,
    apply_fns: Sequence[Callable[..., torch.Tensor]],
    params: Sequence | None,
    stacked_params,
    conv: ConversionConfig,
    ragged_apply_fn: Callable[..., torch.Tensor] | None = None,
) -> ExpertExecutor:
    """The executor of a resolved backend.  ``stacked_params`` is a store
    or a raw stacked tree (wrapped in a ``DenseStore``)."""
    if backend in ("gathered", "grouped", "ragged"):
        store = as_store(stacked_params)
        if store is None:
            raise ValueError(
                f"dispatch={backend!r} needs stacked params or an "
                f"ExpertParamStore; got None"
            )
        if backend == "gathered":
            return GatheredExecutor(apply_fns[0], store, conv)
        if backend == "ragged":
            if ragged_apply_fn is None:
                raise ValueError(
                    "dispatch='ragged' needs a shared ragged_apply_fn "
                    "(see models.dit.make_ragged_expert_apply)"
                )
            return RaggedExecutor(ragged_apply_fn, store, conv)
        return GroupedExecutor(apply_fns[0], store, conv)
    if backend == "dense":
        if params is None:
            raise ValueError(
                "dispatch='dense' runs each expert through its own params "
                "list, which this engine no longer holds (a quantized "
                "ExpertParamStore replaced the full-precision per-expert "
                "params); use a routed strategy or param_dtype='native'"
            )
        return DenseExecutor(tuple(apply_fns), tuple(params), conv)
    raise ValueError(f"unknown executor backend {backend!r}")
