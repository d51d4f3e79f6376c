"""Expert dispatch: ``DispatchPlan`` and the ragged executor.

Each sampling step turns the fusion weights into a ``DispatchPlan`` — per
sample the top-``k`` routed expert slots and their weights, plus the
expert-sorted *group* view of the same assignments — and an executor runs
the routed experts.  This slice ports the backend ``dispatch='auto'``
picks for DiT experts, ``RaggedExecutor``: the routed (sample, slot)
pairs run as one pair-major forward in which every dense layer is a
single ragged grouped GEMM over all resident experts.

Plan invariants (``tests/test_torch_core.py``):

* ``segment_offsets`` is monotone, starts at 0 and ends at ``B·k``;
* ``unsort_order`` is the inverse permutation of ``sort_order``;
* sorted assignment ``r`` belongs to expert ``e`` iff
  ``segment_offsets[e] <= r < segment_offsets[e+1]``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.conversion import ConversionConfig
from repro_torch.core.fusion import stable_top_k
from repro_torch.core.param_store import DenseStore, QuantizedStore
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
    """

    slot_idx: torch.Tensor
    slot_w: torch.Tensor
    sort_order: torch.Tensor
    unsort_order: torch.Tensor
    segment_offsets: torch.Tensor
    num_experts: int

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
                    num_experts: int) -> DispatchPlan:
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
    )


def routed_slots(weights: torch.Tensor, k: int, *, valid=None):
    """Top-``k`` slot selection (the elastic ``valid`` guard is not ported
    yet)."""
    if valid is not None:
        raise NotImplementedError(
            "valid= (elastic membership) is not ported yet — ROADMAP.md, "
            "module queue A")
    return topk_slots(weights, k)


def make_dispatch_plan(weights: torch.Tensor, k: int, *,
                       valid=None) -> DispatchPlan:
    """Plan for routed execution: top-``k`` slots of the fusion weights."""
    slot_idx, slot_w = routed_slots(weights, k, valid=valid)
    return plan_from_slots(slot_idx, slot_w, weights.shape[-1])


def tile_plan(plan: DispatchPlan, g: int) -> DispatchPlan:
    """Plan for ``g`` stacked guidance branches of the same batch: the
    slots repeat ``g`` times (branch-major) and the group view is rebuilt
    over the ``g·B·k`` assignments."""
    if g == 1:
        return plan
    return plan_from_slots(
        torch.cat([plan.slot_idx] * g, dim=0),
        torch.cat([plan.slot_w] * g, dim=0),
        plan.num_experts,
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


@dataclasses.dataclass
class RaggedExecutor:
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

    def velocity(self, plan: DispatchPlan, x, tb, cond_g: dict, g: int,
                 tab) -> torch.Tensor:
        """Fused velocity ``(g·B, *latent)`` of the unfused step path:
        ``predictions`` then one ``kernels.ops.fused_velocity``."""
        preds, w_all, idx_all = self.predictions(plan, x, tb, cond_g, g, tab)
        return ops.fused_velocity(preds, _tile(x, g), w_all,
                                  slot_coef(tab, idx_all),
                                  clamp=self.conv.clamp,
                                  alpha_min=self.conv.alpha_min)


def resolve_dispatch(dispatch: str, mode: str, stackable: bool,
                     uniform: bool = False, ragged_ok: bool = False) -> str:
    """Map a ``SamplerConfig.dispatch`` request to a concrete backend.

    This slice runs the ragged backend only, which is what ``auto``
    resolves to for a stackable, per-sample-routed expert set that
    publishes a shared ``ragged_apply_fn``; every other outcome raises.
    """
    if dispatch not in DISPATCH_BACKENDS:
        raise ValueError(
            f"unknown dispatch backend {dispatch!r}; "
            f"expected one of {DISPATCH_BACKENDS}"
        )
    if dispatch not in ("auto", "ragged"):
        raise NotImplementedError(
            f"dispatch={dispatch!r} is not ported yet (only the ragged "
            f"backend is) — ROADMAP.md, module queue A"
        )
    if mode != "routed" or not stackable or uniform or not ragged_ok:
        raise NotImplementedError(
            "only the ragged backend is ported: it needs routed execution "
            "(strategy top1/topk), stackable params and a shared "
            "ragged_apply_fn on every expert — ROADMAP.md, module queue A"
        )
    return "ragged"
