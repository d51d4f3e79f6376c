"""Heterogeneous expert fusion (paper Fig. 2, Eq. 1, §3.1).

The router posterior ``p(k | x_t, t)`` becomes per-expert fusion weights:
``top1`` keeps the argmax expert, ``topk`` renormalizes over the K most
probable, ``full`` uses all of them.  Ties break toward the lower expert
index, as ``jax.lax.top_k`` does.  The §3.3.1 ``threshold`` router
switches between two experts at a native-time threshold, without the
router.  The §7.3 gate (``ddpm_low_noise_only``) then zeroes DDPM experts
above a noise level.

``unified_expert_velocities`` and ``fuse_predictions`` are the dense
reference arm (every expert, unified to velocity in plain ops, then
Eq. 1), which the reference engine and ``time_map='snr_match'`` run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.conversion import (ConversionConfig, ddpm_flags,
                                         snr_rebased_velocity,
                                         unify_prediction)
from repro_torch.core.schedules import Schedule, get_schedule


@dataclasses.dataclass(frozen=True)
class ExpertSpec:
    """Static description of one decentralized expert."""

    name: str
    objective: str                      # 'ddpm' | 'fm'
    schedule: str                       # 'cosine' | 'linear'
    apply_fn: Callable[..., torch.Tensor]   # (params, x_t, t, **cond)
    cluster_id: int = -1
    #: pair-major ragged forward (``models.dit.make_ragged_expert_apply``);
    #: a shared one on every expert selects the ragged backend.
    ragged_apply_fn: Callable[..., torch.Tensor] | None = None

    def get_schedule(self) -> Schedule:
        return get_schedule(self.schedule)


def stable_top_k(values: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, ties toward the lower index (a stable sort)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk(probs: torch.Tensor, k: int):
    """Top-K routing weights ``(weights, mask)``, both ``(B, K)``.

    Exactly ``k`` experts are selected (ties toward the lowest index) and
    the weights renormalize by the sum of the width-``k`` top values.
    """
    b, kk = probs.shape
    k = min(k, kk)
    vals, idx = stable_top_k(probs, k)
    mask = torch.zeros((b, kk), dtype=torch.bool, device=probs.device)
    mask.scatter_(1, idx, True)
    w = probs * mask
    return w / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-12), mask


def routing_weights(probs: torch.Tensor, strategy: str,
                    k: int = 2) -> torch.Tensor:
    """Map the router posterior to fusion weights per §3.1."""
    if strategy == "top1":
        w, _ = select_topk(probs, 1)
    elif strategy == "topk":
        w, _ = select_topk(probs, k)
    elif strategy == "full":
        w = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-12)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return w


def fuse_predictions(preds: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Eq. 1: ``sum_k w[:, k]·preds[k]`` of ``(K, B, ...)`` velocities and
    ``(B, K)`` weights."""
    k, b = preds.shape[0], preds.shape[1]
    w = weights.movedim(-1, 0).reshape((k, b) + (1,) * (preds.dim() - 2))
    return torch.sum(w * preds, dim=0)


def unified_expert_velocities(
    experts: Sequence[ExpertSpec],
    params: Sequence,
    x_t: torch.Tensor,
    t: torch.Tensor,
    cond: dict | None = None,
    *,
    conv_cfg: ConversionConfig = ConversionConfig(),
    time_map: str = "identity",
    path_schedule: Schedule | None = None,
) -> torch.Tensor:
    """Every expert at ``(x_t, t)``, unified into velocity space:
    ``(K, B, ...)``.  ``time_map='snr_match'`` rebases the experts whose
    schedule differs from the sampling path's (``snr_rebased_velocity``).
    """
    cond = cond or {}
    path = path_schedule or get_schedule("linear")
    outs = []
    for spec, p in zip(experts, params):
        sched = spec.get_schedule()
        if time_map == "snr_match" and sched.name != path.name:
            v = snr_rebased_velocity(
                spec.apply_fn, p, x_t, t, objective=spec.objective,
                expert_schedule=sched, path_schedule=path, cond=cond,
                cfg=conv_cfg)
        else:
            pred = spec.apply_fn(p, x_t, t, **cond)
            v = unify_prediction(pred, x_t, t, objective=spec.objective,
                                 schedule=sched, cfg=conv_cfg)
        outs.append(v)
    return torch.stack(outs, dim=0)


def fusion_weights(
    experts: Sequence[ExpertSpec],
    router_fn: Callable | None,
    x_t: torch.Tensor,
    t: torch.Tensor,
    *,
    strategy: str,
    top_k: int = 2,
    threshold: float = 0.5,
    ddpm_low_noise_only: float = 0.0,
    valid=None,
    cluster_map=None,
) -> torch.Tensor:
    """Per-step fusion weights ``(B, K)`` from the router posterior.

    ``ddpm_low_noise_only > 0`` is the §7.3 gate: ε→v conversion is only
    stable at low noise, so where ``t`` exceeds it the DDPM experts'
    weights are zeroed and the rest renormalized (a sample whose experts
    are all DDPM there keeps all-zero weights, as in the reference).
    ``strategy='threshold'`` never calls the router (``router_fn`` may be
    None).

    Elastic membership: ``valid`` (``(K,)`` bool) zeroes dead slots before
    the strategy selects, so every strategy renormalizes over the live
    experts once and a dead slot weighs exactly 0; ``cluster_map``
    (``(K,)`` int, a tensor on the router's device) gathers the router
    posterior's columns per slot in place of the specs' ``cluster_id``.
    """
    kk = len(experts)
    if strategy == "threshold":
        w = threshold_router_weights(t, kk, threshold=threshold)
        if valid is not None:
            w = w * valid[None, :]
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)
    elif router_fn is None:
        if kk != 1:
            raise ValueError("router_fn required for multi-expert fusion")
        w = torch.ones((x_t.shape[0], 1), device=x_t.device)
    else:
        probs = router_fn(x_t, t)                        # (B, num_clusters)
        # Map cluster posterior -> per-expert probs via each expert's
        # owned cluster (Eq. 1: p(k | x_t)).
        if cluster_map is not None:
            probs = probs[:, cluster_map]
        elif probs.shape[-1] != kk or any(
            e.cluster_id not in (-1, i) for i, e in enumerate(experts)
        ):
            cluster_ids = torch.tensor(
                [max(e.cluster_id, 0) for e in experts], device=probs.device)
            probs = probs[:, cluster_ids]
        if valid is not None:
            probs = probs * valid[None, :]
        w = routing_weights(probs, strategy, top_k)
    if ddpm_low_noise_only > 0.0:
        is_ddpm = ddpm_flags(tuple(e.objective for e in experts), w.device)
        high_noise = t > ddpm_low_noise_only                 # (B,)
        gate = torch.where(high_noise[:, None] & is_ddpm[None, :], 0.0, 1.0)
        w = w * gate
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)
    return w


def threshold_router_weights(
    t: torch.Tensor, num_experts: int, *, threshold: float = 0.5,
    low_noise_expert: int = 0, high_noise_expert: int = 1,
) -> torch.Tensor:
    """§3.3.1 deterministic two-expert threshold router: one-hot ``(B, K)``
    weights on ``low_noise_expert`` where ``t <= threshold``, else on
    ``high_noise_expert`` (an index outside ``0..K-1`` gives a zero row,
    as ``jax.nn.one_hot`` does)."""
    t = torch.as_tensor(t)
    b = t.shape[0] if t.dim() else 1
    thr = torch.tensor(threshold, dtype=torch.float32, device=t.device)
    pick = torch.where(t <= thr, low_noise_expert, high_noise_expert)
    pick = torch.broadcast_to(pick, (b,))
    ids = torch.arange(num_experts, device=t.device)
    return (pick[:, None] == ids[None]).to(torch.float32)


def prediction_conflict(preds: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """§7.5 diagnostic: the weighted variance of the expert velocities
    about their fusion, averaged per batch element ``(B,)``."""
    mean = fuse_predictions(preds, weights)
    diff = preds - mean[None]
    w = weights.movedim(-1, 0).reshape(
        (preds.shape[0], preds.shape[1]) + (1,) * (preds.dim() - 2))
    var = torch.sum(w * diff * diff, dim=0)
    return torch.mean(var.reshape(var.shape[0], -1), dim=-1)
