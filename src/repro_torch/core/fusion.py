"""Heterogeneous expert fusion weights (paper Fig. 2, Eq. 1, §3.1).

The router posterior ``p(k | x_t, t)`` becomes per-expert fusion weights:
``top1`` keeps the argmax expert, ``topk`` renormalizes over the K most
probable, ``full`` uses all of them.  Ties break toward the lower expert
index, as ``jax.lax.top_k`` does.  The §7.3 gate
(``ddpm_low_noise_only``) then zeroes DDPM experts above a noise level.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.conversion import ddpm_flags
from repro_torch.core.schedules import Schedule, get_schedule

_NOT_PORTED = "not ported yet — ROADMAP.md, module queue A"


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
    Elastic membership (``valid``, ``cluster_map``) and the threshold
    router are not ported yet and raise.
    """
    if valid is not None or cluster_map is not None:
        raise NotImplementedError(
            f"valid=/cluster_map= (elastic membership) {_NOT_PORTED}")
    if strategy == "threshold":
        raise NotImplementedError(f"strategy='threshold' {_NOT_PORTED}")
    kk = len(experts)
    if router_fn is None:
        if kk != 1:
            raise ValueError("router_fn required for multi-expert fusion")
        return torch.ones((x_t.shape[0], 1), device=x_t.device)
    probs = router_fn(x_t, t)                            # (B, num_clusters)
    # Map cluster posterior -> per-expert probs via each expert's owned
    # cluster (Eq. 1: p(k | x_t)).
    if probs.shape[-1] != kk or any(
        e.cluster_id not in (-1, i) for i, e in enumerate(experts)
    ):
        cluster_ids = torch.tensor([max(e.cluster_id, 0) for e in experts],
                                   device=probs.device)
        probs = probs[:, cluster_ids]
    w = routing_weights(probs, strategy, top_k)
    if ddpm_low_noise_only > 0.0:
        is_ddpm = ddpm_flags(tuple(e.objective for e in experts), w.device)
        high_noise = t > ddpm_low_noise_only                 # (B,)
        gate = torch.where(high_noise[:, None] & is_ddpm[None, :], 0.0, 1.0)
        w = w * gate
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)
    return w
