"""Training objectives for heterogeneous experts (paper §2.3, §2.4).

Port of ``repro.core.objectives``.  Two objective families:

* ``ddpm`` — ε-prediction (Eq. 3) under a cosine schedule,
* ``fm``   — velocity prediction (Eq. 4) under the linear interpolation path,

plus the Prop.-1 implicit timestep weights ``w_eps = alpha^2/sigma^2`` and
``w_v = 1/sigma^2``, and the diffusion v-parameterization of Salimans & Ho
(``v = alpha eps - sigma x0``) referenced in §2.4's notation remark.

Random draws come from an explicit ``torch.Generator`` (the reference
splits a JAX key): the same distributions, another stream of numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.conversion import _left_broadcast
from repro_torch.core.schedules import Schedule

# Objective identifiers (also used in configs / checkpoints metadata).
DDPM = "ddpm"
FLOW_MATCHING = "fm"


@dataclasses.dataclass(frozen=True)
class Objective:
    """A diffusion objective = (prediction target, default schedule)."""

    name: str
    default_schedule: str

    @property
    def predicts(self) -> str:
        return {"ddpm": "epsilon", "fm": "velocity"}[self.name]


def get_objective(name: str) -> Objective:
    if name == DDPM:
        return Objective(name=DDPM, default_schedule="cosine")
    if name == FLOW_MATCHING:
        return Objective(name=FLOW_MATCHING, default_schedule="linear")
    raise ValueError(f"unknown objective {name!r}")


def target_for(objective: str, schedule: Schedule, x0: torch.Tensor,
               eps: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Regression target for the given objective.

    * DDPM (Eq. 3): target is ``eps``.
    * FM (Eq. 4): the path velocity ``dalpha/dt * x0 + dsigma/dt * eps``
      (``eps - x0`` on the linear path).
    """
    if objective == DDPM:
        return eps
    if objective == FLOW_MATCHING:
        da, ds = schedule.derivs(t)
        da = _left_broadcast(da, x0.dim())
        ds = _left_broadcast(ds, x0.dim())
        return da * x0 + ds * eps
    raise ValueError(f"unknown objective {objective!r}")


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over every element, in float32."""
    return torch.mean(torch.square(pred.to(torch.float32)
                                   - target.to(torch.float32)))


def diffusion_loss(
    apply_fn: Callable[..., torch.Tensor],
    params,
    x0: torch.Tensor,
    eps: torch.Tensor,
    t: torch.Tensor,
    *,
    objective: str,
    schedule: Schedule,
    cond: dict | None = None,
) -> torch.Tensor:
    """Per-expert isolated loss (Eq. 3 / Eq. 4).

    ``apply_fn(params, x_t, t, **cond)`` is the expert network; there is no
    cross-expert term anywhere — decentralization is structural.
    """
    x_t = schedule.perturb(x0, eps, t)
    pred = apply_fn(params, x_t, t, **(cond or {}))
    target = target_for(objective, schedule, x0, eps, t)
    return mse_loss(pred, target)


# ---------------------------------------------------------------------------
# Prop. 1 — implicit timestep weighting (paper §2.4).
# ---------------------------------------------------------------------------


def w_eps(schedule: Schedule, t: torch.Tensor) -> torch.Tensor:
    """Eq. 9 — ε-prediction weight ``alpha^2 / sigma^2`` (== SNR)."""
    a, s = schedule.coeffs(t)
    return (a * a) / torch.clamp(s * s, min=1e-12)


def w_v(schedule: Schedule, t: torch.Tensor) -> torch.Tensor:
    """Eq. 10 — velocity-prediction weight ``1 / sigma^2``."""
    _, s = schedule.coeffs(t)
    return 1.0 / torch.clamp(s * s, min=1e-12)


def weight_ratio(schedule: Schedule, t: torch.Tensor) -> torch.Tensor:
    """Eq. 11 — ``w_v / w_eps = 1 / alpha^2`` (>= 1, diverges as t→1)."""
    a, _ = schedule.coeffs(t)
    return 1.0 / torch.clamp(a * a, min=1e-12)


# ---------------------------------------------------------------------------
# Salimans–Ho v-parameterization (§2.4 notation remark; limitation iii).
# ---------------------------------------------------------------------------


def sh_v_target(schedule: Schedule, x0: torch.Tensor, eps: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """Diffusion v-param target ``v = alpha_t eps - sigma_t x0`` (VP only)."""
    a, s = schedule.coeffs(t)
    a = _left_broadcast(a, x0.dim())
    s = _left_broadcast(s, x0.dim())
    return a * eps - s * x0


def sh_v_to_x0(schedule: Schedule, x_t: torch.Tensor, v: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Under VP (``alpha^2+sigma^2=1``): ``x0 = alpha x_t - sigma v``."""
    a, s = schedule.coeffs(t)
    a = _left_broadcast(a, x_t.dim())
    s = _left_broadcast(s, x_t.dim())
    return a * x_t - s * v


def sample_timesteps(gen: torch.Generator, batch: int, *, objective: str,
                     dtype=torch.float32) -> torch.Tensor:
    """Uniform timestep sampling in each objective's native domain (§6.3),
    on ``gen``'s device.

    DDPM experts: discrete ``t ~ U{0..999}`` divided by 999; FM experts
    ``t ~ U(0,1)``.
    """
    if objective == DDPM:
        idx = torch.randint(0, 1000, (batch,), generator=gen,
                            device=gen.device)
        return idx.to(dtype) / torch.tensor(999.0, dtype=dtype,
                                            device=gen.device)
    return torch.rand((batch,), generator=gen, device=gen.device,
                      dtype=dtype)
