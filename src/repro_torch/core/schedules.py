"""Noise schedules for diffusion / flow-matching experts (paper §2.3, §8.1).

* **linear** (rectified flow): ``alpha_t = 1 - t``, ``sigma_t = t`` — FM
  experts (Eq. 4).
* **cosine**: ``alpha_t = cos(pi t / 2)``, ``sigma_t = sin(pi t / 2)`` —
  DDPM experts (Eq. 26), variance preserving.

``t = 0`` is data, ``t = 1`` is noise for both families.  Discrete DDPM
timesteps follow Eq. 21: ``t_DiT = round(999 t)``.  All arithmetic is
float32 on tensors, in the reference's operation order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

#: §8.3.3 — derivative epsilon for finite differences.
FD_EPS = 1e-4

#: Eq. 21 — size of the pretrained DiT timestep-embedding table.
NUM_DDPM_TIMESTEPS = 1000


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A forward-process schedule ``x_t = alpha_t x0 + sigma_t eps``."""

    name: str
    alpha: Callable[[torch.Tensor], torch.Tensor]
    sigma: Callable[[torch.Tensor], torch.Tensor]
    dalpha: Callable[[torch.Tensor], torch.Tensor]
    dsigma: Callable[[torch.Tensor], torch.Tensor]

    def coeffs(self, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.alpha(t), self.sigma(t)

    def derivs(self, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.dalpha(t), self.dsigma(t)

    def fd_derivs(self, t: torch.Tensor, h: float = FD_EPS):
        """§8.3.3 central finite differences of the schedule coefficients."""
        da = (self.alpha(t + h) - self.alpha(t - h)) / (2.0 * h)
        ds = (self.sigma(t + h) - self.sigma(t - h)) / (2.0 * h)
        return da, ds


def coeff_table(
    schedule: Schedule, ts: torch.Tensor, *, derivative_mode: str = "analytic"
) -> torch.Tensor:
    """Precomputed ``(4, S)`` float32 table of ``(alpha, sigma, dalpha,
    dsigma)`` over the step grid ``ts``."""
    ts = torch.as_tensor(ts, dtype=torch.float32)
    a, s = schedule.coeffs(ts)
    if derivative_mode == "fd":
        da, ds = schedule.fd_derivs(ts)
    else:
        da, ds = schedule.derivs(ts)
    return torch.stack([
        torch.broadcast_to(c, ts.shape) for c in (a, s, da, ds)
    ]).to(torch.float32)


def linear_schedule() -> Schedule:
    """Rectified-flow linear interpolation: ``x_t = (1-t) x0 + t eps``."""
    return Schedule(
        name="linear",
        alpha=lambda t: 1.0 - t,
        sigma=lambda t: t,
        dalpha=lambda t: torch.full_like(t, -1.0, dtype=torch.float32),
        dsigma=lambda t: torch.full_like(t, 1.0, dtype=torch.float32),
    )


def cosine_schedule() -> Schedule:
    """Cosine VP schedule (Eq. 26/27)."""
    half_pi = math.pi / 2.0
    return Schedule(
        name="cosine",
        alpha=lambda t: torch.cos(half_pi * t),
        sigma=lambda t: torch.sin(half_pi * t),
        dalpha=lambda t: -half_pi * torch.sin(half_pi * t),
        dsigma=lambda t: half_pi * torch.cos(half_pi * t),
    )


_REGISTRY: dict[str, Callable[[], Schedule]] = {
    "linear": linear_schedule,
    "cosine": cosine_schedule,
}


def get_schedule(name: str) -> Schedule:
    try:
        return _REGISTRY[name]()
    except KeyError as e:
        raise ValueError(
            f"unknown schedule {name!r}; available: {sorted(_REGISTRY)}"
        ) from e


def to_ddpm_timestep(
    t: torch.Tensor, num_timesteps: int = NUM_DDPM_TIMESTEPS
) -> torch.Tensor:
    """Eq. 21 — map continuous ``t in [0,1]`` to the discrete table index.

    ``round(999 t)`` (half to even, in float32) clipped to ``[0, 999]``;
    integer inputs are already table indices and pass through clipped.
    """
    if not torch.is_floating_point(t):
        return torch.clamp(t, 0, num_timesteps - 1)
    idx = torch.round((num_timesteps - 1) * t.to(torch.float32))
    return torch.clamp(idx, 0, num_timesteps - 1).to(torch.int64)
