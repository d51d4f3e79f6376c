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

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        """Signal-to-noise ratio ``alpha^2 / sigma^2``."""
        a, s = self.coeffs(t)
        return (a * a) / torch.clamp(s * s, min=1e-12)

    def perturb(self, x0: torch.Tensor, eps: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """Forward process ``x_t = alpha_t x0 + sigma_t eps`` (Eq. 22);
        ``t`` broadcasts against the leading axes of ``x0``."""
        a, s = self.coeffs(t)
        ex = tuple(a.shape) + (1,) * (x0.dim() - a.dim())
        return a.reshape(ex) * x0 + s.reshape(ex) * eps


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


def from_ddpm_timestep(
    idx, num_timesteps: int = NUM_DDPM_TIMESTEPS
) -> torch.Tensor:
    """Inverse of :func:`to_ddpm_timestep` (the continuous grid point)."""
    return torch.as_tensor(idx).to(torch.float32) / float(num_timesteps - 1)


def snr_matched_time(
    source: Schedule, target: Schedule, t: torch.Tensor, *, iters: int = 40
) -> torch.Tensor:
    """``t'`` with ``target.snr(t') == source.snr(t)``, by bisection (both
    families have an SNR that decreases in t).

    The reference's ``iters``-step float32 loop in its operation order:
    ``t'`` picks the expert's timestep row ``round(999·t')``, where one
    ulp can flip the row.
    """
    want = torch.log(source.snr(t) + 1e-20)
    lo = torch.zeros_like(torch.as_tensor(t, dtype=torch.float32))
    hi = torch.ones_like(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        got = torch.log(target.snr(mid) + 1e-20)
        # SNR decreases with t: got > want -> need larger t.
        go_right = got > want
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi,
                                                             mid)
    return 0.5 * (lo + hi)
