"""Schedule-aware ε→velocity conversion coefficients (paper §2.3, §8).

The sampler never converts predictions one expert at a time: it tabulates
per-step, per-expert coefficients once per run (``unified_coeff_tables``)
and hands them to the step-fused kernel (``kernels.ops.fused_step``),
which computes for every routed slot

    x̂0 = clip((x_t - sigma·pred) / max(alpha, alpha_min), ±clamp)
    v  = (dalpha·x̂0 + dsigma·pred) · vscale

(Eqs. 23–24 with the Eq. 28/29 safeguards and Eq. 31 dampening).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import torch

from repro_torch.core.schedules import Schedule, coeff_table

#: Eq. 28 — adaptive clamping ranges per representation space.
CLAMP_RANGE = {"latent": 20.0, "pixel": 5.0}

#: Eq. 29 — safe-division floor for alpha_t.
ALPHA_SAFE_MIN = 0.01


@dataclasses.dataclass(frozen=True)
class ConversionConfig:
    """Numerical-stability knobs from §8.3 / §6.2."""

    data_space: Literal["latent", "pixel"] = "latent"
    alpha_min: float = ALPHA_SAFE_MIN
    #: 'analytic' closed-form derivatives; 'fd' §8.3.3 central differences.
    derivative_mode: Literal["analytic", "fd"] = "analytic"
    #: Eq. 31 'piecewise', §6.2 'sigmoid', or 'none'.
    velocity_scaling: Literal["piecewise", "sigmoid", "none"] = "piecewise"

    @property
    def clamp(self) -> float:
        return CLAMP_RANGE[self.data_space]


def _f32(v: float) -> torch.Tensor:
    """A float32 scalar, so comparisons round the constant like the
    reference's weakly-typed Python scalars do (to float32, not double)."""
    return torch.tensor(v, dtype=torch.float32)


def velocity_scale(t: torch.Tensor, mode: str) -> torch.Tensor:
    """Eq. 31 (piecewise) or the §6.2 sigmoid dampening ``s(t)``."""
    t = torch.as_tensor(t, dtype=torch.float32)
    if mode == "none":
        return torch.ones_like(t)
    if mode == "piecewise":
        return torch.where(
            t > _f32(0.85), _f32(0.88),
            torch.where(t > _f32(0.6), _f32(0.93), _f32(0.96)),
        )
    if mode == "sigmoid":
        s = torch.clamp(15.0 / (1.0 + torch.exp(10.0 * (t - 0.85))),
                        max=1.0)
        return torch.where(t > _f32(0.85), s, torch.ones_like(t))
    raise ValueError(f"unknown velocity_scaling mode {mode!r}")


@functools.lru_cache(maxsize=64)
def ddpm_flags(objectives: tuple[str, ...],
               device: torch.device) -> torch.Tensor:
    """The ``(K,)`` bool flags ``objective == 'ddpm'`` on ``device``, made
    once per key and shared: a flag tensor built per call costs a blocking
    host-to-device copy on the card, once a step in the sampler."""
    for obj in objectives:
        if obj not in ("ddpm", "fm"):
            raise ValueError(f"unknown objective {obj!r}")
    return torch.tensor([o == "ddpm" for o in objectives], device=device)


def unified_coeff_tables(
    objectives: list[str],
    schedules: list[Schedule],
    ts: torch.Tensor,
    cfg: ConversionConfig = ConversionConfig(),
) -> torch.Tensor:
    """Per-step, per-expert conversion coefficients ``(S, 5, K)``.

    Row order ``(alpha, sigma, dalpha, dsigma, vscale)``.  DDPM experts get
    their schedule's coefficients plus the Eq. 31 dampening; FM experts the
    identity ``(1, 0, 0, 1, 1)``, under which the conversion reduces exactly
    to ``v = 0·x̂0 + 1·pred``.
    """
    ts = torch.as_tensor(ts, dtype=torch.float32)
    s = ts.shape[0]
    cols = []
    for obj, sched in zip(objectives, schedules):
        if obj == "fm":
            col = torch.tensor([1.0, 0.0, 0.0, 1.0, 1.0],
                               dtype=torch.float32)[:, None].repeat(1, s)
        elif obj == "ddpm":
            base = coeff_table(sched, ts,
                               derivative_mode=cfg.derivative_mode)  # (4, S)
            vs = velocity_scale(ts, cfg.velocity_scaling)            # (S,)
            col = torch.cat([base, vs[None]], dim=0)                 # (5, S)
        else:
            raise ValueError(f"unknown objective {obj!r}")
        cols.append(col)
    return torch.stack(cols, dim=-1).permute(1, 0, 2).contiguous()  # (S,5,K)
