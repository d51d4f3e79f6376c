"""Schedule-aware ε→velocity conversion (paper §2.3, §8).

The fused engines never convert predictions one expert at a time: they
tabulate per-step, per-expert coefficients once per run
(``unified_coeff_tables``) and hand them to the step-fused kernel
(``kernels.ops.fused_step``), which computes for every routed slot

    x̂0 = clip((x_t - sigma·pred) / max(alpha, alpha_min), ±clamp)
    v  = (dalpha·x̂0 + dsigma·pred) · vscale

(Eqs. 23–24 with the Eq. 28/29 safeguards and Eq. 31 dampening).  The
reference engine converts per expert in plain ops (``unify_prediction``,
and ``snr_rebased_velocity`` for ``time_map='snr_match'``).

The checkpoint side of §2.6, Eq. 20 (``convert_checkpoint``): a
pretrained class-conditional DiT's groups transferred, re-initialized,
dropped or newly initialized into a text-conditioned expert.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import torch

from repro_torch.core.schedules import (Schedule, coeff_table,
                                        snr_matched_time)
from repro_torch.tree import tree_leaves

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


def _left_broadcast(c, ndim: int) -> torch.Tensor:
    """Reshape a per-sample coefficient ``(B,)`` to ``(B, 1, ..., 1)``."""
    c = torch.as_tensor(c)
    return c.reshape(tuple(c.shape) + (1,) * (ndim - c.dim()))


def predict_x0_from_eps(x_t, eps, schedule: Schedule, t,
                        cfg: ConversionConfig = ConversionConfig()):
    """Eq. 23 with the Eq. 28/29 safeguards."""
    a, s = schedule.coeffs(t)
    a_safe = _left_broadcast(torch.clamp(a, min=cfg.alpha_min), x_t.dim())
    s = _left_broadcast(s, x_t.dim())
    x0_hat = (x_t - s * eps) / a_safe
    return torch.clamp(x0_hat, -cfg.clamp, cfg.clamp)


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


def eps_to_velocity(x_t, eps, schedule: Schedule, t,
                    cfg: ConversionConfig = ConversionConfig()):
    """Eqs. 22–25 with the §8.3 safeguards: the data-to-noise velocity
    (sampling integrates ``x_{t-dt} = x_t - v·dt``)."""
    x0_hat = predict_x0_from_eps(x_t, eps, schedule, t, cfg)
    if cfg.derivative_mode == "fd":
        da, ds = schedule.fd_derivs(t)
    else:
        da, ds = schedule.derivs(t)
    da = _left_broadcast(da, x_t.dim())
    ds = _left_broadcast(ds, x_t.dim())
    v = da * x0_hat + ds * eps
    scale = _left_broadcast(velocity_scale(t, cfg.velocity_scaling),
                            x_t.dim())
    return scale * v


def velocity_to_x0(x_t, v, schedule: Schedule, t,
                   cfg: ConversionConfig = ConversionConfig()):
    """x0 from a velocity: ``x0 = (s'·x_t − s·v) / (s'·a − s·a')``, the
    denominator kept at least 1e-6 away from 0, then clamped."""
    a, s = schedule.coeffs(t)
    da, ds = schedule.derivs(t)
    denom = ds * a - s * da
    denom = torch.where(torch.abs(denom) < _f32(1e-6),
                        torch.sign(denom) * 1e-6 + (denom == 0) * 1e-6,
                        denom)
    a, s, da, ds, denom = (
        _left_broadcast(c, x_t.dim()) for c in (a, s, da, ds, denom))
    x0 = (ds * x_t - s * v) / denom
    return torch.clamp(x0, -cfg.clamp, cfg.clamp)


def unify_prediction(pred, x_t, t, *, objective: str, schedule: Schedule,
                     cfg: ConversionConfig = ConversionConfig()):
    """An expert's native prediction in the common velocity space: FM
    passes through, DDPM goes through :func:`eps_to_velocity`."""
    if objective == "fm":
        return pred
    if objective == "ddpm":
        return eps_to_velocity(x_t, pred, schedule, t, cfg)
    raise ValueError(f"unknown objective {objective!r}")


def snr_rebased_velocity(apply_fn, params, x_t, t, *, objective: str,
                         expert_schedule: Schedule, path_schedule: Schedule,
                         cond: dict | None = None,
                         cfg: ConversionConfig = ConversionConfig()):
    """SNR-matched cross-schedule conversion (§5.ii): query the expert at
    ``t_e`` with ``SNR_expert(t_e) = SNR_path(t)`` on the rescaled input
    ``x_t·s_e(t_e)/s_p(t)``, recover ``(x̂0, ε̂)`` in the expert's frame
    and rebuild the velocity along the sampling path."""
    cond = cond or {}
    nd = x_t.dim()
    t_e = snr_matched_time(path_schedule, expert_schedule, t)
    s_p = torch.clamp(path_schedule.sigma(t), min=1e-6)
    s_e = expert_schedule.sigma(t_e)
    x_in = x_t * _left_broadcast(s_e / s_p, nd)
    pred = apply_fn(params, x_in, t_e, **cond)

    a_e, s_e_b = (_left_broadcast(c, nd)
                  for c in expert_schedule.coeffs(t_e))
    if objective == "ddpm":
        eps_hat = pred
        x0_hat = torch.clamp(
            (x_in - s_e_b * eps_hat) / torch.clamp(a_e, min=cfg.alpha_min),
            -cfg.clamp, cfg.clamp)
    else:       # a velocity in the expert's frame -> (x0, eps)
        x0_hat = velocity_to_x0(x_in, pred, expert_schedule, t_e, cfg)
        eps_hat = (x_in - a_e * x0_hat) / torch.clamp(s_e_b, min=1e-6)

    da_p, ds_p = path_schedule.derivs(t)
    return _left_broadcast(da_p, nd) * x0_hat \
        + _left_broadcast(ds_p, nd) * eps_hat


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


# ---------------------------------------------------------------------------
# Checkpoint conversion (paper §2.6, Eq. 20) — pretrained ImageNet-DDPM DiT
# checkpoints initialize heterogeneous text-conditioned experts.
# ---------------------------------------------------------------------------

#: Eq. 20 transfer policy by top-level parameter group.
TRANSFER = "transfer"          # copy pretrained weights
REINIT = "reinit"              # N(0, 0.02)
DROP = "drop"                  # remove (class embeddings)
NEW = "new"                    # not in source checkpoint (text stack)

CHECKPOINT_POLICY: dict[str, str] = {
    "patch_embed": TRANSFER,
    "pos_embed": TRANSFER,
    "blocks": TRANSFER,
    "t_embed": TRANSFER,          # timestep MLP kept (Eq. 21 runtime mapping)
    "adaln_single": TRANSFER,
    "final_layer": REINIT,
    "text_proj": NEW,
    "cross_attn": NEW,            # zero-init output proj from the model init
    "class_embed": DROP,
    "null_text_embed": NEW,
}

REINIT_STD = 0.02


def convert_checkpoint(
    pretrained: dict,
    target_template: dict,
    *,
    gen: torch.Generator | None = None,
    policy: dict[str, str] | None = None,
    draws: dict | None = None,
) -> tuple[dict, dict[str, str]]:
    """Apply the Eq. 20 conversion to a parameter tree.

    ``pretrained`` / ``target_template`` are dicts keyed by top-level group
    (``patch_embed``, ``blocks``, ...) of nested dicts of tensors.  Groups
    present in the template but absent from the policy are transferred
    when their shapes match, else keep the template's fresh init.  Groups
    go in sorted order, as in the reference.  A REINIT group's leaves are
    ``REINIT_STD`` times standard normals drawn from ``gen`` (on each
    leaf's device), or taken from ``draws[group]``: a list of standard
    normal arrays, one per leaf in ``tree_leaves`` order.

    Returns ``(params, report)`` where ``report`` maps group -> action.
    """
    policy = dict(CHECKPOINT_POLICY if policy is None else policy)
    draws = draws or {}
    out: dict = {}
    report: dict[str, str] = {}
    for group, template in sorted(target_template.items()):
        action = policy.get(group)
        if action is None:
            same = group in pretrained and _shapes_match(
                pretrained[group], template)
            action = TRANSFER if same else NEW
        if action == TRANSFER and group in pretrained and _shapes_match(
                pretrained[group], template):
            src = iter(tree_leaves(pretrained[group]))
            out[group] = _rebuild(template, lambda dst: next(src).to(
                device=dst.device, dtype=dst.dtype))
            report[group] = TRANSFER
        elif action == REINIT:
            given = iter(draws[group]) if group in draws else None

            def fresh(dst):
                if given is not None:
                    z = torch.as_tensor(next(given), dtype=torch.float32,
                                        device=dst.device)
                else:
                    z = torch.randn(tuple(dst.shape), generator=gen,
                                    device=dst.device, dtype=torch.float32)
                return (REINIT_STD * z).to(dst.dtype)

            out[group] = _rebuild(template, fresh)
            report[group] = REINIT
        elif action == DROP:
            report[group] = DROP
            continue
        else:
            # NEW (or transfer-miss): keep the freshly initialized template.
            out[group] = template
            report[group] = NEW
    # groups only in the source (e.g. class_embed) are dropped implicitly.
    for group in pretrained:
        if group not in target_template:
            report.setdefault(group, DROP)
    return out, report


def _rebuild(template, leaf_fn):
    """``template``'s structure with every leaf replaced by
    ``leaf_fn(leaf)``, the leaves visited in ``tree_leaves`` (sorted-key)
    order."""
    if isinstance(template, dict):
        built = {k: _rebuild(template[k], leaf_fn) for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaf_fn) for v in template)
    return leaf_fn(template)


def _shapes_match(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(tuple(x.shape) == tuple(y.shape) for x, y in zip(la, lb))
