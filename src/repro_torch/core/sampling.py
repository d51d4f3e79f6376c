"""Compute-sparse fused ODE sampling with heterogeneous experts (Fig. 2).

The sampler integrates the data-to-noise velocity backwards (t = 1 → 0)
with Euler steps ``x ← x − u·dt``.  Each step of the serving hot path:

1. the router posterior (a dense DiT forward) becomes top-``k`` fusion
   weights and a ``DispatchPlan`` (``core.fusion``, ``core.dispatch``);
2. the ``RaggedExecutor`` runs only the routed experts, with the cond and
   uncond CFG branches batched (``g = 2``) and every dense layer one
   ragged grouped GEMM kernel, from the store ``param_dtype`` selects
   (native, fp32/bf16 cast, or int8/fp8 quantized — ``core.param_store``);
3. one ``kernels.ops.fused_step`` kernel does the ε→v conversion, the
   router fusion, the CFG combine and the Euler update.

``step_fused=False`` keeps the unfused chain instead: the executor's
fused velocity (``kernels.ops.fused_velocity``), ``cfg_combine`` and
``x − u·dt`` as separate ops — bit-identical to the fused kernel.
``batched_cfg=False`` (or conditioning that cannot be batched) runs the
cond and uncond branches as two forwards.  ``plan_refresh_every = R``
runs item 1 (the router forward, the top-``k`` and the plan) only on
every R-th step and reuses the plan in between (R = 1: every step).
The per-run ``(S, 5, K)`` conversion tables are built once per run key
(``coeff_tables_cached``) and indexed per step.  Options of the
reference sampler outside this path raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import torch

from repro_torch.core.conversion import ConversionConfig, unified_coeff_tables
from repro_torch.core.dispatch import (
    RaggedExecutor,
    make_dispatch_plan,
    resolve_dispatch,
    slot_coef,
)
from repro_torch.core.fusion import ExpertSpec, fusion_weights
from repro_torch.core.param_store import as_store, make_store
from repro_torch.core.schedules import get_schedule
from repro_torch.kernels import ops
from repro_torch.models.dit import stack_expert_params

_QUEUE = "ROADMAP.md, module queue A"


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Inference settings (the reference's fields and defaults)."""

    num_steps: int = 50
    cfg_scale: float = 7.5
    strategy: str = "topk"          # 'top1' | 'topk' | 'full' | 'threshold'
    top_k: int = 2
    threshold: float = 0.5          # for strategy='threshold'
    conversion: ConversionConfig = dataclasses.field(
        default_factory=ConversionConfig
    )
    time_map: str = "identity"
    #: §7.3: above this t the DDPM experts' fusion weights are zeroed.
    ddpm_low_noise_only: float = 0.0
    #: stack cond/uncond along the batch so CFG costs one forward.
    batched_cfg: bool = True
    dispatch: str = "auto"
    param_dtype: str = "native"
    #: one fused kernel per step for convert + fuse + CFG + Euler.
    step_fused: bool = True
    #: rerun the router and the dispatch plan on every R-th step only.
    plan_refresh_every: int = 1


def _check_ported(config: SamplerConfig, engine: str) -> None:
    """Raise the reference's ``ValueError`` for plan reuse where it refuses
    it (in its order), then ``NotImplementedError`` for every sampler
    option the port has not ported."""
    r = config.plan_refresh_every
    if r != 1 and engine == "reference":
        raise ValueError(
            "plan_refresh_every > 1 requires the fused engines (the "
            "reference path recomputes routing every step by design)")
    if r != 1 and config.time_map != "identity":
        raise ValueError(
            "plan_refresh_every > 1 requires time_map='identity'; "
            "snr_match resolves to the reference engine, which "
            "recomputes routing every step by design")
    if r < 1:
        raise ValueError(f"plan_refresh_every must be >= 1, got {r}")
    if engine not in ("auto", "routed"):
        raise NotImplementedError(
            f"engine={engine!r} (the dense and reference engines) is not "
            f"ported yet — {_QUEUE}")
    if config.strategy not in ("top1", "topk"):
        raise NotImplementedError(
            f"strategy={config.strategy!r} is not ported yet (routed top1/"
            f"topk only) — {_QUEUE}")
    if config.time_map != "identity":
        raise NotImplementedError(
            f"time_map={config.time_map!r} is not ported yet — {_QUEUE}")


def cfg_combine(cond_pred: torch.Tensor, uncond_pred: torch.Tensor,
                scale: float) -> torch.Tensor:
    """Classifier-free guidance: ``u + s·(c − u)``."""
    return uncond_pred + scale * (cond_pred - uncond_pred)


def _cfg_batchable(cond: dict, null_cond: dict) -> bool:
    """Can the cond/uncond branches be expressed as one doubled batch?"""
    if "drop_mask" in cond or "drop_mask" in null_cond:
        return False
    for k, v in null_cond.items():
        if v is not None and cond.get(k) is None:
            return False
    return True


def _cfg_grouped_cond(cond: dict, null_cond: dict | None, batch: int) -> dict:
    """Per-sample CFG-branch conditioning: leaves gain a ``(B, G, ...)``
    group axis (G=2 cond/uncond, G=1 without guidance batching).  A branch
    without a value (the null text) is expressed by a ``drop_mask``."""
    if null_cond is None:
        return {k: v[:, None] for k, v in cond.items() if v is not None}
    out: dict = {}
    need_drop = False
    device = None
    for key in sorted(set(cond) | set(null_cond)):
        c, n = cond.get(key), null_cond.get(key)
        if c is None and n is None:
            continue
        if n is None:
            out[key] = torch.stack([c, c], dim=1)
            need_drop = True
            device = c.device
        else:
            out[key] = torch.stack([c, n], dim=1)
    if need_drop:
        out["drop_mask"] = torch.tensor(
            [False, True], device=device)[None].expand(batch, 2)
    return out


@functools.lru_cache(maxsize=128)
def _time_grid(num_steps: int) -> torch.Tensor:
    """Euler time grid, byte-equal to ``jnp.linspace(1, 0, S+1)`` in
    float32: ``1·(1 − i/S) + 0·(i/S)`` for ``i < S``, then exactly 0.

    Byte equality matters: ``round(999·t)`` picks each step's timestep
    embedding row, and a 1-ulp difference can flip it.
    """
    step = torch.arange(num_steps, dtype=torch.float32) / torch.tensor(
        num_steps, dtype=torch.float32)
    out = 1.0 * (1.0 - step) + 0.0 * step
    return torch.cat([out, torch.zeros(1, dtype=torch.float32)])


@functools.lru_cache(maxsize=128)
def coeff_tables_cached(
    objectives: tuple[str, ...],
    schedule_names: tuple[str, ...],
    num_steps: int,
    conv: ConversionConfig,
) -> torch.Tensor:
    """Per-run ``(S, 5, K)`` ``unified_coeff_tables`` (on the CPU), cached
    by its run key."""
    return unified_coeff_tables(
        list(objectives), [get_schedule(n) for n in schedule_names],
        _time_grid(num_steps)[:-1], conv,
    )


def _sample_fused(
    experts: Sequence[ExpertSpec],
    params: Sequence | None,
    router_fn,
    cond: dict,
    null_cond: dict | None,
    config: SamplerConfig,
    init_noise: torch.Tensor,
    stacked_params=None,
) -> torch.Tensor:
    K = len(experts)
    B = init_noise.shape[0]
    device = init_noise.device
    conv = config.conversion

    use_cfg = null_cond is not None and config.cfg_scale != 1.0
    batched = use_cfg and config.batched_cfg \
        and _cfg_batchable(cond, null_cond or {})
    k_slots = 1 if config.strategy == "top1" else min(config.top_k, K)

    stacked = as_store(stacked_params, dtype=config.param_dtype)
    if stacked is None:
        if params is None:
            raise ValueError("params=None requires stacked_params")
        stacked = make_store(stack_expert_params(params),
                             dtype=config.param_dtype)

    ragged_fn = experts[0].ragged_apply_fn
    ragged_ok = ragged_fn is not None and all(
        e.ragged_apply_fn is ragged_fn for e in experts)
    homogeneous = all(e.apply_fn is experts[0].apply_fn for e in experts)
    resolve_dispatch(config.dispatch, "routed", homogeneous, False,
                     ragged_ok)
    executor = RaggedExecutor(ragged_fn, stacked, conv)

    ts = _time_grid(config.num_steps).to(device)
    tables = coeff_tables_cached(
        tuple(e.objective for e in experts),
        tuple(e.schedule for e in experts),
        config.num_steps, conv,
    ).to(device)                                          # (S, 5, K)

    # The forwards of one step: one batched [cond; uncond] forward, the
    # two branches of two-pass CFG (cond, then uncond), or one without CFG.
    if batched:
        forwards = [(_cfg_grouped_cond(cond, null_cond or {}, B), 2)]
    elif use_cfg:
        forwards = [(_cfg_grouped_cond(cond, None, B), 1),
                    (_cfg_grouped_cond(dict(null_cond or {}), None, B), 1)]
    else:
        forwards = [(_cfg_grouped_cond(cond, None, B), 1)]

    def velocity_update(plan, x, tb, dt, tab):
        # Unfused chain: fused velocity, CFG combine, Euler.
        us = [executor.velocity(plan, x, tb, cond_g, g, tab)
              for cond_g, g in forwards]
        if batched:
            u = cfg_combine(us[0][:B], us[0][B:], config.cfg_scale)
        elif use_cfg:
            u = cfg_combine(us[0], us[1], config.cfg_scale)
        else:
            u = us[0]
        return x - u * dt

    def fused_step_update(plan, x, tb, dt, tab):
        # One kernel for convert + fuse + CFG + Euler; two-pass CFG
        # concatenates the branches into the batched layout [cond; uncond].
        outs = [executor.predictions(plan, x, tb, cond_g, g, tab)
                for cond_g, g in forwards]
        if len(outs) == 1:
            preds, w_all, idx_all = outs[0]
        else:
            preds = torch.cat([o[0] for o in outs], dim=1)
            w_all = torch.cat([o[1] for o in outs], dim=0)
            idx_all = torch.cat([o[2] for o in outs], dim=0)
        g = 2 if use_cfg else 1
        return ops.fused_step(
            preds, x, w_all, slot_coef(tab, idx_all), dt,
            g=g, cfg_scale=config.cfg_scale if use_cfg else 1.0,
            clamp=conv.clamp, alpha_min=conv.alpha_min,
        )

    update = fused_step_update if config.step_fused else velocity_update
    x = init_noise
    plan = None
    for i in range(config.num_steps):
        t_hi, t_lo = ts[i], ts[i + 1]
        tb = t_hi.expand(B)
        if i % config.plan_refresh_every == 0:        # step 0 always
            w = fusion_weights(
                experts, router_fn, x, tb,
                strategy=config.strategy, top_k=config.top_k,
                threshold=config.threshold,
                ddpm_low_noise_only=config.ddpm_low_noise_only,
            )                                             # (B, K)
            plan = make_dispatch_plan(w, k_slots)
        x = update(plan, x, tb, t_hi - t_lo, tables[i])
    return x


def sample_ensemble(
    experts: Sequence[ExpertSpec],
    params: Sequence | None,
    router_fn: Callable | None,
    shape: tuple[int, ...],
    *,
    generator: torch.Generator | None = None,
    cond: dict | None = None,
    null_cond: dict | None = None,
    config: SamplerConfig | None = None,
    engine: str = "auto",
    init_noise: torch.Tensor | None = None,
    stacked_params=None,
    device=None,
) -> torch.Tensor:
    """Euler-ODE sampling with router-weighted heterogeneous fusion.

    ``init_noise`` (``shape``) is the starting latent; without it the
    noise is drawn from ``generator`` on ``device`` (default: the
    generator's device).  ``stacked_params`` (a store of
    ``core.param_store`` or a raw stacked tree, stored as
    ``config.param_dtype`` says) lets a long-lived engine stack its
    experts once.
    Returns the samples at t = 0.
    """
    cond = cond or {}
    config = config if config is not None else SamplerConfig()
    _check_ported(config, engine)
    if len(experts) < 2:
        raise NotImplementedError(
            f"single-expert sampling (the dense engine) is not ported yet "
            f"— {_QUEUE}")
    if init_noise is None:
        if generator is None:
            raise ValueError("sample_ensemble needs generator= or "
                             "init_noise=")
        init_noise = torch.randn(
            shape, generator=generator, dtype=torch.float32,
            device=device if device is not None else generator.device)
    elif tuple(init_noise.shape) != tuple(shape):
        raise ValueError(f"init_noise shape {tuple(init_noise.shape)} != "
                         f"{tuple(shape)}")
    return _sample_fused(experts, params, router_fn, cond, null_cond,
                         config, init_noise, stacked_params)
