"""Compute-sparse fused ODE sampling with heterogeneous experts (Fig. 2).

The sampler integrates the data-to-noise velocity backwards (t = 1 → 0)
with Euler steps ``x ← x − u·dt``.  ``sample_ensemble`` resolves one of
three engines (``_resolve_engine``, the reference's rules):

* **routed** (strategies ``top1``/``topk``/``threshold``): each step the
  router posterior (a dense DiT forward; the threshold router needs none)
  becomes fusion weights and a ``DispatchPlan`` (``core.fusion``,
  ``core.dispatch``), and an executor runs only the routed experts —
  for DiT experts the ``RaggedExecutor``, every dense layer one ragged
  grouped GEMM over a store ``param_dtype`` selects; the threshold
  router's batch-uniform plan one gathered expert;
* **dense** (``full``, or expert sets that do not stack): every expert
  runs, through the ``DenseExecutor``, with the whole weight matrix as
  its ``K`` slots;
* **reference**: every expert per CFG branch, unified to velocity in
  plain ops and fused by Eq. 1 (``fuse_predictions``) — the parity
  oracle, and the only engine of ``time_map='snr_match'``.

In the routed and dense engines one ``kernels.ops.fused_step`` kernel
does the ε→v conversion, the fusion, the CFG combine and the Euler
update.  ``step_fused=False`` keeps the unfused chain instead: the
executor's fused velocity (``kernels.ops.fused_velocity``),
``cfg_combine`` and ``x − u·dt`` as separate ops — bit-identical to the
fused kernel.  ``batched_cfg=False`` (or conditioning that cannot be
batched) runs the cond and uncond branches as two forwards.
``plan_refresh_every = R`` runs the routing only on every R-th step.  The
per-run ``(S, 5, K)`` conversion tables are built once per run key
(``coeff_tables_cached``) and indexed per step.

Elastic engines pass a capacity store carrying a ``valid`` mask, and the
per-slot ``(S, 5, K_cap)`` tables and ``(K_cap,)`` cluster map as tensors
(``coeff_tables=``, ``cluster_map=``): routing renormalizes over the live
slots and no executor touches a dead slot.

On an ``("expert", "data")`` mesh (``mesh=``, ``launch.mesh``) every rank
draws or takes the whole batch's noise and runs its "data" slice of the
rows, the router and the plans replicated over "expert"; the executor
runs the rank's resident experts and one "expert" all-reduce a step
completes the per-slot predictions before the step kernel
(``core.dispatch``).  The reference engine runs the rank's resident
experts per branch and one "expert" all-gather a step stacks their
velocities in expert order before the fusion.  The slices' latents are
all-gathered over "data", so every rank returns the whole batch, and the
latents do not depend on the mesh.

``sample_ensemble_step`` is one Euler step of a mixed-timestep batch (the
continuous scheduler's unit of work): each row at its own step index,
one ``fused_step`` launch with a per-row ``dt``.  On a mesh the rank
steps its "data" rows of the batch on its resident experts.

Also here: ``sample_single_expert`` (Table 3's single-expert rows) and
the native DDPM sampler ``sample_ddpm_ancestral``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import torch

from repro_torch.core.conversion import ConversionConfig, unified_coeff_tables
from repro_torch.core.dispatch import (
    full_dispatch_plan,
    make_dispatch_plan,
    make_executor,
    plan_from_slots,
    resolve_dispatch,
    routed_slots,
    slot_coef,
    slot_coef_rows,
)
from repro_torch.core.fusion import (
    ExpertSpec,
    fuse_predictions,
    fusion_weights,
    unified_expert_velocities,
)
from repro_torch.core.param_store import as_store, make_store
from repro_torch.core.schedules import get_schedule
from repro_torch.kernels import ops
from repro_torch.models.dit import stack_expert_params
from repro_torch.tree import tree_leaves, tree_structure


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


def params_are_stackable(params: Sequence) -> bool:
    """True when every expert's parameter tree has the same structure and
    leaf shapes and dtypes — the precondition for stacked dispatch.
    ``None`` entries (experts another rank of an expert mesh holds) are
    skipped."""
    params = [p for p in params if p is not None]
    if len(params) <= 1:
        return True
    t0 = tree_structure(params[0])
    l0 = tree_leaves(params[0])
    for p in params[1:]:
        if tree_structure(p) != t0:
            return False
        for a, b in zip(l0, tree_leaves(p)):
            a, b = torch.as_tensor(a), torch.as_tensor(b)
            if a.shape != b.shape or a.dtype != b.dtype:
                return False
    return True


def _resolve_engine(engine: str, experts: Sequence[ExpertSpec],
                    params: Sequence | None, config: SamplerConfig) -> str:
    """The engine mode, ``'routed'``, ``'dense'`` or ``'reference'``, with
    the reference's ``ValueError``s in its order."""
    if engine not in ("auto", "routed", "dense", "reference"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "reference":
        if config.dispatch != "auto":
            raise ValueError(
                "the reference engine predates the dispatch API; use "
                "dispatch='auto' (executor backends apply to the fused "
                "engines only)"
            )
        if config.plan_refresh_every != 1:
            raise ValueError(
                "plan_refresh_every > 1 requires the fused engines (the "
                "reference path recomputes routing every step by design)"
            )
        return engine
    if config.time_map != "identity":
        # snr_match queries experts at rebased times and inputs: only the
        # per-expert reference engine implements it.
        if engine != "auto":
            raise ValueError(
                f"engine={engine!r} requires time_map='identity'"
            )
        if config.dispatch != "auto":
            raise ValueError(
                f"dispatch={config.dispatch!r} requires time_map="
                f"'identity'; snr_match resolves to the reference engine, "
                f"which predates the dispatch API"
            )
        if config.plan_refresh_every != 1:
            raise ValueError(
                "plan_refresh_every > 1 requires time_map='identity'; "
                "snr_match resolves to the reference engine, which "
                "recomputes routing every step by design"
            )
        return "reference"
    k = len(experts)
    # params=None: the caller holds the experts only as a store (a
    # quantized engine), which is stackable by construction.
    homogeneous = k == 1 or (
        all(e.apply_fn is experts[0].apply_fn for e in experts)
        and (params is None or params_are_stackable(params))
    )
    routed_ok = k > 1 and (
        (config.strategy in ("top1", "topk") and homogeneous)
        or config.strategy == "threshold"
    )
    if engine == "auto":
        return "routed" if routed_ok else "dense"
    if engine == "routed" and not routed_ok:
        raise ValueError(
            "routed engine needs strategy in (top1, topk, threshold) and, "
            "for per-sample routing, a shared apply_fn with stackable params"
        )
    return engine


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
    mode: str,
    init_noise: torch.Tensor,
    stacked_params=None,
    coeff_tables=None,
    cluster_map=None,
    mesh=None,
) -> torch.Tensor:
    K = len(experts)
    B = init_noise.shape[0]
    device = init_noise.device
    conv = config.conversion
    homogeneous = all(e.apply_fn is experts[0].apply_fn for e in experts)

    use_cfg = null_cond is not None and config.cfg_scale != 1.0
    batched = use_cfg and config.batched_cfg \
        and _cfg_batchable(cond, null_cond or {})
    if mode == "routed":
        k_slots = 1 if config.strategy in ("top1", "threshold") \
            else min(config.top_k, K)
        uniform = config.strategy == "threshold"
    else:
        k_slots, uniform = K, False

    # The routed dispatch substrate: a store passed in, else the experts
    # stacked once into the storage ``config.param_dtype`` selects (the
    # threshold router also serves expert sets that do not stack, through
    # the dense executor).
    stacked = as_store(stacked_params, dtype=config.param_dtype)
    # a capacity store's liveness mask (None: every slot live); a resident
    # slice routes by the whole mask it carries
    valid = stacked.routing_mask() if stacked is not None else None
    if stacked is None and params is None:
        raise ValueError(
            "params=None requires stacked_params (an ExpertParamStore or "
            "raw stacked pytree)"
        )
    if stacked is None and mesh is None and mode == "routed" \
            and homogeneous and (not uniform or params_are_stackable(params)):
        stacked = make_store(stack_expert_params(params),
                             dtype=config.param_dtype)

    ragged_fn = experts[0].ragged_apply_fn
    ragged_ok = (mode == "routed" and not uniform and ragged_fn is not None
                 and all(e.ragged_apply_fn is ragged_fn for e in experts))
    backend = resolve_dispatch(config.dispatch, mode, stacked is not None,
                               uniform, ragged_ok)
    executor = make_executor(
        backend, apply_fns=[e.apply_fn for e in experts], params=params,
        stacked_params=stacked, conv=conv,
        ragged_apply_fn=ragged_fn if ragged_ok else None, mesh=mesh)

    refresh_every = int(config.plan_refresh_every)
    if refresh_every < 1:
        raise ValueError(
            f"plan_refresh_every must be >= 1, got {refresh_every}")

    ts = _time_grid(config.num_steps).to(device)
    if coeff_tables is not None:
        tables = coeff_tables.to(device)                  # (S, 5, K)
    else:
        tables = coeff_tables_cached(
            tuple(e.objective for e in experts),
            tuple(e.schedule for e in experts),
            config.num_steps, conv,
        ).to(device)                                      # (S, 5, K)

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
        preds = executor.complete(preds, plan)        # the mesh's one join
        g = 2 if use_cfg else 1
        return ops.fused_step(
            preds, x, w_all, slot_coef(tab, idx_all), dt,
            g=g, cfg_scale=config.cfg_scale if use_cfg else 1.0,
            clamp=conv.clamp, alpha_min=conv.alpha_min,
        )

    def make_plan(w):
        if backend == "dense" and not uniform:
            return full_dispatch_plan(w)
        return make_dispatch_plan(w, k_slots, uniform=uniform, valid=valid)

    update = fused_step_update if config.step_fused else velocity_update
    x = init_noise
    plan = None
    for i in range(config.num_steps):
        t_hi, t_lo = ts[i], ts[i + 1]
        tb = t_hi.expand(B)
        if i % refresh_every == 0:                     # step 0 always
            plan = make_plan(fusion_weights(
                experts, router_fn, x, tb,
                strategy=config.strategy, top_k=config.top_k,
                threshold=config.threshold,
                ddpm_low_noise_only=config.ddpm_low_noise_only,
                valid=valid, cluster_map=cluster_map,
            ))                                            # (B, K) weights
        x = update(plan, x, tb, t_hi - t_lo, tables[i])
    return x


def _expert_velocities_with_cfg(experts, params, x_t, t, cond: dict,
                                null_cond: dict | None,
                                cfg: SamplerConfig) -> torch.Tensor:
    """Every expert's unified velocity ``(K, B, ...)``, CFG-combined over
    two passes (cond, then uncond)."""
    v_c = unified_expert_velocities(experts, params, x_t, t, cond,
                                    conv_cfg=cfg.conversion,
                                    time_map=cfg.time_map)
    if null_cond is None or cfg.cfg_scale == 1.0:
        return v_c
    v_u = unified_expert_velocities(experts, params, x_t, t, null_cond,
                                    conv_cfg=cfg.conversion,
                                    time_map=cfg.time_map)
    return cfg_combine(v_c, v_u, cfg.cfg_scale)


def _sample_reference(experts, params, router_fn, cond: dict,
                      null_cond: dict | None, config: SamplerConfig,
                      init_noise: torch.Tensor, mesh=None) -> torch.Tensor:
    """The per-expert two-pass engine: every expert per branch, unified
    in plain ops, fused by Eq. 1 with the step's fusion weights.  On an
    expert-sharded ``mesh`` the rank runs its resident experts and one
    "expert" all-gather stacks the ``(K, B, ...)`` velocities in expert
    order (bitwise the unsharded stack)."""
    B = init_noise.shape[0]
    K = len(experts)
    lo, hi = (0, K) if mesh is None else mesh.expert_range(K)
    ts = _time_grid(config.num_steps).to(init_noise.device)
    x = init_noise
    for i in range(config.num_steps):
        t_hi, t_lo = ts[i], ts[i + 1]
        tb = t_hi.expand(B)
        v = _expert_velocities_with_cfg(experts[lo:hi], params[lo:hi], x,
                                        tb, cond, null_cond, config)
        if (lo, hi) != (0, K):
            v = mesh.expert_gather(v)
        w = fusion_weights(
            experts, router_fn, x, tb,
            strategy=config.strategy, top_k=config.top_k,
            threshold=config.threshold,
            ddpm_low_noise_only=config.ddpm_low_noise_only,
        )
        x = x - fuse_predictions(v, w) * (t_hi - t_lo)
    return x


def _initial_noise(shape, generator, init_noise, device,
                   caller: str) -> torch.Tensor:
    """``init_noise`` checked against ``shape``, or ``N(0, 1)`` drawn from
    ``generator`` on ``device`` (default: the generator's device)."""
    if init_noise is None:
        if generator is None:
            raise ValueError(f"{caller} needs generator= or init_noise=")
        return torch.randn(
            shape, generator=generator, dtype=torch.float32,
            device=device if device is not None else generator.device)
    if tuple(init_noise.shape) != tuple(shape):
        raise ValueError(f"init_noise shape {tuple(init_noise.shape)} != "
                         f"{tuple(shape)}")
    return init_noise


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
    coeff_tables=None,
    cluster_map=None,
    mesh=None,
) -> torch.Tensor:
    """Euler-ODE sampling with router-weighted heterogeneous fusion.

    ``engine``: ``'auto'`` picks the routed engine where the strategy and
    expert set allow it, else the dense one; ``'routed'``/``'dense'``
    force one; ``'reference'`` is the per-expert two-pass engine (the
    one ``time_map='snr_match'`` resolves to).  ``router_fn`` may be None
    for one expert or the threshold strategy.  ``init_noise``
    (``shape``) is the starting latent; without it the noise is drawn
    from ``generator`` on ``device`` (default: the generator's device).
    ``stacked_params`` (a store of ``core.param_store`` or a raw stacked
    tree, stored as ``config.param_dtype`` says) lets a long-lived engine
    stack its experts once; with it ``params`` may be None (the routed
    engine only).  A store with a ``valid`` mask makes the fused engines
    membership-aware; elastic engines also pass the ``(S, 5, K)``
    ``coeff_tables`` and the ``(K,)`` ``cluster_map`` of their slots
    (fused engines only).

    ``mesh`` (a ``launch.mesh.ExpertMesh``) runs this rank's "data" slice
    of the batch (every row where "data" does not divide it) on its
    resident experts: ``stacked_params`` is then the rank's resident slice
    (``launch.sharding.shard_store``) and ``params`` holds ``None`` for
    the experts of other ranks.  Returns the samples at t = 0, the whole
    batch on every rank.
    """
    cond = cond or {}
    config = config if config is not None else SamplerConfig()
    mode = _resolve_engine(engine, experts, params, config)
    if params is None and mode == "reference":
        raise ValueError(
            "the reference engine runs each expert from its own params "
            "list; params=None (store-only serving) supports the fused "
            "engines only"
        )
    init_noise = _initial_noise(shape, generator, init_noise, device,
                                "sample_ensemble")
    if mode == "reference" and (coeff_tables is not None
                                or cluster_map is not None):
        raise ValueError(
            "coeff_tables/cluster_map (elastic membership) require "
            "the fused engines; the reference engine derives "
            "coefficients from the static ExpertSpec list"
        )
    batch = init_noise.shape[0]
    lo, hi = (0, batch) if mesh is None else mesh.data_range(batch)
    if (lo, hi) != (0, batch):
        init_noise = init_noise[lo:hi]
        cond, null_cond = _rows(cond, batch, lo, hi), \
            _rows(null_cond, batch, lo, hi)
    if mode == "reference":
        x = _sample_reference(experts, params, router_fn, cond, null_cond,
                              config, init_noise, mesh)
    else:
        x = _sample_fused(experts, params, router_fn, cond, null_cond,
                          config, mode, init_noise, stacked_params,
                          coeff_tables, cluster_map, mesh)
    if mesh is None or ((lo, hi) == (0, batch) and mesh.shape["data"] > 1):
        return x                       # no mesh, or the batch replicated
    return mesh.data_gather(x)


def _rows(cond: dict | None, batch: int, lo: int, hi: int):
    """The rows ``[lo, hi)`` of every per-sample tensor of a conditioning
    dict (its leading dim ``batch``); other values pass through."""
    if cond is None:
        return None
    return {k: v[lo:hi] if isinstance(v, torch.Tensor) and v.dim()
            and v.shape[0] == batch else v for k, v in cond.items()}


def sample_ensemble_step(
    experts: Sequence[ExpertSpec],
    params: Sequence | None,
    router_fn: Callable | None,
    x: torch.Tensor,
    t_idx: torch.Tensor,
    slot_idx: torch.Tensor,
    slot_w: torch.Tensor,
    *,
    t_host=None,
    cond: dict | None = None,
    null_cond: dict | None = None,
    config: SamplerConfig | None = None,
    engine: str = "auto",
    stacked_params=None,
    coeff_tables=None,
    cluster_map=None,
    mesh=None,
):
    """One Euler step of a mixed-timestep batch (continuous batching).

    Every row sits at its own index ``t_idx[r]`` on the shared
    ``num_steps`` grid: ``0 <= t_idx < num_steps`` is active, any other
    value (``num_steps`` for a free or finished row) is frozen — its
    latent passes through unchanged and its index does not advance.  The
    step gathers each row's ``(5, K)`` table, time and ``dt`` and makes
    one ``kernels.ops.fused_step`` launch with a ``(B,)`` ``dt``.

    ``slot_idx``/``slot_w`` (``(B, k)``, ``dispatch.routed_slots``) are
    the carried routing, refreshed per row on the row's own phase
    (``t_idx % plan_refresh_every == 0``).  The router runs only on a step
    where some row refreshes; that is decided on the host from
    ``t_host``, the caller's host mirror of ``t_idx`` (the rolling batch
    keeps one), so the decision reads nothing from the device.  Without
    ``t_host``, ``t_idx`` must be on the CPU.

    On a ``mesh`` (``launch.mesh.ExpertMesh``) ``x`` and the conditioning
    hold the rank's rows ``mesh.data_range(B)`` of the ``B``-row batch
    (every row where "data" does not divide ``B``); ``t_idx``,
    ``slot_idx``, ``slot_w`` and ``t_host`` hold the whole batch's, the
    same on every rank; ``stacked_params`` is the rank's resident slice.
    The rank steps its rows on its resident experts.  After the local work
    (router, plan, expert forwards) comes ``mesh.step_agreement`` —
    ``launch.mesh.PeerFailure`` here when another rank's step failed, so
    no rank waits in a join — then the joins: on a step where some row
    refreshes and the rows are split, the slots are all-gathered over
    "data" (one gather of both), and the executor's "expert" all-reduce
    completes the per-slot predictions.

    Rolling equals lockstep row for row because every forward computes
    row ``r`` from row ``r``'s inputs alone and the step kernel is
    elementwise per row.  Needs the routed engine, ``strategy`` in
    ``('top1', 'topk')`` and ``step_fused=True`` (the reference's
    ``ValueError``s).  Returns the advanced ``(x, t_idx, slot_idx,
    slot_w)`` as new tensors (on a mesh: the rank's rows of ``x``, the
    whole batch's rest).
    """
    cond = cond or {}
    config = config if config is not None else SamplerConfig()
    if config.strategy not in ("top1", "topk"):
        raise ValueError(
            f"continuous batching requires per-sample routing (strategy "
            f"in ('top1', 'topk')); strategy={config.strategy!r} plans "
            f"are batch-uniform or dense and have no per-row meaning in "
            f"a mixed-timestep batch"
        )
    if not config.step_fused:
        raise ValueError(
            "continuous batching runs on the step-fused hot path only "
            "(step_fused=True): per-row dt is a fused-kernel operand"
        )
    mode = _resolve_engine(engine, experts, params, config)
    if mode != "routed":
        raise ValueError(
            f"continuous batching requires the routed engine; this "
            f"configuration resolved to {mode!r} (need a shared apply_fn "
            f"with stackable params and >1 expert)"
        )
    K = len(experts)
    B = t_idx.shape[0]
    lo, hi = (0, B) if mesh is None else mesh.data_range(B)
    split = (lo, hi) != (0, B)
    device = x.device
    conv = config.conversion
    k_slots = 1 if config.strategy == "top1" else min(config.top_k, K)
    if tuple(slot_idx.shape) != (B, k_slots) or \
            tuple(slot_w.shape) != (B, k_slots):
        raise ValueError(
            f"slot state must be ({B}, {k_slots}); got "
            f"slot_idx {tuple(slot_idx.shape)}, slot_w "
            f"{tuple(slot_w.shape)}"
        )
    if x.shape[0] != hi - lo:
        raise ValueError(
            f"x holds {x.shape[0]} rows; this rank steps rows [{lo}, {hi}) "
            f"of the {B}-row batch")
    if t_host is None:
        if t_idx.is_cuda:
            raise ValueError(
                "t_host (the host mirror of t_idx) is required for a "
                "batch on the card: the router-skip decision reads no "
                "device value")
        t_host = t_idx.numpy()
    slot_idx = slot_idx.to(torch.int64)
    slot_w = slot_w.to(torch.float32)
    t_idx = t_idx.to(torch.int64)

    use_cfg = null_cond is not None and config.cfg_scale != 1.0
    batched = use_cfg and config.batched_cfg \
        and _cfg_batchable(cond, null_cond or {})

    stacked = as_store(stacked_params, dtype=config.param_dtype)
    if stacked is None and (params is None or mesh is not None):
        raise ValueError(
            "params=None requires stacked_params (an ExpertParamStore or "
            "raw stacked pytree); on a mesh, the rank's resident slice"
        )
    if stacked is None:
        stacked = make_store(stack_expert_params(params),
                             dtype=config.param_dtype)
    valid = stacked.routing_mask()
    ragged_fn = experts[0].ragged_apply_fn
    ragged_ok = ragged_fn is not None and all(
        e.ragged_apply_fn is ragged_fn for e in experts)
    backend = resolve_dispatch(config.dispatch, mode, True, False, ragged_ok)
    executor = make_executor(
        backend, apply_fns=[e.apply_fn for e in experts], params=params,
        stacked_params=stacked, conv=conv,
        ragged_apply_fn=ragged_fn if ragged_ok else None, mesh=mesh)

    S = config.num_steps
    refresh_every = int(config.plan_refresh_every)
    if refresh_every < 1:
        raise ValueError(
            f"plan_refresh_every must be >= 1, got {refresh_every}")
    ts = _time_grid(S).to(device)
    if coeff_tables is not None:
        tables = coeff_tables.to(device)                  # (S, 5, K)
    else:
        tables = coeff_tables_cached(
            tuple(e.objective for e in experts),
            tuple(e.schedule for e in experts), S, conv).to(device)
    num_slots = tables.shape[-1]                          # capacity K

    # Per-row grid state of this rank's rows; frozen rows gather a
    # clipped index whose values the ``active`` mask discards.
    t_rows = t_idx[lo:hi]
    i = torch.clamp(t_rows, 0, S - 1)
    active = (t_rows >= 0) & (t_rows < S)
    tb = ts[i]
    dt = ts[i] - ts[i + 1]
    row_tab = tables[i]                                   # (b, 5, K)

    # Each row refreshes its routing on its own phase; the router runs
    # only when one of the rank's rows does (decided from the host
    # mirror), the slot gather when a row of the batch does.
    host_refresh = (t_host >= 0) & (t_host < S) \
        & (t_host % refresh_every == 0)
    rows_idx, rows_w = slot_idx[lo:hi], slot_w[lo:hi]
    if host_refresh[lo:hi].any():
        refresh = active & (t_rows % refresh_every == 0)
        w = fusion_weights(
            experts, router_fn, x, tb,
            strategy=config.strategy, top_k=config.top_k,
            threshold=config.threshold,
            ddpm_low_noise_only=config.ddpm_low_noise_only,
            valid=valid, cluster_map=cluster_map)         # (b, K)
        new_idx, new_w = routed_slots(w, k_slots, valid=valid)
        rows_idx = torch.where(refresh[:, None], new_idx, rows_idx)
        rows_w = torch.where(refresh[:, None], new_w, rows_w)
    plan = plan_from_slots(rows_idx, rows_w, num_slots)

    # CFG as in ``_sample_fused``; executors read the table only on the
    # unfused path, so row 0's table fills the argument.
    b = x.shape[0]
    tab0 = tables[0]
    if batched:
        outs = [executor.predictions(
            plan, x, tb, _cfg_grouped_cond(cond, null_cond or {}, b), 2,
            tab0)]
    elif use_cfg:
        outs = [executor.predictions(
            plan, x, tb, _cfg_grouped_cond(c, None, b), 1, tab0)
            for c in (cond, dict(null_cond or {}))]
    else:
        outs = [executor.predictions(
            plan, x, tb, _cfg_grouped_cond(cond, None, b), 1, tab0)]
    if len(outs) == 1:
        preds, w_all, idx_all = outs[0]
    else:
        preds = torch.cat([o[0] for o in outs], dim=1)
        w_all = torch.cat([o[1] for o in outs], dim=0)
        idx_all = torch.cat([o[2] for o in outs], dim=0)

    if mesh is not None:
        mesh.step_agreement()                     # before any join
    if not split:
        slot_idx, slot_w = rows_idx, rows_w
    elif host_refresh.any():
        both = mesh.data_gather(torch.cat(
            [rows_idx.to(torch.float64), rows_w.to(torch.float64)], dim=1))
        slot_idx = both[:, :k_slots].to(torch.int64)
        slot_w = both[:, k_slots:].to(torch.float32)
    preds = executor.complete(preds, plan)        # the "expert" join
    g = 2 if use_cfg else 1
    tab_all = row_tab if g == 1 else torch.cat([row_tab, row_tab])
    x_step = ops.fused_step(
        preds, x, w_all, slot_coef_rows(tab_all, idx_all), dt,
        g=g, cfg_scale=config.cfg_scale if use_cfg else 1.0,
        clamp=conv.clamp, alpha_min=conv.alpha_min)
    mask = active.reshape((b,) + (1,) * (x.dim() - 1))
    x = torch.where(mask, x_step, x)
    advance = ((t_idx >= 0) & (t_idx < S)).to(torch.int64)
    return x, t_idx + advance, slot_idx, slot_w


def sample_single_expert(
    expert: ExpertSpec,
    params,
    shape: tuple[int, ...],
    *,
    generator: torch.Generator | None = None,
    cond: dict | None = None,
    null_cond: dict | None = None,
    config: SamplerConfig | None = None,
    init_noise: torch.Tensor | None = None,
    device=None,
) -> torch.Tensor:
    """Single-expert ODE sampling (Table 3's 'FM' and 'DDPM→FM' rows):
    the dense engine over one expert."""
    config = config if config is not None else SamplerConfig()
    return sample_ensemble(
        [expert], [params], None, shape, generator=generator, cond=cond,
        null_cond=null_cond,
        config=dataclasses.replace(config, strategy="full"),
        init_noise=init_noise, device=device)


def sample_ddpm_ancestral(
    apply_fn: Callable[..., torch.Tensor],
    params,
    shape: tuple[int, ...],
    *,
    generator: torch.Generator | None = None,
    init_noise: torch.Tensor | None = None,
    device=None,
    cond: dict | None = None,
    null_cond: dict | None = None,
    num_steps: int = 75,
    cfg_scale: float = 6.0,
    schedule_name: str = "cosine",
) -> torch.Tensor:
    """Native DDPM sampler (Table 3's baseline row): the reference's
    deterministic DDIM (eta = 0) update on the continuous grid, with the
    ε prediction CFG-combined over two passes.  The starting noise is
    ``init_noise`` or a draw from ``generator``."""
    cond = cond or {}
    sched = get_schedule(schedule_name)
    x = _initial_noise(shape, generator, init_noise, device,
                       "sample_ddpm_ancestral")
    ts = _time_grid(num_steps).to(x.device)

    def pred_eps(x, tb):
        e_c = apply_fn(params, x, tb, **cond)
        if null_cond is None or cfg_scale == 1.0:
            return e_c
        e_u = apply_fn(params, x, tb, **null_cond)
        return cfg_combine(e_c, e_u, cfg_scale)

    for i in range(num_steps):
        t_hi, t_lo = ts[i], ts[i + 1]
        eps = pred_eps(x, t_hi.expand(shape[0]))
        a_hi, s_hi = sched.coeffs(t_hi)
        a_lo, s_lo = sched.coeffs(t_lo)
        x0 = (x - s_hi * eps) / torch.clamp(a_hi, min=0.01)
        x0 = torch.clamp(x0, -20.0, 20.0)
        x = a_lo * x0 + s_lo * eps
    return x
