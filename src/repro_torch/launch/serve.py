"""Serving engine of the port: a directory of expert checkpoints in, latents
out, on one GPU.

``ServingEngine.from_checkpoint_dir`` assembles the heterogeneous
ensemble from ``expert*.npz`` (plus ``router.npz``) written by either
package's ``save_checkpoint``; ``generate`` draws the noise, resolves the
conditioning through a content-hash LRU and runs the fused sampler
(``core.sampling.sample_ensemble``): per step a router forward, the
routed experts through the ragged grouped-GEMM kernel, and one step-fused
kernel (``step_fused=False``: the velocity kernel, then the CFG combine
and the Euler update as separate ops).

``sampler.param_dtype`` (or ``from_checkpoint_dir(param_dtype=...)``)
picks the stacked expert store: ``native``, ``fp32``/``bf16`` casts, or
``int8``/``fp8`` quantized with per-expert scales, whose weights
contract in the int8/fp8 GEMM kernels.  A quantized store replaces the
float32 per-expert list (about 4x fewer resident expert bytes).

``sampler.plan_refresh_every = R`` reruns the router and the dispatch
plan on every R-th Euler step only; ``stats["plan_refreshes"]`` counts
⌈S/R⌉ a dispatch.  ``sampler.ddpm_low_noise_only`` gates the DDPM
experts out above that noise level (§7.3).

``sampler.strategy`` ``full`` and ``engine`` ``dense`` run every expert
(the dense executor over the per-expert parameters); ``threshold`` is
the §3.3 two-expert router (one gathered expert a step, from the store);
``engine='reference'`` and ``time_map='snr_match'`` run the per-expert
reference engine.  ``sampler.dispatch`` picks the routed executor
(``ragged``, ``grouped``, ``gathered``), as ``core.dispatch`` resolves it.

``submit`` enqueues a request and ``flush`` coalesces the queued ones by
conditioning signature into one padded power-of-two batch each, expires
requests past their ``deadline_s``, isolates failures per group
(re-queued up to ``max_request_requeues`` times, then FAILED) and slices
each request's latents back out.  ``track_padding`` counts the rows the
expert forwards run against the routed rows (``padding_stats``).

Elastic membership (``capacity=``): the store pads to ``capacity`` slots
with a liveness mask, and ``add_expert``, ``evict_expert``,
``retire_expert``, ``quarantine_expert``, ``trip_expert`` and
``restore_expert`` change membership by building new stores, never by
writing the old one.  ``submit`` snapshots the membership, so a queued
request is served as admitted whatever changes before its ``flush``.
``from_checkpoint_dir(on_bad_checkpoint='skip')`` quarantines bad
checkpoints and masks the slots they leave empty.  The continuous
scheduler and the resilience layer (``repro_torch.serving``) drive the
same engine one Euler step at a time; ``restore`` rebuilds a scheduler
from its journal.

Command line (the reference CLI's plain, ``--coalesce`` and
``--continuous`` modes)::

    python -m repro_torch.launch.serve --ckpt-dir CKPTS --coalesce \
        --plan-refresh 2
    python -m repro_torch.launch.serve --ckpt-dir CKPTS --continuous \
        --capacity 10 --journal-dir JOURNAL

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when no GPU is present.  Only an explicit ``device="cpu"`` (CLI:
``--device cpu``) runs on the CPU (the kernels' plain versions), as the
tests do.  Sharding (``--expert-shards``, ``--data-shards``) is not
ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import os
import re
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.fusion import ExpertSpec
from repro_torch.core.param_store import (DenseStore, make_store,
                                          pad_to_capacity)
from repro_torch.core.sampling import (SamplerConfig, coeff_tables_cached,
                                       params_are_stackable,
                                       sample_ensemble)
from repro_torch.models import dit as D
from repro_torch.models.config import DiTConfig, dit_b2, router_b2
from repro_torch.serving.resilience import (DeadlineExceeded, RequestFailed,
                                            RequestTimeout)
from repro_torch.training.checkpoint import load_checkpoint
from repro_torch.tree import tree_leaves, tree_map, tree_structure
from repro_torch.weights import resolve_device

#: ``expert7.npz`` / ``expert_07.npz`` → checkpoint index 7 (ordering
#: fallback when the metadata carries no ``cluster_id``).
_EXPERT_IDX_RE = re.compile(r"expert[_-]?(\d+)")

#: Per-capacity-slot health states (elastic membership): ``EMPTY`` —
#: capacity padding, never filled; ``ACTIVE`` — live and routable;
#: ``DRAINING`` — ``retire_expert``: masked at once, ``EVICTED`` after the
#: next ``flush`` serves the requests admitted under it; ``QUARANTINED``
#: — masked for failed integrity checks; ``PROBATION`` — masked by the
#: circuit breaker until a canary probe restores it; ``EVICTED`` —
#: masked by ``evict_expert``, reusable by ``add_expert``.
EXPERT_HEALTH_STATES = ("EMPTY", "ACTIVE", "DRAINING", "QUARANTINED",
                        "PROBATION", "EVICTED")


def _as_device_tensor(a, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or a (possibly
    read-only) array, copied off the caller's buffer."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32)


def _validate_expert_params(params, template, path: str) -> None:
    """Integrity gate of one loaded expert checkpoint: its tree structure
    and leaf shapes against the ensemble's template (the first checkpoint
    loaded), then every float leaf finite.  Raises the reference's
    ``ValueError``, naming the file.

    As in the reference, a bf16 leaf is not checked for finiteness (its
    numpy dtype is not of kind ``'f'``).
    """
    leaves = tree_leaves(params)
    if template is not None:
        structure, shapes = template
        if tree_structure(params) != structure:
            raise ValueError(
                f"{path}: param tree structure does not match the "
                f"ensemble's expert template — wrong architecture or a "
                f"partially-written checkpoint"
            )
        for leaf, shape in zip(leaves, shapes):
            if tuple(leaf.shape) != tuple(shape):
                raise ValueError(
                    f"{path}: leaf shape mismatch {tuple(leaf.shape)} "
                    f"!= template {tuple(shape)}"
                )
    for leaf in leaves:
        if leaf.dtype in (torch.float16, torch.float32, torch.float64) \
                and not bool(torch.isfinite(leaf).all()):
            raise ValueError(
                f"{path}: non-finite leaf values (NaN/Inf) — corrupt "
                f"training artifact"
            )


@dataclasses.dataclass
class PendingRequest:
    """Handle returned by ``ServingEngine.submit``; resolved by ``flush``.

    ``state`` walks QUEUED → DONE, or to FAILED (its group exhausted its
    re-queues) or DEADLINE_EXCEEDED (it outlived ``deadline_s`` before
    dispatch); ``result()`` then raises the named error.  The request's
    noise comes from ``seed`` (an int or a ``torch.Generator``) at flush
    time, as ``generate`` draws it, unless ``noise`` is the exact array.
    On an elastic engine it holds the membership it was admitted under
    (``ServingEngine._membership``), so later membership changes cannot
    change its output.
    """

    seed: int | torch.Generator | None
    text_emb: torch.Tensor | None
    batch_size: int
    noise: torch.Tensor | None = None
    _result: torch.Tensor | None = None
    done: bool = False
    state: str = "QUEUED"
    error: BaseException | None = None
    requeues: int = 0
    _membership: tuple | None = None
    #: global submission order, the FIFO key of re-queues.
    seq: int = -1
    #: lifetime bounds: wall-clock seconds from submit, and scheduler
    #: ticks from submit (None: unbounded).  ``flush`` enforces
    #: ``deadline_s``; the resilient scheduler both, at tick boundaries.
    deadline_s: float | None = None
    max_steps: int | None = None
    submit_t: float | None = None

    def result(self, timeout: float | None = None) -> torch.Tensor:
        """The resolved latents, or the request's named terminal error.

        ``timeout`` bounds how long to wait for another thread to flush
        the engine (``RequestTimeout`` on expiry); ``None`` raises at once
        if the request is unresolved; 0 polls."""
        if timeout is not None:
            give_up = time.monotonic() + timeout
            while not self.done and self.state not in (
                    "FAILED", "DEADLINE_EXCEEDED"):
                if time.monotonic() >= give_up:
                    raise RequestTimeout(
                        f"request seq={self.seq} still {self.state} after "
                        f"{timeout}s ({self.requeues} requeue(s))",
                        seq=self.seq, requeues=self.requeues)
                time.sleep(min(0.005, max(timeout, 1e-4)))
        if self.state == "DEADLINE_EXCEEDED":
            if isinstance(self.error, DeadlineExceeded):
                raise self.error
            raise DeadlineExceeded(
                f"request seq={self.seq} exceeded its deadline "
                f"({self.requeues} requeue(s))",
                seq=self.seq, requeues=self.requeues)
        if self.state == "FAILED":
            raise RequestFailed(
                f"request seq={self.seq} failed after {self.requeues} "
                f"dispatch attempt(s): {self.error!r}",
                seq=self.seq, requeues=self.requeues) from self.error
        if not self.done:
            raise RuntimeError(
                "request not yet flushed — submit() only enqueues; call "
                "ServingEngine.flush() before reading result()")
        return self._result


@dataclasses.dataclass
class ServingEngine:
    experts: list[ExpertSpec]
    expert_params: list
    router_fn: object | None
    latent_shape: tuple[int, int, int]
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    engine: str = "auto"
    #: cross-request conditioning cache: max distinct text embeddings kept
    #: resident, keyed by content hash and evicted LRU.  0 disables.
    cond_cache_size: int = 64
    device: torch.device = torch.device("cuda")
    #: automatic re-queues per request before a failing dispatch group
    #: marks its requests FAILED.
    max_request_requeues: int = 1
    #: count the rows the expert forwards run (``padding_stats``).
    track_padding: bool = False
    #: elastic membership: the store pads to this many slots with a
    #: liveness mask and the membership methods are enabled.  None keeps
    #: the fixed-membership engine.
    capacity: int | None = None
    #: per-slot health at start (elastic; ``from_checkpoint_dir`` marks
    #: the slots of quarantined checkpoints); default all ACTIVE.
    initial_health: list | None = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self._cond_cache: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self._queue: list[PendingRequest] = []
        self._seq = 0                              # global submission order
        self.stats = {"requests": 0, "cond_cache_hits": 0,
                      "cond_cache_misses": 0, "plan_refreshes": 0,
                      "merged_batches": 0, "batched_requests": 0,
                      "experts_added": 0, "experts_evicted": 0,
                      "quarantined_checkpoints": 0, "degraded_steps": 0,
                      "request_requeues": 0, "failed_requests": 0,
                      "deadline_exceeded": 0, "padded_model_rows": 0,
                      "routed_model_rows": 0, "model_steps": 0,
                      "watchdog_trips": 0, "breaker_trips": 0,
                      "breaker_probes": 0, "breaker_restores": 0,
                      "journal_snapshots": 0}
        self.quarantine: list[dict] = []
        self.elastic = self.capacity is not None
        if self.track_padding:
            self._count_executed_rows()
        self.homogeneous = len(self.experts) <= 1 or (
            all(e.apply_fn is self.experts[0].apply_fn for e in self.experts)
            and params_are_stackable(self.expert_params))
        pd = self.sampler.param_dtype
        if pd != "native":
            # The store serves routed execution only; the dense and
            # reference engines run from the per-expert list.  Reject at
            # construction, where strategy and engine are known.
            routed_capable = (
                self.homogeneous and len(self.experts) > 1
                and self.sampler.strategy in ("top1", "topk", "threshold")
                and self.engine in ("auto", "routed")
            )
            if not routed_capable:
                raise ValueError(
                    f"param_dtype={pd!r} changes the stacked expert "
                    f"store's storage, which only routed execution uses: "
                    f"it needs a homogeneous ensemble of ≥ 2 experts "
                    f"(shared apply_fn + stackable params), strategy in "
                    f"top1/topk/threshold, and engine auto/routed — got "
                    f"{len(self.experts)} expert(s), homogeneous="
                    f"{self.homogeneous}, strategy="
                    f"{self.sampler.strategy!r}, engine={self.engine!r}"
                )
        # The routed engine's dispatch substrate: every expert's leaves
        # stacked once, ``(K, ...)``, on the device, in the storage dtype.
        self.param_store = (
            make_store(D.stack_expert_params(self.expert_params), dtype=pd)
            if self.homogeneous and self.expert_params else None)
        # the template ``add_expert`` checks a joining checkpoint against
        self._slot_template = None
        if self.expert_params:
            self._slot_template = (
                tree_structure(self.expert_params[0]),
                [tuple(x.shape) for x in tree_leaves(self.expert_params[0])])
        if pd in ("int8", "fp8"):
            # The quantized store is the resident representation: drop the
            # float32 per-expert list so the byte saving is real (the dense
            # and reference engines need it, and raise without it).
            self.expert_params = None
        self.expert_health = ["ACTIVE"] * len(self.experts)
        self.membership_epoch = 0
        if self.elastic:
            self._init_elastic()

    # -- elastic membership -------------------------------------------------

    def _init_elastic(self) -> None:
        k0 = len(self.experts)
        if self.param_store is None:
            raise ValueError(
                "elastic serving (capacity=...) needs a homogeneous "
                "ensemble with stackable params — the validity-masked "
                "capacity layout lives in the stacked ExpertParamStore"
            )
        if self.capacity < k0:
            raise ValueError(
                f"capacity={self.capacity} < {k0} loaded experts")
        if self.sampler.strategy not in ("top1", "topk"):
            raise ValueError(
                f"elastic serving requires per-sample routing (strategy "
                f"'top1' or 'topk'); got {self.sampler.strategy!r}"
            )
        if self.engine not in ("auto", "routed"):
            raise ValueError(
                f"elastic serving requires the routed engine (engine "
                f"'auto' or 'routed'); got {self.engine!r}"
            )
        if self.router_fn is None:
            raise ValueError(
                "elastic serving routes per sample; a router_fn is "
                "required"
            )
        if self.sampler.ddpm_low_noise_only > 0.0:
            raise ValueError(
                "elastic serving is incompatible with ddpm_low_noise_only "
                "> 0: the §7.3 gate bakes each slot's objective into the "
                "trace, so a hot-added expert changing a slot's objective "
                "would silently bypass it"
            )
        self.experts = list(self.experts)
        health = (list(self.initial_health) if self.initial_health
                  else ["ACTIVE"] * k0)
        if len(health) != k0 or any(
                h not in EXPERT_HEALTH_STATES for h in health):
            raise ValueError(
                f"initial_health must be {k0} states from "
                f"{EXPERT_HEALTH_STATES}; got {health}"
            )
        # Capacity padding: EMPTY slots hold zero parameters, a placeholder
        # spec (the slots' objectives reach the sampler through the
        # coefficient tables) and a dead liveness bit.
        for i in range(k0, self.capacity):
            self.experts.append(dataclasses.replace(
                self.experts[0], name=f"<empty:{i}>", objective="fm",
                schedule="linear", cluster_id=0))
        self.expert_health = health + ["EMPTY"] * (self.capacity - k0)
        self.param_store = pad_to_capacity(self.param_store, self.capacity)
        self.param_store = self.param_store.with_valid(
            torch.tensor([h == "ACTIVE" for h in self.expert_health],
                         device=self.device))
        self._refresh_membership_arrays()

    def _refresh_membership_arrays(self) -> None:
        """Rebuild the slots' ``(S, 5, K_cap)`` coefficient tables and
        ``(K_cap,)`` cluster map on the device from the slot specs (the
        tables come from ``coeff_tables_cached``, a cache hit for a
        membership seen before)."""
        self._coeff_tables = coeff_tables_cached(
            tuple(e.objective for e in self.experts),
            tuple(e.schedule for e in self.experts),
            self.sampler.num_steps, self.sampler.conversion,
        ).to(self.device)
        self._cluster_map = torch.tensor(
            [max(e.cluster_id, 0) for e in self.experts],
            dtype=torch.int64, device=self.device)

    def _membership(self) -> tuple | None:
        """The admission-time snapshot ``(epoch, store, tables, cluster
        map, live slots)``: every part is immutable, so holding it pins a
        request's routing whatever membership changes follow.  The live
        count is read from the host-side health, never from the device."""
        if not self.elastic:
            return None
        return (self.membership_epoch, self.param_store,
                self._coeff_tables, self._cluster_map,
                self.num_live_experts)

    def _require_elastic(self, op: str) -> None:
        if not self.elastic:
            raise ValueError(
                f"{op} requires an elastic engine — construct the "
                f"ServingEngine with capacity=<K_cap> (or "
                f"from_checkpoint_dir(capacity=...))"
            )

    @property
    def num_live_experts(self) -> int:
        return sum(h == "ACTIVE" for h in self.expert_health)

    def _with_slot_valid(self, e: int, live: bool):
        mask = self.param_store.valid_mask().clone()
        mask[e] = live
        return self.param_store.with_valid(mask)

    def add_expert(self, ckpt_path: str, *, slot: int | None = None) -> int:
        """Hot-add a contributor checkpoint into a free capacity slot.

        The checkpoint is loaded and checked against the ensemble's
        template (a failure is recorded in ``self.quarantine`` and
        re-raised, the engine unchanged), written into the slot
        (``store.set_expert``, quantized per ``sampler.param_dtype``),
        the tables and cluster map rebuilt, and the slot's liveness bit
        flipped last, in the same new store object.  Returns the slot.
        """
        self._require_elastic("add_expert")
        if slot is None:
            free = [i for i, h in enumerate(self.expert_health)
                    if h in ("EMPTY", "EVICTED")]
            if not free:
                raise RuntimeError(
                    f"no free capacity slot (capacity={self.capacity}, "
                    f"health={self.expert_health}); evict or retire an "
                    f"expert first"
                )
            slot = free[0]
        elif self.expert_health[slot] in ("ACTIVE", "DRAINING"):
            raise ValueError(
                f"slot {slot} is {self.expert_health[slot]}; evict it "
                f"before overwriting"
            )
        try:
            params, meta = load_checkpoint(ckpt_path, device=self.device)
            for field in ("objective", "schedule"):
                if field not in meta:
                    raise ValueError(
                        f"{ckpt_path}: metadata missing {field!r} — not a "
                        f"self-describing expert checkpoint"
                    )
            _validate_expert_params(params, self._slot_template, ckpt_path)
        except (ValueError, FileNotFoundError) as e:
            self.quarantine.append(
                {"path": ckpt_path, "reason": str(e), "slot": None})
            self.stats["quarantined_checkpoints"] += 1
            raise
        self.param_store = self.param_store.set_expert(slot, params)
        self.param_store = self._with_slot_valid(slot, True)
        cid = int(meta.get("cluster_id", slot))
        self.experts[slot] = dataclasses.replace(
            self.experts[0],
            name=meta.get("name", os.path.basename(ckpt_path)),
            objective=meta["objective"], schedule=meta["schedule"],
            cluster_id=max(cid, 0))
        self.expert_health[slot] = "ACTIVE"
        self._refresh_membership_arrays()
        self.membership_epoch += 1
        self.stats["experts_added"] += 1
        return slot

    def _mask_slot(self, e: int, state: str) -> int:
        if not (0 <= e < len(self.experts)):
            raise IndexError(
                f"expert slot {e} out of range [0, {len(self.experts)})")
        if self.expert_health[e] not in ("ACTIVE", "DRAINING"):
            raise ValueError(
                f"slot {e} is {self.expert_health[e]}, not servable")
        self.param_store = self._with_slot_valid(e, False)
        self.expert_health[e] = state
        self.membership_epoch += 1
        return e

    def evict_expert(self, e: int) -> int:
        """Mask slot ``e`` at once (``EVICTED``).  New requests route over
        the survivors; a request already submitted is served under its
        admission-time snapshot, as a flush before the eviction would."""
        self._require_elastic("evict_expert")
        self._mask_slot(e, "EVICTED")
        self.stats["experts_evicted"] += 1
        return e

    def retire_expert(self, e: int) -> int:
        """Graceful eviction: masked at once, ``DRAINING`` until the next
        ``flush`` serves the requests admitted under it, then ``EVICTED``
        (and reusable by ``add_expert``)."""
        self._require_elastic("retire_expert")
        self._mask_slot(e, "DRAINING")
        self.stats["experts_evicted"] += 1
        return e

    def quarantine_expert(self, e: int, reason: str = "") -> int:
        """Mask slot ``e`` as ``QUARANTINED`` (suspect parameters at run
        time) and record it."""
        self._require_elastic("quarantine_expert")
        self._mask_slot(e, "QUARANTINED")
        self.quarantine.append({"path": self.experts[e].name,
                                "reason": reason or "runtime", "slot": e})
        self.stats["quarantined_checkpoints"] += 1
        return e

    def trip_expert(self, e: int, reason: str = "") -> int:
        """Circuit-breaker trip: mask slot ``e`` as ``PROBATION`` (the
        ``quarantine_expert`` masking path); canary probes
        (``serving.resilience``) bring it back with ``restore_expert``."""
        self._require_elastic("trip_expert")
        self._mask_slot(e, "PROBATION")
        self.quarantine.append({"path": self.experts[e].name,
                                "reason": reason or "breaker trip",
                                "slot": e})
        self.stats["breaker_trips"] += 1
        return e

    def restore_expert(self, e: int) -> int:
        """Unmask a ``PROBATION`` or ``QUARANTINED`` slot back to
        ``ACTIVE`` (a new store with the bit set, epoch bumped)."""
        self._require_elastic("restore_expert")
        if not (0 <= e < len(self.experts)):
            raise IndexError(
                f"expert slot {e} out of range [0, {len(self.experts)})")
        if self.expert_health[e] not in ("PROBATION", "QUARANTINED"):
            raise ValueError(
                f"slot {e} is {self.expert_health[e]}; only PROBATION/"
                f"QUARANTINED slots can be restored"
            )
        self.param_store = self._with_slot_valid(e, True)
        self.expert_health[e] = "ACTIVE"
        self.membership_epoch += 1
        return e

    def _note_degraded(self, membership, steps: int | None = None) -> None:
        """Count degraded-mode steps: serving with fewer live experts than
        the routing width (the k slots renormalize over the survivors).
        ``steps`` defaults to a dispatch's ``num_steps`` (a rolling tick
        passes its own).  The live count is the snapshot's host-side one:
        no device read."""
        if membership is None:
            return
        n_live, store = membership[4], membership[1]
        k_slots = 1 if self.sampler.strategy == "top1" \
            else min(self.sampler.top_k, store.num_experts)
        if n_live < k_slots:
            self.stats["degraded_steps"] += (
                self.sampler.num_steps if steps is None else steps)

    def membership_line(self) -> str:
        """One-line membership and fault summary (the CLI prints it)."""
        s = self.stats
        cap = self.capacity if self.elastic else len(self.experts)
        probation = sum(h == "PROBATION" for h in self.expert_health)
        return (f"membership: live={self.num_live_experts}/{cap} "
                f"added={s['experts_added']} "
                f"evicted={s['experts_evicted']} "
                f"quarantined={s['quarantined_checkpoints']} "
                f"degraded_steps={s['degraded_steps']} "
                f"requeues={s['request_requeues']} "
                f"failed={s['failed_requests']} "
                f"probation={probation} "
                f"trips={s['breaker_trips']} "
                f"probes={s['breaker_probes']} "
                f"restores={s['breaker_restores']} "
                f"deadline_exceeded={s['deadline_exceeded']}")

    def restore(self, journal_dir: str, **kwargs):
        """Crash recovery: a resilient scheduler rebuilt from the journal
        a previous process wrote, its in-flight requests re-admitted at
        their last snapshot (``serving.resilience.ResilientScheduler.
        restore``).  The engine must hold the checkpoints and membership
        the journal was written under."""
        from repro_torch.serving.resilience import ResilientScheduler

        return ResilientScheduler.restore(self, journal_dir, **kwargs)

    @property
    def stacked_params(self):
        """The dispatch substrate: a dense store's stacked tree; a
        quantized store itself (its float32 leaves are never expanded
        whole)."""
        if isinstance(self.param_store, DenseStore):
            return self.param_store.stacked
        return self.param_store

    @classmethod
    def from_checkpoint_dir(
        cls, ckpt_dir: str, *, dit_cfg: DiTConfig,
        router_cfg: DiTConfig | None = None,
        sampler: SamplerConfig | None = None,
        engine: str = "auto",
        param_dtype: str | None = None,
        cond_cache_size: int = 64,
        capacity: int | None = None,
        on_bad_checkpoint: str = "raise",
        track_padding: bool = False,
        device=None,
    ) -> "ServingEngine":
        """Assemble an engine from a directory of expert checkpoints.

        Experts are ordered numerically by cluster id (from each
        checkpoint's metadata, falling back to the ``expert<N>.npz``
        filename index).  Duplicate cluster ids raise ``ValueError``; so
        does a checkpoint without ``objective``/``schedule`` metadata, and
        one (after the first in path order, the template) whose tree
        structure or leaf shapes differ from the first's or whose float
        leaves are not finite.  With ``on_bad_checkpoint='skip'`` such a
        checkpoint is quarantined instead (``engine.quarantine``,
        ``stats['quarantined_checkpoints']``) and the rest served; a
        cluster id it leaves empty becomes a masked EMPTY slot, which
        forces the elastic (capacity) path.  Otherwise holes in
        ``0..K-1`` raise.  ``capacity`` reserves slots for
        ``add_expert``.  Parameters load onto ``device`` (``None`` →
        ``"cuda"``).  ``param_dtype``, when given, overrides
        ``sampler.param_dtype``.  Experts with a class head
        (``dit_cfg.num_classes``) publish no ragged forward, so
        ``dispatch='auto'`` resolves to grouped.
        """
        if on_bad_checkpoint not in ("raise", "skip"):
            raise ValueError(
                f"on_bad_checkpoint must be 'raise' or 'skip', "
                f"got {on_bad_checkpoint!r}"
            )
        dev = resolve_device(device)
        apply_fn = D.make_expert_apply(dit_cfg)
        ragged_fn = None
        if not dit_cfg.num_classes:
            ragged_fn = D.make_ragged_expert_apply(dit_cfg)
        paths = glob.glob(os.path.join(ckpt_dir, "expert*.npz"))
        if not paths:
            raise FileNotFoundError(f"no expert*.npz under {ckpt_dir}")
        loaded, quarantined = [], []
        template = None
        for path in sorted(paths):
            try:
                p, meta = load_checkpoint(path, device=dev)
                for field in ("objective", "schedule"):
                    if field not in meta:
                        raise ValueError(
                            f"{path}: missing '{field}' metadata — not a "
                            f"self-describing expert checkpoint"
                        )
                cid = int(meta.get("cluster_id", -1))
                if cid < 0:
                    m = _EXPERT_IDX_RE.search(os.path.basename(path))
                    if m is None:
                        raise ValueError(
                            f"{path}: no cluster_id metadata and no "
                            f"numeric index in the filename — cannot "
                            f"place this expert"
                        )
                    cid = int(m.group(1))
                if template is None:
                    template = (tree_structure(p),
                                [tuple(x.shape) for x in tree_leaves(p)])
                else:
                    _validate_expert_params(p, template, path)
            except (ValueError, FileNotFoundError) as e:
                if on_bad_checkpoint == "raise":
                    raise
                quarantined.append({"path": path, "reason": str(e)})
                continue
            loaded.append((cid, path, p, meta))
        if not loaded:
            raise ValueError(
                f"every expert checkpoint under {ckpt_dir} was "
                f"quarantined: {[q['path'] for q in quarantined]}"
            )
        seen: dict[int, str] = {}
        for cid, path, _, _ in loaded:
            if cid in seen:
                raise ValueError(
                    f"duplicate cluster_id {cid}: {seen[cid]} and {path}"
                )
            seen[cid] = path
        n_slots = max(seen) + 1
        holes = sorted(set(range(n_slots)) - set(seen))
        if holes and on_bad_checkpoint == "raise":
            raise ValueError(
                f"expert checkpoints must cover cluster ids 0..{n_slots - 1} "
                f"exactly (the router posterior's columns are positional); "
                f"got {sorted(seen)} — missing {holes}"
            )
        by_cid = {cid: (path, p, meta) for cid, path, p, meta in loaded}
        experts, params, health = [], [], []
        for cid in range(n_slots):
            if cid in by_cid:
                path, p, meta = by_cid[cid]
                experts.append(ExpertSpec(
                    name=meta.get("name", os.path.basename(path)),
                    objective=meta["objective"],
                    schedule=meta["schedule"],
                    apply_fn=apply_fn,
                    cluster_id=cid,
                    ragged_apply_fn=ragged_fn,
                ))
                params.append(p)
                health.append("ACTIVE")
            else:
                # a masked placeholder for a quarantined slot: zero
                # parameters, never routed, never gathered
                experts.append(ExpertSpec(
                    name=f"<quarantined:{cid}>", objective="fm",
                    schedule="linear", apply_fn=apply_fn, cluster_id=cid,
                    ragged_apply_fn=ragged_fn))
                params.append(tree_map(torch.zeros_like, loaded[0][2]))
                health.append("EMPTY")
        if holes and capacity is None:
            capacity = n_slots                  # masking needs elastic mode
        router_fn = None
        router_path = os.path.join(ckpt_dir, "router.npz")
        if router_cfg is not None and os.path.exists(router_path):
            rp, _ = load_checkpoint(router_path, device=dev)
            router_fn = D.make_router_fn(router_cfg, rp)
        sampler = sampler if sampler is not None else SamplerConfig()
        if param_dtype is not None:
            sampler = dataclasses.replace(sampler, param_dtype=param_dtype)
        eng = cls(
            experts=experts, expert_params=params, router_fn=router_fn,
            latent_shape=(dit_cfg.latent_size, dit_cfg.latent_size,
                          dit_cfg.latent_channels),
            sampler=sampler,
            engine=engine, cond_cache_size=cond_cache_size, device=dev,
            track_padding=track_padding, capacity=capacity,
            initial_health=health if capacity is not None else None,
        )
        if quarantined:
            eng.quarantine.extend(quarantined)
            eng.stats["quarantined_checkpoints"] += len(quarantined)
        return eng

    # -- cross-request conditioning cache -----------------------------------

    def _cached_cond(self, text_emb):
        """Content-hash-keyed LRU over host conditioning arrays.

        Requests carrying byte-identical embeddings (one prompt, many
        seeds) resolve to one resident device tensor.  Tensors pass
        through unhashed (moved to the engine's device): hashing a device
        tensor would force a device→host copy per request.
        """
        if text_emb is None:
            return None
        if isinstance(text_emb, torch.Tensor) or self.cond_cache_size <= 0:
            return _as_device_tensor(text_emb, self.device)
        arr = np.ascontiguousarray(text_emb)
        key = (arr.shape, str(arr.dtype),
               hashlib.sha1(arr.tobytes()).hexdigest())
        cached = self._cond_cache.get(key)
        if cached is not None:
            self._cond_cache.move_to_end(key)
            self.stats["cond_cache_hits"] += 1
            return cached
        self.stats["cond_cache_misses"] += 1
        val = _as_device_tensor(arr, self.device)
        self._cond_cache[key] = val
        while len(self._cond_cache) > self.cond_cache_size:
            self._cond_cache.popitem(last=False)
        return val

    # -- dispatch-padding observability -----------------------------------

    def _count_executed_rows(self) -> None:
        """Wrap the shared expert forwards with host row counters: a dense
        ``apply_fn`` call runs its batch's rows (the grouped executor's
        bucket padding included), a ragged call ``P·g`` (pairs times
        guidance replicas).  One wrapper per forward kind for every
        expert, since the engine and ragged eligibility compare the
        forwards by identity."""
        if not self.experts:
            return
        if any(e.apply_fn is not self.experts[0].apply_fn
               for e in self.experts):
            raise ValueError(
                "track_padding=True needs a homogeneous ensemble (one "
                "shared apply_fn): heterogeneous sets run the dense "
                "executor, which has no dispatch padding to observe"
            )
        base_apply = self.experts[0].apply_fn

        def counted_apply(params, x, t, **cond):
            self.stats["padded_model_rows"] += x.shape[0]
            return base_apply(params, x, t, **cond)

        base_ragged = self.experts[0].ragged_apply_fn
        counted_ragged = None
        if base_ragged is not None:
            def counted_ragged(view, x_p, t_p, cond, pe, g):
                self.stats["padded_model_rows"] += x_p.shape[0] * g
                return base_ragged(view, x_p, t_p, cond, pe, g)

        self.experts = [dataclasses.replace(e, apply_fn=counted_apply,
                                            ragged_apply_fn=counted_ragged)
                        for e in self.experts]

    def _count_dispatch(self, batch_size: int, has_text: bool) -> None:
        """Per-dispatch statistics: plan refreshes (⌈S/R⌉) and, with
        ``track_padding``, the routed rows the plans ask for, ``B·k·g·S``."""
        steps = self.sampler.num_steps
        self.stats["plan_refreshes"] += -(-steps // max(
            1, self.sampler.plan_refresh_every))
        if not self.track_padding:
            return
        k_slots = 1 if self.sampler.strategy in ("top1", "threshold") \
            else min(self.sampler.top_k, max(len(self.experts), 1))
        g = 2 if (has_text and self.sampler.cfg_scale != 1.0) else 1
        self.stats["routed_model_rows"] += batch_size * k_slots * g * steps
        self.stats["model_steps"] += steps

    def padding_stats(self) -> dict:
        """Executed against routed rows per sampling step, into ``stats``
        (needs ``track_padding=True``): ``padding_overhead`` is
        executed/routed − 1 — 0.0 under the ragged executor, the bucket
        overshoot under the grouped one."""
        if not self.track_padding:
            raise ValueError(
                "padding stats need ServingEngine(track_padding=True) — "
                "row counting wraps the expert forward at construction")
        steps = max(self.stats["model_steps"], 1)
        routed = max(self.stats["routed_model_rows"], 1)
        self.stats["padded_rows_per_step"] = \
            self.stats["padded_model_rows"] / steps
        self.stats["routed_rows_per_step"] = \
            self.stats["routed_model_rows"] / steps
        self.stats["padding_overhead"] = \
            self.stats["padded_model_rows"] / routed - 1.0
        return {k: self.stats[k] for k in (
            "padded_rows_per_step", "routed_rows_per_step",
            "padding_overhead")}

    # -- sampling -----------------------------------------------------------

    def _noise(self, seed_or_generator, batch_size: int,
               noise=None) -> torch.Tensor:
        """``noise`` on the device, or ``(B, H, W, C)`` drawn from an int
        seed or a ``torch.Generator`` on the engine's device."""
        if noise is not None:
            return _as_device_tensor(noise, self.device)
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed_or_generator))
        return torch.randn((batch_size,) + tuple(self.latent_shape),
                           generator=gen, dtype=torch.float32,
                           device=self.device)

    def _sample(self, noise: torch.Tensor, text,
                membership=None) -> torch.Tensor:
        """One sampler dispatch from ``noise``; with text, batched CFG
        against the learned null embedding.  An elastic engine serves
        under ``membership`` (a ``_membership`` snapshot; default the
        current one)."""
        has_text = text is not None
        self._count_dispatch(noise.shape[0], has_text)
        store, tables, cmap = self.param_store, None, None
        if self.elastic:
            membership = membership or self._membership()
            _, store, tables, cmap, _ = membership
            self._note_degraded(membership)
        return sample_ensemble(
            self.experts, self.expert_params, self.router_fn,
            tuple(noise.shape),
            cond={"text_emb": text} if has_text else None,
            null_cond={"text_emb": None} if has_text else None,
            config=self.sampler, engine=self.engine, init_noise=noise,
            stacked_params=store, coeff_tables=tables, cluster_map=cmap,
        )

    def generate(self, seed_or_generator, batch_text_emb, batch_size: int,
                 *, noise=None) -> torch.Tensor:
        """Sample ``batch_size`` latents ``(B, H, W, C)``.

        The starting noise is drawn from ``seed_or_generator`` (an int
        seed or a ``torch.Generator`` on the engine's device) unless
        ``noise`` hands in the exact array to start from.  With text the
        sampler runs batched classifier-free guidance against the learned
        null embedding.
        """
        self.stats["requests"] += 1
        noise = self._noise(seed_or_generator, batch_size, noise)
        return self._sample(noise, self._cached_cond(batch_text_emb))

    # -- cross-request batching queue ---------------------------------------

    def _next_seq(self) -> int:
        """The next global submission-order stamp."""
        seq = self._seq
        self._seq += 1
        return seq

    def submit(self, seed_or_generator, text_emb=None,
               batch_size: int | None = None, *, noise=None,
               deadline_s: float | None = None) -> PendingRequest:
        """Enqueue a request; returns a handle resolved by ``flush()``.

        The noise comes from the request's own seed (or ``noise``) at
        flush time, so a coalesced request samples what ``generate``
        would from that seed.  A request still queued ``deadline_s``
        seconds after submit is expired by the next ``flush()``.  On an
        elastic engine the request snapshots the current membership.
        """
        if batch_size is None:
            batch_size = text_emb.shape[0] if text_emb is not None else 1
        if text_emb is not None and text_emb.shape[0] != batch_size:
            raise ValueError(f"text_emb batch {text_emb.shape[0]} != "
                             f"batch_size {batch_size}")
        req = PendingRequest(
            seed=seed_or_generator, text_emb=self._cached_cond(text_emb),
            batch_size=batch_size, noise=noise,
            _membership=self._membership(), seq=self._next_seq(),
            deadline_s=deadline_s, submit_t=time.monotonic())
        self._queue.append(req)
        self.stats["requests"] += 1
        return req

    def flush(self) -> int:
        """Run all queued requests, coalescing compatible ones.

        Latent shape and sampler config are the engine's, so requests are
        compatible when their conditioning signature is (text present and
        its trailing shape) and, on an elastic engine, so is the
        membership epoch they were admitted under.  Each group is one sampler dispatch over the
        merged batch padded to the next power of two (zero noise, zero
        text), and each request's rows are sliced back out.  A failing
        group re-queues only its own requests, each at most
        ``max_request_requeues`` times before it is FAILED with the
        exception; re-queued requests keep FIFO order.  Returns the number
        of groups dispatched.
        """
        if not self._queue:
            return 0
        now = time.monotonic()
        live = []
        for req in self._queue:
            if req.deadline_s is not None and \
                    now - req.submit_t >= req.deadline_s:
                req.state = "DEADLINE_EXCEEDED"
                req.error = DeadlineExceeded(
                    f"request seq={req.seq} exceeded deadline_s="
                    f"{req.deadline_s} before dispatch ({req.requeues} "
                    f"requeue(s))", seq=req.seq, requeues=req.requeues)
                self.stats["deadline_exceeded"] += 1
            else:
                live.append(req)
        groups: dict[tuple, list[PendingRequest]] = {}
        for req in live:
            sig = (req.text_emb is not None,
                   tuple(req.text_emb.shape[1:])
                   if req.text_emb is not None else (),
                   req._membership[0] if req._membership is not None
                   else -1)
            groups.setdefault(sig, []).append(req)
        self._queue = []
        ok = 0
        for (has_text, text_tail, _epoch), reqs in groups.items():
            try:
                self._dispatch_group(has_text, text_tail, reqs)
                ok += 1
            except Exception as e:
                for r in reqs:
                    r.requeues += 1
                    if r.requeues > self.max_request_requeues:
                        r.state = "FAILED"
                        r.error = e
                        self.stats["failed_requests"] += 1
                    else:
                        self.stats["request_requeues"] += 1
                        self._queue.append(r)
        self._queue.sort(key=lambda r: r.seq)
        if self.elastic:
            # DRAINING slots held for their in-flight snapshots are done
            for i, h in enumerate(self.expert_health):
                if h == "DRAINING":
                    self.expert_health[i] = "EVICTED"
        return ok

    def _dispatch_group(self, has_text: bool, text_tail: tuple,
                        reqs: list[PendingRequest]) -> None:
        total = sum(r.batch_size for r in reqs)
        pad = (1 << (total - 1).bit_length()) - total
        noise = [self._noise(r.seed, r.batch_size, r.noise) for r in reqs]
        if pad:
            noise.append(torch.zeros((pad,) + tuple(self.latent_shape),
                                     device=self.device))
        text = None
        if has_text:
            text = [r.text_emb for r in reqs]
            if pad:
                text.append(torch.zeros((pad,) + text_tail,
                                        dtype=text[0].dtype,
                                        device=self.device))
            text = torch.cat(text)
        noise = torch.cat(noise)
        membership = reqs[0]._membership
        out = (self._sample(noise, text) if membership is None
               else self._sample(noise, text, membership))
        self.stats["merged_batches"] += 1
        self.stats["batched_requests"] += len(reqs)
        off = 0
        for r in reqs:
            r._result = out[off:off + r.batch_size]
            r.state = "DONE"
            r.done = True
            off += r.batch_size


#: CLI flags of the reference whose modes the port has not ported yet:
#: flag -> (default, ROADMAP.md module queue item)
_UNPORTED_FLAGS = {
    "expert_shards": (1, "A.8"), "data_shards": (None, "A.8"),
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a directory of DiT expert checkpoints (and "
                    "router.npz) on the port: the reference CLI's plain, "
                    "--coalesce and --continuous modes.")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cfg-scale", type=float, default=7.5)
    ap.add_argument("--strategy", default="topk",
                    choices=("top1", "topk", "full", "threshold"))
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "routed", "dense", "reference"))
    ap.add_argument("--dispatch", default="auto",
                    choices=("auto", "gathered", "grouped", "ragged",
                             "dense"))
    ap.add_argument("--param-dtype", default="native",
                    choices=("native", "fp32", "bf16", "int8", "fp8"))
    ap.add_argument("--plan-refresh", type=int, default=1,
                    help="rerun the router and the dispatch plan only "
                         "every R-th Euler step (R=1: every step)")
    ap.add_argument("--no-step-fuse", action="store_true",
                    help="the unfused step: velocity kernel, then CFG "
                         "combine and Euler update as separate ops")
    ap.add_argument("--cond-cache", type=int, default=64,
                    help="cross-request conditioning LRU capacity "
                         "(0 disables)")
    # As in the reference CLI: store_true with default True, so the
    # reduced config is always served.
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--latent-size", type=int, default=8)
    ap.add_argument("--coalesce", action="store_true",
                    help="drive requests through submit()/flush() instead "
                         "of per-request generate()")
    ap.add_argument("--continuous", action="store_true",
                    help="drive requests through the rolling "
                         "mixed-timestep scheduler (repro_torch.serving): "
                         "requests join and leave the batch at step "
                         "boundaries instead of lockstep flushing")
    ap.add_argument("--max-resident", type=int, default=8,
                    help="rolling-batch capacity per shape bucket "
                         "(continuous mode)")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="scheduler queue-depth bound before submit() "
                         "raises QueueBackpressure (continuous mode)")
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="continuous mode: submit one request every N "
                         "scheduler ticks (staggered arrivals)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="--continuous: each request's deadline in "
                         "seconds (ignored in the plain and --coalesce "
                         "modes, as in the reference CLI)")
    ap.add_argument("--tick-budget", type=float, default=None,
                    help="continuous mode: wall-clock watchdog budget per "
                         "bucket tick; a slower tick fails only that "
                         "bucket, retried after a bounded backoff")
    ap.add_argument("--journal-dir", default=None,
                    help="continuous mode: write the crash-recovery "
                         "request journal here; recover with "
                         "ServingEngine.restore(journal_dir)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="expert-slot capacity (>= checkpoint count): pads "
                         "the store with masked EMPTY slots and enables "
                         "elastic membership")
    ap.add_argument("--on-bad-checkpoint", default="raise",
                    choices=("raise", "skip"),
                    help="'skip' quarantines corrupt, truncated or "
                         "mismatched expert checkpoints and serves the "
                         "rest instead of refusing to start")
    ap.add_argument("--track-padding", action="store_true",
                    help="count executed against routed expert rows and "
                         "print them per step (plain mode)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    # parsed, not ported: a non-default value raises
    ap.add_argument("--expert-shards", type=int, default=1)
    ap.add_argument("--data-shards", type=int, default=None)
    return ap


def main(argv=None) -> None:
    """The reference CLI's plain, ``--coalesce`` and ``--continuous``
    modes, printing its lines less ``traces=`` (the port compiles no
    per-shape trace).  Text embeddings come from ``torch.Generator`` seed
    r, so the latents differ from the reference CLI's; the engine tests
    hold parity."""
    args = _parser().parse_args(argv)
    for name, (default, item) in _UNPORTED_FLAGS.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet — "
                f"ROADMAP.md, module queue {item}")
    dit_cfg, rcfg = dit_b2(), router_b2()
    if args.reduced:
        dit_cfg = dit_cfg.reduced(latent_size=args.latent_size)
        rcfg = rcfg.reduced(latent_size=args.latent_size)
    engine = ServingEngine.from_checkpoint_dir(
        args.ckpt_dir, dit_cfg=dit_cfg, router_cfg=rcfg,
        sampler=SamplerConfig(
            num_steps=args.steps, cfg_scale=args.cfg_scale,
            strategy=args.strategy, top_k=args.top_k,
            dispatch=args.dispatch, param_dtype=args.param_dtype,
            step_fused=not args.no_step_fuse,
            plan_refresh_every=args.plan_refresh),
        engine=args.engine, cond_cache_size=args.cond_cache,
        capacity=args.capacity, on_bad_checkpoint=args.on_bad_checkpoint,
        track_padding=args.track_padding, device=args.device)
    print(f"loaded {len(engine.experts)} experts "
          f"({[e.objective for e in engine.experts]}) "
          f"homogeneous={engine.homogeneous} mesh=None")
    if engine.elastic:
        print(engine.membership_line())

    def text(r):
        # a host array, as a remote text encoder delivers it — the form
        # the conditioning cache hashes
        gen = torch.Generator().manual_seed(r)
        return torch.randn((args.batch, dit_cfg.text_len, dit_cfg.text_dim),
                           generator=gen).numpy()

    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    if args.continuous:
        from repro_torch.serving import (ContinuousScheduler,
                                         ResiliencePolicy,
                                         ResilientScheduler)

        resilient = (args.deadline_s is not None
                     or args.tick_budget is not None
                     or args.journal_dir is not None)
        if resilient:
            sched = ResilientScheduler(
                engine, max_resident=args.max_resident,
                max_queue_depth=args.max_queue,
                policy=ResiliencePolicy(tick_budget_s=args.tick_budget),
                journal_dir=args.journal_dir)
        else:
            sched = ContinuousScheduler(
                engine, max_resident=args.max_resident,
                max_queue_depth=args.max_queue)
        t0 = time.time()
        handles = []
        for r in range(args.requests):
            kw = dict(deadline_s=args.deadline_s) if resilient else {}
            handles.append(sched.submit(r, text(r), **kw))
            for _ in range(max(args.arrival_every, 0)):
                sched.step()
        sched.run_until_idle()
        outs = [h.result() for h in handles]
        sync()
        dt = time.time() - t0
        n = sum(o.shape[0] for o in outs)
        print(f"continuous {len(handles)} requests in "
              f"{sched.step_count} ticks: {n} imgs in {dt:.2f}s "
              f"({n / dt:.1f} img/s)")
        print(sched.line())
        if engine.elastic:
            print(engine.membership_line())
        return
    if args.coalesce:
        t0 = time.time()
        # As the reference: --deadline-s acts under --continuous only.
        handles = [engine.submit(r, text(r)) for r in range(args.requests)]
        engine.flush()
        outs = [h.result() for h in handles]
        sync()
        dt = time.time() - t0
        n = sum(o.shape[0] for o in outs)
        print(f"coalesced {len(handles)} requests -> "
              f"{engine.stats['merged_batches']} dispatch(es): "
              f"{n} imgs in {dt:.2f}s ({n / dt:.1f} img/s)")
        print(f"cache: cond_hits={engine.stats['cond_cache_hits']} "
              f"cond_misses={engine.stats['cond_cache_misses']} "
              f"plan_refreshes={engine.stats['plan_refreshes']} "
              f"(R={args.plan_refresh}, {args.steps} steps/dispatch)")
        if engine.elastic:
            print(engine.membership_line())
        return
    for r in range(args.requests):
        t0 = time.time()
        out = engine.generate(r, text(r), args.batch)
        sync()
        dt = time.time() - t0
        print(f"request {r}: {tuple(out.shape)} in {dt:.2f}s "
              f"({args.batch / dt:.1f} img/s) "
              f"finite={bool(torch.isfinite(out).all())}")
    print(f"cache: cond_hits={engine.stats['cond_cache_hits']} "
          f"cond_misses={engine.stats['cond_cache_misses']} "
          f"plan_refreshes={engine.stats['plan_refreshes']} "
          f"(R={args.plan_refresh}, {args.steps} steps/request)")
    if args.track_padding:
        ps = engine.padding_stats()
        print(f"padding: padded_rows/step={ps['padded_rows_per_step']:.2f} "
              f"routed_rows/step={ps['routed_rows_per_step']:.2f} "
              f"overhead={ps['padding_overhead']:.3f}")
    if engine.elastic:
        print(engine.membership_line())


if __name__ == "__main__":
    main()
