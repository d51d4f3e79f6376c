"""Multi-rank parity check of the port's sharded serving engine.

Spawns ``--world N`` ranks (``launch.mesh.spawn``: one process each, a
``FileStore`` in a temporary directory) and holds, for the same seeds,
the sharded engine against the port's own unsharded engine:

  1. the degenerate ``(1, 1)`` mesh == unsharded, bitwise (run in this
     process first: a world of one);
  2. expert-sharded ``(N, 1)`` == unsharded;
  3. data-sharded ``(1, N)`` == unsharded;
  4. the grouped executor (``dispatch='grouped'``) on both meshes ==
     unsharded — each rank runs its resident experts' segments;
  5. ``submit``/``flush`` on the expert-sharded engine: one merged
     dispatch whose slices equal each request's unsharded ``generate``;
  6. an int8 store (``param_dtype='int8'``) on ``(N, 1)``: every
     per-expert scale is cut with the leaf it rescales (each rank holds
     ``K / N`` of each), the store's resident bytes are ``1 / N`` of the
     whole, and the latents match the dense unsharded engine's
     (``1e-4 · max``: the toy leaves quantize exactly);
  7. ``step_fused=False`` on both meshes == the fused unsharded engine,
     and plan reuse (``plan_refresh_every=2``) on both == unsharded R 2;
  8. masked elastic membership (``capacity=K+N``) on both meshes: the
     validity mask is cut with its store on ``(N, 1)``, padded slots
     contribute nothing, and evicting a routed expert on each sharded
     engine equals the same eviction unsharded;
  9. the ragged executor (``dispatch='ragged'``, a small reduced-DiT
     ensemble publishing ``ragged_apply_fn``) on both meshes == its
     unsharded grouped engine, no ragged forward ever handed zero pairs,
     and hot evict + hot add on an elastic ragged ``(N, 1)`` engine change
     the latents and stay finite;
 10. continuous batching (``serving.ContinuousScheduler``): three
     staggered requests (batch 1, 2, 1) into a rolling batch of 4, at
     ``steps_per_tick`` 1 and 2, on both meshes == the unsharded rolling
     run (bitwise on ``(N, 1)``), and on each mesh each request bitwise
     that mesh's ``generate`` of it (the reference's rolling == lockstep
     property; the toy's ops are row-independent);
 11. ``serving.ResilientScheduler`` with a journal (rank 0 writes it) on
     both meshes, abandoned after 2 ticks and rebuilt on every rank by
     ``ServingEngine.restore``: the continuation bitwise an uninterrupted
     twin's;
 12. the elastic rolling batch (``capacity=K+N``) on both meshes == the
     unsharded one, before and after evicting a routed expert;
 13. the reference engine (``engine='reference'``) on ``(N, 1)`` bitwise
     the unsharded reference engine.

Tolerance: ``max |Δ| ≤ 1e-5 · max |latent|`` (the reference's) except
where an item says bitwise or otherwise.  ``--dit`` swaps the toy
closed-form experts (``launch.faults.toy_ensemble``) for reduced DiT
experts and skips items 4, 6–8, 11 and 12 (the first four as the
reference does), and holds item 10's lockstep comparison to the
tolerance (the router's GEMMs sum by the batch's row count).  Rank 0
prints one JSON line with the reference's keys and the new items'
(``rolling_parity``, ``resilient_restore_parity``,
``elastic_rolling_parity``, ``reference_engine_parity``)::

    python -m repro_torch.launch.sharded_parity --world 2 --device cpu
    python -m repro_torch.launch.sharded_parity --world 2 --device cuda \\
        --backend gloo

``serve_checkpoints_rank`` and ``serve_rolling_rank`` are the rank
functions the tests spawn to serve a checkpoint directory on given
meshes, through ``generate`` and through the rolling schedulers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.core.fusion import ExpertSpec
from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch.faults import toy_ensemble
from repro_torch.launch.mesh import spawn
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.tree import tree_leaves, tree_map

REL_TOL = 1e-5
QUANT_REL_TOL = 1e-4


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _same(got, want, label: str) -> None:
    _check(torch.equal(got.cpu(), want.cpu()), f"{label}: not bitwise")


def rolling_run(engine, reqs, *, spt: int = 1) -> list:
    """Serve ``reqs`` (dicts of ``seed``, ``text``, ``noise`` or None)
    through a ``ContinuousScheduler`` of 4 rows, ``spt`` steps a tick,
    one submitted a tick, then tick until idle; returns each request's
    latents.  Every rank of a mesh calls it alike."""
    from repro_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler(engine, max_resident=4, steps_per_tick=spt)
    handles = []
    for r in reqs:
        handles.append(sched.submit(r["seed"], r["text"],
                                    noise=r.get("noise")))
        sched.step()
    sched.run_until_idle()
    return [h.result() for h in handles]


def kill_and_restore(engine, reqs, journal: str, kill_at: int = 2,
                     max_resident: int = 4):
    """``reqs``, submitted at once, through a journaled
    ``ResilientScheduler`` abandoned after ``kill_at`` ticks (no drain),
    then through the scheduler ``engine.restore`` rebuilds from the
    journal, and through an uninterrupted twin given the same traffic:
    ``(restored, twin)`` latents, request by request."""
    from repro_torch.serving import ResilientScheduler

    def traffic(sched):
        return [sched.submit(r["seed"], r["text"], noise=r.get("noise"))
                for r in reqs]

    dead = ResilientScheduler(engine, max_resident=max_resident,
                              journal_dir=journal)
    traffic(dead)
    for _ in range(kill_at):
        dead.step()
    if dead.journal is not None:
        dead.journal.close()
    del dead                                   # the crash: no drain
    twin = ResilientScheduler(engine, max_resident=max_resident)
    handles = traffic(twin)
    twin.run_until_idle()
    twin = [h.result() for h in handles]
    restored = engine.restore(journal)
    got = {r.seq: r for b in restored._buckets.values()
           for r in b.resident_requests()}
    got.update({r.seq: r for r in restored._queue})
    restored.run_until_idle()
    if restored.journal is not None:
        restored.journal.close()
    return [got[s].result() for s in sorted(got)], twin


def _requests(text: np.ndarray, sizes=(1, 2, 1), seed: int = 20) -> list:
    """Staggered requests over the rows of ``text``: batch ``sizes``,
    seeds ``seed + i``."""
    out, lo = [], 0
    for i, b in enumerate(sizes):
        out.append(dict(seed=seed + i, text=text[lo:lo + b], noise=None))
        lo += b
    return out


def _close(got, want, rel: float, label: str) -> None:
    got, want = got.detach().cpu(), want.detach().cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    _check(bool(torch.isfinite(got).all()), f"{label}: non-finite latents")
    _check(err <= rel * scale,
           f"{label}: max |Δ| {err:.3e} > {rel:g} · max |latent| {scale:.3e}")


def _jittered(cfg, seed: int, device) -> dict:
    """Reduced DiT parameters plus 0.02-scale noise on every leaf: a
    fresh init predicts exact zeros (zero-init output layers), which
    would make every expert's parameters inert."""
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda a: (a + 0.02 * torch.randn(a.shape, generator=gen)
                               ).to(device), D.init(cfg, gen))


def dit_ensemble(k: int, device, *, ragged: bool = False, cfg=None):
    """``(experts, params, router_fn, latent_shape, cfg)`` of ``k``
    jittered reduced DiT experts (DDPM/cosine and FM/linear alternating)
    and a reduced DiT router; with ``ragged`` every spec publishes one
    shared ``ragged_apply_fn`` and the router's logits grow with the slot
    index (the reference's ragged item)."""
    cfg = cfg or dit_b2().reduced(latent_size=8)
    apply_fn = D.make_expert_apply(cfg)
    ragged_fn = D.make_ragged_expert_apply(cfg) if ragged else None
    experts = [
        ExpertSpec(f"e{i}", "ddpm" if i % 2 == 0 else "fm",
                   "cosine" if i % 2 == 0 else "linear", apply_fn, i,
                   ragged_apply_fn=ragged_fn)
        for i in range(k)]
    params = [_jittered(cfg, 40 + i, device) for i in range(k)]
    if ragged:
        def router_fn(x, t):
            logits = (torch.arange(float(k), device=x.device)[None]
                      .expand(x.shape[0], k)
                      + x.mean(dim=(1, 2, 3))[:, None])
            return torch.softmax(logits, dim=-1)
    else:
        rcfg = router_b2(num_clusters=k).reduced(latent_size=8)
        router_fn = D.make_router_fn(rcfg, _jittered(rcfg, 99, device))
    latent = (cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    return experts, params, router_fn, latent, cfg


def _text(batch: int, length: int, dim: int) -> np.ndarray:
    gen = torch.Generator().manual_seed(0)
    return torch.randn((batch, length, dim), generator=gen).numpy()


def _guard_pairs(experts):
    """The specs with their shared ragged forward wrapped in a check that
    no call runs zero pairs (a rank with none must launch nothing)."""
    inner = experts[0].ragged_apply_fn

    def guarded(view, x_p, t_p, cond, pe, g):
        _check(x_p.shape[0] > 0, "a ragged forward was handed zero pairs")
        return inner(view, x_p, t_p, cond, pe, g)

    return [dataclasses.replace(e, ragged_apply_fn=guarded) for e in experts]


def _parity_rank(rank: int, world: int, args: dict, out: str) -> None:
    torch.set_num_threads(1)
    dev = torch.device(args["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    batch, steps = args["batch"], args["steps"]
    if args["dit"]:
        experts, params, router_fn, latent, cfg = dit_ensemble(4, dev)
        text = _text(batch, cfg.text_len, cfg.text_dim)
    else:
        experts, params, router_fn, latent = toy_ensemble(4, dev)
        text = _text(batch, 5, 6)
    sampler = SamplerConfig(num_steps=steps, cfg_scale=3.0, strategy="topk",
                            top_k=2)

    def engine(smp, experts=experts, params=params, router_fn=router_fn,
               latent=latent, **kw):
        return ServingEngine(experts=experts, expert_params=params,
                             router_fn=router_fn, latent_shape=latent,
                             sampler=smp, device=dev, **kw)

    meshes = ((world, 1), (1, world))
    base = engine(sampler)
    ref = base.generate(0, text, batch)

    # 2, 3: the expert- and data-sharded meshes
    sharded = {}
    for e, d in meshes:
        sharded[e, d] = engine(sampler, n_expert_shards=e, n_data_shards=d)
        _close(sharded[e, d].generate(0, text, batch), ref, REL_TOL,
               f"mesh ({e}, {d})")
    esh = sharded[world, 1]
    _check(esh.param_store.num_resident == 4 // world
           and esh.param_store.num_experts == 4,
           "the expert-sharded store must hold K/N resident experts")

    toy = not args["dit"]
    if toy:
        # 4: grouped segments on both meshes
        grouped = dataclasses.replace(sampler, dispatch="grouped")
        for e, d in meshes:
            _close(engine(grouped, n_expert_shards=e, n_data_shards=d)
                   .generate(0, text, batch), ref, REL_TOL,
                   f"grouped ({e}, {d})")

    # 5: coalesced submit/flush on the expert-sharded engine
    h1 = esh.submit(7, text[:1], 1)
    h2 = esh.submit(8, text[1:], batch - 1)
    dispatches = esh.flush()
    _check(dispatches == 1, f"expected 1 merged dispatch, got {dispatches}")
    _close(h1.result(), base.generate(7, text[:1], 1), REL_TOL, "coalesced 1")
    _close(h2.result(), base.generate(8, text[1:], batch - 1), REL_TOL,
           "coalesced 2")

    if toy:
        # 6: the int8 store's scales cut with their leaves
        qsh = engine(dataclasses.replace(sampler, param_dtype="int8"),
                     n_expert_shards=world, n_data_shards=1)
        _check(qsh.expert_params is None,
               "the quantized engine must drop the per-expert list")
        store = qsh.param_store
        whole = engine(dataclasses.replace(sampler, param_dtype="int8"))
        for q, s in zip(tree_leaves(store.qvals), tree_leaves(store.scales)):
            _check(q.shape[0] == s.shape[0] == store.num_experts // world,
                   f"each rank must hold K/N = {store.num_experts // world} "
                   f"rows of every leaf and scale, got {q.shape[0]} and "
                   f"{s.shape[0]}")
        _check(store.nbytes() * world == whole.param_store.nbytes(),
               "the resident store must be 1/N of the whole")
        _close(qsh.generate(0, text, batch), ref, QUANT_REL_TOL, "int8")

        # 7: unfused against the fused baseline; plan reuse R 2
        unfused = dataclasses.replace(sampler, step_fused=False)
        reuse = dataclasses.replace(sampler, plan_refresh_every=2)
        ref_reuse = engine(reuse).generate(0, text, batch)
        for e, d in meshes:
            _close(engine(unfused, n_expert_shards=e, n_data_shards=d)
                   .generate(0, text, batch), ref, REL_TOL,
                   f"unfused ({e}, {d})")
            _close(engine(reuse, n_expert_shards=e, n_data_shards=d)
                   .generate(0, text, batch), ref_reuse, REL_TOL,
                   f"plan reuse ({e}, {d})")

        # 8: masked elastic membership
        cap = len(experts) + world
        el_ref = engine(sampler, capacity=cap)
        el_ref.evict_expert(3)
        masked_ref = el_ref.generate(0, text, batch)
        _check(not torch.equal(masked_ref, ref),
               "evicting a routed expert must change the output")
        for e, d in meshes:
            el = engine(sampler, capacity=cap, n_expert_shards=e,
                        n_data_shards=d)
            if e == world:
                _check(el.param_store.valid.shape[0] == cap // world,
                       "the validity mask must be cut with its store")
            _close(el.generate(0, text, batch), ref, REL_TOL,
                   f"elastic ({e}, {d})")
            el.evict_expert(3)
            _close(el.generate(0, text, batch), masked_ref, REL_TOL,
                   f"elastic evicted ({e}, {d})")

    # 9: the ragged executor on both meshes, and hot evict / add
    r_cfg = dit_b2().reduced(d_model=64, num_heads=2, text_dim=16,
                             text_len=4, latent_size=8)
    r_experts, r_params, r_router, r_latent, _ = dit_ensemble(
        4, dev, ragged=True, cfg=r_cfg)
    r_experts = _guard_pairs(r_experts)
    r_text = _text(batch, r_cfg.text_len, r_cfg.text_dim)
    r_kw = dict(experts=r_experts, params=r_params, router_fn=r_router,
                latent=r_latent)
    r_ragged = dataclasses.replace(sampler, dispatch="ragged")
    r_ref = engine(dataclasses.replace(sampler, dispatch="grouped"),
                   **r_kw).generate(0, r_text, batch)
    for e, d in meshes:
        _close(engine(r_ragged, n_expert_shards=e, n_data_shards=d, **r_kw)
               .generate(0, r_text, batch), r_ref, REL_TOL,
               f"ragged ({e}, {d})")
    r_el = engine(r_ragged, capacity=4 + world, n_expert_shards=world,
                  n_data_shards=1, **r_kw)
    full = r_el.generate(0, r_text, batch)
    _close(full, r_ref, REL_TOL, "ragged elastic")
    r_el.evict_expert(2)
    evicted = r_el.generate(0, r_text, batch)
    _check(not torch.equal(evicted, full),
           "evicting a routed expert must change the ragged output")
    if rank == 0:
        from repro_torch.training.checkpoint import (expert_metadata,
                                                     save_checkpoint)

        save_checkpoint(
            os.path.join(out, "r_new.npz"),
            tree_map(lambda a: a.cpu(), _jittered(r_cfg, 77, "cpu")),
            metadata=expert_metadata(name="r_new", objective="fm",
                                     schedule="linear", cluster_id=2,
                                     arch="dit-reduced"))
    torch.distributed.barrier()
    r_el.add_expert(os.path.join(out, "r_new.npz"), slot=2)
    added = r_el.generate(0, r_text, batch)
    _check(not torch.equal(added, evicted),
           "hot-adding into a routed slot must change the ragged output")
    _check(bool(torch.isfinite(added).all()), "hot add: non-finite latents")

    # 10: continuous batching on both meshes, and rolling == lockstep
    reqs = _requests(text)
    for spt in (1, 2):
        want = rolling_run(base, reqs, spt=spt)
        for e, d in meshes:
            m_eng = engine(sampler, n_expert_shards=e, n_data_shards=d)
            got = rolling_run(m_eng, reqs, spt=spt)
            for i, (a, b) in enumerate(zip(got, want)):
                label = f"rolling spt {spt} ({e}, {d}) request {i}"
                if d == 1:
                    _same(a, b, label)
                else:
                    _close(a, b, REL_TOL, label)
                if spt == 1:
                    lock = m_eng.generate(reqs[i]["seed"], reqs[i]["text"],
                                          a.shape[0])
                    if toy:
                        _same(a, lock, f"{label} vs lockstep")
                    else:
                        _close(a, lock, REL_TOL, f"{label} vs lockstep")

    if toy:
        # 11: the resilient scheduler's journal, restored on every rank
        for e, d in meshes:
            journal = os.path.join(out, f"journal_{e}x{d}")
            got, twin = kill_and_restore(
                engine(sampler, n_expert_shards=e, n_data_shards=d), reqs,
                journal)
            _check(len(got) == len(reqs), f"restore ({e}, {d}): "
                   f"{len(got)} requests back of {len(reqs)}")
            for i, (a, b) in enumerate(zip(got, twin)):
                _same(a, b, f"restore ({e}, {d}) request {i}")

        # 12: the elastic rolling batch, before and after an eviction
        cap = len(experts) + world
        el_ref = engine(sampler, capacity=cap)
        el_want = [rolling_run(el_ref, reqs)]
        el_ref.evict_expert(3)
        el_want.append(rolling_run(el_ref, reqs))
        for e, d in meshes:
            el = engine(sampler, capacity=cap, n_expert_shards=e,
                        n_data_shards=d)
            runs = [rolling_run(el, reqs)]
            el.evict_expert(3)
            runs.append(rolling_run(el, reqs))
            for when, got, want in zip(("live", "evicted"), runs, el_want):
                for i, (a, b) in enumerate(zip(got, want)):
                    _close(a, b, REL_TOL,
                           f"elastic rolling {when} ({e}, {d}) request {i}")

    # 13: the reference engine on the expert split
    ref_base = engine(sampler, engine="reference").generate(0, text, batch)
    _same(engine(sampler, engine="reference", n_expert_shards=world,
                 n_data_shards=1).generate(0, text, batch), ref_base,
          f"reference engine ({world}, 1)")

    if rank == 0:
        with open(os.path.join(out, "verdict.json"), "w") as f:
            json.dump({
                "devices": world, "dit": bool(args["dit"]),
                "batch": batch, "steps": steps,
                "parity": "ok",
                "grouped_parity": "ok" if toy else "skipped",
                "quantized_parity": "ok" if toy else "skipped",
                "step_fusion_parity": "ok" if toy else "skipped",
                "elastic_masked_parity": "ok" if toy else "skipped",
                "ragged_parity": "ok",
                "coalesced_requests": esh.stats["batched_requests"],
                "merged_batches": esh.stats["merged_batches"],
                "rolling_parity": "ok",
                "resilient_restore_parity": "ok" if toy else "skipped",
                "elastic_rolling_parity": "ok" if toy else "skipped",
                "reference_engine_parity": "ok",
            }, f)


def _degenerate(args: dict) -> None:
    """Item 1, in this process: the ``(1, 1)`` mesh bitwise unsharded."""
    import torch.distributed as dist

    dev = torch.device(args["device"])
    experts, params, router_fn, latent = toy_ensemble(4, dev)
    text = _text(args["batch"], 5, 6)
    sampler = SamplerConfig(num_steps=args["steps"], cfg_scale=3.0,
                            strategy="topk", top_k=2)
    started = not dist.is_initialized()
    try:
        outs = [ServingEngine(
            experts=experts, expert_params=params, router_fn=router_fn,
            latent_shape=latent, sampler=sampler, device=dev, **kw
        ).generate(0, text, args["batch"])
            for kw in ({}, dict(n_expert_shards=1, n_data_shards=1))]
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    _check(torch.equal(outs[0], outs[1]),
           "the (1, 1) mesh must be bitwise the unsharded engine")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sharded_parity")
    ap.add_argument("--world", type=int, default=2,
                    help="ranks to spawn (>= 2)")
    ap.add_argument("--device", default=None,
                    help="torch device of every rank (default: the GPU)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the ranks' backend (default: nccl on the GPU, "
                         "gloo on the CPU; ranks sharing a card need gloo)")
    ap.add_argument("--dit", action="store_true",
                    help="reduced DiT experts instead of the toy ensemble")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    a = ap.parse_args(argv)
    if a.world < 2:
        raise ValueError(f"--world must be >= 2, got {a.world}")
    from repro_torch.weights import resolve_device

    dev = resolve_device(a.device)
    backend = a.backend or {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    args = dict(device=dev.type, dit=a.dit, batch=a.batch, steps=a.steps)
    _degenerate(args)
    with tempfile.TemporaryDirectory(prefix="sharded_parity_") as out:
        spawn(_parity_rank, a.world, args, out, backend=backend,
              device=dev.type)
        with open(os.path.join(out, "verdict.json")) as f:
            verdict = json.load(f)
    print(json.dumps(verdict))
    return verdict


# --- the tests' rank function ------------------------------------------------


def _toy_from_dir(ckpt_dir: str, k: int):
    """The toy ensemble's specs and router over parameters saved in
    ``expert<i>.npz`` (loaded on the host)."""
    from repro_torch.training.checkpoint import load_checkpoint

    experts, _, router_fn, latent = toy_ensemble(k)
    params = [load_checkpoint(os.path.join(ckpt_dir, f"expert{i}.npz"),
                              device="cpu")[0] for i in range(k)]
    return experts, params, router_fn, latent


def serve_checkpoints_rank(rank: int, world: int, jobs: list) -> None:
    """For each job, serve ``job["ckpt_dir"]`` on each mesh of
    ``job["meshes"]`` and write ``<out>/<label>_<e>x<d>_rank<r>.npz``: the
    latents (``out``), this rank's ``padded_model_rows`` (the rows its
    expert forwards ran: ragged pairs times guidance replicas) and its
    store's resident bytes.

    A job: ``kind`` (``"toy"``: the toy ensemble over saved parameters;
    ``"dit"``: ``from_checkpoint_dir`` of the reduced DiT config), ``k``,
    ``noise`` and ``text`` (``.npy`` paths; ``text`` may be None),
    ``sampler`` (``SamplerConfig`` fields), ``label``, ``out``,
    ``device``."""
    torch.set_num_threads(1)
    for job in jobs:
        _serve_job(rank, job)


def _job_engine(job: dict, e: int, d: int, **kw) -> ServingEngine:
    """The job's engine on the ``(e, d)`` mesh (``kw``: more engine
    fields)."""
    dev = torch.device(job["device"])
    sampler = SamplerConfig(**job["sampler"])
    kw = dict(n_expert_shards=e, n_data_shards=d, track_padding=True, **kw)
    if job["kind"] == "toy":
        experts, params, router_fn, latent = _toy_from_dir(
            job["ckpt_dir"], job["k"])
        return ServingEngine(experts=experts, expert_params=params,
                             router_fn=router_fn, latent_shape=latent,
                             sampler=sampler, device=dev, **kw)
    cfg = dit_b2().reduced(latent_size=8)
    eng = ServingEngine.from_checkpoint_dir(
        job["ckpt_dir"], dit_cfg=cfg,
        router_cfg=router_b2(num_clusters=job["k"]).reduced(latent_size=8),
        sampler=sampler, device=dev, **kw)
    if eng.experts[0].ragged_apply_fn is not None:
        eng.experts = _guard_pairs(eng.experts)
    return eng


def _serve_job(rank: int, job: dict) -> None:
    noise = np.load(job["noise"])
    text = np.load(job["text"]) if job.get("text") else None
    for e, d in job["meshes"]:
        eng = _job_engine(job, e, d)
        out = eng.generate(0, text, noise.shape[0], noise=noise)
        np.savez(os.path.join(job["out"],
                              f"{job['label']}_{e}x{d}_rank{rank}.npz"),
                 out=out.cpu().numpy(),
                 rows=eng.stats["padded_model_rows"],
                 nbytes=eng.param_store.nbytes())


def job_requests(job: dict) -> list:
    """A rolling job's requests, seeds 0, 1, …: the ``noise_<i>`` and
    ``text_<i>`` arrays of the ``job["requests"]`` ``.npz``."""
    with np.load(job["requests"]) as z:
        n = sum(name.startswith("noise_") for name in z.files)
        return [dict(seed=i, text=z[f"text_{i}"], noise=z[f"noise_{i}"])
                for i in range(n)]


def _chaos_run(job: dict, e: int, d: int, rank: int, fault: str) -> dict:
    """The job's requests through a ``launch.chaos.ChaosScheduler`` whose
    fault fires on one rank only: ``"crash"`` — rank 0's tick 2 raises
    (one re-queue allowed); ``"stall"`` — rank 1's tick 3 burns twice the
    tick budget of its fake clock (no re-queue allowed, so FAILED).  The
    other ranks run a plain ``ResilientScheduler``.  Returns each
    request's state, re-queues and latents (zeros where not DONE) and the
    engine's counters."""
    from repro_torch.launch.chaos import ChaosScheduler, FakeClock
    from repro_torch.serving import ResiliencePolicy, ResilientScheduler

    crash = fault == "crash"
    eng = _job_engine(job, e, d, max_request_requeues=1 if crash else 0)
    fires = rank == (0 if crash else 1)
    kw = dict(max_resident=4, clock=FakeClock(),
              policy=ResiliencePolicy(tick_budget_s=0.25))
    if fires:
        sched = ChaosScheduler(eng, fail_ticks=(2,) if crash else (),
                               slow_ticks=() if crash else (3,), **kw)
    else:
        sched = ResilientScheduler(eng, **kw)
    handles = []
    for r in job_requests(job):
        handles.append(sched.submit(r["seed"], r["text"], noise=r["noise"]))
        sched.step()
    sched.run_until_idle()
    return dict(
        states=[h.state for h in handles],
        requeues=[h.requeues for h in handles],
        out=[h.result().cpu().numpy() if h.state == "DONE"
             else np.zeros((0,)) for h in handles],
        stats={k: eng.stats[k] for k in ("request_requeues",
                                         "failed_requests",
                                         "scheduler_steps")},
        ticks=sched.step_count)


def serve_rolling_rank(rank: int, world: int, jobs: list) -> None:
    """For each job, serve its requests (``job_requests``) through the
    rolling schedulers on each mesh of ``job["meshes"]`` and write
    ``<out>/<label>_<e>x<d>_rank<r>.npz`` (request ``i``'s latents under
    ``<run>_<i>``) and ``….json`` (the chaos runs' records, this rank's
    host agreements).  ``job["runs"]`` picks the runs:

    * ``rolling``: ``steps_per_tick`` 1 (also this rank's
      ``padded_model_rows``, ``rows``) and 2;
    * ``lockstep``: the same mesh's ``generate`` of each request;
    * ``restore``: ``kill_and_restore`` (``restore_<i>``, ``twin_<i>``);
    * ``elastic``: the rolling batch at ``capacity=K+2``, then with slot
      3 evicted (``elastic_live_<i>``, ``elastic_evicted_<i>``);
    * ``reference``: the reference engine's ``generate`` of the whole
      batch (``reference``; on ``(E, 1)`` meshes only), and for the toy
      ensemble ``time_map='snr_match'``'s (``snr_match``);
    * ``chaos``: ``_chaos_run`` for ``crash`` and ``stall``.

    Otherwise a job is ``serve_checkpoints_rank``'s (whose ``noise`` and
    ``text`` the reference run serves), plus ``requests``."""
    torch.set_num_threads(1)
    for job in jobs:
        reqs = job_requests(job)
        runs = job["runs"]
        for e, d in job["meshes"]:
            arrays, record = {}, {}

            def put(name, outs):
                for i, o in enumerate(outs):
                    arrays[f"{name}_{i}"] = o.cpu().numpy()

            eng = _job_engine(job, e, d)
            if "rolling" in runs:
                put("rolling_spt1", rolling_run(eng, reqs))
                arrays["rows"] = np.int64(eng.stats["padded_model_rows"])
                put("rolling_spt2", rolling_run(eng, reqs, spt=2))
            if "lockstep" in runs:
                put("lockstep", [eng.generate(r["seed"], r["text"],
                                              r["text"].shape[0],
                                              noise=r["noise"])
                                 for r in reqs])
            if "restore" in runs:
                got, twin = kill_and_restore(
                    eng, reqs, os.path.join(job["out"],
                                            f"journal_{job['label']}_{e}x"
                                            f"{d}"))
                put("restore", got)
                put("twin", twin)
            if "elastic" in runs:
                el = _job_engine(job, e, d, capacity=job["k"] + 2)
                put("elastic_live", rolling_run(el, reqs))
                el.evict_expert(3)
                put("elastic_evicted", rolling_run(el, reqs))
            if "reference" in runs and d == 1:
                noise, text = np.load(job["noise"]), np.load(job["text"])
                ref = _job_engine(job, e, d, engine="reference")
                arrays["reference"] = ref.generate(
                    0, text, noise.shape[0], noise=noise).cpu().numpy()
                if job["kind"] == "toy":      # snr_match resolves to it
                    snr = _job_engine(dict(job, sampler=dict(
                        job["sampler"], time_map="snr_match")), e, d)
                    arrays["snr_match"] = snr.generate(
                        0, text, noise.shape[0], noise=noise).cpu().numpy()
            if "chaos" in runs:
                for fault in ("crash", "stall"):
                    rec = _chaos_run(job, e, d, rank, fault)
                    for i, o in enumerate(rec.pop("out")):
                        arrays[f"chaos_{fault}_{i}"] = o
                    record[fault] = rec
            record["agreements"] = eng.mesh.counts
            stem = os.path.join(job["out"],
                                f"{job['label']}_{e}x{d}_rank{rank}")
            np.savez(stem + ".npz", **arrays)
            with open(stem + ".json", "w") as f:
                json.dump(record, f)


def cli_rank(rank: int, world: int, runs: list, out: str) -> None:
    """The serving CLI (``launch.serve.main``) on this rank for each
    ``(name, argv)`` of ``runs``, its standard output written to
    ``<out>/<name>_rank<r>.txt``."""
    import contextlib

    from repro_torch.launch import serve

    torch.set_num_threads(1)
    for name, argv in runs:
        with open(os.path.join(out, f"{name}_rank{rank}.txt"), "w") as f, \
                contextlib.redirect_stdout(f):
            serve.main(argv)


def faults_rank(rank: int, world: int, argv: list, out: str) -> None:
    """``launch.faults.main(argv)`` on this rank; rank 0 writes the
    verdict to ``out`` as JSON."""
    from repro_torch.launch import faults

    torch.set_num_threads(1)
    verdict = faults.main(argv)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(verdict, f)


if __name__ == "__main__":
    main()
