"""Continuous batching, the resilient scheduler and the reference engine on
the port's ``("expert", "data")`` mesh, on gloo CPU ranks.

One spawn of two ranks (``launch.sharded_parity.serve_rolling_rank``)
serves, on ``(2, 1)`` and ``(1, 2)``, the eight jittered reduced DiT
experts and router written by the JAX package's ``save_checkpoint`` (2
DDPM + 6 FM, top-2, CFG 7.5, 4 steps; the ragged executor) and the
reference's closed-form toy ensemble (4 experts, top-2, CFG 3; the grouped
executor).  Three requests (batch 1, 2, 1; JAX-drawn noise, seeded numpy
text) arrive one a tick into a rolling batch of 4.  A second spawn runs
the toy ensemble on four ranks, ``(2, 2)``; a third the serving CLI's
``--continuous`` modes on two.

Tolerances, as ``test_torch_sharded.py`` holds the coalesced engine:

* ``(E, 1)`` against the port's unsharded run: bitwise (every rank runs
  the whole batch and an exact "expert" sum joins the slots);
* ``(1, D)`` and ``(2, 2)``: ``MESH_REL = 1e-5 · max |latent|`` (a rank's
  forwards run a part of the batch, which may sum in another order);
* the rolling run against the same mesh's ``generate`` (the reference's
  rolling == lockstep property): bitwise on the toy ensemble, whose ops
  are row-independent; within ``SLICE_REL`` on the DiT ensemble, whose
  router GEMMs sum by the batch's row count, as unsharded
  (``test_torch_continuous.py``);
* against the JAX package's unsharded ``generate`` and reference engine:
  ``SLICE_REL = 1e-4 · max |latent|`` (the reference's sharded engine
  cannot run on this jax, ``test_torch_sharded.py``);
* the ranks' ragged forwards' rows sum to the unsharded run's, exactly.

Every rank returns whole requests, bitwise equal across ranks.  A fault
fired on one rank only — an injected crash, or a stall past the tick
budget — ends the same way on every rank.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest

from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.launch.sharded_parity import toy_ensemble as jtoy_ensemble
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro_torch.launch.mesh import spawn
from repro_torch.launch.sharded_parity import (_job_engine, cli_rank,
                                               job_requests,
                                               kill_and_restore,
                                               rolling_run,
                                               serve_rolling_rank)
from repro_torch.models.config import dit_b2, router_b2
from test_torch_serve import (  # noqa: F401  (one_torch_thread: a fixture)
    SLICE_REL, _write_ensemble, one_torch_thread)
from test_torch_sharded import MESH_REL, SAMPLERS, _write_toy

SIZES = (1, 2, 1)
MESHES = [(2, 1), (1, 2)]
LATENT = {"dit": (8, 8, 4), "toy": (4, 4, 2)}
TEXT = {"dit": None, "toy": (5, 6)}
RUNS = {"toy": ["rolling", "lockstep", "restore", "elastic", "reference",
                "chaos"],
        "dit": ["rolling", "lockstep", "reference"]}


def _jax_engine(kind, ckpt_dir, **kw):
    sampler = JSamplerConfig(**SAMPLERS[kind])
    if kind == "toy":
        experts, params, router, latent = jtoy_ensemble(4)
        return JServingEngine(experts=experts, expert_params=params,
                              router_fn=router, latent_shape=latent,
                              sampler=sampler, **kw)
    return JServingEngine.from_checkpoint_dir(
        ckpt_dir, dit_cfg=j_dit_b2().reduced(latent_size=8),
        router_cfg=j_router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=sampler, **kw)


def _load(out, label, mesh, world=2):
    e, d = mesh
    ranks = []
    for r in range(world):
        stem = os.path.join(out, f"{label}_{e}x{d}_rank{r}")
        with np.load(stem + ".npz") as z:
            arrays = dict(z)
        with open(stem + ".json") as f:
            arrays["record"] = json.load(f)
        ranks.append(arrays)
    return ranks


@pytest.fixture(scope="module")
def rolled(tmp_path_factory):
    """The jobs, the two-rank spawn's outputs, the port's unsharded runs
    of the same requests and the JAX package's."""
    root = tmp_path_factory.mktemp("mesh_rolling")
    out = str(root / "out")
    os.makedirs(out)
    cfg = dit_b2().reduced(latent_size=8)
    dirs = {"dit": str(root / "dit"), "toy": str(root / "toy")}
    for d in dirs.values():
        os.makedirs(d)
    _write_ensemble(dirs["dit"], cfg, router_b2(num_clusters=8).reduced(
        latent_size=8))
    _write_toy(dirs["toy"])
    rng = np.random.default_rng(6)
    jobs, keys = {}, {}
    for kind in ("dit", "toy"):
        tail = TEXT[kind] or (cfg.text_len, cfg.text_dim)
        text = rng.standard_normal((sum(SIZES),) + tail).astype(np.float32)
        keys[kind] = [jax.random.PRNGKey(30 + i) for i in range(len(SIZES))]
        arrays, lo = {}, 0
        for i, b in enumerate(SIZES):
            arrays[f"noise_{i}"] = np.asarray(jax.random.normal(
                keys[kind][i], (b,) + LATENT[kind]))
            arrays[f"text_{i}"] = text[lo:lo + b]
            lo += b
        np.savez(os.path.join(out, f"{kind}_requests.npz"), **arrays)
        ref_key = jax.random.PRNGKey(40)
        np.save(os.path.join(out, f"{kind}_noise.npy"), np.asarray(
            jax.random.normal(ref_key, (sum(SIZES),) + LATENT[kind])))
        np.save(os.path.join(out, f"{kind}_text.npy"), text)
        keys[kind, "ref"] = ref_key
        jobs[kind] = dict(
            kind=kind, label=kind, ckpt_dir=dirs[kind], k=8 if kind == "dit"
            else 4, meshes=MESHES, sampler=SAMPLERS[kind], out=out,
            device="cpu", runs=RUNS[kind],
            requests=os.path.join(out, f"{kind}_requests.npz"),
            noise=os.path.join(out, f"{kind}_noise.npy"),
            text=os.path.join(out, f"{kind}_text.npy"))
    spawn(serve_rolling_rank, 2, list(jobs.values()))

    port, want = {}, {}
    for kind, job in jobs.items():
        reqs = job_requests(job)
        eng = _job_engine(job, 1, None)
        runs = dict(rolling_spt1=rolling_run(eng, reqs),
                    rows=eng.stats["padded_model_rows"],
                    rolling_spt2=rolling_run(eng, reqs, spt=2))
        runs["reference"] = _job_engine(job, 1, None, engine="reference") \
            .generate(0, np.load(job["text"]), sum(SIZES),
                      noise=np.load(job["noise"]))
        if kind == "toy":
            el = _job_engine(job, 1, None, capacity=6)
            runs["elastic_live"] = rolling_run(el, reqs)
            el.evict_expert(3)
            runs["elastic_evicted"] = rolling_run(el, reqs)
            runs["restore"], runs["twin"] = kill_and_restore(
                _job_engine(job, 1, None), reqs,
                str(root / "journal_unsharded"))
        port[kind] = runs
        jeng = _jax_engine(kind, dirs[kind])
        want[kind] = [np.asarray(jeng.generate(k, r["text"], len(r["text"])))
                      for k, r in zip(keys[kind], reqs)]
        want[kind, "reference"] = np.asarray(
            _jax_engine(kind, dirs[kind], engine="reference").generate(
                keys[kind, "ref"], np.load(job["text"]), sum(SIZES)))
    return dict(jobs=jobs, out=out, port=port, want=want)


def _close(got, want, rel, label):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    assert np.isfinite(got).all(), label
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * float(np.max(np.abs(want))), (label, err)


def _held(got, want, mesh, label):
    """Bitwise on ``(E, 1)``, within ``MESH_REL`` where "data" splits."""
    if mesh[1] == 1:
        assert np.array_equal(np.asarray(got), np.asarray(want)), label
    else:
        _close(got, want, MESH_REL, label)


def _same_on_every_rank(ranks, name):
    for r in ranks[1:]:
        assert np.array_equal(r[name], ranks[0][name]), name


@pytest.mark.parametrize("spt", [1, 2])
@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "1x2"])
@pytest.mark.parametrize("kind", ["dit", "toy"])
def test_rolling_matches_the_unsharded_rolling_run(rolled, kind, mesh, spt):
    """Staggered requests through ``ContinuousScheduler`` on the mesh,
    each rank's whole requests against the port's unsharded rolling run,
    and against the JAX package's unsharded ``generate``."""
    ranks = _load(rolled["out"], kind, mesh)
    for i in range(len(SIZES)):
        name = f"rolling_spt{spt}_{i}"
        _same_on_every_rank(ranks, name)
        for r in ranks:
            _held(r[name], rolled["port"][kind][f"rolling_spt{spt}"][i]
                  .numpy(), mesh, f"{kind} {mesh} {name}")
            _close(r[name], rolled["want"][kind][i], SLICE_REL,
                   f"{kind} {mesh} {name} vs jax")


@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "1x2"])
@pytest.mark.parametrize("kind", ["dit", "toy"])
def test_rolling_equals_lockstep_on_the_mesh(rolled, kind, mesh):
    """Each request of the rolling run against the same mesh's
    ``generate`` of it: bitwise on the row-independent toy ensemble."""
    for r in _load(rolled["out"], kind, mesh):
        for i in range(len(SIZES)):
            got, lock = r[f"rolling_spt1_{i}"], r[f"lockstep_{i}"]
            if kind == "toy":
                assert np.array_equal(got, lock), (mesh, i)
            else:
                _close(got, lock, SLICE_REL, f"dit {mesh} {i}")


@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "1x2"])
def test_ranks_split_the_ragged_rows(rolled, mesh):
    """The rows the ranks' ragged forwards ran (pairs times guidance
    replicas) sum to the unsharded rolling run's, exactly; each rank ran
    fewer."""
    rows = [int(r["rows"]) for r in _load(rolled["out"], "dit", mesh)]
    whole = rolled["port"]["dit"]["rows"]
    assert sum(rows) == whole
    assert all(0 < n < whole for n in rows)


@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "1x2"])
def test_resilient_journal_restores_on_every_rank(rolled, mesh):
    """A journaled ``ResilientScheduler`` (rank 0 writes the journal),
    abandoned after 2 ticks and rebuilt on every rank by
    ``ServingEngine.restore``: bitwise an uninterrupted twin's, and the
    unsharded restore's as the rolling runs are."""
    ranks = _load(rolled["out"], "toy", mesh)
    for i in range(len(SIZES)):
        _same_on_every_rank(ranks, f"restore_{i}")
        for r in ranks:
            assert np.array_equal(r[f"restore_{i}"], r[f"twin_{i}"]), i
            _held(r[f"restore_{i}"], rolled["port"]["toy"]["restore"][i]
                  .numpy(), mesh, f"restore {mesh} {i}")
    journal = os.path.join(rolled["out"],
                           f"journal_toy_{mesh[0]}x{mesh[1]}")
    with open(os.path.join(journal, "journal.jsonl")) as f:
        events = [json.loads(line)["ev"] for line in f]
    assert events.count("open") == 2 and "restored" in events


@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "1x2"])
def test_elastic_rolling_batch_on_the_mesh(rolled, mesh):
    """``capacity=K+2``: the masked slots serve nothing; evicting a
    routed expert changes the requests as it does unsharded."""
    ranks = _load(rolled["out"], "toy", mesh)
    for when in ("live", "evicted"):
        for i in range(len(SIZES)):
            name = f"elastic_{when}_{i}"
            _same_on_every_rank(ranks, name)
            _held(ranks[0][name],
                  rolled["port"]["toy"][f"elastic_{when}"][i].numpy(),
                  mesh, name)
    assert not np.array_equal(ranks[0]["elastic_live_1"],
                              ranks[0]["elastic_evicted_1"])


@pytest.mark.parametrize("kind", ["dit", "toy"])
def test_reference_engine_on_the_expert_split(rolled, kind):
    """``engine='reference'`` on ``(2, 1)``: each rank runs its resident
    experts, one all-gather stacks the velocities; bitwise the port's
    unsharded reference engine, within ``SLICE_REL`` of the JAX one."""
    ranks = _load(rolled["out"], kind, (2, 1))
    _same_on_every_rank(ranks, "reference")
    got = ranks[0]["reference"]
    assert np.array_equal(got, rolled["port"][kind]["reference"].numpy())
    _close(got, rolled["want"][kind, "reference"], SLICE_REL, kind)


@pytest.mark.parametrize("fault", ["crash", "stall"])
@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "1x2"])
def test_a_fault_on_one_rank_ends_alike_on_every_rank(rolled, mesh, fault):
    """A crash injected into rank 0's tick 2 (one re-queue allowed), or a
    stall past the tick budget on rank 1's tick 3 (none allowed): every
    rank fails or re-queues the same requests, keeps the same counters,
    and serves what it serves bitwise as the fault-free run."""
    ranks = _load(rolled["out"], "toy", mesh)
    recs = [r["record"][fault] for r in ranks]
    assert all(rec == recs[0] for rec in recs[1:]), recs
    states, requeues = recs[0]["states"], recs[0]["requeues"]
    if fault == "crash":
        assert states == ["DONE"] * len(SIZES)
        assert recs[0]["stats"]["request_requeues"] >= 1
        assert max(requeues) == 1
    else:
        assert "FAILED" in states
        assert recs[0]["stats"]["failed_requests"] == states.count("FAILED")
    for i, state in enumerate(states):
        name = f"chaos_{fault}_{i}"
        _same_on_every_rank(ranks, name)
        if state == "DONE":
            _held(ranks[0][name],
                  rolled["port"]["toy"]["rolling_spt1"][i].numpy(), mesh,
                  name)


def test_four_ranks_roll_on_a_2x2_mesh(rolled, tmp_path):
    """The toy ensemble's rolling run on four ranks, ``(2, 2)``: each rank
    holds two experts and two of the four rows."""
    job = dict(rolled["jobs"]["toy"], meshes=[(2, 2)], runs=["rolling"],
               out=str(tmp_path))
    spawn(serve_rolling_rank, 4, [job])
    ranks = _load(str(tmp_path), "toy", (2, 2), world=4)
    for spt in (1, 2):
        for i in range(len(SIZES)):
            name = f"rolling_spt{spt}_{i}"
            _same_on_every_rank(ranks, name)
            _close(ranks[0][name],
                   rolled["port"]["toy"][f"rolling_spt{spt}"][i].numpy(),
                   MESH_REL, name)


def test_snr_match_resolves_to_the_reference_engine_on_the_split(rolled):
    """``time_map='snr_match'`` (the reference engine) on ``(2, 1)``:
    bitwise the port's unsharded engine, within ``SLICE_REL`` of the
    JAX one."""
    job = rolled["jobs"]["toy"]
    snr = dict(job, sampler=dict(job["sampler"], time_map="snr_match"))
    want = _job_engine(snr, 1, None).generate(
        0, np.load(job["text"]), sum(SIZES), noise=np.load(job["noise"]))
    ranks = _load(rolled["out"], "toy", (2, 1))
    _same_on_every_rank(ranks, "snr_match")
    assert np.array_equal(ranks[0]["snr_match"], want.numpy())
    jeng = _jax_engine("toy", None)
    jeng.sampler = JSamplerConfig(**snr["sampler"])
    _close(ranks[0]["snr_match"], np.asarray(jeng.generate(
        jax.random.PRNGKey(40), np.load(job["text"]), sum(SIZES))),
        SLICE_REL, "snr_match vs jax")


CLI_RUNS = {
    "expert_continuous": ["--expert-shards", "2", "--continuous",
                          "--deadline-s", "1000", "--tick-budget", "1000"],
    "data_continuous": ["--data-shards", "2", "--continuous",
                        "--max-resident", "4"],
    "expert_reference": ["--expert-shards", "2", "--engine", "reference",
                         "--batch", "2"],
}


def test_serve_cli_modes_on_two_ranks(rolled, tmp_path):
    """``python -m repro_torch.launch.serve`` under two ranks (what
    ``torchrun --nproc-per-node 2`` runs): ``--continuous`` with
    ``--expert-shards`` (journal, deadline, tick budget) and with
    ``--data-shards``, and ``--engine reference --expert-shards 2``.
    Rank 0 prints the reference's lines, the other rank nothing; only
    rank 0 writes the journal."""
    journal = str(tmp_path / "journal")
    base = ["--ckpt-dir", rolled["jobs"]["dit"]["ckpt_dir"], "--device",
            "cpu", "--steps", "2", "--requests", "2", "--batch", "1",
            "--arrival-every", "1"]
    runs = [(name, base + argv + (["--journal-dir", journal]
                                  if name == "expert_continuous" else []))
            for name, argv in CLI_RUNS.items()]
    spawn(cli_rank, 2, runs, str(tmp_path))
    for name in CLI_RUNS:
        with open(tmp_path / f"{name}_rank0.txt") as f:
            lines = f.read().splitlines()
        with open(tmp_path / f"{name}_rank1.txt") as f:
            assert f.read() == "", name
        mesh = "{'expert': 1, 'data': 2}" if name.startswith("data") \
            else "{'expert': 2, 'data': 1}"
        assert lines[0].endswith(f"mesh={mesh}"), lines
        if "continuous" in name:
            assert lines[1].startswith("continuous 2 requests in "), lines
            assert lines[2].startswith("scheduler: "), lines
        else:
            assert all(ln.endswith("finite=True")
                       for ln in lines[1:3]), lines
    with open(os.path.join(journal, "journal.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [e["ev"] for e in events].count("open") == 1
    assert sum(e["ev"] == "resolve" for e in events) == 2
