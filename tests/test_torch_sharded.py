"""The port's sharded serving engine on several CPU ranks, against the JAX
package's unsharded engine.

Each multi-rank test spawns gloo ranks (``repro_torch.launch.mesh.spawn``:
one process per rank, a ``FileStore`` in a temporary directory).  The
ensembles are written by the JAX package's ``save_checkpoint``: the eight
jittered reduced DiT experts and router of ``test_torch_serve.py`` (2
DDPM + 6 FM, top-2, CFG 7.5, 4 steps; the ragged executor) and the
reference's closed-form toy ensemble (4 experts, top-2, CFG 3; the grouped
executor).  Every rank gets the exact noise the JAX engine draws and the
same seeded numpy text.

Tolerances: against the JAX package's unsharded ``generate``, ``max |Δ| ≤
1e-4 · max |latent|`` (as ``test_torch_serve.py`` holds the unsharded
port: float32 GEMMs summed in another order than XLA, amplified by CFG);
against the port's own unsharded engine ``1e-5 · max |latent|`` (the
reference's sharded parity tolerance: a rank's forwards run a part of the
batch, which may sum in another order).  Every rank returns the whole
batch, and the ranks' latents are bitwise equal.

The JAX package's sharded engine is not used: on this jax its
``with_sharding_constraint`` refuses the ``Explicit`` mesh axes that
``jax.make_mesh`` builds, so its mesh tests fail here (ROADMAP.md A.8).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.launch.sharded_parity import toy_ensemble as jtoy_ensemble
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro.training import checkpoint as jckpt
from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch.faults import toy_ensemble
from repro_torch.launch.mesh import spawn
from repro_torch.launch.serve import ServingEngine
from repro_torch.launch.sharded_parity import (faults_rank,
                                               serve_checkpoints_rank)
from repro_torch.models.config import dit_b2, router_b2
from test_torch_serve import (  # noqa: F401  (one_torch_thread: a fixture)
    SLICE_REL, _write_ensemble, one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_REL = 1e-5
BATCH = 4
MESHES = [(2, 1), (1, 2)]
#: the sampler of each ensemble (toy: the reference parity script's)
SAMPLERS = {
    "dit": dict(num_steps=4, cfg_scale=7.5, top_k=2),
    "toy": dict(num_steps=4, cfg_scale=3.0, strategy="topk", top_k=2),
    "threshold": dict(num_steps=4, cfg_scale=7.5, strategy="threshold"),
}
#: the keys of the reference's ``launch/faults.py`` verdict
FAULTS_KEYS = ["devices", "assembly_quarantine", "inflight_snapshot",
               "retire_drain", "add_expert_quarantine", "flush_isolation",
               "membership"]


def _jax_dit_engine(path, sampler):
    return JServingEngine.from_checkpoint_dir(
        path, dit_cfg=j_dit_b2().reduced(latent_size=8),
        router_cfg=j_router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=JSamplerConfig(**sampler))


def _port_dit_engine(path, sampler, **kw):
    return ServingEngine.from_checkpoint_dir(
        path, dit_cfg=dit_b2().reduced(latent_size=8),
        router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=SamplerConfig(**sampler), device="cpu", track_padding=True,
        **kw)


def _write_toy(path):
    """The reference's toy parameters through its ``save_checkpoint``."""
    experts, params, _, _ = jtoy_ensemble(4)
    for i, (e, p) in enumerate(zip(experts, params)):
        jckpt.save_checkpoint(
            os.path.join(path, f"expert{i}.npz"),
            jax.tree.map(np.asarray, p),
            metadata=jckpt.expert_metadata(
                name=e.name, objective=e.objective, schedule=e.schedule,
                cluster_id=i, arch="toy"))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every ensemble served by the JAX engine, the port's unsharded engine
    and, in one spawn of two ranks, the port's engine on each mesh."""
    root = tmp_path_factory.mktemp("sharded")
    dit_dir, toy_dir, out = (str(root / n) for n in ("dit", "toy", "out"))
    for d in (dit_dir, toy_dir, out):
        os.makedirs(d)
    cfg = dit_b2().reduced(latent_size=8)
    _write_ensemble(dit_dir, cfg, router_b2(num_clusters=8).reduced(
        latent_size=8))
    _write_toy(toy_dir)
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(5)
    inputs = {
        "dit": (np.asarray(jax.random.normal(key, (BATCH, 8, 8, 4),
                                             dtype=jnp.float32)),
                rng.standard_normal((BATCH, cfg.text_len, cfg.text_dim))
                .astype(np.float32)),
        "toy": (np.asarray(jax.random.normal(key, (BATCH, 4, 4, 2),
                                             dtype=jnp.float32)),
                rng.standard_normal((BATCH, 5, 6)).astype(np.float32)),
    }
    inputs["threshold"] = inputs["dit"]
    jexperts, jparams, jrouter, jlatent = jtoy_ensemble(4)
    want, port = {}, {}
    for label, sampler in SAMPLERS.items():
        noise, text = inputs[label]
        if label == "toy":
            jeng = JServingEngine(
                experts=jexperts, expert_params=jparams, router_fn=jrouter,
                latent_shape=jlatent, sampler=JSamplerConfig(**sampler))
            experts, params, router_fn, latent = toy_ensemble(4, "cpu")
            peng = ServingEngine(
                experts=experts, expert_params=params, router_fn=router_fn,
                latent_shape=latent, sampler=SamplerConfig(**sampler),
                device="cpu", track_padding=True)
        else:
            jeng = _jax_dit_engine(dit_dir, sampler)
            peng = _port_dit_engine(dit_dir, sampler)
        want[label] = np.asarray(jeng.generate(key, text, BATCH))
        got = peng.generate(0, text, BATCH, noise=noise).numpy()
        port[label] = dict(out=got, rows=peng.stats["padded_model_rows"],
                           nbytes=peng.param_store.nbytes())
        np.save(os.path.join(out, f"{label}_noise.npy"), noise)
        np.save(os.path.join(out, f"{label}_text.npy"), text)
    jobs = [dict(kind="toy" if label == "toy" else "dit", label=label,
                 ckpt_dir=toy_dir if label == "toy" else dit_dir,
                 k=4 if label == "toy" else 8,
                 meshes=[(1, 2)] if label == "threshold" else MESHES,
                 noise=os.path.join(out, f"{label}_noise.npy"),
                 text=os.path.join(out, f"{label}_text.npy"),
                 sampler=sampler, out=out, device="cpu")
            for label, sampler in SAMPLERS.items()]
    spawn(serve_checkpoints_rank, 2, jobs)
    ranks = {}
    for label, job in zip(SAMPLERS, jobs):
        for e, d in job["meshes"]:
            ranks[label, (e, d)] = [
                dict(np.load(os.path.join(out, f"{label}_{e}x{d}_rank{r}"
                                               f".npz")))
                for r in range(2)]
    return dict(want=want, port=port, ranks=ranks, out=out, toy_dir=toy_dir)


def _assert_close(got, want, rel, label):
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert np.isfinite(got).all(), label
    assert err <= rel * scale, (label, err, scale)


@pytest.mark.parametrize("label,mesh", [
    ("dit", (2, 1)), ("dit", (1, 2)), ("toy", (2, 1)), ("toy", (1, 2)),
    ("threshold", (1, 2))],
    ids=["dit-2x1", "dit-1x2", "toy-2x1", "toy-1x2", "threshold-1x2"])
def test_sharded_engine_matches_jax_engine(served, label, mesh):
    """Each rank's whole batch against the JAX package's unsharded engine
    and the port's unsharded engine; the ranks agree bitwise.  The
    threshold router's plan is batch-uniform and reads only the step's
    time, so a "data" split routes every slice as the whole batch."""
    ranks = served["ranks"][label, mesh]
    for r in ranks:
        assert r["out"].shape == served["want"][label].shape
        _assert_close(r["out"], served["want"][label], SLICE_REL,
                      f"{label} {mesh} vs jax")
        _assert_close(r["out"], served["port"][label]["out"], MESH_REL,
                      f"{label} {mesh} vs port")
    assert np.array_equal(ranks[0]["out"], ranks[1]["out"])


@pytest.mark.parametrize("label,mesh", [
    ("dit", (2, 1)), ("dit", (1, 2)), ("toy", (2, 1)), ("toy", (1, 2))],
    ids=["dit-2x1", "dit-1x2", "toy-2x1", "toy-1x2"])
def test_ranks_split_the_work(served, label, mesh):
    """On ``(2, 1)`` each rank's store holds half the whole's bytes (the
    other experts never reach it); on ``(1, 2)`` the whole.  Under the
    ragged executor the routed pairs the ranks' forwards run sum to the
    unsharded engine's (``padded_model_rows``: pairs times guidance
    replicas, each pair on exactly one rank)."""
    ranks = served["ranks"][label, mesh]
    whole = served["port"][label]["nbytes"]
    for r in ranks:
        assert int(r["nbytes"]) * mesh[0] == whole
    if label == "dit":
        assert sum(int(r["rows"]) for r in ranks) == \
            served["port"][label]["rows"]
        assert all(int(r["rows"]) < served["port"][label]["rows"]
                   for r in ranks)


def test_parity_script_on_two_ranks():
    """``python -m repro_torch.launch.sharded_parity --world 2 --device
    cpu``: the reference's keys and items 10–13's (the rolling
    schedulers and the reference engine on the mesh), every one "ok"."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sharded_parity",
         "--world", "2", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict["devices"] == 2
    for key in ("parity", "grouped_parity", "quantized_parity",
                "step_fusion_parity", "elastic_masked_parity",
                "ragged_parity", "rolling_parity",
                "resilient_restore_parity", "elastic_rolling_parity",
                "reference_engine_parity"):
        assert verdict[key] == "ok", key
    assert verdict["merged_batches"] == 1
    assert verdict["coalesced_requests"] == 2


def test_faults_scenario_on_two_ranks(tmp_path):
    """``launch/faults.py --expert-shards 2`` on two ranks: every engine of
    the scenario on a ``(2, 1)`` mesh, the reference's verdict keys."""
    out = str(tmp_path / "verdict.json")
    spawn(faults_rank, 2, ["--device", "cpu", "--expert-shards", "2"], out)
    with open(out) as f:
        verdict = json.load(f)
    assert list(verdict) == FAULTS_KEYS
    assert verdict["devices"] == 2
    for key in FAULTS_KEYS[1:-1]:
        assert verdict[key] == "ok", key
    assert verdict["membership"].startswith("membership: live=5/8 ")


def test_four_ranks_on_a_2x2_mesh(served, tmp_path):
    """The toy ensemble on four ranks, ``(2, 2)``: each rank holds two
    experts and two of the four rows."""
    out, src = str(tmp_path), served["out"]
    job = dict(kind="toy", label="toy", ckpt_dir=served["toy_dir"], k=4,
               meshes=[(2, 2)], noise=os.path.join(src, "toy_noise.npy"),
               text=os.path.join(src, "toy_text.npy"),
               sampler=SAMPLERS["toy"], out=out, device="cpu")
    spawn(serve_checkpoints_rank, 4, [job])
    outs = [dict(np.load(os.path.join(out, f"toy_2x2_rank{r}.npz")))
            for r in range(4)]
    for r in outs:
        _assert_close(r["out"], served["want"]["toy"], SLICE_REL,
                      "2x2 vs jax")
        _assert_close(r["out"], served["port"]["toy"]["out"], MESH_REL,
                      "2x2 vs port")
        assert int(r["nbytes"]) * 2 == served["port"]["toy"]["nbytes"]
