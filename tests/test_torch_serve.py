"""The port's serving engine against the JAX package's, on the CPU.

Both engines load the same directory — eight jittered reduced DiT experts
(2 DDPM/cosine + 6 FM/linear, the paper's heterogeneous mix) and a router,
written by the JAX package's ``save_checkpoint`` — and serve the same
request: the same text embeddings and the exact noise the JAX engine draws
(``jax.random.normal(key, shape)``, handed to the port with ``noise=``).
Top-2 routing, CFG 7.5, batch 4, 4 Euler steps.

Tolerance: ``max |Δ| ≤ 1e-4 · max |latent|``.  Every step sums float32
GEMMs in another order than XLA, CFG 7.5 amplifies the difference of the
two branches, and four steps compound it (observed ~1e-5).

Also here: the engine's checkpoint-directory errors, its statistics and
device rule, and the isolation of ``repro_torch`` from JAX.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro.training import checkpoint as jckpt
from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.tree import tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs use one intra-op thread in these modules: the
    reduced models gain nothing from more, and in a parallel test run (a
    process per core) more threads oversubscribe the cores and spin-wait
    (measured: 129 s against 26 s for the same tests beside six busy
    processes).  Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SLICE_REL = 1e-4
BATCH, STEPS = 4, 4
MIX = [("ddpm", "cosine")] * 2 + [("fm", "linear")] * 6


def _numpy_params(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return tree_map(
        lambda a: (a + 0.02 * torch.randn(a.shape, generator=gen)).numpy(),
        D.init(cfg, gen))


def _write_ensemble(path, cfg, rcfg, mix=MIX, cluster_ids=None):
    cluster_ids = range(len(mix)) if cluster_ids is None else cluster_ids
    for i, (cid, (obj, sched)) in enumerate(zip(cluster_ids, mix)):
        jckpt.save_checkpoint(
            os.path.join(path, f"expert{i}.npz"), _numpy_params(cfg, i),
            metadata=jckpt.expert_metadata(
                name=f"e{cid}", objective=obj, schedule=sched,
                cluster_id=cid, arch=cfg.name))
    jckpt.save_checkpoint(os.path.join(path, "router.npz"),
                          _numpy_params(rcfg, 99), metadata={})


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ensemble"))
    cfg = dit_b2().reduced(latent_size=8)
    _write_ensemble(path, cfg, router_b2(num_clusters=8).reduced(
        latent_size=8))
    text = np.random.default_rng(0).standard_normal(
        (BATCH, cfg.text_len, cfg.text_dim)).astype(np.float32)
    jengs = {
        scale: JServingEngine.from_checkpoint_dir(
            path, dit_cfg=j_dit_b2().reduced(latent_size=8),
            router_cfg=j_router_b2(num_clusters=8).reduced(latent_size=8),
            sampler=JSamplerConfig(num_steps=STEPS, cfg_scale=scale,
                                   top_k=2))
        for scale in (7.5, 1.0)
    }
    return dict(path=path, cfg=cfg, text=text, jengs=jengs)


def _port_engine(path, cfg_scale=7.5, **kw):
    return ServingEngine.from_checkpoint_dir(
        path, dit_cfg=dit_b2().reduced(latent_size=8),
        router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=SamplerConfig(num_steps=STEPS, cfg_scale=cfg_scale,
                              top_k=2),
        device="cpu", **kw)


def _jax_noise(key):
    return np.asarray(jax.random.normal(key, (BATCH, 8, 8, 4),
                                        dtype=jnp.float32))


@pytest.mark.parametrize("with_text,cfg_scale", [
    (True, 7.5), (True, 1.0), (False, 7.5)],
    ids=["cfg7.5_g2", "cfg1_g1", "uncond_g1"])
def test_generate_matches_jax_engine(ensemble, with_text, cfg_scale):
    """Batched CFG (``g = 2``), and the single-branch path (``g = 1``)
    both with text at ``cfg_scale = 1`` and without text."""
    key = jax.random.PRNGKey(7)
    text = ensemble["text"] if with_text else None
    want = np.asarray(ensemble["jengs"][cfg_scale].generate(key, text,
                                                            BATCH))
    eng = _port_engine(ensemble["path"], cfg_scale=cfg_scale)
    got = eng.generate(0, text, BATCH, noise=_jax_noise(key)).numpy()
    assert got.shape == want.shape == (BATCH, 8, 8, 4)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= SLICE_REL * np.abs(want).max(), (err, np.abs(want).max())


def test_engine_orders_experts_and_counts(ensemble):
    eng = _port_engine(ensemble["path"])
    assert [e.cluster_id for e in eng.experts] == list(range(8))
    assert [e.objective for e in eng.experts] == [o for o, _ in MIX]
    text = ensemble["text"]
    a = eng.generate(1, text, BATCH)
    b = eng.generate(torch.Generator().manual_seed(1), text.copy(), BATCH)
    c = eng.generate(2, text, BATCH)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert eng.stats == {"requests": 3, "cond_cache_hits": 2,
                         "cond_cache_misses": 1,
                         "plan_refreshes": 3 * STEPS,
                         "merged_batches": 0, "batched_requests": 0,
                         "experts_added": 0, "experts_evicted": 0,
                         "quarantined_checkpoints": 0, "degraded_steps": 0,
                         "request_requeues": 0, "failed_requests": 0,
                         "deadline_exceeded": 0, "padded_model_rows": 0,
                         "routed_model_rows": 0, "model_steps": 0,
                         "watchdog_trips": 0, "breaker_trips": 0,
                         "breaker_probes": 0, "breaker_restores": 0,
                         "journal_snapshots": 0}


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine.from_checkpoint_dir(REPO, dit_cfg=dit_b2())


def test_checkpoint_dir_errors(tmp_path):
    cfg = dit_b2().reduced(latent_size=8)
    rcfg = router_b2(num_clusters=2).reduced(latent_size=8)
    mix = [("fm", "linear")] * 2
    with pytest.raises(FileNotFoundError, match="no expert"):
        _port_engine(str(tmp_path))
    dup = tmp_path / "dup"
    _write_ensemble(str(dup), cfg, rcfg, mix, cluster_ids=[1, 1])
    with pytest.raises(ValueError, match="duplicate cluster_id 1"):
        _port_engine(str(dup))
    hole = tmp_path / "hole"
    _write_ensemble(str(hole), cfg, rcfg, mix, cluster_ids=[0, 2])
    with pytest.raises(ValueError, match=r"missing \[1\]"):
        _port_engine(str(hole))
    nometa = tmp_path / "nometa"
    nometa.mkdir()
    jckpt.save_checkpoint(str(nometa / "expert0.npz"),
                          _numpy_params(cfg, 0), metadata={"cluster_id": 0})
    with pytest.raises(ValueError, match="missing 'objective'"):
        _port_engine(str(nometa))
    # numeric, not lexicographic, order: file expert10 holds cluster 0
    order = tmp_path / "order"
    order.mkdir()
    for name, cid in (("expert10.npz", 0), ("expert2.npz", 1)):
        jckpt.save_checkpoint(
            str(order / name), _numpy_params(cfg, cid),
            metadata=jckpt.expert_metadata(
                name=name, objective="fm", schedule="linear", cluster_id=cid,
                arch=cfg.name))
    eng = _port_engine(str(order))
    assert [e.name for e in eng.experts] == ["expert10.npz", "expert2.npz"]


def test_import_pulls_in_neither_jax_nor_the_reference():
    modules = ["repro_torch.launch.serve", "repro_torch.weights",
               "repro_torch.kernels.ops", "repro_torch.kernels._build"]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + "bad = [m for m in sys.modules if m == 'jax' or "
          "m.startswith('jax.') or m == 'repro' or "
          "m.startswith('repro.')]\n"
          "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_neither_jax_nor_the_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def _write_fm_pair(path, cfg, mutate=None):
    """Two reduced FM experts by the JAX ``save_checkpoint``; ``mutate``
    edits the first leaf (in the reference's flattening order) of
    ``expert1.npz``."""
    for i in range(2):
        params = _numpy_params(cfg, i)
        if i == 1 and mutate is not None:
            first = jax.tree_util.tree_flatten_with_path(params)[0][0][0]
            node = params
            for k in first[:-1]:
                node = node[k.key]
            node[first[-1].key] = mutate(node[first[-1].key])
        jckpt.save_checkpoint(
            os.path.join(path, f"expert{i}.npz"), params,
            metadata=jckpt.expert_metadata(
                name=f"e{i}", objective="fm", schedule="linear",
                cluster_id=i, arch=cfg.name))


def _with_nan(a):
    a = a.copy()
    a.reshape(-1)[0] = np.nan
    return a


def _one_larger(a):
    return np.zeros(tuple(n + 1 for n in a.shape), a.dtype)


@pytest.mark.parametrize("mutate", [_with_nan, _one_larger],
                         ids=["nan", "shape"])
def test_bad_checkpoint_raises_the_reference_error(tmp_path, mutate):
    """Every checkpoint after the first (the template) is checked at load:
    structure, leaf shapes, finite float leaves — with the reference's
    ``ValueError``, letter for letter (the file named)."""
    cfg = dit_b2().reduced(latent_size=8)
    _write_fm_pair(str(tmp_path), cfg, mutate)
    with pytest.raises(ValueError) as jerr:
        JServingEngine.from_checkpoint_dir(
            str(tmp_path), dit_cfg=j_dit_b2().reduced(latent_size=8))
    with pytest.raises(ValueError) as err:
        ServingEngine.from_checkpoint_dir(str(tmp_path), dit_cfg=cfg,
                                          device="cpu")
    assert str(err.value) == str(jerr.value)
    assert os.path.join(str(tmp_path), "expert1.npz") in str(err.value)


def test_mismatched_tree_raises_the_reference_error(tmp_path):
    cfg = dit_b2().reduced(latent_size=8)
    _write_fm_pair(str(tmp_path), cfg)
    other = dit_b2(adaln_single=False).reduced(latent_size=8)
    jckpt.save_checkpoint(
        os.path.join(str(tmp_path), "expert1.npz"), _numpy_params(other, 1),
        metadata=jckpt.expert_metadata(name="e1", objective="fm",
                                       schedule="linear", cluster_id=1,
                                       arch=cfg.name))
    with pytest.raises(ValueError) as jerr:
        JServingEngine.from_checkpoint_dir(
            str(tmp_path), dit_cfg=j_dit_b2().reduced(latent_size=8))
    with pytest.raises(ValueError) as err:
        ServingEngine.from_checkpoint_dir(str(tmp_path), dit_cfg=cfg,
                                          device="cpu")
    assert str(err.value) == str(jerr.value)
    assert "tree structure" in str(err.value)


def test_class_head_experts_resolve_to_grouped(tmp_path):
    """Experts with a class head publish no ragged forward (as in the
    reference), so the engine constructs and ``dispatch='auto'`` resolves
    to the grouped executor."""
    from repro.core.dispatch import resolve_dispatch as j_resolve
    from repro_torch.core.dispatch import resolve_dispatch

    cfg = dit_b2(num_classes=3).reduced(latent_size=8)
    _write_fm_pair(str(tmp_path), cfg)
    jeng = JServingEngine.from_checkpoint_dir(
        str(tmp_path), dit_cfg=j_dit_b2(num_classes=3).reduced(latent_size=8))
    eng = ServingEngine.from_checkpoint_dir(str(tmp_path), dit_cfg=cfg,
                                            device="cpu")
    assert all(e.ragged_apply_fn is None for e in eng.experts)
    assert all(e.ragged_apply_fn is None for e in jeng.experts)
    assert eng.homogeneous and jeng.homogeneous
    ragged_ok = eng.experts[0].ragged_apply_fn is not None
    assert resolve_dispatch("auto", "routed", eng.param_store is not None,
                            False, ragged_ok) == "grouped" == j_resolve(
        "auto", "routed", jeng.param_store is not None, False, ragged_ok)
