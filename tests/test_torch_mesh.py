"""The port's serving mesh and partition specs against the JAX package's,
in one process on the CPU.

* ``launch.mesh``: the ``(E, D)`` shapes and the reference's
  ``ValueError``s on a world of one (the reference sees one CPU device);
* ``launch.sharding``: ``expert_param_specs`` of raw stacked trees and of
  dense, bf16, int8, fp8 and capacity-padded stores of the reference's toy
  ensemble and of four reduced DiT experts, on meshes ``(1, 1)``, ``(2,
  1)``, ``(4, 2)`` and ``(3, 1)``, equal the reference's
  ``PartitionSpec``s as tuples (a stand-in mesh with ``shape`` and
  ``axis_names`` serves both packages' functions; a ``K`` the "expert"
  axis does not divide replicates); the stores' ``logical_axes``;
  ``serve_batch_spec``, ``dit_batch_specs`` and ``sanitize_spec``;
* ``rolling_state_shardings``, ``expert_param_shardings`` and
  ``to_shardings``: the specs of the port's ``NamedSharding``s equal the
  ``.spec`` of the reference's on an ``AbstractMesh`` of the same shape;
* ``shard_store``: a rank's slice holds rows ``[lo, hi)`` of every leaf,
  scale and mask, a ``K / E`` share of the bytes, and answers global ids;
* the engine on the degenerate ``(1, 1)`` mesh (a world of one) is
  bitwise the unsharded engine, on every serving path, the continuous
  scheduler and the reference engine included.
"""

from __future__ import annotations

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.core import param_store as jstore
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.launch.serve import ServingEngine as JServingEngine
from repro.launch.sharded_parity import toy_ensemble as jtoy_ensemble
from repro.models import dit as jdit
from repro_torch.core import param_store
from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch import mesh, sharding
from repro_torch.launch.faults import toy_ensemble
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.serving import ContinuousScheduler
from repro_torch.tree import tree_leaves, tree_map
from test_torch_serve import (  # noqa: F401  (one_torch_thread: a fixture)
    _numpy_params, _write_ensemble, one_torch_thread)

KINDS = ["raw", "native", "bf16", "int8", "fp8", "capacity"]
SPEC_MESHES = [(1, 1), (2, 1), (4, 2), (3, 1)]


@pytest.fixture(scope="module", autouse=True)
def world_of_one():
    """The engines here start a world-of-one process group; it is
    destroyed after the module if the module started it."""
    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


def _stand_in(e, d):
    return types.SimpleNamespace(shape={"expert": e, "data": d},
                                 axis_names=("expert", "data"))


def _raise_message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("e,d", [(1, 1), (1, None), (3, 1), (0, 1), (1, 0),
                                 (2, None)],
                         ids=["1x1", "1xNone", "3x1", "0x1", "1x0",
                              "2xNone"])
def test_expert_mesh_shapes_and_errors_match_reference(e, d):
    """On one device (one rank) a mesh needing more raises the reference's
    "needs N devices but only M are visible"; shard counts below 1 raise
    "must be >= 1"; the rest stand up the reference's shape."""
    try:
        want = dict(jmesh.make_expert_mesh(e, d).shape)
    except ValueError as err:
        assert _raise_message(
            lambda: mesh.make_expert_mesh(e, d, device="cpu")) == str(err)
        return
    got = mesh.make_expert_mesh(e, d, device="cpu")
    assert got.shape == want
    assert got.axis_names == ("expert", "data")
    assert (got.expert_index, got.data_index) == (0, 0)
    assert mesh.mesh_devices(got) == 1


def test_mesh_helpers_match_reference():
    host, jhost = mesh.make_host_mesh(), jmesh.make_host_mesh()
    assert host.axis_names == tuple(jhost.axis_names)
    assert host.shape == dict(jhost.shape)
    assert mesh.mesh_devices(host) == jmesh.mesh_devices(jhost)
    for names in (("expert", "data"), ("data", "model"),
                  ("pod", "data", "model")):
        m = types.SimpleNamespace(axis_names=names)
        assert mesh.data_axes(m) == jmesh.data_axes(m)


def test_expert_range_and_data_range():
    m = mesh.ExpertMesh(shape={"expert": 2, "data": 2}, expert_index=1,
                        data_index=0, expert_group=None, data_group=None,
                        backend="gloo")
    assert m.expert_range(8) == (4, 8)
    assert m.expert_range(7) == (0, 7)          # does not divide: replicated
    assert m.data_range(6) == (0, 3)
    assert m.data_range(5) == (0, 5)


def test_engine_rejects_an_expert_axis_that_does_not_divide_k():
    experts, params, router_fn, latent = toy_ensemble(4, "cpu")
    jexperts, jparams, jrouter, jlatent = jtoy_ensemble(4)
    want = _raise_message(lambda: JServingEngine(
        experts=jexperts, expert_params=jparams, router_fn=jrouter,
        latent_shape=jlatent, n_expert_shards=3, n_data_shards=1))
    got = _raise_message(lambda: ServingEngine(
        experts=experts, expert_params=params, router_fn=router_fn,
        latent_shape=latent, device="cpu", n_expert_shards=3,
        n_data_shards=1))
    assert got == want
    assert "does not divide the 4-expert ensemble" in got


# --- partition specs ----------------------------------------------------------


@pytest.fixture(scope="module")
def ensembles():
    """Numpy parameters of the reference's toy ensemble and of four reduced
    DiT experts."""
    _, jparams, _, _ = jtoy_ensemble(4)
    cfg = dit_b2().reduced(latent_size=8)
    return {"toy": [jax.tree.map(np.asarray, p) for p in jparams],
            "dit": [_numpy_params(cfg, i) for i in range(4)]}


def _stores(params_np, kind):
    """The same store built by both packages from numpy parameters."""
    jstacked = jdit.stack_expert_params(
        [jax.tree.map(jnp.asarray, p) for p in params_np])
    pstacked = D.stack_expert_params(
        [tree_map(torch.from_numpy, p) for p in params_np])
    if kind == "raw":
        return jstacked, pstacked
    if kind == "capacity":
        k = len(params_np) + 2
        return (jstore.pad_to_capacity(jstore.make_store(jstacked), k),
                param_store.pad_to_capacity(
                    param_store.make_store(pstacked), k))
    return (jstore.make_store(jstacked, dtype=kind),
            param_store.make_store(pstacked, dtype=kind))


def _jax_spec_leaves(specs):
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda s: isinstance(s, P))]


@pytest.mark.parametrize("e,d", SPEC_MESHES,
                         ids=[f"{e}x{d}" for e, d in SPEC_MESHES])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ens", ["toy", "dit"])
def test_expert_param_specs_match_reference(ensembles, ens, kind, e, d):
    jst, pst = _stores(ensembles[ens], kind)
    m = _stand_in(e, d)
    if kind == "raw":
        want = _jax_spec_leaves(jsharding.expert_param_specs(jst, m))
        got = sharding.store_spec_leaves(
            pst, sharding.expert_param_specs(pst, m))
    else:
        want = _jax_spec_leaves(jsharding.expert_param_specs(
            jst, m, logical_axes=jst.logical_axes()))
        got = sharding.store_spec_leaves(pst, sharding.expert_param_specs(
            pst, m, logical_axes=pst.logical_axes()))
    assert got == want
    k = pst.num_experts if kind != "raw" else 4
    lead = "expert" if k % e == 0 else None
    assert all(spec[0] == lead and set(spec[1:]) <= {None} for spec in got)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ens", ["toy", "dit"])
def test_logical_axes_match_reference(ensembles, ens, kind):
    """Every leaf ``("expert", None, ...)``; scales and ``valid``
    ``("expert",)`` — a store's own, and ``stacked_param_logical_axes``."""
    jst, pst = _stores(ensembles[ens], kind)
    want = jax.tree.leaves(jdit.stacked_param_logical_axes(jst),
                           is_leaf=lambda a: isinstance(a, tuple))
    got = sharding.store_spec_leaves(pst, D.stacked_param_logical_axes(pst))
    assert got == want
    if kind != "raw":
        assert got == sharding.store_spec_leaves(pst, pst.logical_axes())


@pytest.mark.parametrize("shape", [(4, 8, 8, 4), (3, 8, 8, 4), (), (0, 5),
                                   (6,)], ids=str)
@pytest.mark.parametrize("e,d", [(1, 1), (1, 2), (2, 1), (1, 3)],
                         ids=["1x1", "1x2", "2x1", "1x3"])
def test_batch_specs_match_reference(shape, e, d):
    m = _stand_in(e, d)
    assert sharding.serve_batch_spec(m, shape) == tuple(
        jsharding.serve_batch_spec(m, shape))
    spec = ("data", "expert") + (None,) * max(len(shape) - 2, 0)
    assert sharding.sanitize_spec(spec, shape, m) == tuple(
        jsharding.sanitize_spec(P(*spec), shape, m))
    assert sharding.dispatch_plan_sharding(m) == ()


ROLLING_MESHES = [(1, 1), (2, 1), (1, 2), (4, 2), (1, 3)]


@pytest.mark.parametrize("shape", [(8, 8, 8, 4), (3, 8, 8, 4), (6, 4, 4, 2)],
                         ids=str)
@pytest.mark.parametrize("e,d", ROLLING_MESHES,
                         ids=[f"{e}x{d}" for e, d in ROLLING_MESHES])
def test_rolling_state_shardings_match_reference(shape, e, d):
    """The latent's rows over "data" where it divides them, the row
    state replicated."""
    jm = AbstractMesh((e, d), ("expert", "data"))
    jlat, jrow = jsharding.rolling_state_shardings(jm, shape)
    lat, row = sharding.rolling_state_shardings(_stand_in(e, d), shape)
    assert (lat.spec, row.spec) == (tuple(jlat.spec), tuple(jrow.spec))
    assert lat.spec[0] == ("data" if shape[0] % d == 0 else None)


@pytest.mark.parametrize("e,d", SPEC_MESHES,
                         ids=[f"{e}x{d}" for e, d in SPEC_MESHES])
@pytest.mark.parametrize("kind", KINDS)
def test_expert_param_shardings_match_reference(ensembles, kind, e, d):
    jst, pst = _stores(ensembles["toy"], kind)
    jm, m = AbstractMesh((e, d), ("expert", "data")), _stand_in(e, d)
    axes = {} if kind == "raw" else dict(logical_axes=pst.logical_axes())
    jaxes = {} if kind == "raw" else dict(logical_axes=jst.logical_axes())
    want = [tuple(s.spec) for s in jax.tree.leaves(
        jsharding.expert_param_shardings(jst, jm, **jaxes),
        is_leaf=lambda s: hasattr(s, "spec"))]
    got = sharding.store_spec_leaves(
        pst, sharding.expert_param_shardings(pst, m, **axes))
    assert [s.spec for s in got] == want
    assert all(s.mesh is m for s in got)


def test_to_shardings_matches_reference():
    """A tree of specs (a tuple is one spec) to ``NamedSharding``s."""
    jm, m = AbstractMesh((2, 2), ("expert", "data")), _stand_in(2, 2)
    specs = {"x": ("data", None), "t": (), "w": [("expert",), (None, None)]}
    want = jsharding.to_shardings(jm, {
        "x": P("data", None), "t": P(), "w": [P("expert"), P(None, None)]})
    got = sharding.to_shardings(m, specs)
    for key in ("x", "t"):
        assert got[key] == sharding.NamedSharding(m, specs[key])
        assert got[key].spec == tuple(want[key].spec)
    assert [s.spec for s in got["w"]] == [tuple(s.spec) for s in want["w"]]


@pytest.mark.parametrize("names", [("expert", "data"),
                                   ("pod", "data", "model")],
                         ids=["expert_data", "pod_data_model"])
def test_dit_batch_specs_match_reference(names):
    m = types.SimpleNamespace(axis_names=names, shape={})
    batch = {"x": np.zeros((4, 8, 8, 4)), "t": np.zeros((4,)),
             "text": np.zeros((4, 7, 3))}
    want = jsharding.dit_batch_specs(m, batch)
    got = sharding.dit_batch_specs(
        m, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("kind", ["native", "int8", "fp8", "capacity"])
def test_shard_store_cuts_leaves_scales_and_mask_together(ensembles, kind,
                                                          index):
    _, whole = _stores(ensembles["dit"], kind)
    if kind == "capacity":
        whole = whole.with_valid(torch.tensor([1, 0, 1, 1, 0, 0],
                                              dtype=torch.bool))
    m = mesh.ExpertMesh(shape={"expert": 2, "data": 1}, expert_index=index,
                        data_index=0, expert_group=None, data_group=None,
                        backend="gloo")
    part = sharding.shard_store(whole, m)
    k = whole.num_experts
    lo, hi = index * k // 2, (index + 1) * k // 2
    assert (part.num_experts, part.first_expert, part.num_resident) == \
        (k, lo, k // 2)
    for got, want in zip(sharding.store_spec_leaves(part, part),
                         sharding.store_spec_leaves(whole, whole)):
        assert torch.equal(got, want[lo:hi])
    assert part.nbytes() * 2 == whole.nbytes()
    if kind == "capacity":
        assert torch.equal(part.valid_mask(), whole.valid_mask()[lo:hi])
    for e in range(lo, hi):
        for a, b in zip(tree_leaves(part.expert(e)),
                        tree_leaves(whole.expert(e))):
            assert torch.equal(a, b)
    ids = torch.arange(lo, hi).flip(0)
    for a, b in zip(tree_leaves(part.gather(ids)),
                    tree_leaves(whole.gather(ids))):
        assert torch.equal(a, b)


# --- the degenerate (1, 1) mesh ---------------------------------------------


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_ckpts"))
    cfg = dit_b2().reduced(latent_size=8)
    _write_ensemble(path, cfg, router_b2(num_clusters=8).reduced(
        latent_size=8))
    text = np.random.default_rng(3).standard_normal(
        (2, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return path, text


DEGENERATE = {
    "native": {}, "int8": dict(param_dtype="int8"),
    "grouped": dict(dispatch="grouped"), "gathered": dict(dispatch="gathered"),
    "full": dict(strategy="full"), "threshold": dict(strategy="threshold"),
    "unfused": dict(step_fused=False), "plan_reuse": dict(plan_refresh_every=2),
}


@pytest.mark.parametrize("path", list(DEGENERATE) + ["elastic"])
def test_degenerate_mesh_is_bitwise_unsharded(ckpts, path):
    """The ``(1, 1)`` mesh (a world of one: its collectives run over groups
    of one) serves each path bitwise as the engine without a mesh; on the
    elastic engine also after an eviction."""
    ckpt_dir, text = ckpts
    sampler = SamplerConfig(num_steps=2, cfg_scale=7.5, top_k=2,
                            **DEGENERATE.get(path, {}))
    kw = dict(capacity=10) if path == "elastic" else {}
    outs = []
    for shards in ({}, dict(n_expert_shards=1, n_data_shards=1)):
        eng = ServingEngine.from_checkpoint_dir(
            ckpt_dir, dit_cfg=dit_b2().reduced(latent_size=8),
            router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
            sampler=sampler, device="cpu", track_padding=True, **kw,
            **shards)
        got = [eng.generate(0, text, 2)]
        if path == "elastic":
            eng.evict_expert(3)
            got.append(eng.generate(0, text, 2))
        outs.append((got, eng.stats["padded_model_rows"], eng.mesh))
    (want, rows, no_mesh), (got, rows_m, m) = outs
    assert no_mesh is None and m.shape == {"expert": 1, "data": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert rows_m == rows


def test_what_the_mesh_does_not_serve_yet_raises():
    """What the mesh once refused now serves: on the ``(1, 1)`` mesh the
    continuous scheduler (staggered requests, ``steps_per_tick`` 2) and
    the reference engine build and serve, bitwise the unsharded ones."""
    experts, params, router_fn, latent = toy_ensemble(4, "cpu")
    base = dict(experts=experts, expert_params=params, router_fn=router_fn,
                latent_shape=latent, device="cpu",
                sampler=SamplerConfig(num_steps=3, cfg_scale=3.0, top_k=2))
    rng = np.random.default_rng(4)
    texts = [rng.standard_normal((b, 5, 6)).astype(np.float32)
             for b in (1, 2, 1)]
    outs = []
    for shards in ({}, dict(n_expert_shards=1, n_data_shards=1)):
        eng = ServingEngine(**base, **shards)
        sched = ContinuousScheduler(eng, max_resident=4, steps_per_tick=2)
        handles = []
        for i, t in enumerate(texts):
            handles.append(sched.submit(i, t))
            sched.step()
        sched.run_until_idle()
        ref = ServingEngine(**base, engine="reference", **shards)
        outs.append(([h.result() for h in handles],
                     ref.generate(7, texts[1], 2), eng.mesh, ref.mesh))
    (want, want_ref, no_mesh, _), (got, got_ref, m, m_ref) = outs
    assert no_mesh is None and m.shape == m_ref.shape == {"expert": 1,
                                                          "data": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got_ref, want_ref)


def test_port_imports_no_jax():
    """The new modules import nothing of JAX or the JAX package."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "repro_torch", "launch")
    for name in ("mesh.py", "sharding.py", "sharded_parity.py"):
        with open(os.path.join(src, name)) as f:
            text = f.read()
        assert "import jax" not in text and "from jax" not in text
        assert "from repro." not in text and "import repro\n" not in text
