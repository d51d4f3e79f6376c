"""The LM sharding rules of the port (``repro_torch.launch.sharding``'s
LM half), the production meshes' shapes, the dry-run's analytic terms
(``launch.hlo_analysis``, ``launch.dryrun._active_params``) and the
configs' ``fsdp_params`` against the JAX package.

The reference's spec functions read only ``mesh.shape`` and
``mesh.axis_names``, so a ``SimpleNamespace`` with those two serves them
for both production meshes, ``(16, 16)`` on ``("data", "model")`` and
``(2, 16, 16)`` on ``("pod", "data", "model")``.  The port's meta-device
trees (``launch.steps.param_shapes``, ``input_specs``) and the
reference's ``jax.eval_shape`` trees go through each package's
functions; the specs must be equal leaf for leaf, by leaf path.  The
analytic terms are exact functions of the same numbers: equal within
float64 rounding (``rel=1e-12``).
"""

from __future__ import annotations

import importlib
import os
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.launch import hlo_analysis as jha
from repro.launch import hlo_cost as jhc
from repro.launch import sharding as jsh
from repro.launch import steps as JS
from repro.models import zoo as jzoo
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun, hlo_analysis, mesh as M, sharding
from repro_torch.launch import steps
from repro_torch.models import zoo



def _import_reference_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` to 512
    host devices for its own process; the flags are put back at once, so
    this process's JAX (not started yet at collection) keeps its one
    device."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


jdry = _import_reference_dryrun()

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def _mesh(name):
    shape = MESHES[name]
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape))


def _port_leaves(tree, path=()):
    """``{path: spec}`` of a port spec tree (dicts, lists; tuples are
    specs)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, path + (str(i),)))
        return out
    return {path: tuple(tree)}


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))
    return {tuple(jsh._path_names(p)): tuple(s) for p, s in flat}


@pytest.fixture(scope="module")
def trees():
    """Both packages' full-size parameter shape trees, by arch."""
    return {a: (steps.param_shapes(get_config(a)),
                JS.param_shapes(j_get_config(a))) for a in ARCH_IDS}


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(trees, arch, mesh_name, fsdp):
    """``param_specs`` at full size: the same leaf paths and, on each, the
    same spec as the reference's."""
    pt, jt = trees[arch]
    mesh = _mesh(mesh_name)
    got = _port_leaves(sharding.param_specs(pt, mesh, fsdp=fsdp))
    want = _jax_leaves(jsh.param_specs(jt, mesh, fsdp=fsdp))
    assert set(got) == set(want)
    for path in want:
        assert got[path] == want[path], path
    # a NamedSharding per leaf pairs its spec with the mesh
    sh = sharding.param_shardings(pt, mesh, fsdp=fsdp)
    emb = sh["embed"]["emb"]
    assert emb.mesh is mesh and emb.spec == got[("embed", "emb")]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_jax(arch, mesh_name):
    """``batch_specs`` of every train and prefill batch, the decode
    token and position, and ``cache_specs`` of ``decode_32k`` and — where
    ``supports_long_context`` allows — ``long_500k`` (batch 1: the KV
    sequence over the data axes)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    mesh = _mesh(mesh_name)
    for name in ("train_4k", "prefill_32k"):
        got = sharding.batch_specs(cfg, mesh, steps.input_specs(
            cfg, SHAPES[name])["batch"])
        want = jsh.batch_specs(jcfg, mesh, JS.input_specs(
            jcfg, J_SHAPES[name])["batch"])
        assert set(got) == set(want)
        for k in want:
            assert got[k] == tuple(want[k]), (name, k)
    for name in ("decode_32k", "long_500k"):
        if name == "long_500k" and not zoo.supports_long_context(cfg):
            assert not jzoo.supports_long_context(jcfg)
            continue
        shape, jshape = SHAPES[name], J_SHAPES[name]
        spec, jspec = steps.input_specs(cfg, shape), JS.input_specs(
            jcfg, jshape)
        rcfg, _ = steps.cfg_for_shape(cfg, shape)
        jrcfg, _ = JS.cfg_for_shape(jcfg, jshape)
        got = sharding.cache_specs(rcfg, mesh, spec["cache"],
                                   shape.global_batch)
        want = jsh.cache_specs(jrcfg, mesh, jspec["cache"],
                               jshape.global_batch)
        assert set(got) == set(want), name
        for k in want:
            assert got[k] == tuple(want[k]), (name, k)
        tok = {"token": spec["token"], "pos": spec["pos"]}
        jtok = {"token": jspec["token"], "pos": jspec["pos"]}
        got = sharding.batch_specs(cfg, mesh, tok)
        want = jsh.batch_specs(jcfg, mesh, jtok)
        assert {k: got[k] for k in got} == {k: tuple(v)
                                            for k, v in want.items()}


def test_rule_helpers_match_jax():
    """``_rule_for`` on every owner name at 1–4 dims over both data-axis
    tuples, ``_pad`` and ``_first_divisible``."""
    names = sorted(jsh._COL | jsh._ROW | jsh._COL_TP_ONLY) + [
        "emb", "router", "conv_w", "table", "block_embed", "scale",
        "A_log"]
    assert sharding._COL == jsh._COL and sharding._ROW == jsh._ROW
    assert sharding._COL_TP_ONLY == jsh._COL_TP_ONLY
    for dp in (("data",), ("pod", "data")):
        for n in names:
            for nd in range(1, 5):
                got = sharding._rule_for(["blocks", n], nd, dp)
                want = tuple(jsh._rule_for(["blocks", n], nd, dp))
                assert got == want, (dp, n, nd)
    assert sharding._pad(("model",), 3, 1) == tuple(jsh._pad(P("model"), 3,
                                                             1))
    mesh = _mesh("16x16")
    for shape in ((8, 32, 48), (1, 16, 3), (32,)):
        for dims in ([0, 1, 2], [2, 1], [3]):
            assert sharding._first_divisible(shape, dims, mesh, "model") \
                == jsh._first_divisible(shape, dims, mesh, "model")


PAIRS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("arch,shape_name", PAIRS,
                         ids=[f"{a}-{s}" for a, s in PAIRS])
def test_dryrun_terms_match_jax(trees, arch, shape_name):
    """``model_flops``, ``_active_params`` (on the port's own parameter
    count, equal to the reference's), the ``Roofline`` terms and its
    dominant one, and the collective wire factors at group sizes 0–512,
    on all 40 (arch, shape) pairs."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    pt, jt = trees[arch]
    n = sum(x.numel() for x in jax.tree_util.tree_leaves(pt))
    jn = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jt))
    assert n == jn
    active = dryrun._active_params(cfg, n)
    assert active == jdry._active_params(jcfg, jn)
    shape, jshape = SHAPES[shape_name], J_SHAPES[shape_name]
    assert (shape.seq_len, shape.global_batch, shape.kind) == (
        jshape.seq_len, jshape.global_batch, jshape.kind)
    got = hlo_analysis.model_flops(cfg, shape, n, active)
    assert got == pytest.approx(jha.model_flops(jcfg, jshape, jn, active),
                                rel=1e-12)
    for k, terms in enumerate(((got / 256, 3e12, 7e9), (1.0, 2e15, 0.0),
                               (5.0, 1.0, 9e13))):
        kw = dict(flops_per_device=terms[0], bytes_per_device=terms[1],
                  collective_bytes_per_device=terms[2],
                  peak_flops=M.PEAK_FLOPS_BF16, hbm_bw=M.HBM_BW,
                  ici_bw=M.LINK_BW)
        r, jr = hlo_analysis.Roofline(**kw).as_dict(), \
            jha.Roofline(**kw).as_dict()
        assert r["dominant"] == jr["dominant"], k
        for key in jr:
            if key != "dominant":
                assert r[key] == pytest.approx(jr[key], rel=1e-12), key
        assert hlo_analysis.Roofline(**kw).bound_s == pytest.approx(
            jha.Roofline(**kw).bound_s, rel=1e-12)
    for op in hlo_analysis.COLLECTIVES:
        for size in (0, 1, 2, 16, 32, 512):
            group = ",".join(str(i) for i in range(size))
            line = f"replica_groups={{{{{group}}}}}" if size else ""
            assert hlo_analysis.wire_factor(op, size) == pytest.approx(
                jhc._wire_factor(op, line), rel=1e-12), (op, size)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_params_matches_jax(arch):
    """``fsdp_params`` (and every other field) as the reference's; it is
    set on the four configs whose training state does not fit a card."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert cfg.fsdp_params == jcfg.fsdp_params
    assert cfg.fsdp_params == (arch in ("mixtral-8x7b", "mixtral-8x22b",
                                        "deepseek-67b",
                                        "deepseek-coder-33b"))
    assert cfg.reduced().fsdp_params == jcfg.reduced().fsdp_params


def test_production_mesh_shapes_and_constants():
    """The production meshes' shapes and axes are the reference's; on a
    world of one (no process group) the port's raises; the roofline's
    denominators are the H100 SXM's."""
    for multi in (False, True):
        shape, axes = M.PRODUCTION_MESHES[multi]
        want = (2, 16, 16) if multi else (16, 16)
        assert shape == want
        assert axes == (("pod", "data", "model") if multi
                        else ("data", "model"))
        with pytest.raises(ValueError, match="needs a world of"):
            M.make_production_mesh(multi_pod=multi, device="cpu")
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.LINK_BW) == (989e12, 3.35e12,
                                                        450e9)
    assert M.data_axes(_mesh("2x16x16")) == ("pod", "data")
    assert M.data_axes(_mesh("16x16")) == ("data",)
    with pytest.raises(ValueError, match="unknown collective"):
        hlo_analysis.wire_factor("broadcast", 4)
