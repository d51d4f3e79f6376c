"""Elastic expert membership of the port against the JAX package, on the
CPU.

The same seeded numpy trees, checkpoints and noise go through both
packages:

* the stores' ``pad_to_capacity``, ``set_expert`` and ``with_valid``:
  dense and int8 bitwise (int8 rounds the same float32 quotients half to
  even), fp8 within one e4m3 step (``2⁻³`` relative: both round the same
  float32 quotient, but XLA's CPU float32 → e4m3 conversion is not
  PyTorch's) and its scales bitwise;
* ``fusion_weights(valid=, cluster_map=)`` and ``routed_slots(valid=)``:
  bitwise on exactly representable posteriors, ``rtol 1e-6`` otherwise;
* the elastic engines after the same evict, add, quarantine, restore
  sequence, on the reduced DiT ensemble of ``test_torch_serve.py`` and on
  the reference's closed-form toy ensemble: latents within
  ``1e-4 · max |latent|`` (float32 GEMMs summed in another order, as in
  ``test_torch_serve.py``), ``membership_line`` equal;
* every misuse raises the reference's message, and
  ``on_bad_checkpoint='skip'`` makes the reference's quarantine records
  for each ``faults`` writer.

Within the port: an all-live capacity store serves the fixed-membership
engine's latents bitwise; a request submitted before an eviction is
served as ``generate`` served it before; a NaN-poisoned dead slot never
reaches the latents.
"""

from __future__ import annotations

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import fusion as jfusion
from repro.core import param_store as jstore
from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.launch import faults as jfaults
from repro.launch import serve as jserve
from repro.launch.sharded_parity import toy_ensemble as jtoy_ensemble
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro.training import checkpoint as jckpt
from repro_torch.core import dispatch, fusion, param_store
from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch import faults, serve
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.tree import tree_leaves, tree_map
from test_torch_serve import (  # noqa: F401  (one_torch_thread: a fixture)
    SLICE_REL, _numpy_params, _write_ensemble, one_torch_thread)

STEPS = 4
TOY_SAMPLER = dict(num_steps=4, cfg_scale=3.0, strategy="topk", top_k=2)


def _close(got, want, rel=SLICE_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _tree(rng, k):
    """A small stacked tree (leading expert axis ``k``) of float32 numpy
    arrays, one expert all zeros (its scale is 1.0)."""
    tree = {"w": rng.standard_normal((k, 6, 5)).astype(np.float32),
            "blocks": [{"b": rng.standard_normal((k, 7)).astype(
                np.float32)}]}
    if k > 1:
        tree["w"][1] = 0.0
    return tree


# --- stores ------------------------------------------------------------------


def _leaves(store):
    if isinstance(store, param_store.QuantizedStore):
        return tree_leaves((store.qvals, store.scales, store.valid))
    return tree_leaves((store.stacked, store.valid))


@pytest.mark.parametrize("dtype", ["native", "bf16", "int8", "fp8"])
def test_store_membership_matches_jax(dtype):
    rng = np.random.default_rng(0)
    stacked = _tree(rng, 3)
    joiner = tree_map(lambda a: 3.0 * a[0] + 0.5, _tree(rng, 1))
    jst = jstore.make_store(jax.tree.map(jnp.asarray, stacked), dtype=dtype)
    st = param_store.make_store(tree_map(torch.from_numpy, stacked),
                                dtype=dtype)
    jst = jstore.pad_to_capacity(jst, 5).set_expert(
        3, jax.tree.map(jnp.asarray, joiner))
    jst = jst.with_valid(jst.valid_mask().at[3].set(True))
    old = param_store.pad_to_capacity(st, 5)
    old_leaves = _leaves(old)
    kept = [a.clone() for a in old_leaves]
    st = old.set_expert(3, tree_map(torch.from_numpy, joiner))
    mask = st.valid_mask().clone()
    mask[3] = True
    st = st.with_valid(mask)
    # the store is functional: the padded store's leaves are unchanged
    assert all(torch.equal(a, b) for a, b in zip(kept, old_leaves))
    assert old.valid.tolist() == [True, True, True, False, False]
    assert st.num_experts == jst.num_experts == 5
    assert st.valid.tolist() == np.asarray(jst.valid).tolist() == [
        True, True, True, True, False]
    assert st.nbytes() == jst.nbytes()
    if dtype in ("int8", "fp8"):
        for a, b in zip(tree_leaves(st.scales),
                        jax.tree.leaves(jst.scales)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tree_leaves(st.scales)[0][4] == 1.0  # pad
        for a, b in zip(tree_leaves(st.qvals),
                        jax.tree.leaves(jst.qvals)):
            got = a.float().numpy()
            want = np.asarray(b).astype(np.float32)
            if dtype == "int8":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=2 ** -3)
    for a, b in zip(tree_leaves(st.materialize()),
                    jax.tree.leaves(jst.materialize())):
        got, want = a.float().numpy(), np.asarray(b).astype(np.float32)
        if dtype == "fp8":
            np.testing.assert_allclose(got, want, rtol=2 ** -3)
        else:
            np.testing.assert_array_equal(got, want)


def test_quantized_slot_is_a_store_quantized_with_it():
    """``set_expert`` on an int8 store writes the bytes and scale of a
    store quantized from the start with that expert in the slot."""
    rng = np.random.default_rng(1)
    stacked = tree_map(torch.from_numpy, _tree(rng, 4))
    joiner = tree_map(lambda a: 2.0 * a[2] - 0.25, stacked)
    got = param_store.make_store(stacked, dtype="int8").set_expert(
        0, joiner)
    full = param_store.make_store(
        tree_map(lambda s, j: torch.cat([j[None], s[1:]]), stacked, joiner),
        dtype="int8")
    for a, b in zip(tree_leaves((got.qvals, got.scales)),
                    tree_leaves((full.qvals, full.scales))):
        assert torch.equal(a, b)


def test_store_misuse_raises_the_reference_message():
    st = param_store.make_store({"w": torch.zeros(3, 2)})
    jst = jstore.make_store({"w": jnp.zeros((3, 2))})
    for fn, jfn in (
            (lambda: param_store.pad_to_capacity(st, 2),
             lambda: jstore.pad_to_capacity(jst, 2)),
            (lambda: st.with_valid(torch.ones(4, dtype=torch.bool)),
             lambda: jst.with_valid(jnp.ones(4, bool)))):
        with pytest.raises(ValueError) as want:
            jfn()
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            fn()


# --- routing -------------------------------------------------------------------


def _spec(cid, j=False):
    mod = jfusion if j else fusion
    return mod.ExpertSpec(f"e{cid}", "fm", "linear", lambda *a, **k: None,
                          cid)


@pytest.mark.parametrize("strategy,k", [("top1", 1), ("topk", 2),
                                        ("topk", 3), ("full", 2),
                                        ("threshold", 1)])
def test_masked_fusion_weights_and_slots_match_jax(strategy, k):
    """A capacity of 6 slots over a 4-cluster router posterior, slots 1
    and 4 dead, slot 5 a second expert on cluster 2; ``routed_slots``
    with ``k`` beyond the live count where ``k = 3`` meets slot masking."""
    rng = np.random.default_rng(k)
    probs = rng.dirichlet(np.ones(4), size=5).astype(np.float32)
    valid = np.array([True, False, True, True, False, True])
    cmap = np.array([0, 1, 2, 3, 0, 2])
    t = np.linspace(0.1, 0.9, 5).astype(np.float32)
    got = fusion.fusion_weights(
        [_spec(i) for i in range(6)], lambda x, tt: torch.from_numpy(probs),
        torch.zeros(5, 2), torch.from_numpy(t), strategy=strategy, top_k=k,
        valid=torch.from_numpy(valid), cluster_map=torch.from_numpy(cmap))
    want = jfusion.fusion_weights(
        [_spec(i, True) for i in range(6)], lambda x, tt: jnp.asarray(probs),
        jnp.zeros((5, 2)), jnp.asarray(t), strategy=strategy, top_k=k,
        valid=jnp.asarray(valid), cluster_map=jnp.asarray(cmap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert (got.numpy()[:, ~valid] == 0).all()
    for kk in (k, 5):
        idx, w = dispatch.routed_slots(got, kk, valid=torch.from_numpy(
            valid))
        jidx, jw = jdispatch.routed_slots(want, kk, valid=jnp.asarray(valid))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
        assert valid[idx.numpy()].all()
        plan = dispatch.make_dispatch_plan(got, kk,
                                           valid=torch.from_numpy(valid))
        assert torch.equal(plan.slot_idx, idx)
        assert plan.segment_offsets[2].item() == plan.segment_offsets[1]


# --- the elastic engine: reduced DiT against the JAX engine ---------------------


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("elastic"))
    cfg = dit_b2().reduced(latent_size=8)
    _write_ensemble(path, cfg, router_b2(num_clusters=8).reduced(
        latent_size=8))
    joiner = os.path.join(str(tmp_path_factory.mktemp("joiner")),
                          "expert8.npz")
    jckpt.save_checkpoint(joiner, _numpy_params(cfg, 40),
                          metadata=jckpt.expert_metadata(
                              name="e8", objective="fm", schedule="linear",
                              cluster_id=3, arch=cfg.name))
    text = np.random.default_rng(4).standard_normal(
        (2, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return dict(path=path, joiner=joiner, text=text)


def _dit_kw(j=False):
    if j:
        return dict(dit_cfg=j_dit_b2().reduced(latent_size=8),
                    router_cfg=j_router_b2(num_clusters=8).reduced(
                        latent_size=8),
                    sampler=JSamplerConfig(num_steps=STEPS, cfg_scale=7.5,
                                           top_k=2))
    return dict(dit_cfg=dit_b2().reduced(latent_size=8),
                router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
                sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5,
                                      top_k=2), device="cpu")


def _membership_ops(eng, joiner):
    """Evict slots 0-2, add a ninth expert (cluster 3, tied with slot 3)
    into slot 8, quarantine and restore slot 3, trip slot 4."""
    for e in (0, 1, 2):
        eng.evict_expert(e)
    slot = eng.add_expert(joiner, slot=8)
    eng.quarantine_expert(3, "suspect")
    eng.restore_expert(3)
    eng.trip_expert(4)
    return slot


def test_elastic_dit_engine_matches_jax(ensemble):
    """Capacity 10 over the 8 experts, ``_membership_ops``, then a
    request: latents within ``1e-4 · max`` of the JAX engine's, the same
    health, quarantine records and membership line."""
    jeng = jserve.ServingEngine.from_checkpoint_dir(
        ensemble["path"], capacity=10, **_dit_kw(True))
    eng = serve.ServingEngine.from_checkpoint_dir(
        ensemble["path"], capacity=10, **_dit_kw())
    assert _membership_ops(jeng, ensemble["joiner"]) == _membership_ops(
        eng, ensemble["joiner"]) == 8
    assert eng.expert_health == jeng.expert_health
    key = jax.random.PRNGKey(3)
    want = np.asarray(jeng.generate(key, ensemble["text"], 2))
    noise = np.asarray(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    got = eng.generate(0, ensemble["text"], 2, noise=noise)
    _close(got, want)
    assert eng.membership_line() == jeng.membership_line()
    assert eng.quarantine == jeng.quarantine
    # the changes reach the routing: without them the request differs
    plain = serve.ServingEngine.from_checkpoint_dir(
        ensemble["path"], capacity=10, **_dit_kw())
    assert not torch.allclose(plain.generate(0, ensemble["text"], 2,
                                             noise=noise), got)


def test_elastic_int8_store_is_quantized_from_scratch(ensemble):
    """After ``_membership_ops`` on an int8 elastic engine, its store holds
    the bytes and scales of a store quantized from the start over the
    eight checkpoints with the ninth in slot 8 (dead slots aside), and it
    serves finite latents."""
    eng = serve.ServingEngine.from_checkpoint_dir(
        ensemble["path"], capacity=10, param_dtype="int8", **_dit_kw())
    _membership_ops(eng, ensemble["joiner"])
    dense = serve.ServingEngine.from_checkpoint_dir(
        ensemble["path"], capacity=10, **_dit_kw())
    dense.add_expert(ensemble["joiner"], slot=8)
    want = param_store.make_store(dense.param_store.stacked, dtype="int8")
    assert eng.param_store.valid.tolist() == [False] * 3 + [True] + [
        False] + [True] * 4 + [False]
    for a, b in zip(tree_leaves((eng.param_store.qvals,
                                 eng.param_store.scales)),
                    tree_leaves((want.qvals, want.scales))):
        assert torch.equal(a, b)
    out = eng.generate(0, ensemble["text"], 2)
    assert bool(torch.isfinite(out).all())


def test_all_live_capacity_equals_fixed_membership(ensemble):
    """Capacity 10 with every one of the 8 experts live serves the
    fixed-membership engine's latents bitwise (the two empty slots weigh
    0 and are never gathered)."""
    fixed = serve.ServingEngine.from_checkpoint_dir(ensemble["path"],
                                                    **_dit_kw())
    el = serve.ServingEngine.from_checkpoint_dir(ensemble["path"],
                                                 capacity=10, **_dit_kw())
    want = fixed.generate(7, ensemble["text"], 2)
    assert torch.equal(el.generate(7, ensemble["text"], 2), want)


# --- the elastic engine: the toy ensemble against the JAX engine ---------------


def _toy(j=False, k=6, capacity=8, **kw):
    if j:
        experts, params, router_fn, latent = jtoy_ensemble(8)
        return jserve.ServingEngine(
            experts=experts[:k], expert_params=params[:k],
            router_fn=router_fn, latent_shape=latent,
            sampler=JSamplerConfig(**TOY_SAMPLER), capacity=capacity, **kw)
    experts, params, router_fn, latent = faults.toy_ensemble(8, "cpu")
    return serve.ServingEngine(
        experts=experts[:k], expert_params=params[:k], router_fn=router_fn,
        latent_shape=latent, sampler=SamplerConfig(**TOY_SAMPLER),
        capacity=capacity, device="cpu", **kw)


def _toy_ckpt(path, i, cid=None, j=False):
    params = (jtoy_ensemble if j else faults.toy_ensemble)(8)[1][i]
    jckpt.save_checkpoint(path, jax.tree.map(np.asarray, params) if j
                          else tree_map(lambda a: a.numpy(), params),
                          metadata=jckpt.expert_metadata(
                              name=f"e{i}", objective="fm",
                              schedule="linear",
                              cluster_id=i if cid is None else cid,
                              arch="toy"))
    return path


TOY_TEXT = np.random.default_rng(9).standard_normal((4, 5, 6)).astype(
    np.float32)


def test_toy_elastic_sequence_matches_jax(tmp_path):
    """Evict down to one live expert under top-2 (degraded), hot-add two
    back, and serve after each change: every latent within tolerance of
    the JAX engine's, the same ``degraded_steps`` and membership line."""
    jeng, eng = _toy(True), _toy()
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, (4, 4, 4, 2), jnp.float32))
    ck6 = _toy_ckpt(str(tmp_path / "e6.npz"), 6)
    ck7 = _toy_ckpt(str(tmp_path / "e7.npz"), 7)

    def serve_both():
        _close(eng.generate(0, TOY_TEXT, 4, noise=noise),
               jeng.generate(key, TOY_TEXT, 4))
        assert eng.membership_line() == jeng.membership_line()

    serve_both()
    for e in (0, 1, 2, 3, 4):
        eng.evict_expert(e)
        jeng.evict_expert(e)
    serve_both()
    assert eng.stats["degraded_steps"] == TOY_SAMPLER["num_steps"]
    for ck in (ck6, ck7):
        assert eng.add_expert(ck) == jeng.add_expert(ck)
    serve_both()
    assert eng.expert_health == jeng.expert_health


def test_poisoned_dead_slot_never_reaches_the_latents():
    """NaN bytes in an evicted slot: the plans remap it, so the latents
    are finite and equal those of the clean engine."""
    el, clean = _toy(), _toy()
    el.evict_expert(3)
    clean.evict_expert(3)
    faults.poison_expert_runtime(el, 3)
    faults.poison_expert_runtime(el, 7)               # an EMPTY slot
    out = el.generate(1, TOY_TEXT, 4)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, clean.generate(1, TOY_TEXT, 4))


def test_submitted_request_keeps_its_snapshot(tmp_path):
    """Submit, evict, add, then flush: the request equals ``generate``
    before the changes bitwise; one submitted after differs."""
    eng = _toy()
    before = eng.generate(3, TOY_TEXT, 4)
    h_old = eng.submit(3, TOY_TEXT)
    eng.evict_expert(5)
    eng.add_expert(_toy_ckpt(str(tmp_path / "e6.npz"), 6))
    h_new = eng.submit(3, TOY_TEXT)
    assert eng.flush() == 2                            # one per epoch
    assert torch.equal(h_old.result(), before)
    assert not torch.equal(h_new.result(), before)


def test_retire_drains_then_frees_the_slot():
    eng = _toy()
    h = eng.submit(2, TOY_TEXT)
    eng.retire_expert(4)
    assert eng.expert_health[4] == "DRAINING"
    assert eng.num_live_experts == 5
    eng.flush()
    assert h.state == "DONE" and eng.expert_health[4] == "EVICTED"
    assert eng.stats["experts_evicted"] == 1


# --- misuse: the reference's messages --------------------------------------------


def _same_error(fn, jfn, exc=ValueError):
    with pytest.raises(exc) as want:
        jfn()
    with pytest.raises(exc) as got:
        fn()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(capacity=4), dict(strategy="full"), dict(strategy="threshold"),
    dict(engine="dense"), dict(router=None), dict(ddpm_low_noise_only=0.5),
    dict(initial_health=["ACTIVE", "BROKEN"] + ["ACTIVE"] * 4),
    dict(initial_health=["ACTIVE"]),
], ids=["capacity", "full", "threshold", "dense", "router", "ddpm_gate",
        "health_state", "health_len"])
def test_elastic_guards_raise_the_reference_message(kw):
    def build(j):
        experts, params, router_fn, latent = (
            jtoy_ensemble(8) if j else faults.toy_ensemble(8, "cpu"))
        sampler = dict(TOY_SAMPLER)
        for key in ("strategy", "ddpm_low_noise_only"):
            if key in kw:
                sampler[key] = kw[key]
        extra = {} if j else dict(device="cpu")
        return (jserve if j else serve).ServingEngine(
            experts=experts[:6], expert_params=params[:6],
            router_fn=None if "router" in kw else router_fn,
            latent_shape=latent,
            sampler=(JSamplerConfig if j else SamplerConfig)(**sampler),
            engine=kw.get("engine", "auto"),
            capacity=kw.get("capacity", 8),
            initial_health=kw.get("initial_health"), **extra)

    _same_error(lambda: build(False), lambda: build(True))


def test_membership_misuse_raises_the_reference_message(tmp_path):
    fixed = dict(capacity=None)
    _same_error(lambda: _toy(**fixed).evict_expert(0),
                lambda: _toy(True, **fixed).evict_expert(0))
    _same_error(lambda: _toy(**fixed).add_expert("x"),
                lambda: _toy(True, **fixed).add_expert("x"))
    eng, jeng = _toy(), _toy(True)
    ck = _toy_ckpt(str(tmp_path / "e6.npz"), 6)
    for op, exc in ((lambda e: e.evict_expert(6), ValueError),    # EMPTY
                    (lambda e: e.restore_expert(0), ValueError),  # ACTIVE
                    (lambda e: e.evict_expert(9), IndexError),
                    (lambda e: e.restore_expert(-1), IndexError),
                    (lambda e: e.add_expert(ck, slot=1), ValueError)):
        _same_error(lambda: op(eng), lambda: op(jeng), exc)
    full, jfull = _toy(k=6, capacity=6), _toy(True, k=6, capacity=6)
    _same_error(lambda: full.add_expert(ck), lambda: jfull.add_expert(ck),
                RuntimeError)
    missing = str(tmp_path / "nope.npz")
    with pytest.raises(FileNotFoundError):
        eng.add_expert(missing)
    assert eng.quarantine[-1]["path"] == missing
    assert eng.stats["quarantined_checkpoints"] == 1


def test_from_checkpoint_dir_option_errors(tmp_path):
    _same_error(
        lambda: serve.ServingEngine.from_checkpoint_dir(
            str(tmp_path), on_bad_checkpoint="ignore", **_dit_kw()),
        lambda: jserve.ServingEngine.from_checkpoint_dir(
            str(tmp_path), on_bad_checkpoint="ignore", **_dit_kw(True)))
    for i in range(2):
        path = jfaults.scramble_checkpoint(_toy_ckpt(
            str(tmp_path / f"expert{i}.npz"), i, j=True))
    _same_error(
        lambda: serve.ServingEngine.from_checkpoint_dir(
            str(tmp_path), on_bad_checkpoint="skip", **_dit_kw()),
        lambda: jserve.ServingEngine.from_checkpoint_dir(
            str(tmp_path), on_bad_checkpoint="skip", **_dit_kw(True)))
    assert path.endswith("expert1.npz")


@pytest.mark.parametrize("writer", [
    "truncate_checkpoint", "scramble_checkpoint",
    "poison_checkpoint_nonfinite", "mismatch_checkpoint_shapes"])
def test_skip_quarantines_as_the_reference(ensemble, tmp_path, writer):
    """The port's writer corrupts ``expert3.npz`` of a copy of the reduced
    ensemble (bytes equal to the reference writer's output); both engines
    quarantine it with the same record, mask the hole, and serve."""
    for name in os.listdir(ensemble["path"]):
        with open(os.path.join(ensemble["path"], name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    target = str(tmp_path / "expert3.npz")
    twin = str(tmp_path / "twin.npz")
    (tmp_path / "twin.npz").write_bytes((tmp_path / "expert3.npz")
                                        .read_bytes())
    getattr(faults, writer)(target)
    getattr(jfaults, writer)(twin)
    assert (tmp_path / "twin.npz").read_bytes() == \
        (tmp_path / "expert3.npz").read_bytes()
    os.remove(twin)
    jeng = jserve.ServingEngine.from_checkpoint_dir(
        str(tmp_path), on_bad_checkpoint="skip", **_dit_kw(True))
    eng = serve.ServingEngine.from_checkpoint_dir(
        str(tmp_path), on_bad_checkpoint="skip", **_dit_kw())
    assert eng.quarantine == jeng.quarantine and len(eng.quarantine) == 1
    assert eng.expert_health == jeng.expert_health
    assert eng.expert_health[3] == "EMPTY" and eng.capacity == 8
    assert eng.membership_line() == jeng.membership_line()
    out = eng.generate(0, ensemble["text"][:1], 1)
    assert bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match=re.escape(target)):
        serve.ServingEngine.from_checkpoint_dir(str(tmp_path), **_dit_kw())


@pytest.mark.parametrize("mode", [["--capacity", "10"],
                                  ["--capacity", "10", "--coalesce"]],
                         ids=["plain", "coalesce"])
def test_cli_elastic_lines_match_the_reference(ensemble, capsys,
                                               monkeypatch, mode):
    argv = ["--ckpt-dir", ensemble["path"], "--batch", "2", "--requests",
            "2", "--steps", "2"] + mode
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    want = _blank(capsys.readouterr().out)
    serve.main(argv + ["--device", "cpu"])
    got = _blank(capsys.readouterr().out)
    assert got == want
    assert got[1].startswith("membership: live=8/10 ")


def _blank(text: str) -> list[str]:
    out = []
    for line in text.strip().splitlines():
        line = re.sub(r" traces=\d+", "", line)
        line = re.sub(r"in [0-9.]+s \([0-9.]+ img/s\)", "in Ts (R img/s)",
                      line)
        out.append(line)
    return out
