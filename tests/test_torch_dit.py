"""Parity of the port's DiT (dense and ragged forwards), its layers and its
checkpoint I/O with the JAX package, on the CPU.

Weights are seeded, jittered ``dit_b2().reduced(latent_size=8)`` parameters
(fresh init zeroes the output layers, which would make the comparison
vacuous) with the reference's structure, made as numpy arrays and handed
to the JAX package as ``jnp`` arrays and to the port with
``params_from_numpy``.

Tolerance: float32 GEMM chains whose summation order differs between XLA
and PyTorch, through two transformer layers: ``rtol = atol = 1e-5``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.param_store import DenseStore as JDense
from repro.models import dit as JD
from repro.models import layers as JL
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro.training import checkpoint as jckpt
from repro_torch.kernels import ops
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.training import checkpoint as ckpt
from repro_torch.weights import params_from_numpy
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

TOL = dict(rtol=1e-5, atol=1e-5)


def jittered_numpy_params(cfg, seed):
    """Seeded parameters with the reference's structure as numpy arrays,
    every leaf jittered (fresh init zeroes the output layers)."""
    gen = torch.Generator().manual_seed(seed)
    params = D.init(cfg, gen)
    return tree_map(
        lambda a: (a + 0.02 * torch.randn(a.shape, generator=gen)).numpy(),
        params)


@pytest.fixture(scope="module")
def models():
    cfg = dit_b2().reduced(latent_size=8)
    rcfg = router_b2(num_clusters=4).reduced(latent_size=8)
    experts = [jittered_numpy_params(cfg, i) for i in range(3)]
    router = jittered_numpy_params(rcfg, 9)
    return dict(
        jcfg=j_dit_b2().reduced(latent_size=8),
        jrcfg=j_router_b2(num_clusters=4).reduced(latent_size=8),
        jexperts=[jax.tree.map(jnp.asarray, p) for p in experts],
        jrouter=jax.tree.map(jnp.asarray, router),
        cfg=cfg, rcfg=rcfg,
        experts=[params_from_numpy(p, "cpu") for p in experts],
        router=params_from_numpy(router, "cpu"),
    )


def _inputs(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.latent_size, cfg.latent_size,
                             cfg.latent_channels)).astype(np.float32)
    t = rng.uniform(0, 1, (b,)).astype(np.float32)
    text = rng.standard_normal((b, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    return x, t, text


@pytest.mark.parametrize("router", [False, True])
def test_port_init_has_the_reference_structure(models, router):
    cfg, jcfg = (models["rcfg"], models["jrcfg"]) if router else \
        (models["cfg"], models["jcfg"])
    got = tree_map(lambda a: a.numpy(),
                     D.init(cfg, torch.Generator().manual_seed(0)))
    want = jax.eval_shape(lambda k: JD.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_sinusoidal_table_patchify_roundtrip():
    # an ulp of exp() in a frequency, times angles up to 999 rad, moves
    # cos/sin by up to ~1e-4; checkpoints carry the table, so this only
    # concerns weights the port initializes itself
    np.testing.assert_allclose(D.sinusoidal_table(1000, 256).numpy(),
                               np.asarray(JD.sinusoidal_table(1000, 256)),
                               rtol=1e-5, atol=2e-4)
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    p = D.patchify(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(p.numpy(), np.asarray(JD.patchify(x, 2)))
    np.testing.assert_array_equal(D.unpatchify(p, 2, 8, 4).numpy(), x)


def test_layernorm_and_attention_match_jax():
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 5, 16)) + 1).astype(np.float32)
    np.testing.assert_allclose(ops.layernorm(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.layernorm({}, x)), **TOL)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 6, 3, 8), (2, 4, 3, 8), (2, 4, 3, 8)))
    want = JL.chunked_attention(
        q, k, v, q_positions=jnp.arange(6), kv_positions=jnp.arange(4),
        causal=False, chunk_size=4)
    # the DiT's attention call: (B, S, H, D) projections as (B, H, S, D)
    # views, 6 queries over 4 keys (a cross-attention's unequal lengths)
    got = ops.flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                                for a in (q, k, v)), causal=False)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("text_mode", ["text", "null", "drop_mask"])
def test_dense_expert_apply_matches_jax(models, text_mode):
    cfg = models["cfg"]
    x, t, text = _inputs(cfg, 3)
    drop = np.array([False, True, False])
    jkw, kw = {}, {}
    if text_mode != "null":
        jkw["text_emb"], kw["text_emb"] = text, torch.from_numpy(text)
    if text_mode == "drop_mask":
        jkw["drop_mask"], kw["drop_mask"] = drop, torch.from_numpy(drop)
    want = np.asarray(JD.apply(models["jcfg"], models["jexperts"][0], x, t,
                               **jkw))
    got = D.apply(cfg, models["experts"][0], torch.from_numpy(x),
                  torch.from_numpy(t), **kw)
    assert np.abs(want).max() > 1e-2           # jittered: not trivially 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_router_posterior_matches_jax(models):
    x, t, _ = _inputs(models["cfg"], 4, seed=1)
    want = np.asarray(JD.make_router_fn(models["jrcfg"], models["jrouter"])(
        x, t))
    got = D.make_router_fn(models["rcfg"], models["router"])(
        torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("g,with_text", [(2, True), (1, True), (1, False)])
def test_ragged_expert_apply_matches_jax(models, g, with_text):
    """Pair-major ragged forward over stacked experts: repeated and missing
    experts among the pairs, the per-pair prefix broadcast to ``g``
    replicas, and the ``drop_mask`` null-text substitution."""
    cfg = models["cfg"]
    pe = np.array([2, 0, 2, 1, 0], np.int32)
    x, t, _ = _inputs(cfg, len(pe), seed=2)
    rng = np.random.default_rng(3)
    cond_np = {}
    if with_text:
        cond_np["text_emb"] = rng.standard_normal(
            (len(pe), g, cfg.text_len, cfg.text_dim)).astype(np.float32)
        if g == 2:
            cond_np["drop_mask"] = np.broadcast_to([False, True], (5, 2))
    jview = JDense.from_stacked(
        JD.stack_expert_params(models["jexperts"])).ragged_view()
    want = np.asarray(jax.jit(JD.make_ragged_expert_apply(models["jcfg"]),
                              static_argnums=5)(
        jview, x, t, {k: jnp.asarray(v) for k, v in cond_np.items()},
        jnp.asarray(pe), g))
    view = D.stack_expert_params(models["experts"])
    got = D.make_ragged_expert_apply(cfg)(
        view, torch.from_numpy(x), torch.from_numpy(t),
        {k: torch.from_numpy(np.array(v)) for k, v in cond_np.items()},
        torch.from_numpy(pe), g)
    assert got.shape == (len(pe) * g,) + x.shape[1:]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_checkpoints_cross_both_packages(models, tmp_path):
    meta = jckpt.expert_metadata(name="e", objective="ddpm",
                                 schedule="cosine", cluster_id=3,
                                 arch="dit-b2")
    jpath = os.path.join(tmp_path, "expert3.npz")
    jckpt.save_checkpoint(jpath, models["jexperts"][1], metadata=meta)
    params, got_meta = ckpt.load_checkpoint(jpath, device="cpu")
    assert got_meta == meta
    for a, b in zip(tree_leaves(params), tree_leaves(
            models["experts"][1])):
        assert torch.equal(a, b)
    ppath = os.path.join(tmp_path, "port.npz")
    ckpt.save_checkpoint(ppath, models["experts"][1],
                         metadata=ckpt.expert_metadata(
                             name="e", objective="ddpm", schedule="cosine",
                             cluster_id=3, arch="dit-b2"))
    jparams, jmeta = jckpt.load_checkpoint(ppath)
    assert jmeta == meta
    for a, b in zip(jax.tree.leaves(jparams),
                    jax.tree.leaves(models["jexperts"][1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_checkpoint_named_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="checkpoint not found"):
        ckpt.load_checkpoint(os.path.join(tmp_path, "missing"), device="cpu")
    junk = os.path.join(tmp_path, "junk.npz")
    with open(junk, "wb") as fh:
        fh.write(b"not a zip archive")
    with pytest.raises(ValueError, match=r"junk\.npz.*corrupt"):
        ckpt.load_checkpoint(junk, device="cpu")
    raw = os.path.join(tmp_path, "raw.npz")
    np.savez(raw, w=np.zeros(3))
    with pytest.raises(ValueError, match=r"raw\.npz.*__metadata__"):
        ckpt.load_checkpoint(raw, device="cpu")
    bad_meta = os.path.join(tmp_path, "badmeta.npz")
    np.savez(bad_meta, __metadata__=np.asarray("{not json"), w=np.zeros(3))
    with pytest.raises(ValueError, match="mangled"):
        ckpt.load_checkpoint(bad_meta, device="cpu")
    good = os.path.join(tmp_path, "good.npz")
    ckpt.save_checkpoint(good, {"w": torch.ones(2)}, metadata={"a": 1})
    with open(good, "rb") as fh:
        data = fh.read()
    trunc = os.path.join(tmp_path, "trunc.npz")
    with open(trunc, "wb") as fh:
        fh.write(data[: len(data) // 2])
    with pytest.raises(ValueError, match=r"trunc\.npz.*corrupt"):
        ckpt.load_checkpoint(trunc, device="cpu")


def test_params_from_numpy_keeps_structure_and_lists():
    tree = {"a": [np.ones((2,), np.float32), {"b": np.arange(3)}],
            "c": np.float32(2.0)}
    got = params_from_numpy(tree, "cpu")
    assert isinstance(got["a"], list) and got["a"][1]["b"].dtype == \
        torch.int64
    assert got["c"].shape == () and got["c"].item() == 2.0


def test_weights_default_to_the_gpu(tmp_path):
    """Without ``device=`` weights go to the GPU, and without one the load
    raises rather than landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default is usable")
    path = os.path.join(tmp_path, "w.npz")
    ckpt.save_checkpoint(path, {"w": torch.ones(2)}, metadata={"a": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.ones(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.load_checkpoint(path)


@pytest.fixture(scope="module")
def per_block():
    """Jittered reduced experts with per-block adaLN-Zero
    (``adaln_single=False``), carried across to both packages."""
    cfg = dit_b2(adaln_single=False).reduced(latent_size=8)
    experts = [jittered_numpy_params(cfg, 20 + i) for i in range(3)]
    return dict(jcfg=j_dit_b2(adaln_single=False).reduced(latent_size=8),
                cfg=cfg,
                jexperts=[jax.tree.map(jnp.asarray, p) for p in experts],
                experts=[params_from_numpy(p, "cpu") for p in experts])


def test_per_block_adaln_init_has_the_reference_structure(per_block):
    got = tree_map(lambda a: a.numpy(), D.init(
        per_block["cfg"], torch.Generator().manual_seed(0)))
    want = jax.eval_shape(lambda k: JD.init(per_block["jcfg"], k),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert "adaln_per_block" in got and "adaln_single" not in got
    assert not got["adaln_per_block"]["w"].any()        # adaLN-Zero


@pytest.mark.parametrize("text_mode", ["text", "drop_mask"])
def test_per_block_adaln_dense_apply_matches_jax(per_block, text_mode):
    cfg = per_block["cfg"]
    x, t, text = _inputs(cfg, 3, seed=4)
    kw = {"text_emb": text}
    if text_mode == "drop_mask":
        kw["drop_mask"] = np.array([True, False, True])
    want = np.asarray(JD.apply(per_block["jcfg"], per_block["jexperts"][0],
                               x, t, **kw))
    got = D.apply(cfg, per_block["experts"][0], torch.from_numpy(x),
                  torch.from_numpy(t),
                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_per_block_adaln_ragged_apply_matches_jax(per_block, g):
    """One ragged modulation GEMM per layer from ``silu(τ)``, over the
    stacked experts' ``adaln_per_block`` leaves."""
    cfg = per_block["cfg"]
    pe = np.array([1, 2, 0, 1], np.int32)
    x, t, _ = _inputs(cfg, len(pe), seed=5)
    rng = np.random.default_rng(6)
    cond_np = {"text_emb": rng.standard_normal(
        (len(pe), g, cfg.text_len, cfg.text_dim)).astype(np.float32)}
    if g == 2:
        cond_np["drop_mask"] = np.broadcast_to([False, True], (len(pe), 2))
    jview = JDense.from_stacked(
        JD.stack_expert_params(per_block["jexperts"])).ragged_view()
    want = np.asarray(jax.jit(JD.make_ragged_expert_apply(per_block["jcfg"]),
                              static_argnums=5)(
        jview, x, t, {k: jnp.asarray(v) for k, v in cond_np.items()},
        jnp.asarray(pe), g))
    view = D.stack_expert_params(per_block["experts"])
    got = D.make_ragged_expert_apply(cfg)(
        view, torch.from_numpy(x), torch.from_numpy(t),
        {k: torch.from_numpy(np.array(v)) for k, v in cond_np.items()},
        torch.from_numpy(pe), g)
    assert got.shape == (len(pe) * g,) + x.shape[1:]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
