"""The port's cast and quantized expert stores (fp32/bf16/int8/fp8) against
the JAX package's, on the CPU: the stores, the kernel modules' plain
versions, the ragged GEMM wrapper and the serving slice.

The same numpy leaves, drawn from a seed, go to both packages.  The JAX
side runs its Pallas kernels in interpret mode; for the quantized GEMM it
runs with ``REPRO_FORCE_PALLAS=1``, because with Pallas on the reference
computes another function than its fallback (quantized activations
against quantized weights on widths with a row tile), and that is what
its TPU kernel computes and what the port computes.

Tolerances, each with its reason:

* stores, int8 GEMM, dequant: bitwise (exact integer accumulation; the
  same float32 multiplies in the same order);
* fp8 GEMM, narrow (untiled) widths: float32 sums in another order,
  ``max |Δ| ≤ 1e-5 · max |out|``;
* the serving slice — see ``test_quantized_engine_matches_jax``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import param_store as jps
from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.hetero_fuse import hetero_fuse_dequant as j_dequant
from repro.kernels.ragged_gemm import ragged_gemm as j_ragged_gemm
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro.training import checkpoint as jckpt
from repro_torch.core import param_store as ps
from repro_torch.core.sampling import SamplerConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.tree import tree_leaves, tree_map
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

GEMM_REL = 1e-5
SLICE_REL = 1e-4
QUANT_SLICE_REL = 5e-3
BATCH, STEPS = 4, 4
MIX = [("ddpm", "cosine")] * 2 + [("fm", "linear")] * 6
JAX_DTYPES = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
TORCH_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    """A tensor's or array's raw bits, so float8/bf16 compare exactly."""
    if isinstance(a, torch.Tensor):
        size = a.element_size()
        a = a.contiguous().view({1: torch.uint8, 2: torch.int16,
                                 4: torch.int32}[size]).numpy()
        return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[size])
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def assert_bitwise(got, want):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


def assert_rel(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _stacked_leaves():
    """A stacked tree shaped like the DiT's: a (K, L, D, F) block leaf,
    matrices, a bias, an all-zero leaf (scale 1) and a list."""
    rng = np.random.default_rng(3)
    k = 3
    return {
        "blocks": {"w": (0.3 * rng.standard_normal((k, 2, 24, 40))
                         ).astype(np.float32),
                   "b": rng.standard_normal((k, 2, 40)).astype(np.float32)},
        "proj": {"w": rng.standard_normal((k, 16, 24)).astype(np.float32)},
        "zero": np.zeros((k, 5), np.float32),
        "table": [(50.0 * rng.standard_normal((k, 7, 9))).astype(np.float32),
                  rng.uniform(-1e-3, 1e-3, (k, 11)).astype(np.float32)],
    }


def _stores(dtype):
    leaves = _stacked_leaves()
    jstore = jps.make_store(jax.tree.map(jnp.asarray, leaves), dtype=dtype)
    store = ps.make_store(tree_map(_t, leaves), dtype=dtype)
    return store, jstore


def _pairs(tree, jtree):
    return list(zip(tree_leaves(tree), jax.tree.leaves(jtree)))


@pytest.mark.parametrize("dtype", ["native", "fp32", "bf16", "int8", "fp8"])
def test_make_store_matches_jax_bitwise(dtype):
    store, jstore = _stores(dtype)
    assert store.num_experts == jstore.num_experts == 3
    assert store.nbytes() == jstore.nbytes()
    if dtype in ("int8", "fp8"):
        assert isinstance(store, ps.QuantizedStore)
        assert store.storage == jstore.storage == dtype
        for got, want in _pairs(store.qvals, jstore.qvals):
            assert got.dtype == TORCH_DTYPES[dtype]
            assert_bitwise(got, want)
        for got, want in _pairs(store.scales, jstore.scales):
            assert got.shape == (3,)
            assert_bitwise(got, want)
    else:
        assert store.storage == jstore.storage == dtype
        for got, want in _pairs(store.stacked, jstore.stacked):
            assert_bitwise(got, want)


@pytest.mark.parametrize("dtype", ["int8", "fp8", "bf16"])
def test_store_access_patterns_match_jax_bitwise(dtype):
    """``gather`` (per-sample and 0-d), ``expert``, ``static_slice``,
    ``materialize`` and ``dequant_leaf`` over the ragged view."""
    store, jstore = _stores(dtype)
    idx = np.array([2, 0, 2, 1], np.int32)
    cases = [
        (store.gather(_t(idx)), jstore.gather(jnp.asarray(idx))),
        (store.gather(torch.tensor(1)), jstore.gather(jnp.int32(1))),
        (store.expert(2), jstore.expert(2)),
        (store.static_slice(1, 3).materialize(),
         jstore.static_slice(1, 3).materialize()),
        (store.materialize(torch.bfloat16), jstore.materialize(jnp.bfloat16)),
        (tree_map(ps.dequant_leaf, store.ragged_view()),
         jax.tree.map(jps.dequant_leaf, jstore.ragged_view(),
                      is_leaf=lambda a: isinstance(a, jps.QuantLeaf))),
    ]
    for got, want in cases:
        for g, w in _pairs(got, want):
            assert_bitwise(g, w)


@pytest.mark.parametrize("m,d,f,experts", [
    (16, 32, 128, [0, 0, 2, 2, 3]),       # expert 1 empty
    (8, 48, 256, [1, 1, 1, 0]),
    (32, 19, 128, [3, 0, 2, 1, 2, 0]),    # depth not a multiple of 4
])
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_ref_ragged_gemm_quantized_matches_jax_kernel(qdtype, m, d, f,
                                                      experts):
    rng = np.random.default_rng(m + d)
    k = 4
    pe = np.asarray(experts, np.int32)
    rows = len(pe) * m
    w32 = rng.standard_normal((k, d, f)).astype(np.float32)
    x32 = rng.standard_normal((rows, d)).astype(np.float32)
    wq, ws = jps._quantize_leaf(jnp.asarray(w32),
                                127.0 if qdtype == "int8" else 448.0, qdtype)
    xq, xs = jps._quantize_leaf(jnp.asarray(x32),
                                127.0 if qdtype == "int8" else 448.0, qdtype)
    want_kernel = np.asarray(j_ragged_gemm(
        xq, wq, jnp.asarray(pe), xs, ws, block_m=m, block_f=128,
        interpret=True))
    want_ref = np.asarray(jref.ref_ragged_gemm(xq, wq, jnp.asarray(pe), xs,
                                               ws))
    tq = TORCH_DTYPES[qdtype]
    got = ref.ref_ragged_gemm(_t(_bits(xq)).view(tq), _t(_bits(wq)).view(tq),
                              _t(pe), _t(xs), _t(ws)).numpy()
    if qdtype == "int8":
        assert_bitwise(got, want_kernel)
        assert_bitwise(got, want_ref)
    else:
        assert_rel(got, want_kernel, GEMM_REL)
        assert_rel(got, want_ref, GEMM_REL)


@pytest.mark.parametrize("qdtype,out", [
    ("int8", "float32"), ("fp8", "float32"), ("int8", "bfloat16")])
def test_ref_hetero_fuse_dequant_matches_jax_kernel(qdtype, out):
    rng = np.random.default_rng(len(qdtype) + len(out))
    leaf = (4.0 * rng.standard_normal((5, 2048))).astype(np.float32)
    q, s = jps._quantize_leaf(jnp.asarray(leaf),
                              127.0 if qdtype == "int8" else 448.0, qdtype)
    s = s * jnp.asarray(rng.uniform(0.5, 2.0, (5,)).astype(np.float32))
    want = j_dequant(q, s, out_dtype=jnp.dtype(out), interpret=True)
    got = ref.ref_hetero_fuse_dequant(
        _t(_bits(q)).view(TORCH_DTYPES[qdtype]), _t(s),
        out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    assert_bitwise(got, want)


def _quant_operands(qdtype, mids, seed):
    rng = np.random.default_rng(seed)
    k, p, d, f = 5, 6, 24, 40
    x = rng.standard_normal((p,) + mids + (d,)).astype(np.float32)
    w = rng.standard_normal((k, d, f)).astype(np.float32)
    b = rng.standard_normal((k, f)).astype(np.float32)
    pe = np.asarray([4, 0, 0, 2, 4, 1], np.int32)
    store = ps.make_store({"w": _t(w)}, dtype=qdtype)
    return x, store.qvals["w"], store.scales["w"], b, pe


@pytest.mark.parametrize("mids", [(), (2, 7), (16, 16)],
                         ids=["m1", "m14_text_like", "m256"])
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantized_ragged_expert_matmul_matches_jax_ops(monkeypatch, qdtype,
                                                        mids):
    """Against the reference's wrapper with Pallas on: m = 256 takes the
    quantized kernel (bitwise for int8), m = 1 and m = 14 have no row tile
    and contract dequantized weights in float32."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    x, q, s, b, pe = _quant_operands(qdtype, mids, len(mids))
    jq = jnp.asarray(_bits(q)).view(JAX_DTYPES[qdtype])
    want = np.asarray(jops.ragged_expert_matmul(
        jnp.asarray(x), jq, jnp.asarray(pe), bias=jnp.asarray(b),
        w_scale=jnp.asarray(s.numpy())))
    got = ops.ragged_expert_matmul(_t(x), q, _t(pe), bias=_t(b), w_scale=s)
    assert got.shape == want.shape and got.dtype == torch.float32
    if qdtype == "int8" and mids == (16, 16):
        assert_bitwise(got, want)
    else:
        assert_rel(got.numpy(), want, GEMM_REL)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_narrow_widths_quantize_no_activations(monkeypatch, qdtype):
    """A width without a row tile (m = 1, 14) never quantizes activations:
    it equals the float32 product with dequantized weights, while the
    tileable m = 16 goes through the activation quantizer."""
    calls = []
    real = ops.quantize_rows
    monkeypatch.setattr(ops, "quantize_rows",
                        lambda *a: calls.append(a) or real(*a))
    for mids in [(), (2, 7)]:
        x, q, s, b, pe = _quant_operands(qdtype, mids, 7)
        got = ops.ragged_expert_matmul(_t(x), q, _t(pe), w_scale=s)
        wd = ref.ref_hetero_fuse_dequant(q.reshape(5, -1), s).reshape(q.shape)
        want = torch.einsum("p...d,pdf->p...f", _t(x), wd[_t(pe).long()])
        assert_rel(got.numpy(), want.numpy(), GEMM_REL)
    assert calls == []
    x, q, s, b, pe = _quant_operands(qdtype, (16,), 7)
    ops.ragged_expert_matmul(_t(x), q, _t(pe), w_scale=s)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# The serving slice
# ---------------------------------------------------------------------------


def _numpy_params(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return tree_map(
        lambda a: (a + 0.02 * torch.randn(a.shape, generator=gen)).numpy(),
        D.init(cfg, gen))


def _cfgs():
    """Reduced DiT-B/2 whose 7 text rows make CFG-doubled text groups of
    m = 14 (untiled), as the full width's 2·77 = 154 are."""
    return (dit_b2().reduced(latent_size=8, text_len=7),
            router_b2(num_clusters=8).reduced(latent_size=8),
            j_dit_b2().reduced(latent_size=8, text_len=7),
            j_router_b2(num_clusters=8).reduced(latent_size=8))


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("quant_ensemble"))
    cfg, rcfg, _, _ = _cfgs()
    for i, (obj, sched) in enumerate(MIX):
        jckpt.save_checkpoint(
            os.path.join(path, f"expert{i}.npz"), _numpy_params(cfg, i),
            metadata=jckpt.expert_metadata(
                name=f"e{i}", objective=obj, schedule=sched, cluster_id=i,
                arch=cfg.name))
    jckpt.save_checkpoint(os.path.join(path, "router.npz"),
                          _numpy_params(rcfg, 99), metadata={})
    key = jax.random.PRNGKey(7)
    return dict(
        path=path, key=key,
        text=np.random.default_rng(0).standard_normal(
            (BATCH, cfg.text_len, cfg.text_dim)).astype(np.float32),
        noise=np.asarray(jax.random.normal(key, (BATCH, 8, 8, 4),
                                           dtype=jnp.float32)),
        port={}, jax={})


def _jax_latents(ens, param_dtype):
    if param_dtype not in ens["jax"]:
        _, _, jcfg, jrcfg = _cfgs()
        eng = JServingEngine.from_checkpoint_dir(
            ens["path"], dit_cfg=jcfg, router_cfg=jrcfg,
            sampler=JSamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2),
            param_dtype=param_dtype)
        ens["jax"][param_dtype] = np.asarray(
            eng.generate(ens["key"], ens["text"], BATCH))
    return ens["jax"][param_dtype]


def _port_latents(ens, param_dtype, noise=None):
    if noise is None and param_dtype in ens["port"]:
        return ens["port"][param_dtype]
    cfg, rcfg, _, _ = _cfgs()
    eng = ServingEngine.from_checkpoint_dir(
        ens["path"], dit_cfg=cfg, router_cfg=rcfg,
        sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2),
        param_dtype=param_dtype, device="cpu")
    out = eng.generate(0, ens["text"], BATCH,
                       noise=ens["noise"] if noise is None else noise)
    assert out.shape == (BATCH, 8, 8, 4) and torch.isfinite(out).all()
    if noise is None:
        ens["port"][param_dtype] = out.numpy()
    return out.numpy()


def test_bf16_engine_matches_jax_engine(ensemble):
    """bf16 storage: ``1e-4 · max|latent|``, as native.

    The m = 1 timestep/modulation path multiplies bf16 activations by
    bf16 weights into bf16, so rounding happens op by op.  The port
    rounds where ``jnp`` semantics say (each op, as the JAX engine run
    without jit does); under ``jit`` XLA may keep bf16 intermediates of a
    fusion in float32 (excess precision), which moves the jitted JAX
    engine by ~5e-3 · max|latent| from its own un-jitted run.  So the
    port is held to the un-jitted engine at the native tolerance, and to
    the jitted one within ``1e-2 · max|latent|``.
    """
    got = _port_latents(ensemble, "bf16")
    want_jit = _jax_latents(ensemble, "bf16")
    assert_rel(got, want_jit, 1e-2)
    with jax.disable_jit():
        _, _, jcfg, jrcfg = _cfgs()
        eng = JServingEngine.from_checkpoint_dir(
            ensemble["path"], dit_cfg=jcfg, router_cfg=jrcfg,
            sampler=JSamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2,
                                   param_dtype="bf16"))
        want = np.asarray(eng.generate(ensemble["key"], ensemble["text"],
                                       BATCH))
    assert_rel(got, want, SLICE_REL)


@pytest.mark.parametrize("param_dtype", ["int8", "fp8"])
def test_quantized_engine_matches_jax(monkeypatch, ensemble, param_dtype):
    """int8/fp8 storage against the JAX engine under
    ``REPRO_FORCE_PALLAS=1``: ``max |Δ| ≤ 5e-3 · max|latent|``.

    Every op of the slice matches the reference to float32 rounding
    (the quantized GEMM bitwise for int8), but activations are quantized
    per row before each tiled GEMM, and an ulp-level difference upstream
    (attention sums, cuBLAS-free CPU GEMMs in another order) can flip one
    activation's rounding: one quantum is ~1/127 (int8) or ~1/16 (fp8) of
    its value, and CFG 7.5 amplifies it over the 4 steps.  Measured: the
    port differs from the reference by 8.3e-4 (int8) and 1.7e-3 (fp8) of
    max|latent|; the port against itself with the starting noise moved by
    2 ulp differs by the same order (1.2e-3 for fp8 after 3 steps), and
    so does the reference's forward against itself under a 2-ulp input
    change (3.4e-3 for int8).  Without flips (fp8, 1 or 2 steps) the two
    agree to 1.3e-6.  5e-3 allows a few flips and stays under 1e-2.

    The quantized latents also differ from each package's own dense
    latents by about the same amount.
    """
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    want = _jax_latents(ensemble, param_dtype)
    got = _port_latents(ensemble, param_dtype)
    assert_rel(got, want, QUANT_SLICE_REL)
    monkeypatch.delenv("REPRO_FORCE_PALLAS")
    jax_shift = np.abs(want - _jax_latents(ensemble, "native")).max()
    port_shift = np.abs(got - _port_latents(ensemble, "native")).max()
    # quantization itself moves the latents far more than the tolerance
    assert jax_shift > 2 * QUANT_SLICE_REL * np.abs(want).max()
    assert 0.5 <= port_shift / jax_shift <= 2.0, (port_shift, jax_shift)


def test_quantized_store_replaces_the_expert_list(ensemble):
    cfg, rcfg, _, _ = _cfgs()
    eng = ServingEngine.from_checkpoint_dir(
        ensemble["path"], dit_cfg=cfg, router_cfg=rcfg,
        sampler=SamplerConfig(num_steps=STEPS, top_k=2, param_dtype="fp8"),
        param_dtype="int8", device="cpu")
    assert eng.sampler.param_dtype == "int8"
    assert isinstance(eng.param_store, ps.QuantizedStore)
    assert eng.expert_params is None
    dense = ServingEngine.from_checkpoint_dir(
        ensemble["path"], dit_cfg=cfg, router_cfg=rcfg, device="cpu")
    ratio = dense.param_store.nbytes() / eng.param_store.nbytes()
    assert 3.5 < ratio <= 4.0, ratio


def test_quantized_full_strategy_raises_as_the_reference_does(ensemble):
    cfg, rcfg, jcfg, jrcfg = _cfgs()
    with pytest.raises(ValueError, match="param_dtype='int8'"):
        JServingEngine.from_checkpoint_dir(
            ensemble["path"], dit_cfg=jcfg, router_cfg=jrcfg,
            sampler=JSamplerConfig(strategy="full"), param_dtype="int8")
    with pytest.raises(ValueError, match="param_dtype='int8'"):
        ServingEngine.from_checkpoint_dir(
            ensemble["path"], dit_cfg=cfg, router_cfg=rcfg,
            sampler=SamplerConfig(strategy="full"), param_dtype="int8",
            device="cpu")
