"""Parity of the port's kernel modules (plain versions, on the CPU) with
the JAX package's kernels.

The same numpy inputs, drawn from a seed, go through the JAX kernel (in
Pallas interpret mode, or through its CPU wrapper) and through the port's
plain PyTorch version.  The CUDA kernels themselves are held against
these plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

Tolerances:

* ragged GEMM — float32 products whose summation order differs between
  XLA and PyTorch: ``rtol = atol = 1e-5``;
* step kernel — elementwise float32 with a K-term sum, where the CFG
  combine ``u_u + 7.5·(u_c − u_u)`` amplifies rounding of the two
  branches (XLA may contract ``a·b + c`` into one FMA, PyTorch on the CPU
  does not): ``max |Δ| ≤ 1e-6 · max |out|``, relative to the output's
  scale.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.hetero_fuse import hetero_fuse_step as j_hetero_fuse_step
from repro.kernels.ragged_gemm import ragged_gemm as j_ragged_gemm
from repro_torch.core.schedules import get_schedule
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.hetero_fuse import (hetero_fuse_coeffs,
                                             hetero_fuse_step)
from repro_torch.kernels.ragged_gemm import ragged_gemm_fp8_variant

GEMM_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_REL = 1e-6


def assert_step_close(got, want):
    err = np.abs(got - want).max()
    assert err <= STEP_REL * np.abs(want).max(), (err, np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m,d,f,experts", [
    (16, 32, 128, [0, 0, 2, 2, 3]),       # expert 1 empty
    (8, 48, 256, [1, 1, 1, 0]),
    (32, 16, 128, [3, 0, 2, 1, 2, 0]),
])
def test_ref_ragged_gemm_matches_jax_kernel(m, d, f, experts):
    rng = np.random.default_rng(m * 7 + d)
    k = 4
    pe = np.asarray(experts, np.int32)
    x = rng.standard_normal((len(pe) * m, d)).astype(np.float32)
    w = rng.standard_normal((k, d, f)).astype(np.float32)
    want_kernel = np.asarray(j_ragged_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(pe),
        block_m=m, block_f=128, interpret=True))
    want_ref = np.asarray(jref.ref_ragged_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(pe)))
    got = ref.ref_ragged_gemm(_t(x), _t(w), _t(pe)).numpy()
    np.testing.assert_allclose(got, want_kernel, **GEMM_TOL)
    np.testing.assert_allclose(got, want_ref, **GEMM_TOL)


@pytest.mark.parametrize("mids", [(), (2, 7), (16, 16)],
                         ids=["m1", "m14_text_like", "m256"])
def test_ragged_expert_matmul_matches_jax_ops(mids):
    """Every group width goes through the same path: m = 1 (timestep and
    modulation MLPs), a non-multiple of 8 (CFG-doubled text rows) and a
    token-wide group."""
    rng = np.random.default_rng(len(mids) + 3)
    k, p, d, f = 5, 6, 24, 40
    x = rng.standard_normal((p,) + mids + (d,)).astype(np.float32)
    w = rng.standard_normal((k, d, f)).astype(np.float32)
    b = rng.standard_normal((k, f)).astype(np.float32)
    pe = np.asarray([4, 0, 0, 2, 4, 1], np.int32)
    want = np.asarray(jops.ragged_expert_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(pe), bias=jnp.asarray(b)))
    got = ops.ragged_expert_matmul(_t(x), _t(w), _t(pe), bias=_t(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **GEMM_TOL)


def test_ragged_expert_matmul_takes_a_strided_expert_axis():
    """One layer of a ``(K, L, D, F)`` stack is a strided ``(K, D, F)``
    view — what the DiT's ragged forward hands the wrapper."""
    rng = np.random.default_rng(5)
    stack = _t(rng.standard_normal((3, 2, 8, 12)).astype(np.float32))
    x = _t(rng.standard_normal((4, 5, 8)).astype(np.float32))
    pe = torch.tensor([2, 0, 1, 2])
    got = ops.ragged_expert_matmul(x, stack[:, 1], pe)
    want = torch.stack([x[i] @ stack[pe[i], 1] for i in range(4)])
    torch.testing.assert_close(got, want, **GEMM_TOL)


def _step_inputs(g, per_row_dt, seed=0, k=2):
    rng = np.random.default_rng(seed + 10 * g + per_row_dt
                                + (0 if k == 2 else 100 * k))
    b, t = 3, 256
    preds = (4.0 * rng.standard_normal((k, g, b, t))).astype(np.float32)
    x = (3.0 * rng.standard_normal((b, t))).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (g, b, k)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    coef = rng.uniform(-1.5, 1.5, (5, k, g, b)).astype(np.float32)
    coef[0, 0] = 0.001            # alpha below alpha_min: the safe floor
    coef[1, 0] = 1.0              # with x/alpha large: the ±clamp bites
    if k > 1:                     # slot 1 an FM expert: the identity
        coef[:, 1] = np.array([1, 0, 0, 1, 1], np.float32)[:, None, None]
    dt = (rng.uniform(0.01, 0.2, (b,)) if per_row_dt
          else np.array([0.125])).astype(np.float32)
    return preds, x, w, coef, dt


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("per_row_dt", [False, True], ids=["dt1", "dtB"])
def test_ref_hetero_fuse_step_matches_jax_kernel(g, per_row_dt, k):
    preds, x, w, coef, dt = _step_inputs(g, per_row_dt, k=k)
    kw = dict(cfg_scale=7.5, clamp=20.0, alpha_min=0.01)
    want = np.asarray(j_hetero_fuse_step(
        *(jnp.asarray(a) for a in (preds, x, w, coef, dt)),
        interpret=True, **kw))
    got = ref.ref_hetero_fuse_step(
        *(_t(a) for a in (preds, x, w, coef, dt)), **kw).numpy()
    # the clamp is exercised, not vacuous
    x0 = (x[None] - coef[1, 0, :, :, None] * preds[0]) / 0.01
    assert (np.abs(x0) > 20.0).any()
    assert_step_close(got, want)


@pytest.mark.parametrize("g", [1, 2])
def test_fused_step_matches_jax_ops(g):
    """The wrapper's latent reshapes around the step kernel: ``(K, G·B,
    H, W, C)`` predictions and a 0-d ``dt``."""
    rng = np.random.default_rng(g)
    k, b, lat = 2, 4, (4, 4, 4)
    preds = rng.standard_normal((k, g * b) + lat).astype(np.float32)
    x = rng.standard_normal((b,) + lat).astype(np.float32)
    w = rng.uniform(0, 1, (g * b, k)).astype(np.float32)
    coef = rng.uniform(0.05, 1.5, (5, k, g * b)).astype(np.float32)
    kw = dict(g=g, cfg_scale=7.5 if g == 2 else 1.0, clamp=20.0,
              alpha_min=0.01)
    want = np.asarray(jops.fused_step(
        jnp.asarray(preds), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(coef), jnp.float32(0.25), **kw))
    got = ops.fused_step(_t(preds), _t(x), _t(w), _t(coef),
                         torch.tensor(0.25), **kw)
    assert got.shape == x.shape
    assert_step_close(got.numpy(), want)


def test_cpu_wrappers_launch_no_kernel():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    ops.reset_launches()
    x = torch.randn(2, 3, 4)
    ops.ragged_expert_matmul(x, torch.randn(2, 4, 5), torch.tensor([0, 1]))
    xw = torch.randn(2, 8, 4)                      # a tileable width
    for qdtype in (torch.int8, torch.float8_e4m3fn):
        ops.ragged_expert_matmul(xw, torch.ones(2, 4, 5).to(qdtype),
                                 torch.tensor([0, 1]), w_scale=torch.ones(2))
    ops.fused_step(torch.randn(1, 2, 3), torch.randn(2, 3),
                   torch.ones(2, 1), torch.ones(5, 1, 2), torch.tensor(0.1),
                   g=1)
    ops.fused_velocity(torch.randn(1, 2, 3), torch.randn(2, 3),
                       torch.ones(2, 1), torch.ones(5, 1, 2))
    ops.dequant_params(torch.ones(2, 3, dtype=torch.int8), torch.ones(2))
    h = torch.randn(2, 5, 8)
    ops.adaln_modulate(h, torch.zeros(2, 8), torch.zeros(2, 8))
    ops.layernorm(h)
    ops.flash_attention(*(torch.randn(1, 2, 5, 4) for _ in range(3)))
    ops.flash_attention_gqa(torch.randn(1, 2, 5, 4),
                            *(torch.randn(1, 1, 5, 4) for _ in range(2)))
    ops.fused_convert_and_fuse(torch.randn(2, 2, 3), torch.randn(2, 3),
                               torch.ones(2, 2), ["ddpm", "fm"],
                               [get_schedule("cosine"),
                                get_schedule("linear")], torch.rand(2))
    ops.ssd_scan(torch.randn(1, 2, 4, 3), torch.rand(1, 2, 4),
                 -torch.ones(2), torch.randn(1, 4, 5), torch.randn(1, 4, 5),
                 chunk=2)
    hg = h.clone().requires_grad_(True)           # the training path
    xg = torch.randn(1, 2, 4, 3, requires_grad=True)
    (ops.adaln_modulate(hg, torch.zeros(2, 8), torch.zeros(2, 8)).sum()
     + ops.layernorm(hg).sum()
     + ops.flash_attention(hg[:, None], hg[:, None], hg[:, None],
                           causal=False).sum()
     + ops.ssd_scan(xg, torch.rand(1, 2, 4), -torch.ones(2),
                    torch.randn(1, 4, 5), torch.randn(1, 4, 5),
                    chunk=2)[0].sum()).backward()
    assert hg.grad is not None and xg.grad is not None
    assert set(ops.LAUNCHES) == {
        "ragged_gemm", "ragged_gemm_int8", "ragged_gemm_fp8",
        "hetero_fuse_step", "hetero_fuse_coeffs", "hetero_fuse_dequant",
        "hetero_fuse", "adaln_fuse", "flash_attention", "ssd_scan",
        "adaln_fuse_bwd", "flash_attention_bwd", "ssd_scan_bwd"}
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_quantized_weights_raise_not_implemented():
    """Only the stores' weight dtypes are served: float32, bf16, int8 and
    e4m3 (with their scales).  Any other raises, and a quantized weight
    without its scales is an error."""
    for dtype in (torch.float64, torch.float8_e5m2):
        with pytest.raises(NotImplementedError, match="not served"):
            ops.ragged_expert_matmul(torch.randn(1, 2, 4),
                                     torch.zeros(1, 4, 3, dtype=dtype),
                                     torch.tensor([0]))
    with pytest.raises(ValueError, match="w_scale"):
        ops.ragged_expert_matmul(torch.randn(1, 2, 4),
                                 torch.zeros(1, 4, 3, dtype=torch.int8),
                                 torch.tensor([0]))


def test_library_name_covers_source_headers_and_flags(tmp_path, monkeypatch):
    """A kernel library's file name hashes its source, every shared header
    of ``csrc/`` and the flags: an edited header never loads a stale
    build."""
    src, header = tmp_path / "k.cu", tmp_path / "hopper.cuh"
    src.write_text('#include "hopper.cuh"\n')
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path(src)
    assert first == _build.library_path(src)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")
    header.write_text("// v2\n")
    second = _build.library_path(src)
    assert second != first
    src.write_text('#include "hopper.cuh"\n// edited\n')
    assert _build.library_path(src) not in (first, second)
    monkeypatch.setitem(_build.EXTRA_FLAGS, "k.cu", ("-fmad=false",))
    assert _build.library_path(src) not in (first, second)


def test_fp8_variant_launcher_checks_its_arguments():
    """The e4m3 variants' launcher takes e4m3 weights and a listed variant,
    and launches on CUDA tensors only."""
    x = torch.zeros(16, 32, dtype=torch.float8_e4m3fn)
    w = torch.zeros(2, 32, 8, dtype=torch.float8_e4m3fn)
    pe = torch.zeros(1, dtype=torch.int32)
    xs, ws = torch.ones(16), torch.ones(2)
    with pytest.raises(TypeError, match="e4m3"):
        ragged_gemm_fp8_variant(x, w.to(torch.int8), pe, 16, xs, ws, 0)
    for bad in (-1, 4):
        with pytest.raises(ValueError, match="variant"):
            ragged_gemm_fp8_variant(x, w, pe, 16, xs, ws, bad)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ragged_gemm_fp8_variant(x, w, pe, 16, xs, ws, 3)


def test_step_launchers_check_their_operands():
    """Off the card the launchers raise before any build, with the checks'
    messages; ``fused_step`` still rejects a ``dt`` of the wrong length."""
    p, x = torch.zeros(2, 2, 3, 8), torch.zeros(3, 8)
    w, c, dt = torch.zeros(2, 3, 2), torch.zeros(5, 2, 2, 3), torch.zeros(1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        hetero_fuse_step(p, x, w, c, dt)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        hetero_fuse_coeffs(p[:, 0], x, w[0], c[:, :, 0])
    with pytest.raises(ValueError, match="dt must be"):
        ops.fused_step(p.reshape(2, 6, 8), x, w.reshape(6, 2),
                       c.reshape(5, 2, 6), torch.zeros(2), g=2)


@pytest.mark.parametrize("k", [1, 3, 8, 9])
@pytest.mark.parametrize("g", [1, 2])
def test_ref_fuse_sums_slots_in_order(g, k):
    """The plain step and velocity versions sum Σ_k w_k v_k from 0 in slot
    order, as the kernel does, at any K (numpy float32, one op at a time,
    bitwise)."""
    preds, x, w, coef, dt = _step_inputs(g, True, k=k)
    kw = dict(cfg_scale=7.5, clamp=20.0, alpha_min=0.01)
    one = np.float32
    fused = []
    for gi in range(g):
        acc = np.zeros_like(x)
        for s in range(k):
            al, sg, da, ds, vs = (coef[i, s, gi][:, None] for i in range(5))
            p = preds[s, gi]
            x0 = (x - sg * p) / np.maximum(al, one(0.01))
            x0 = np.clip(x0, one(-20.0), one(20.0))
            acc = acc + w[gi, :, s][:, None] * ((da * x0 + ds * p) * vs)
        fused.append(acc)
    u = fused[0] if g == 1 else fused[1] + one(7.5) * (fused[0] - fused[1])
    want = x - u * dt[:, None]
    got = ref.ref_hetero_fuse_step(*(_t(a) for a in (preds, x, w, coef, dt)),
                                   **kw).numpy()
    np.testing.assert_array_equal(got, want)
    got = ref.ref_hetero_fuse_coeffs(_t(preds[:, 0]), _t(x), _t(w[0]),
                                     _t(coef[:, :, 0]), clamp=20.0,
                                     alpha_min=0.01).numpy()
    np.testing.assert_array_equal(got, fused[0])


@pytest.mark.parametrize("form", ["float", "0-d", "(1,)", "(B,) float64"])
def test_fused_step_takes_dt_in_every_form(form):
    """``ops.fused_step`` turns a Python float, a 0-d or ``(1,)`` tensor and
    a per-row tensor of another dtype into the kernel's float32 ``(1,)`` or
    ``(B,)`` operand, without changing the result."""
    preds, x, w, coef, dt = _step_inputs(2, form.startswith("(B,)"), k=3)
    k, g, b, t = preds.shape
    arg = {"float": float(dt[0]), "0-d": torch.tensor(dt[0]),
           "(1,)": _t(dt), "(B,) float64": torch.from_numpy(
               dt.astype(np.float64))}[form]
    kw = dict(cfg_scale=7.5, clamp=20.0, alpha_min=0.01)
    got = ops.fused_step(_t(preds).reshape(k, g * b, t), _t(x),
                         _t(w).reshape(g * b, k), _t(coef).reshape(5, k, g * b),
                         arg, g=g, **kw)
    want = ref.ref_hetero_fuse_step(*(_t(a) for a in (preds, x, w, coef, dt)),
                                    **kw)
    assert torch.equal(got, want)
