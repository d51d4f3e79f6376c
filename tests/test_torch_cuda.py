"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX, so on a GPU
machine without JAX they run with::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: the float32/bf16/fp8 GEMM bodies sum in another order than
cuBLAS/ATen (``rtol = atol = 1e-5`` relative to O(1) operands scaled by
``1/sqrt(D)``; fp8 ``max |Δ| ≤ 1e-5 · max |out|``); the int8 body
accumulates exact integers and applies the plain version's two float32
multiplies, so it is compared bitwise; the step kernel is built without
FMA contraction and matches its plain version's operation order, so it
is compared at ``max |Δ| ≤ 1e-6 · max |out|``; the velocity and dequant
kernels bitwise.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.core import param_store
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ragged_gemm import ragged_gemm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("p,m,d,f", [
    (16, 1, 768, 4608),       # modulation MLP: one row per pair
    (16, 154, 768, 768),      # CFG-doubled text rows (2·77)
    (5, 130, 16, 770),        # ragged edges on every axis
    (3, 7, 3, 5),             # smaller than one tile
])
def test_ragged_gemm_kernel_matches_plain(cuda, p, m, d, f):
    gen = torch.Generator(device=cuda).manual_seed(p * m + f)
    k = 8
    x = torch.randn(p, m, d, generator=gen, device=cuda)
    w = torch.randn(k, d, f, generator=gen, device=cuda) / d ** 0.5
    b = torch.randn(k, f, generator=gen, device=cuda)
    pe = torch.randint(0, k, (p,), generator=gen, device=cuda)
    ops.reset_launches()
    got = ops.ragged_expert_matmul(x, w, pe, bias=b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ragged_gemm"] == 1
    want = ref.ref_ragged_gemm(x.reshape(p * m, d), w, pe).reshape(
        p, m, f) + b[pe][:, None]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p,m,d,f", [(5, 130, 16, 770), (3, 7, 3, 5),
                                     (16, 512, 768, 3072)])
@pytest.mark.parametrize("qdtype", [torch.int8, torch.float8_e4m3fn],
                         ids=["int8", "fp8"])
def test_quantized_ragged_gemm_kernel_matches_plain(cuda, qdtype, p, m, d, f):
    """The int8/fp8 bodies called directly (any m, ragged edges on every
    axis), with one group routed to a bad expert id: its rows are NaN."""
    gen = torch.Generator(device=cuda).manual_seed(p + m + d)
    k = 6
    x = torch.randn(p * m, d, generator=gen, device=cuda)
    w = torch.randn(k, d, f, generator=gen, device=cuda)
    xq, xs = ops.quantize_rows(x, qdtype)
    wq, ws = ops.quantize_rows(w.reshape(k, -1), qdtype)
    wq = wq.reshape(k, d, f)
    pe = torch.randint(0, k, (p,), generator=gen, device=cuda,
                       dtype=torch.int32)
    pe[p // 2] = k + 3                                  # a bad expert id
    got = ragged_gemm(xq, wq, pe, m, xs, ws)
    torch.cuda.synchronize()
    bad = torch.zeros(p, dtype=torch.bool, device=cuda)
    bad[p // 2] = True
    rows = ~bad.repeat_interleave(m)
    assert torch.isnan(got[~rows]).all() and torch.isfinite(got[rows]).all()
    good = pe.clone()
    good[p // 2] = 0
    want = ref.ref_ragged_gemm(xq, wq, good, xs, ws)
    if qdtype == torch.int8:
        assert torch.equal(got[rows], want[rows])
    else:
        err = (got[rows] - want[rows]).abs().max().item()
        assert err <= 1e-5 * want[rows].abs().max().item(), err


@pytest.mark.parametrize("qdtype", [torch.int8, torch.float8_e4m3fn],
                         ids=["int8", "fp8"])
def test_quantized_wrapper_counts_its_path(cuda, qdtype):
    """A tileable width launches the quantized body; a narrow one (2·7
    rows, like the CFG-doubled text) launches the dequant kernel and the
    float32 body — no plain path on the card."""
    k, d, f = 4, 64, 96
    w = torch.randn(k, d, f, device=cuda)
    wq, ws = ops.quantize_rows(w.reshape(k, -1), qdtype)
    wq = wq.reshape(k, d, f)
    pe = torch.tensor([3, 0, 0, 2], device=cuda)
    body = "ragged_gemm_int8" if qdtype == torch.int8 else "ragged_gemm_fp8"
    for mids, want in (((16,), {body: 1}),
                       ((2, 7), {"ragged_gemm": 1,
                                 "hetero_fuse_dequant": 1})):
        x = torch.randn((4,) + mids + (d,), device=cuda)
        ops.reset_launches()
        got = ops.ragged_expert_matmul(x, wq, pe, w_scale=ws)
        torch.cuda.synchronize()
        assert {n: c for n, c in ops.LAUNCHES.items() if c} == want
        cpu = ops.ragged_expert_matmul(x.cpu(), wq.cpu(), pe.cpu(),
                                       w_scale=ws.cpu())
        err = (got.cpu() - cpu).abs().max().item()
        assert err <= 1e-5 * cpu.abs().max().item(), err


def test_bf16_weight_body_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(6, 130, 200, generator=gen, device=cuda)
    w = (torch.randn(4, 200, 300, generator=gen, device=cuda)
         / 200 ** 0.5).to(torch.bfloat16)
    pe = torch.tensor([1, 1, 0, 3, 2, 0], device=cuda)
    ops.reset_launches()
    got = ops.ragged_expert_matmul(x, w, pe)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ragged_gemm"] == 1
    want = ref.ref_ragged_gemm(x.reshape(-1, 200), w, pe).reshape(got.shape)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_ragged_gemm_kernel_strided_expert_axis(cuda):
    stack = torch.randn(4, 3, 64, 96, device=cuda)
    x = torch.randn(6, 10, 64, device=cuda)
    pe = torch.tensor([3, 3, 0, 1, 2, 0], device=cuda)
    got = ops.ragged_expert_matmul(x, stack[:, 2], pe)
    want = torch.stack([x[i] @ stack[pe[i], 2] for i in range(6)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_ragged_gemm_bad_expert_id_poisons_rows(cuda):
    x = torch.ones(2, 4, 8, device=cuda)
    w = torch.ones(2, 8, 3, device=cuda)
    got = ops.ragged_expert_matmul(x, w, torch.tensor([1, 5], device=cuda))
    assert torch.isfinite(got[0]).all() and torch.isnan(got[1]).all()


def test_ragged_gemm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(2, 4, 8, device=cuda)
    with pytest.raises(NotImplementedError):
        ops.ragged_expert_matmul(x, torch.randn(2, 8, 3, device=cuda,
                                                dtype=torch.float64),
                                 torch.tensor([0, 1], device=cuda))
    with pytest.raises(ValueError):
        ops.ragged_expert_matmul(x, torch.randn(2, 8, 3),
                                 torch.tensor([0, 1], device=cuda))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("per_row_dt", [False, True], ids=["dt1", "dtB"])
def test_hetero_fuse_step_kernel_matches_plain(cuda, g, per_row_dt):
    gen = torch.Generator(device=cuda).manual_seed(g + 2 * per_row_dt)
    k, b, t = 2, 8, 4096 + 3
    preds = 4 * torch.randn(k, g, b, t, generator=gen, device=cuda)
    x = 3 * torch.randn(b, t, generator=gen, device=cuda)
    w = torch.rand(g, b, k, generator=gen, device=cuda)
    coef = 1.5 * torch.rand(5, k, g, b, generator=gen, device=cuda)
    coef[0, 0] = 0.001                      # alpha below alpha_min
    coef[1, 0] = 1.0                        # large x̂0: the clamp bites
    dt = torch.rand(b if per_row_dt else 1, generator=gen, device=cuda)
    kw = dict(cfg_scale=7.5, clamp=20.0, alpha_min=0.01)
    ops.reset_launches()
    got = ops.fused_step(preds.reshape(k, g * b, t), x, w.reshape(g * b, k),
                         coef.reshape(5, k, g * b), dt, g=g, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["hetero_fuse_step"] == 1
    want = ref.ref_hetero_fuse_step(preds, x, w, coef, dt, **kw)
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item(), err


@pytest.mark.parametrize("k,b,t", [(2, 16, 4096), (3, 5, 4099)])
def test_hetero_fuse_coeffs_kernel_matches_plain_bitwise(cuda, k, b, t):
    gen = torch.Generator(device=cuda).manual_seed(k * b)
    preds = 4 * torch.randn(k, b, t, generator=gen, device=cuda)
    x = 3 * torch.randn(b, t, generator=gen, device=cuda)
    w = torch.rand(b, k, generator=gen, device=cuda)
    coef = 1.5 * torch.rand(5, k, b, generator=gen, device=cuda)
    coef[0, 0] = 0.001                      # alpha below alpha_min
    coef[1, 0] = 1.0                        # large x̂0: the clamp bites
    ops.reset_launches()
    got = ops.fused_velocity(preds, x, w, coef)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["hetero_fuse_coeffs"] == 1
    want = ref.ref_hetero_fuse_coeffs(preds, x, w, coef)
    assert torch.equal(got, want)


@pytest.mark.parametrize("qdtype,out", [
    (torch.int8, torch.float32), (torch.float8_e4m3fn, torch.float32),
    (torch.int8, torch.bfloat16), (torch.float8_e4m3fn, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(8, 768, 3072), (3, 7, 5)],
                         ids=["leaf", "odd"])
def test_hetero_fuse_dequant_kernel_matches_plain_bitwise(cuda, qdtype, out,
                                                          shape):
    gen = torch.Generator(device=cuda).manual_seed(shape[-1])
    leaf = 3 * torch.randn(shape, generator=gen, device=cuda)
    q, s = ops.quantize_rows(leaf.reshape(shape[0], -1), qdtype)
    q = q.reshape(shape)
    ops.reset_launches()
    got = ops.dequant_params(q, s, out_dtype=out)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["hetero_fuse_dequant"] == 1
    assert got.dtype == out and got.shape == q.shape
    want = ref.ref_hetero_fuse_dequant(q.reshape(shape[0], -1), s,
                                       out_dtype=out).reshape(shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantization_on_the_card_is_bitwise_the_cpus(cuda, dtype):
    """Store scales and per-row activation scales divide by qmax exactly
    (a Python-scalar division on the card would multiply by a rounded
    reciprocal), so the card quantizes as the CPU and the reference do."""
    gen = torch.Generator().manual_seed(11)
    leaf = torch.randn(8, 3, 96, 384, generator=gen)
    on_card = param_store.make_store({"w": leaf.to(cuda)}, dtype=dtype)
    on_cpu = param_store.make_store({"w": leaf}, dtype=dtype)
    assert torch.equal(on_card.scales["w"].cpu(), on_cpu.scales["w"])
    assert torch.equal(on_card.qvals["w"].cpu().view(torch.uint8),
                       on_cpu.qvals["w"].view(torch.uint8))
    x = 5 * torch.randn(512, 768, generator=gen)
    qdtype = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[dtype]
    xq_card, xs_card = ops.quantize_rows(x.to(cuda), qdtype)
    xq_cpu, xs_cpu = ops.quantize_rows(x, qdtype)
    assert torch.equal(xs_card.cpu(), xs_cpu)
    assert torch.equal(xq_card.cpu().view(torch.uint8),
                       xq_cpu.view(torch.uint8))
