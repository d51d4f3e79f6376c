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
is compared at ``max |Δ| ≤ 1e-6 · max |out|``; the velocity, flag-form
fuse and dequant kernels bitwise.  The AdaLN and attention kernels sum
float32 in another order than ATen (and the attention kernel's online
softmax rescales as it goes): float32 outputs at ``rtol = atol = 1e-5``;
bf16 outputs, rounded once from float32 on both sides, within one bf16
ulp (``rtol = 2⁻⁷``).  The SSD scan kernel computes the chunked algorithm
against its sequential plain version: ``max |Δ| ≤ 5e-5 · max |want|`` for
float32 y and the state (every decay factor ``exp(cum_i − cum_j)`` comes
from float32 cumulative log-decays reaching |cum| ≈ 200 over a chunk, an
ulp of which, 1.5e-5, is the factor's relative error; three of those),
one bf16 ulp (``2⁻⁷``) of max|y| for bf16 y.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.core import param_store
from repro_torch.core.conversion import velocity_scale
from repro_torch.core.schedules import get_schedule
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


@pytest.mark.parametrize("p,m,d,f,offset", [
    (5, 130, 16, 770, 0),     # ragged edges on every axis
    (3, 7, 3, 5, 0),          # smaller than one tile
    (16, 512, 768, 3072, 0),  # MLP up-projection
    (16, 256, 16, 768, 0),    # patch embedding: D shallower than k32
    (16, 512, 768, 768, 0),   # attention projections, layers 1..
    (16, 256, 768, 768, 0),   # attention projections, layer 0
    (16, 512, 768, 16, 0),    # final layer: F narrower than a tile
    (4, 64, 48, 96, 0),       # D = 48: a part of one slab
    (4, 64, 64, 96, 1),       # x one byte off its allocation
    (16, 1, 768, 3072, 0),    # one row per group
])
@pytest.mark.parametrize("qdtype", [torch.int8, torch.float8_e4m3fn],
                         ids=["int8", "fp8"])
def test_quantized_ragged_gemm_kernel_matches_plain(cuda, qdtype, p, m, d, f,
                                                    offset):
    """The int8/fp8 bodies called directly (any m, ragged edges on every
    axis, the serving widths, an x at an odd address), with one group
    routed to a bad expert id: its rows are NaN."""
    gen = torch.Generator(device=cuda).manual_seed(p + m + d)
    k = 6
    x = torch.randn(p * m, d, generator=gen, device=cuda)
    w = torch.randn(k, d, f, generator=gen, device=cuda)
    xq, xs = ops.quantize_rows(x, qdtype)
    if offset:
        buf = torch.empty(xq.numel() + offset, dtype=qdtype, device=cuda)
        buf[offset:] = xq.reshape(-1)
        xq = buf[offset:].view(xq.shape)
        assert xq.is_contiguous() and xq.data_ptr() % 16 == offset
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


@pytest.mark.parametrize("operand", ["x", "w"])
def test_fp8_body_widens_every_e4m3_value_exactly(cuda, operand):
    """The fp8 body widens e4m3 to bf16 as it stages a tile: every finite
    e4m3 value (subnormals and -0 too), in the activations or in the
    weights, contracted against an identity comes out exact; a NaN stays
    NaN along its row (x) or column (w)."""
    codes = torch.arange(256, dtype=torch.int32)
    codes[(codes & 0x7F) == 0x7F] = 0                   # the NaN codes
    vals = codes.to(torch.uint8).view(torch.float8_e4m3fn)
    pats = torch.stack([vals.roll(r) for r in range(16)])
    nan_code = torch.tensor([0x7F], dtype=torch.uint8).view(
        torch.float8_e4m3fn)
    eye = torch.eye(256).to(torch.float8_e4m3fn)
    if operand == "x":
        x, w = pats.clone(), eye[None]
        x[3, 5] = nan_code
    else:
        x, w = eye, pats.t().contiguous()[None]
        w[0, 5, 3] = nan_code
    x, w = x.to(cuda), w.to(cuda)
    m = x.shape[0]
    one = torch.ones((), device=cuda)
    got = ragged_gemm(x, w, torch.zeros(1, dtype=torch.int32, device=cuda), m,
                      one.expand(m).contiguous(), one.expand(1).contiguous())
    torch.cuda.synchronize()
    want = x.float() @ w[0].float()
    nan = torch.zeros_like(got, dtype=torch.bool)
    if operand == "x":
        nan[3] = True
    else:
        nan[:, 3] = True
    assert torch.isnan(got[nan]).all() and torch.isnan(want[nan]).all()
    assert torch.equal(got[~nan], want[~nan])


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


# The float32 and bf16 bodies: a cp.async ring of 16-deep slabs, 8×8
# register tiles (a narrow 32-row tile for small m), every product an IEEE
# float32 FFMA summed in ascending k.

def _dense_operands(cuda, p, m, d, f, wdtype, seed, k=6):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(p * m, d, generator=gen, device=cuda)
    w = (torch.randn(k, d, f, generator=gen, device=cuda)
         / d ** 0.5).to(wdtype)
    pe = torch.randint(0, k, (p,), generator=gen, device=cuda,
                       dtype=torch.int32)
    return x, w, pe


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,f", [(768, 3072), (3072, 768), (768, 768),
                                 (768, 4608)],
                         ids=["mlp_up", "mlp_down", "attn", "modulation"])
@pytest.mark.parametrize("m", [1, 7, 154, 256, 512, 513])
def test_dense_body_serving_widths(cuda, m, d, f, wdtype):
    """Every row width the two tiles split between (m 1, 7 and 154 on
    the narrow tile, 256, 512 and 513 on the wide one) at the DiT's
    depths and widths."""
    x, w, pe = _dense_operands(cuda, 8, m, d, f, wdtype, m + d)
    got = ragged_gemm(x, w, pe, m)
    torch.testing.assert_close(got, ref.ref_ragged_gemm(x, w, pe),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,d,f,offset", [
    (130, 201, 300, 0),       # D not a multiple of 4
    (130, 64, 130, 0),        # F not a multiple of 4
    (9, 3, 5, 0),             # smaller than a slab and a tile
    (154, 768, 768, 1),       # x one float off 16-byte alignment
    (513, 96, 264, 3),        # and a partial wide tile
])
def test_dense_body_unaligned_operands(cuda, m, d, f, offset, wdtype):
    """Operands the 16-byte copies cannot take stage element by element
    in the same kernel: the same tiles, the same sums."""
    x, w, pe = _dense_operands(cuda, 5, m, d, f, wdtype, d + f)
    if offset:
        buf = torch.empty(x.numel() + offset, device=cuda)
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(x.shape)
        assert x.data_ptr() % 16 == 4 * offset
    got = ragged_gemm(x, w, pe, m)
    torch.testing.assert_close(got, ref.ref_ragged_gemm(x, w, pe),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 154, 512])
def test_dense_body_layer_view(cuda, m, wdtype):
    """Layer 5 of a ``(K, L, D, F)`` stack: the expert axis strided."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    stack = (torch.randn(4, 12, 768, 768, generator=gen, device=cuda)
             / 768 ** 0.5).to(wdtype)
    w = stack[:, 5]
    assert not w.is_contiguous()
    x = torch.randn(6 * m, 768, generator=gen, device=cuda)
    pe = torch.tensor([3, 3, 0, 1, 2, 0], dtype=torch.int32, device=cuda)
    got = ragged_gemm(x, w, pe, m)
    torch.testing.assert_close(got, ref.ref_ragged_gemm(x, w, pe),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("operand", ["x", "w"])
@pytest.mark.parametrize("m", [1, 154, 512])
def test_dense_body_keeps_inf_and_nan(cuda, m, operand):
    """±Inf and NaN in x or w reach the same outputs, with the same
    signs, as in the plain version; the finite outputs agree."""
    x, w, pe = _dense_operands(cuda, 4, m, 768, 768, torch.float32, 7 * m)
    pe[:] = torch.tensor([0, 1, 0, 2], dtype=torch.int32, device=cuda)
    if operand == "x":
        x[0, 5] = float("inf")
        x[m, 9] = float("-inf")
        x[2 * m - 1, 700] = float("nan")
    else:
        w[0, 5, 17] = float("inf")
        w[1, 9, 300] = float("-inf")
        w[0, 700, 640] = float("nan")
    got = ragged_gemm(x, w, pe, m)
    want = ref.ref_ragged_gemm(x, w, pe)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got).any()
    assert torch.equal(got == float("inf"), want == float("inf"))
    assert torch.equal(got == float("-inf"), want == float("-inf"))
    assert torch.isinf(got).any()
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 154, 512])
def test_dense_body_bad_expert_poisons_only_its_group(cuda, m, wdtype):
    x, w, pe = _dense_operands(cuda, 5, m, 768, 768, wdtype, m)
    pe[1], pe[3] = 6 + 3, -1                      # two bad expert ids
    got = ragged_gemm(x, w, pe, m)
    bad = torch.tensor([False, True, False, True, False],
                       device=cuda).repeat_interleave(m)
    assert torch.isnan(got[bad]).all() and torch.isfinite(got[~bad]).all()
    good = pe.clone()
    good[1] = good[3] = 0
    torch.testing.assert_close(got[~bad], ref.ref_ragged_gemm(
        x, w, good)[~bad], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 154, 512])
def test_dense_body_is_bitwise_deterministic(cuda, m, wdtype):
    """No split-K, no atomics: two launches give the same bits."""
    x, w, pe = _dense_operands(cuda, 16, m, 768, 3072, wdtype, 11)
    first = ragged_gemm(x, w, pe, m)
    assert torch.equal(ragged_gemm(x, w, pe, m), first)


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


F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _close(got, want):
    tol = F32_TOL if want.dtype == torch.float32 else BF16_TOL
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16],
                         ids=["x32", "x16"])
@pytest.mark.parametrize("mdtype", [torch.float32, torch.bfloat16],
                         ids=["mod32", "mod16"])
@pytest.mark.parametrize("shape", [(4, 64, 768), (3, 5, 70)],
                         ids=["vec", "scalar"])
def test_adaln_fuse_strided_and_broadcast_x(cuda, xdtype, mdtype, shape):
    """x as the ragged forward passes it — the ``(P, g, T, d)`` replica
    broadcast of ``(P, T, d)`` (stride 0 on g) — and as a materialized
    slice; γ/β as slices of the ``(P, L, 6, d)`` modulation stack.  D 70
    takes the scalar (unaligned) path."""
    p, t, d = shape
    gen = torch.Generator(device=cuda).manual_seed(d + t)
    base = (3 * torch.randn(p, t, d, generator=gen, device=cuda)
            + 1).to(xdtype)
    mods = (0.3 * torch.randn(p, 12, 6, d, generator=gen, device=cuda)
            ).to(mdtype)
    gamma, beta = mods[:, 4, 0], mods[:, 4, 1]
    assert gamma.stride(0) == 12 * 6 * d
    bcast = base[:, None].expand(p, 2, t, d)
    wide = torch.randn(p, t, 2 * d, generator=gen, device=cuda).to(xdtype)
    for x in (base, bcast, wide[..., :d]):
        for rs in (False, True):
            ops.reset_launches()
            got = ops.adaln_modulate(x, gamma, beta, round_scale=rs)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["adaln_fuse"] == 1
            _close(got, ref.ref_adaln_fuse(x, gamma, beta, round_scale=rs))
        got = ops.layernorm(x)
        _close(got, ref.ref_adaln_fuse(x, None, None))


def test_adaln_fuse_rounds_one_plus_gamma_to_bf16(cuda):
    """bf16 modulations: the DiT's ``1.0 + γ`` rounds to bf16 before the
    multiply; ``round_scale`` gives exactly that product, and without it
    the kernel keeps ``1 + γ`` in float32 as the reference kernel does."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 32, 256, generator=gen, device=cuda)
    gamma = (0.05 * torch.randn(2, 256, generator=gen, device=cuda)
             ).to(torch.bfloat16)
    beta = torch.zeros(2, 256, dtype=torch.bfloat16, device=cuda)
    rounded = ops.adaln_modulate(x, gamma, beta, round_scale=True)
    exact = ops.adaln_modulate(x, gamma, beta)
    y = ref.ref_adaln_fuse(x, None, None)
    torch.testing.assert_close(
        rounded, y * (1.0 + gamma)[:, None].float(), **F32_TOL)
    torch.testing.assert_close(
        exact, y * (1.0 + gamma.float())[:, None], **F32_TOL)
    assert (rounded - exact).abs().max().item() > 1e-3


@pytest.mark.parametrize("s", [256, 64, 100], ids=["S256", "S64", "S100"])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (True, 24), (False, 40)],
                         ids=["full", "causal", "causal_w24", "w40"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_bshd_views(cuda, s, causal, window, dtype):
    """q, k, v as the DiT hands them over: ``(B, S, H, D)`` projections
    seen as ``(B, H, S, D)`` (no transposed copy); S 64 fills one tile,
    S 100 leaves a partial tile.  The output comes back laid out as q."""
    gen = torch.Generator(device=cuda).manual_seed(s + window)
    b, h, d = 3, 4, 64
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=cuda)
               .to(dtype).transpose(1, 2) for _ in range(3))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.transpose(1, 2).is_contiguous()
    _close(got, ref.ref_flash_attention(q, k, v, causal=causal,
                                        window=window))


@pytest.mark.parametrize("d", [16, 72, 128])
def test_flash_attention_head_dims_and_scale(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(2, 3, 128, d, generator=gen, device=cuda)
               for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True, softmax_scale=0.3)
    _close(got, ref.ref_flash_attention(q, k, v, causal=True,
                                        softmax_scale=0.3))


def test_flash_attention_gqa_indexes_kv_heads(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, 8, 192, 32, generator=gen, device=cuda)
    k, v = (torch.randn(2, 2, 192, 32, generator=gen, device=cuda)
            for _ in range(2))
    ops.reset_launches()
    got = ops.flash_attention_gqa(q, k, v, causal=True, window=50)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ref.ref_flash_attention(q, k.repeat_interleave(4, dim=1),
                                   v.repeat_interleave(4, dim=1),
                                   causal=True, window=50)
    _close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [100, 200], ids=["S100", "S200"])
@pytest.mark.parametrize("d", [32, 48, 64, 128, 256])
@pytest.mark.parametrize("causal,window", [(True, 50), (False, 0)],
                         ids=["causal_w50", "full"])
def test_flash_attention_tiles_head_dims_and_gqa(cuda, d, s, causal, window,
                                                 dtype):
    """Sequence lengths that fill no query or kv tile (S 100 and 200 leave
    partial tiles of 64 and 32 rows), every head-dim template (D 48 uses
    D 64's with a partial row), with 4 query heads over 2 kv heads, and
    causal and window masks together."""
    gen = torch.Generator(device=cuda).manual_seed(d + s)
    q = torch.randn(2, 4, s, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, 2, s, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    ops.reset_launches()
    got = ops.flash_attention_gqa(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    _close(got, ref.ref_flash_attention(
        q, k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1),
        causal=causal, window=window))


@pytest.mark.parametrize("k,b,t", [(8, 16, 4096), (3, 5, 4099)])
def test_hetero_fuse_kernel_matches_plain_bitwise(cuda, k, b, t):
    """The flag form: bitwise against its plain version, and against the
    velocity kernel given the matching unified coefficients (FM experts
    as the identity ``(1, 0, 0, 1, 1)``)."""
    gen = torch.Generator(device=cuda).manual_seed(k + t)
    preds = 4 * torch.randn(k, b, t, generator=gen, device=cuda)
    x = 3 * torch.randn(b, t, generator=gen, device=cuda)
    w = torch.rand(b, k, generator=gen, device=cuda)
    objectives = ["ddpm", "ddpm"] + ["fm"] * (k - 2)
    schedules = [get_schedule("cosine" if o == "ddpm" else "linear")
                 for o in objectives]
    tb = torch.rand(b, generator=gen, device=cuda)
    tb[0] = 0.999                           # alpha below alpha_min
    ops.reset_launches()
    got = ops.fused_convert_and_fuse(preds, x, w, objectives, schedules, tb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["hetero_fuse"] == 1
    ddpm = torch.tensor([o == "ddpm" for o in objectives], device=cuda)
    alpha = torch.stack([s.alpha(tb) for s in schedules])
    sigma = torch.stack([s.sigma(tb) for s in schedules])
    dalpha = torch.stack([s.dalpha(tb) for s in schedules])
    dsigma = torch.stack([s.dsigma(tb) for s in schedules])
    vs = velocity_scale(tb, "piecewise")
    vscale = torch.where(ddpm[:, None], vs[None], 1.0)
    want = ref.ref_hetero_fuse(preds, x, w, ddpm, alpha, sigma, dalpha,
                               dsigma, vscale)
    assert torch.equal(got, want)
    ident = torch.tensor([1.0, 0.0, 0.0, 1.0, 1.0], device=cuda)
    coef = torch.stack([alpha, sigma, dalpha, dsigma, vscale])
    coef = torch.where(ddpm[None, :, None], coef, ident[:, None, None])
    assert torch.equal(got, ops.fused_velocity(preds, x, w, coef))


@pytest.mark.parametrize("with_text", [True, False], ids=["text", "notext"])
def test_ragged_dit_forward_runs_the_new_kernels(cuda, with_text):
    """The reduced ragged DiT forward on the card: ``3L + 1`` AdaLN
    launches with text (msa, cross-attention LayerNorm, mlp per layer,
    final layer; ``2L + 1`` without), ``L`` attention launches, and the
    latents of its CPU run within ``1e-4 · max|out|``."""
    from repro_torch.core.param_store import make_store
    from repro_torch.models import dit as D
    from repro_torch.models.config import dit_b2
    from repro_torch.tree import tree_map

    cfg = dit_b2().reduced(latent_size=16, use_text=with_text)
    gen = torch.Generator().manual_seed(3)
    experts = [tree_map(lambda a: a + 0.02 * torch.randn(
        a.shape, generator=gen), D.init(cfg, gen)) for _ in range(3)]
    store = make_store(D.stack_expert_params(experts), dtype="native")
    x = torch.randn(4, 16, 16, 4, generator=gen)
    t = torch.rand(4, generator=gen)
    cond = ({"text_emb": torch.randn(4, 2, cfg.text_len, cfg.text_dim,
                                     generator=gen)} if with_text else {})
    pe = torch.tensor([0, 2, 1, 2])
    fwd = D.make_ragged_expert_apply(cfg)
    want = fwd(store.ragged_view(), x, t, cond, pe, 2)
    card = make_store(D.stack_expert_params(
        [tree_map(lambda a: a.to(cuda), e) for e in experts]), dtype="native")
    ops.reset_launches()
    got = fwd(card.ragged_view(), x.to(cuda), t.to(cuda),
              {n: a.to(cuda) for n, a in cond.items()}, pe.to(cuda), 2)
    torch.cuda.synchronize()
    layers = cfg.num_layers
    assert ops.LAUNCHES["adaln_fuse"] == (3 if with_text else 2) * layers + 1
    assert ops.LAUNCHES["flash_attention"] == layers
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


SSD_REL = 5e-5


def _ssd_views(cuda, b, h, s, p, n, dtype, seed, dt_shift=-2.0):
    """The mixer's layout: x, B, C strided slices of one ``(b, s, h·p + 2n)``
    buffer, dt ``(b, s, h)`` float32 = softplus(N + shift), A from
    ``−linspace(1, 16, h)`` (``A_log`` up to log 16); x and dt returned as
    the kernel's ``(B, H, S, ·)`` views."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    xbc = torch.randn(b, s, h * p + 2 * n, generator=gen,
                      device=cuda).to(dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p).transpose(1, 2)
    B = xbc[..., h * p:h * p + n]
    C = xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=cuda) + dt_shift)
    A = -torch.linspace(1.0, 16.0, h, device=cuda)
    return x, dt.transpose(1, 2), A, B, C


def _ssd_check(x, dt, A, B, C, chunk):
    ops.reset_launches()
    y, state = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == 1
    wy, ws = ref.ref_ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), A, B,
                              C)
    assert y.dtype == x.dtype and state.dtype == torch.float32
    assert y.transpose(1, 2).is_contiguous()       # laid out (B, S, H, P)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    rel = SSD_REL if x.dtype == torch.float32 else 2.0 ** -7
    err = (y.transpose(1, 2).float() - wy.float()).abs().max().item()
    assert err <= rel * wy.float().abs().max().item(), err
    serr = (state - ws).abs().max().item()
    assert serr <= SSD_REL * ws.abs().max().item(), serr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (2, 8, 512, 64, 128, 128),      # mamba2-2.7b head shape, 4 chunks
    (1, 4, 100, 64, 128, 128),      # S < chunk: one partial tile
    (2, 3, 64, 32, 16, 16),         # the reduced config's shape
    (1, 2, 48, 8, 32, 8),           # small head and state, chunk 8
])
def test_ssd_scan_kernel_matches_plain(cuda, dtype, b, h, s, p, n, chunk):
    _ssd_check(*_ssd_views(cuda, b, h, s, p, n, dtype, seed=s + p),
               chunk=chunk)


def test_ssd_scan_kernel_masks_before_exp(cuda):
    """dt near softplus(10) with A down to −16: above the diagonal
    ``exp(cum_i − cum_j)`` overflows, and the kernel must select, not
    multiply by a mask (``inf · 0 = NaN``)."""
    _ssd_check(*_ssd_views(cuda, 1, 16, 256, 64, 128, torch.float32, seed=7,
                           dt_shift=10.0), chunk=128)


def test_ssd_scan_rejects_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C = _ssd_views(cuda, 1, 2, 48, 16, 8, torch.float32, 1)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd_scan(x, dt, A, B, C, chunk=32)
    with pytest.raises(ValueError, match="at most"):
        ops.ssd_scan(*_ssd_views(cuda, 1, 2, 16, 128, 8, torch.float32, 1),
                     chunk=16)
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssd_scan(x, dt, A, B.to(torch.bfloat16), C, chunk=16)


def test_mamba2_forward_runs_the_scan_kernel(cuda):
    """The reduced Mamba2 backbone on the card: one ``ssd_scan`` launch per
    layer of ``forward_train`` and ``prefill``, none in ``decode_step``;
    logits within ``1e-4 · max|out|`` of the CPU run, and prefill followed
    by a decode step reproduces ``forward_train``'s next logits."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.tree import tree_map

    cfg = get_config("mamba2-2.7b").reduced()
    params = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    want, _ = zoo.forward_train(cfg, params, {"tokens": toks})
    card = tree_map(lambda a: a.to(cuda), params)
    ops.reset_launches()
    got, _ = zoo.forward_train(cfg, card, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == cfg.num_layers
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    ops.reset_launches()
    last, cache = zoo.prefill(cfg, card, {"tokens": toks[:, :48].to(cuda)})
    assert ops.LAUNCHES["ssd_scan"] == cfg.num_layers
    step, _ = zoo.decode_step(cfg, card, cache, toks[:, 48:49].to(cuda),
                              None)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == cfg.num_layers
    for lg, pos in ((last, 47), (step, 48)):
        err = (lg.cpu() - want[:, pos]).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
