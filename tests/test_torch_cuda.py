"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX, so on a GPU
machine without JAX they run with::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: the float32/bf16/fp8 GEMM bodies sum in another order than
cuBLAS/ATen (``rtol = atol = 1e-5`` relative to O(1) operands scaled by
``1/sqrt(D)``; fp8 ``max |Δ| ≤ 1e-5 · max |out|``); the int8 body
accumulates exact integers and applies the plain version's two float32
multiplies, so it is compared bitwise; the step and velocity kernels are
built without FMA contraction and keep their plain versions' operation
order (the sum over slots from 0 in slot order), so they are compared
bitwise, as are the flag-form fuse and dequant kernels.  The AdaLN and
attention kernels sum float32 in another order than ATen (and the
attention kernel's online softmax rescales as it goes): float32 outputs
at ``rtol = atol = 1e-5``;
bf16 outputs, rounded once from float32 on both sides, within one bf16
ulp (``rtol = 2⁻⁷``).  The SSD scan kernel computes the chunked algorithm
against its sequential plain version: ``max |Δ| ≤ 5e-5 · max |want|`` for
float32 y and the state (every decay factor ``exp(cum_i − cum_j)`` comes
from float32 cumulative log-decays reaching |cum| ≈ 200 over a chunk, an
ulp of which, 1.5e-5, is the factor's relative error; three of those),
one bf16 ulp (``2⁻⁷``) of max|y| for bf16 y.  The AdaLN and attention
backward kernels (float32) sum in another order than ATen (row sums of
``D`` terms, the ``dγ``/``dβ`` sums over ``G·S`` rows, the attention's
``S``-term products): AdaLN gradients within ``1e-5 · max |want|`` of
their plain version, attention gradients within ``1e-5`` of the largest
of the three; both are bitwise repeatable (no atomics).  The attention
backward in bf16 (causal, windowed, grouped) adds ``BF16_GRAD_REL = 2⁻⁷``
of each gradient's largest: the gradients round once to bf16 and Δ comes
from the forward's bf16-rounded output, against the plain version's
float32 one.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.core import param_store
from repro_torch.core.conversion import velocity_scale
from repro_torch.core.schedules import get_schedule
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import design as flash_design
from repro_torch.kernels.hetero_fuse import (hetero_fuse_coeffs,
                                             hetero_fuse_step)
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


def _offset(a: torch.Tensor, off: int) -> torch.Tensor:
    """``a`` copied into a contiguous view ``off`` floats into its buffer."""
    buf = torch.empty(a.numel() + off, dtype=a.dtype, device=a.device)
    return buf[off:].view(a.shape).copy_(a)


def _step_operands(dev, k, g, b, t, per_row_dt, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    preds = 4 * torch.randn(k, g, b, t, generator=gen, device=dev)
    x = 3 * torch.randn(b, t, generator=gen, device=dev)
    w = torch.rand(g, b, k, generator=gen, device=dev)
    coef = 1.5 * torch.rand(5, k, g, b, generator=gen, device=dev)
    coef[0, 0] = 0.001                      # alpha below alpha_min
    coef[1, 0] = 1.0                        # large x̂0: the clamp bites
    dt = torch.rand(b if per_row_dt else 1, generator=gen, device=dev)
    return preds, x, w, coef, dt


STEP_KW = dict(cfg_scale=7.5, clamp=20.0, alpha_min=0.01)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off1"])
@pytest.mark.parametrize("t", [4096, 4099, 1])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 9])       # 9: the runtime-K loop
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("per_row_dt", [False, True], ids=["dt1", "dtB"])
def test_hetero_fuse_step_kernel_matches_plain(cuda, g, per_row_dt, k, t,
                                               offset):
    b = 8
    preds, x, w, coef, dt = _step_operands(cuda, k, g, b, t, per_row_dt,
                                           k * t + g + 2 * per_row_dt)
    preds, x = _offset(preds, offset), _offset(x, offset)
    ops.reset_launches()
    got = ops.fused_step(preds.reshape(k, g * b, t), x, w.reshape(g * b, k),
                         coef.reshape(5, k, g * b), dt, g=g, **STEP_KW)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["hetero_fuse_step"] == 1
    want = ref.ref_hetero_fuse_step(preds, x, w, coef, dt, **STEP_KW)
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off1"])
@pytest.mark.parametrize("t", [4096, 4099, 1])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 9])
def test_hetero_fuse_coeffs_kernel_matches_plain_bitwise(cuda, k, t, offset):
    b = 16 if t == 4096 else 5
    gen = torch.Generator(device=cuda).manual_seed(k * b + t)
    preds = 4 * torch.randn(k, b, t, generator=gen, device=cuda)
    x = 3 * torch.randn(b, t, generator=gen, device=cuda)
    w = torch.rand(b, k, generator=gen, device=cuda)
    coef = 1.5 * torch.rand(5, k, b, generator=gen, device=cuda)
    coef[0, 0] = 0.001                      # alpha below alpha_min
    coef[1, 0] = 1.0                        # large x̂0: the clamp bites
    preds, x = _offset(preds, offset), _offset(x, offset)
    ops.reset_launches()
    got = ops.fused_velocity(preds, x, w, coef)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["hetero_fuse_coeffs"] == 1
    want = ref.ref_hetero_fuse_coeffs(preds, x, w, coef)
    assert torch.equal(got, want)


def test_hetero_fuse_step_and_coeffs_are_bitwise_deterministic(cuda):
    """No atomics, no order that depends on scheduling: two launches at
    the serving shape give the same bits."""
    preds, x, w, coef, dt = _step_operands(cuda, 2, 2, 8, 4096, False, 3)
    first = hetero_fuse_step(preds, x, w, coef, dt, **STEP_KW)
    assert torch.equal(hetero_fuse_step(preds, x, w, coef, dt, **STEP_KW),
                       first)
    pv, xv = preds.reshape(2, 16, 4096), torch.cat([x, x])
    wv, cv = w.reshape(16, 2), coef.reshape(5, 2, 16)
    first = hetero_fuse_coeffs(pv, xv, wv, cv)
    assert torch.equal(hetero_fuse_coeffs(pv, xv, wv, cv), first)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 72, 128])
def test_flash_attention_head_dims_and_scale(cuda, d, dtype):
    """bf16 at D 16 and 128 runs the tensor-core kernel; bf16 at D 72 (not
    a multiple of 16) and every float32 call run the FFMA template, and
    both match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(2, 3, 128, d, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    tc = dtype == torch.bfloat16 and d % 16 == 0
    assert flash_design(q, k, v) == ("wgmma bf16" if tc else "FFMA")
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
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128, 256])
@pytest.mark.parametrize("causal,window", [(True, 50), (False, 0)],
                         ids=["causal_w50", "full"])
def test_flash_attention_tiles_head_dims_and_gqa(cuda, d, s, causal, window,
                                                 dtype):
    """Sequence lengths that fill no query or kv tile (S 100 and 200 leave
    partial tiles of 64 and 32 rows), every head-dim template of the FFMA
    kernel (float32; D 48 uses D 64's with a partial row) and every width
    of the tensor-core kernel (bf16, D 16–128 by 16: V's 32-, 64- and
    128-byte swizzles; D 256 stays on the FFMA template), with 4 query
    heads over 2 kv heads, and causal and window masks together."""
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


def _plain_lse(q, k, causal, window, scale, prefix=0):
    """Each query row's float32 log-sum-exp of its scaled, masked logits
    (the plain version's logits), ``(B, H, Sq)``; ``k`` of ``Skv`` keys
    (a mask takes ``Sq == Skv``; ``prefix`` opens the pairs below it)."""
    s = q.shape[2]
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    pos = torch.arange(s, device=q.device)
    mask = torch.ones(s, k.shape[2], dtype=torch.bool, device=q.device)
    if causal:
        mask &= (pos[None] <= pos[:, None]) | (
            (pos[None] < prefix) & (pos[:, None] < prefix))
    if window:
        mask &= pos[:, None] - pos[None] < window
    return torch.logsumexp(logits.masked_fill(~mask, -torch.inf), dim=-1)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 256)],
                         ids=["causal", "full", "causal_w256"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 63, 1000, 1024],
                         ids=["S1", "S63", "S1000", "S1024"])
@pytest.mark.parametrize("hq,hkv,d", [
    (32, 32, 80), (16, 8, 128), (32, 8, 64), (32, 32, 64), (32, 32, 128),
    (16, 8, 64), (16, 8, 80), (32, 8, 80), (32, 8, 128)],
    ids=["zamba2_D80", "internlm2_gqa", "32over8_D64", "32_D64", "32_D128",
         "16over8_D64", "16over8_D80", "32over8_D80", "32over8_D128"])
def test_flash_attention_lm_head_shapes(cuda, hq, hkv, d, s, dtype, causal,
                                        window, layout):
    """The LM backbones' attention at their head shapes — zamba2's 32 heads
    of D 80 and internlm2's 16 query heads over 8 kv heads of D 128 — and
    the rest of D 64, 80, 128 × (32, 32), (16, 8), (32, 8) heads; causal,
    full and causal with a window; on ``(B, S, H, D)`` projections seen as
    ``(B, H, S, D)``, as ``transformer.attn_full`` hands them over, and on
    contiguous ``(B, H, S, D)``; S 1, 63 (one partial tile), 1000 (a
    partial last tile) and 1024.  bf16 runs the tensor-core kernel, float32
    the FFMA template; the row log-sum-exp the kernel also writes is held
    against the plain one within ``1e-5`` of its largest magnitude."""
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=cuda).manual_seed(d + s)
    shape = (2, s, hq, d) if layout == "bshd" else (2, hq, s, d)
    q = torch.randn(*shape, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(*shape[:2], hkv, d, generator=gen, device=cuda)
            .to(dtype) if layout == "bshd" else
            torch.randn(2, hkv, s, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    if layout == "bshd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    assert flash_design(q, k, v) == (
        "wgmma bf16" if dtype == torch.bfloat16 else "FFMA")
    ops.reset_launches()
    got = ops.flash_attention_gqa(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    if layout == "bshd":
        assert got.transpose(1, 2).is_contiguous()
    rep = hq // hkv
    kr, vr = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    _close(got, ref.ref_flash_attention(q, kr, vr, causal=causal,
                                        window=window))
    again, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 with_lse=True)
    assert torch.equal(again, got)
    want = _plain_lse(q, kr, causal, window, d ** -0.5)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    err = (lse - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


_FLAG_MIXES = {
    "all_ddpm": lambda k: ["ddpm"] * k,
    "all_fm": lambda k: ["fm"] * k,
    "mixed": lambda k: ["ddpm" if i % 2 == 0 else "fm" for i in range(k)],
}


@pytest.mark.parametrize("b,t", [(16, 4096), (5, 4099)])
@pytest.mark.parametrize("mix", sorted(_FLAG_MIXES))
@pytest.mark.parametrize("k", [1, 2, 3, 8, 12])
def test_hetero_fuse_kernel_matches_plain_bitwise(cuda, k, mix, b, t):
    """The flag form at K 1–8 (slot loops unrolled) and 12 (the runtime
    loop), every flag pattern: bitwise against its plain version, and
    against the velocity kernel given the matching unified coefficients
    (FM experts as the identity ``(1, 0, 0, 1, 1)``)."""
    gen = torch.Generator(device=cuda).manual_seed(k + t)
    preds = 4 * torch.randn(k, b, t, generator=gen, device=cuda)
    x = 3 * torch.randn(b, t, generator=gen, device=cuda)
    w = torch.rand(b, k, generator=gen, device=cuda)
    objectives = _FLAG_MIXES[mix](k)
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


@pytest.mark.parametrize("backend", ["grouped", "gathered", "dense"])
def test_executors_on_the_card_match_the_ragged_executor(cuda, backend):
    """At reduced width on the card, the grouped, gathered and dense
    executors give the ragged executor's top-2 predictions (the dense one
    runs every expert; its unrouted slots weigh exactly 0, so the fused
    velocities are compared): within ``1e-4 · max|out|`` (float32 GEMMs
    in cuBLAS against the ragged kernel, in another order)."""
    from repro_torch.core import dispatch
    from repro_torch.core.conversion import ConversionConfig
    from repro_torch.core.param_store import make_store
    from repro_torch.core.sampling import _cfg_grouped_cond
    from repro_torch.models import dit as D
    from repro_torch.models.config import dit_b2
    from repro_torch.tree import tree_map

    cfg = dit_b2().reduced(latent_size=16)
    gen = torch.Generator().manual_seed(5)
    experts = [tree_map(lambda a: (a + 0.02 * torch.randn(
        a.shape, generator=gen)).to(cuda), D.init(cfg, gen))
        for _ in range(4)]
    store = make_store(D.stack_expert_params(experts), dtype="native")
    b = 4
    x = torch.randn(b, 16, 16, 4, generator=gen).to(cuda)
    tb = torch.full((b,), 0.7).to(cuda)
    text = torch.randn(b, cfg.text_len, cfg.text_dim, generator=gen)
    cond_g = _cfg_grouped_cond({"text_emb": text.to(cuda)},
                               {"text_emb": None}, b)
    w = torch.rand(b, 4, generator=gen).to(cuda)
    conv = ConversionConfig()
    tab = torch.tensor([[1.0], [0.0], [0.0], [1.0], [1.0]]).expand(
        5, 4).contiguous().to(cuda)
    plan = dispatch.make_dispatch_plan(w, 2)
    ragged = dispatch.RaggedExecutor(D.make_ragged_expert_apply(cfg), store,
                                     conv)
    apply_fn = D.make_expert_apply(cfg)
    want = ragged.velocity(plan, x, tb, cond_g, 2, tab)
    if backend == "dense":
        topk, _ = torch.sort(w, dim=-1, descending=True)
        w2 = torch.where(w >= topk[:, 1:2], w, torch.zeros_like(w))
        plan = dispatch.full_dispatch_plan(w2)
        ex = dispatch.DenseExecutor([apply_fn] * 4, experts, conv)
    else:
        ex = dispatch.make_executor(backend, apply_fns=[apply_fn] * 4,
                                    params=experts, stacked_params=store,
                                    conv=conv)
    got = ex.velocity(plan, x, tb, cond_g, 2, tab)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert bool(torch.isfinite(got).all())
    assert err <= 1e-4 * want.abs().max().item(), err


SSD_REL = 5e-5


def _ssd_views(cuda, b, h, s, p, n, dtype, seed, dt_shift=-2.0, skew=0):
    """The mixer's layout: x, B, C strided slices of one ``(b, s, h·p + 2n)``
    buffer (``skew`` leading elements dropped from each row: with an odd
    skew no row is 16-byte aligned), dt ``(b, s, h)`` float32 =
    softplus(N + shift), A from ``−linspace(1, 16, h)`` (``A_log`` up to
    log 16); x and dt returned as the kernel's ``(B, H, S, ·)`` views."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    xbc = torch.randn(b, s, skew + h * p + 2 * n, generator=gen,
                      device=cuda).to(dtype)[..., skew:]
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
    (2, 8, 512, 64, 64, 128),       # zamba2-2.7b head shape: N 64
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("chunk", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("p,n", [(64, 128), (32, 16), (16, 128), (8, 16)])
def test_ssd_scan_kernel_column_groups_and_tiles(cuda, dtype, p, n, chunk):
    """Every column-group and tile edge of the kernel: P 64 fills both of a
    block's column groups of 32 state rows, 32 one, 16 and 8 part of one
    (the rest zero padded); N 128 and 16 (inter slabs of 8 state
    columns); chunks of 8 to 128 positions, one tile each, and 256,
    walked as two tiles of 128; three chunks a sequence (two of 256)."""
    s = 3 * chunk if chunk <= 128 else 2 * chunk
    _ssd_check(*_ssd_views(cuda, 2, 3, s, p, n, dtype, seed=chunk + p + n),
               chunk=chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("p", [64, 36])
def test_ssd_scan_kernel_unaligned_views(cuda, dtype, p):
    """x, B and C rows off 16-byte alignment (an odd skew of the
    projection buffer), and P 36, not a whole number of 16-byte words:
    x, and for P 36 y, take the element-by-element paths, and so does the
    prep for B and C."""
    _ssd_check(*_ssd_views(cuda, 2, 3, 200, p, 128, dtype, seed=p, skew=1),
               chunk=40)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_scan_kernel_one_sequence_few_heads(cuda, dtype):
    """Batch 1 with 16 heads: 32 blocks, far fewer than the SMs."""
    _ssd_check(*_ssd_views(cuda, 1, 16, 512, 64, 128, dtype, seed=5),
               chunk=128)


def test_ssd_scan_kernel_mixer_shape_and_repeatable(cuda):
    """mamba2-2.7b's mixer in one scoring request — x ``(4, 80, 1024, 64)``
    bf16 as a strided view of the projection, N 128, chunk 128 — against
    the plain version, and the same bits on a second run (no atomics, a
    fixed order of every sum)."""
    views = _ssd_views(cuda, 4, 80, 1024, 64, 128, torch.bfloat16, seed=16)
    _ssd_check(*views, chunk=128)
    y0, s0 = ops.ssd_scan(*views, chunk=128)
    y1, s1 = ops.ssd_scan(*views, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1) and torch.equal(s0, s1)


def test_ssd_scan_kernel_zamba2_mixer_shape(cuda):
    """zamba2-2.7b's mixer in one scoring request — x ``(4, 80, 1024, 64)``
    bf16 as a strided view of the projection, state N 64 (the kernel's
    scratch holds 128 columns: the rest must be read as zeros), chunk
    128 — against the plain version."""
    _ssd_check(*_ssd_views(cuda, 4, 80, 1024, 64, 64, torch.bfloat16,
                           seed=17), chunk=128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,n,tile,skew", [
    (4, 1024, 128, 128, 0),          # the mixer's B and C views
    (2, 100, 16, 32, 1),             # partial tile, unaligned, N 16
    (1, 48, 128, 8, 0),              # small tiles
])
def test_ssd_scan_prep_kernel_matches_plain(cuda, dtype, b, s, n, tile, skew):
    """The prep kernel against ``ref_ssd_scan_prep``: C·Bᵀ on the causal
    triangle within ``1e-5 · max|want|`` (float32 sums over n in another
    order than ATen), C transposed and B bitwise (widened exactly), zeros
    everywhere else — B and C read as 16-byte words (the mixer's views)
    and element by element (the skewed ones)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_prep

    _, _, _, B, C = _ssd_views(cuda, b, 2, s, 8, n, dtype, seed=s, skew=skew)
    got = ssd_scan_prep(B, C, tile=tile)
    want = ref.ref_ssd_scan_prep(B, C, tile)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got[:, :, 0] - want[:, :, 0]).abs().max().item()
    assert err <= 1e-5 * want[:, :, 0].abs().max().item(), err
    assert torch.equal(got[:, :, 1:], want[:, :, 1:])


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


@pytest.mark.parametrize("arch,over", [
    ("zamba2-2.7b", {}), ("zamba2-2.7b", dict(head_dim=80)),
    ("internlm2-1.8b", dict(num_kv_heads=2))],
    ids=["hybrid", "hybrid_D80", "dense_gqa"])
def test_lm_backbones_run_the_kernels(cuda, arch, over):
    """The reduced hybrid and dense backbones on the card (float32): one
    ``flash_attention`` launch per attention (each application of the
    shared block, each dense layer) and one ``ssd_scan`` per mixer in
    ``forward_train`` and ``prefill``, none in ``decode_step``; logits
    within ``1e-4 · max|out|`` of the plain path's (the CPU run); prefill
    (48 tokens, its cache copied into one of room 64) followed by a decode
    step reproduces ``forward_train``'s logits."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.tree import tree_map

    cfg = get_config(arch).reduced(**over)
    attn = cfg.num_layers // (cfg.attn_every or 1)
    ssd = cfg.num_layers if cfg.arch_type == "hybrid" else 0
    params = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    want, _ = zoo.forward_train(cfg, params, {"tokens": toks})
    card = tree_map(lambda a: a.to(cuda), params)
    ops.reset_launches()
    got, _ = zoo.forward_train(cfg, card, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert (ops.LAUNCHES["flash_attention"], ops.LAUNCHES["ssd_scan"]) == \
        (attn, ssd)
    tol = 1e-4 * want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= tol
    ops.reset_launches()
    last, cache = zoo.prefill(cfg, card, {"tokens": toks[:, :48].to(cuda)})
    room = zoo.make_cache(cfg, 2, 64, cuda)
    for key, a in cache.items():
        if key in ("k", "v"):
            room[key][:, :, :48] = a
        elif key == "pos":
            room[key][:, :48] = a
        else:
            room[key] = a
    pos = torch.full((2,), 48, dtype=torch.int32, device=cuda)
    step, _ = zoo.decode_step(cfg, card, room, toks[:, 48:49].to(cuda), pos)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES["flash_attention"], ops.LAUNCHES["ssd_scan"]) == \
        (attn, ssd)
    for lg, p in ((last, 47), (step, 48)):
        assert (lg.cpu() - want[:, p]).abs().max().item() <= tol


@pytest.mark.parametrize("impl,cf", [("dense_scan", 1.25), ("dropping", 0.5)],
                         ids=["dense_scan", "dropping"])
def test_moe_logprobs_on_the_card_match_the_cpu(cuda, impl, cf):
    """The reduced float32 mixtral (2 layers, 4 experts, window 64) as a
    two-expert ensemble: fused log-probabilities of 4 × 96 tokens on the
    card (one attention launch a layer and expert) within
    ``1e-4 · max|out|`` of the CPU's — under ``dense_scan`` and under
    ``dropping`` at a capacity that drops (a different drop set would
    move a row by an expert's output)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.lm_ensemble import (LMExpertEnsemble,
                                              TokenPrototypeRouter)
    from repro_torch.models import zoo
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              moe_impl=impl, moe_capacity_factor=cf)
    experts = [zoo.init(cfg, torch.Generator().manual_seed(k), "cpu")
               for k in range(2)]
    gen = torch.Generator().manual_seed(2)
    corpora = [torch.randint(0, cfg.vocab_size, (4, 128), generator=gen)
               for _ in range(2)]
    router = TokenPrototypeRouter.fit(corpora, vocab=cfg.vocab_size)
    toks = torch.randint(0, cfg.vocab_size, (4, 96), generator=gen)

    def logprobs(dev, params):
        ens = LMExpertEnsemble(cfg=cfg, expert_params=params, router=router,
                               strategy="topk", top_k=1)
        return ens.fused_logprobs(toks.to(dev))

    want = logprobs("cpu", experts)
    ops.reset_launches()
    got = logprobs(cuda, [tree_map(lambda a: a.to(cuda), e)
                          for e in experts])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    assert bool(torch.isfinite(got).all())
    assert (got.cpu() - want).abs().max().item() <= \
        1e-4 * want.abs().max().item()


@pytest.mark.parametrize("param_dtype", ["native", "int8", "fp8"])
def test_capacity_padded_ragged_gemm_skips_dead_slots(cuda, param_dtype):
    """A capacity-10 store of 8 experts with slot 3 evicted and NaN in
    slots 3 and 9: the routed slots (``routed_slots`` with the mask)
    never name them, so the ragged GEMM's rows are finite and equal the
    plain version over the clean weights (float32 and fp8 within
    ``1e-5``, int8 bitwise) at a tiled width (m 256) and a narrow one
    (m 1)."""
    from repro_torch.core.dispatch import routed_slots

    gen = torch.Generator(device=cuda).manual_seed(10)
    k, d, f = 8, 768, 768
    clean = param_store.make_store(
        {"w": torch.randn(k, d, f, generator=gen, device=cuda) / d ** 0.5},
        dtype=param_dtype)
    store = param_store.pad_to_capacity(clean, 10)
    mask = store.valid_mask().clone()
    mask[3] = False
    nan = {"w": torch.full((d, f), float("nan"), device=cuda)}
    store = store.set_expert(3, nan).set_expert(9, nan).with_valid(mask)
    weights = torch.softmax(torch.randn(16, 10, generator=gen, device=cuda),
                            -1) * mask
    slot_idx, _ = routed_slots(weights, 2, valid=store.valid)
    pe = slot_idx.reshape(-1)
    assert not bool(((pe == 3) | (pe == 9)).any())
    leaf = store.ragged_view()["w"]
    want_leaf = clean.ragged_view()["w"]
    for m in (256, 1):
        x = torch.randn(32, m, d, generator=gen, device=cuda)
        if param_dtype == "native":
            got = ops.ragged_expert_matmul(x, leaf, pe)
            want = ops.ragged_expert_matmul(x.cpu(), want_leaf.cpu(),
                                            pe.cpu())
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                       atol=1e-5)
        else:
            got = ops.ragged_expert_matmul(x, leaf.q, pe,
                                           w_scale=leaf.scale)
            want = ops.ragged_expert_matmul(
                x.cpu(), want_leaf.q.cpu(), pe.cpu(),
                w_scale=want_leaf.scale.cpu())
            if m > 1 and param_dtype == "int8":
                assert torch.equal(got.cpu(), want)
            else:                 # float32 sums (m 1: dequantized weights)
                err = (got.cpu() - want).abs().max().item()
                assert err <= 1e-5 * want.abs().max().item(), err
        assert bool(torch.isfinite(got).all())


def test_per_row_dt_step_at_the_rolling_capacity(cuda):
    """The rolling tick's step: a batch of 8 rows at 8 different steps
    (a ``(8,)`` dt, per-row coefficient slices from ``slot_coef_rows``),
    K 2, batched CFG, at the full-width latent: bitwise the plain version,
    and each row bitwise a shared-dt launch at that row's dt."""
    from repro_torch.core.dispatch import slot_coef_rows

    gen = torch.Generator(device=cuda).manual_seed(8)
    b, k, t = 8, 2, 4096
    preds = 4 * torch.randn(k, 2 * b, t, generator=gen, device=cuda)
    x = 3 * torch.randn(b, t, generator=gen, device=cuda)
    w = torch.rand(2 * b, k, generator=gen, device=cuda)
    tabs = 1.5 * torch.rand(8, 5, 10, generator=gen, device=cuda)
    idx = torch.randint(0, 10, (2 * b, k), generator=gen, device=cuda)
    coef = slot_coef_rows(torch.cat([tabs, tabs]), idx)
    dt = torch.rand(b, generator=gen, device=cuda)
    ops.reset_launches()
    got = ops.fused_step(preds, x, w, coef, dt, g=2, **STEP_KW)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["hetero_fuse_step"] == 1
    want = ref.ref_hetero_fuse_step(preds.reshape(k, 2, b, t), x,
                                    w.reshape(2, b, k),
                                    coef.reshape(5, k, 2, b), dt, **STEP_KW)
    assert torch.equal(got, want)
    for r in range(b):
        one = ops.fused_step(preds, x, w, coef, dt[r:r + 1], g=2, **STEP_KW)
        assert torch.equal(got[r], one[r])


# ---------------------------------------------------------------------------
# Backward kernels (training path)
# ---------------------------------------------------------------------------

GRAD_REL = 1e-5


def _close_rel(got, want, rel=GRAD_REL):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), (err, want.abs().max())


@pytest.mark.parametrize("shape,view", [
    ((4, 256, 768), "plain"),           # the DiT's modulate site
    ((3, 2, 33, 100), "plain"),         # G 2, D off the 32-lane stride
    ((3, 40, 96), "broadcast"),         # (P, g, T, d) replica broadcast
    ((2, 70, 64), "slice"),             # a strided slice of wider rows
    ((2, 64, 768), "offset"),           # base one float off: shared path
    ((2, 50, 33), "plain"),             # D % 4 ≠ 0
    ((2, 40, 70), "plain"),
    ((2, 77, 768), "plain"),            # rows that fill no chunk
    ((1, 300, 256), "plain"),
    ((2, 40, 1024), "plain"),           # the register path's widest row
    ((2, 9, 3072), "plain"),            # shared path, wide rows
    ((2, 5, 3584), "plain"),            # BWD_MAX_D
])
@pytest.mark.parametrize("affine", [True, False], ids=["mod", "ln"])
def test_adaln_fuse_bwd_kernel_matches_plain(cuda, shape, view, affine):
    """dx, dγ and dβ of the backward kernel against the plain version's
    formula, with γ/β slices of a modulation stack, and through
    ``ops.adaln_modulate``/``ops.layernorm`` under autograd: one forward
    and one backward launch, gradients equal to the direct call's."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    b, d = shape[0], shape[-1]
    base = 3 * torch.randn(shape, generator=gen, device=cuda) + 1
    if view == "broadcast":
        x = base[:, None].expand(b, 2, *shape[1:])
    elif view == "slice":
        x = torch.randn(b, shape[1], 2 * d, generator=gen,
                        device=cuda)[..., :d]
    elif view == "offset":
        x = (3 * torch.randn(base.numel() + 1, generator=gen, device=cuda)
             + 1)[1:].view(shape)
    else:
        x = base
    mods = 0.3 * torch.randn(b, 6, 6, d, generator=gen, device=cuda)
    gamma = mods[:, 2, 0] if affine else None
    dy = torch.randn(x.shape, generator=gen, device=cuda)
    from repro_torch.kernels.adaln_fuse import adaln_fuse_bwd

    rows = x if x.dim() in (3, 4) else x.reshape(b, -1, d)
    got = adaln_fuse_bwd(rows, gamma, dy)
    want = ref.ref_adaln_fuse_bwd(x, gamma, dy)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _close_rel(g, w)
    again = adaln_fuse_bwd(rows, gamma, dy)
    assert all(a is None or torch.equal(a, g) for a, g in zip(again, got))

    xg = x.detach().requires_grad_(True)
    mg = mods.detach().requires_grad_(True)
    ops.reset_launches()
    if affine:
        out = ops.adaln_modulate(xg, mg[:, 2, 0], mg[:, 2, 1],
                                 round_scale=True)
    else:
        out = ops.layernorm(xg)
    assert out.grad_fn is not None
    out.backward(dy)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["adaln_fuse"] == 1
    assert ops.LAUNCHES["adaln_fuse_bwd"] == 1
    _close_rel(xg.grad, want[0])
    if affine:
        _close_rel(mg.grad[:, 2, 0], want[1])
        _close_rel(mg.grad[:, 2, 1], want[2])
        assert mg.grad[:, 3:].abs().max().item() == 0.0


@pytest.mark.parametrize("b,h,s,d,scale", [
    (2, 12, 256, 64, None),       # the DiT's self-attention, (B, S, H, D)
    (2, 3, 100, 64, 0.3),         # partial tiles, a softmax scale
    (1, 2, 70, 32, None),         # narrower head
    (1, 2, 129, 128, 0.1),        # widest head the backward takes
    (3, 1, 1, 16, None),          # one position
    (1, 3, 77, 33, None),         # D % 4 ≠ 0: staged element by element
    (2, 2, 300, 70, 0.2),         # S that fills no tile, D 70
    (1, 2, 300, 128, None),
    (8, 130, 64, 64, None),       # B·H 1040
])
def test_flash_attention_bwd_kernel_matches_plain(cuda, b, h, s, d, scale):
    """dq, dk and dv of the backward kernel (from the forward's row
    log-sum-exp) against the plain version's formula on ``(B, S, H, D)``
    projections read as ``(B, H, S, D)`` views; through
    ``ops.flash_attention`` under autograd the same gradients, one forward
    and one backward launch, bitwise repeatable."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    gen = torch.Generator(device=cuda).manual_seed(b * h + s + d)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=cuda)
                   .transpose(1, 2) for _ in range(4))
    out, lse = flash_attention(q, k, v, causal=False, softmax_scale=scale,
                               with_lse=True)
    plain_out = flash_attention(q, k, v, causal=False, softmax_scale=scale)
    assert torch.equal(out, plain_out)
    got = flash_attention_bwd(q, k, v, out, lse, do, softmax_scale=scale)
    want = ref.ref_flash_attention_bwd(q, k, v, do, softmax_scale=scale)
    torch.cuda.synchronize()
    # relative to the largest gradient of the three: at S 1 dq and dk are
    # 0 exactly (P = 1), which the plain version rounds to ~1e-7
    top = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= GRAD_REL * top
    again = flash_attention_bwd(q, k, v, out, lse, do, softmax_scale=scale)
    assert all(torch.equal(a, g) for a, g in zip(again, got))

    qg, kg, vg = (a.detach().requires_grad_(True) for a in (q, k, v))
    ops.reset_launches()
    o2 = ops.flash_attention(qg, kg, vg, causal=False, softmax_scale=scale)
    assert o2.grad_fn is not None and torch.equal(o2.detach(), out)
    o2.backward(do)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.LAUNCHES["flash_attention_bwd"] == 1
    for g, w in zip((qg.grad, kg.grad, vg.grad), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("s,d", [(256, 64), (100, 128)])
def test_flash_attention_bwd_kernel_unaligned_views(cuda, s, d):
    """q, k, v and dO one float off 16-byte alignment (the element-by-
    element staging path and scalar stores): the plain version's
    gradients, bitwise repeatable."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    b, h = 2, 4
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    n = b * s * h * d
    q, k, v, do = (torch.randn(n + 1, generator=gen, device=cuda)[1:]
                   .view(b, s, h, d).transpose(1, 2) for _ in range(4))
    out, lse = flash_attention(q, k, v, causal=False, with_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do)
    want = ref.ref_flash_attention_bwd(q, k, v, do)
    torch.cuda.synchronize()
    top = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= GRAD_REL * top
    again = flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


#: bf16 attention gradients against the plain version's float32 ones:
#: half a bf16 ulp of each element from the final rounding, and Δ formed
#: from the forward's bf16-rounded output where the plain version forms it
#: from its float32 one (up to 0.9 of a bf16 ulp of the gradient's max in
#: a CPU emulation at S 1024, D 80 and 128): two bf16 ulps of each
#: gradient's largest |value|, plus the float32 rule's ``GRAD_REL`` of the
#: largest of the three for the sums' order (a gradient that is 0 exactly,
#: dq and dk under a window of 1, is ~1e-8 in the plain version).
BF16_GRAD_REL = 2.0 ** -7


def _bwd_check(cuda, b, hq, hkv, s, d, causal, window, dtype, scale=None,
               offset=False, skv=None, prefix=0):
    """The backward kernel against the plain version on (B, S, H, D)
    projections read as (B, H, S, D) views (one element off 16-byte
    alignment with ``offset``; k and v ``skv`` positions long, ``s`` by
    default; the prefix-LM mask's ``prefix``), bitwise repeatable, on the
    route its shape picks (bf16 at D a multiple of 16 up to 128, aligned
    and without a prefix: the tensor-core kernels; else the FFMA tile
    kernel); then the same call under autograd through
    ``ops.flash_attention``: one forward and one backward launch, the
    direct call's gradients bitwise."""
    from repro_torch.kernels.flash_attention import (bwd_design,
                                                     flash_attention,
                                                     flash_attention_bwd)

    gen = torch.Generator(device=cuda).manual_seed(b * hq + s + d + hkv)

    skv = s if skv is None else skv

    def draw(h, sd=1.0, n_pos=s):
        n, off = b * n_pos * h * d, int(offset)
        base = (sd * torch.randn(n + off, generator=gen, device=cuda)).to(
            dtype)
        return base[off:].view(b, n_pos, h, d).transpose(1, 2)
    q, k, v, do = (draw(hq), draw(hkv, n_pos=skv), draw(hkv, n_pos=skv),
                   draw(hq, 0.1))
    tc = (dtype == torch.bfloat16 and d % 16 == 0 and d <= 128
          and not offset and not prefix)
    assert bwd_design(q, k, v, do, prefix_len=prefix) == (
        "wgmma bf16" if tc else "FFMA")
    kw = dict(causal=causal, window=window, softmax_scale=scale,
              prefix_len=prefix)
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = ref.ref_flash_attention_bwd(q, k, v, do, **kw)
    torch.cuda.synchronize()
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert bool(torch.isfinite(g).all())
    top = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        err = (g.float() - w).abs().max().item()
        tol = GRAD_REL * top
        if dtype == torch.bfloat16:
            tol += BF16_GRAD_REL * w.abs().max().item()
        assert err <= tol, (err, tol)
    again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))

    qg, kg, vg = (a.detach().requires_grad_(True) for a in (q, k, v))
    ops.reset_launches()
    o2 = ops.flash_attention(qg, kg, vg, **kw)
    assert o2.grad_fn is not None and torch.equal(o2.detach(), out)
    o2.backward(do)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "flash_attention": 1, "flash_attention_bwd": 1}
    for g, w in zip((qg.grad, kg.grad, vg.grad), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (2, 4, 2, 256, 64, True, 0),      # causal GQA
    (1, 4, 1, 200, 128, True, 0),     # one kv head, ragged S, widest head
    (1, 4, 4, 300, 80, True, 0),      # zamba2's head: D 80 (bf16: the
                                      # 32-byte swizzle)
    (2, 4, 2, 257, 64, True, 70),     # causal sliding window, ragged S
    (1, 2, 2, 333, 80, False, 100),   # a window without the causal mask
    (1, 8, 2, 130, 128, False, 0),    # non-causal GQA 4 a group
    (2, 2, 1, 64, 16, True, 1),       # window 1: the diagonal alone
    (1, 3, 3, 77, 40, True, 0),       # D 40: bf16 takes the FFMA route
])
def test_flash_attention_bwd_kernel_masks_and_groups(cuda, b, hq, hkv, s, d,
                                                     causal, window, dtype):
    """The backward kernel with the forward's masks and grouped kv heads
    (dk and dv summed over each group on chip), float32 and bf16, against
    the plain version (float32 within ``GRAD_REL`` of the largest of the
    three; bf16 within that plus ``BF16_GRAD_REL`` of each gradient's
    largest), bitwise repeatable, one forward and one backward launch
    under autograd."""
    _bwd_check(cuda, b, hq, hkv, s, d, causal, window, dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (4, 16, 8, 1024, 128),            # internlm2-1.8b's training shape
    (4, 32, 32, 1024, 80),            # zamba2-2.7b's shared block
])
def test_flash_attention_bwd_kernel_lm_training_shapes(cuda, b, hq, hkv, s,
                                                       d):
    """The two LM training shapes, causal bf16, as the model lays them out
    (a 4 × 1024-token batch)."""
    _bwd_check(cuda, b, hq, hkv, s, d, True, 0, torch.bfloat16)


@pytest.mark.parametrize("b,hq,hkv,s,window", [
    (1, 4, 1, 1024, 256),             # Mixtral's 4-head group, S 4 × window
    (2, 8, 2, 600, 300),              # ragged S, two groups
], ids=["group4_w256", "ragged_w300"])
def test_flash_attention_bwd_kernel_windowed_bf16_on_wgmma(cuda, b, hq, hkv,
                                                          s, window):
    """The causal sliding-window backward in bf16 at D 128 (Mixtral's
    attention, window shorter than S) on the tensor-core route
    (``_bwd_check`` asserts ``"wgmma bf16"``), against the plain
    version."""
    _bwd_check(cuda, b, hq, hkv, s, 128, True, window, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,window",
                         [(2, 7, 1, 300, 0), (1, 14, 2, 257, 0),
                          (2, 6, 1, 300, 128)],
                         ids=["7over1", "14over2", "6over1_window"])
def test_flash_attention_group_of_seven(cuda, b, hq, hkv, s, window, dtype):
    """deepseek-coder-33b's group of 7 query heads a kv head (not a power
    of two), causal at D 128, and mixtral-8x22b's group of 6 under a
    sliding window that masks: the forward within ``_close`` of the plain
    version over repeated kv heads (one launch), then the backward
    (``_bwd_check``)."""
    gen = torch.Generator(device=cuda).manual_seed(hq + s)
    q = torch.randn(b, s, hq, 128, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, s, hkv, 128, generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    ops.reset_launches()
    got = ops.flash_attention_gqa(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    if dtype == torch.bfloat16:
        assert flash_design(q, k, v) == "wgmma bf16"
    _close(got, ref.ref_flash_attention(
        q, k.repeat_interleave(hq // hkv, dim=1),
        v.repeat_interleave(hq // hkv, dim=1), causal=True, window=window))
    _bwd_check(cuda, b, hq, hkv, s, 128, True, window, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_bwd_kernel_unaligned_masked_views(cuda, dtype):
    """Causal GQA and windowed operands one element off 16-byte alignment
    (element-by-element staging, scalar stores): the plain version's
    gradients, bitwise repeatable."""
    _bwd_check(cuda, 2, 4, 2, 150, 64, True, 0, dtype, scale=0.2,
               offset=True)
    _bwd_check(cuda, 1, 2, 2, 100, 128, True, 33, dtype, offset=True)


def _kernels_launched(fn) -> dict:
    """The kernels one ``fn()`` launches on the card (after a warm-up
    call), under ``torch.profiler``: ``{name: launches}`` by the kernel's
    name without its namespace and template arguments."""
    import re

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+)(<[^>]*>)?\(", evt.key)
            out[m.group(1) if m else evt.key] = evt.count
    return out


#: the backward's kernels on each route, one launch each a call
BWD_ROUTES = {
    "wgmma bf16": {"flash_attention_bwd_delta": 1,
                   "flash_attention_bwd_dkdv_wgmma": 1,
                   "flash_attention_bwd_dq_wgmma": 1},
    "FFMA": {"flash_attention_bwd_delta": 1, "flash_attention_bwd_tile": 1,
             "flash_attention_bwd_dq_sum": 1}}


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,dtype,route", [
    (2, 16, 8, 512, 128, True, torch.bfloat16, "wgmma bf16"),  # GQA, D 128
    (2, 8, 8, 300, 80, True, torch.bfloat16, "wgmma bf16"),    # D 80
    (1, 3, 3, 77, 40, True, torch.bfloat16, "FFMA"),           # bf16 D 40
    (32, 12, 12, 256, 64, False, torch.float32, "FFMA"),       # the DiT's
], ids=["bf16_d128_causal_gqa", "bf16_d80_causal", "bf16_d40",
        "f32_dit_training"])
def test_flash_attention_bwd_route_by_shape(cuda, b, hq, hkv, s, d, causal,
                                            dtype, route):
    """Under ``torch.profiler`` one backward launches its route's three
    kernels and no other: aligned bf16 at D 128 (causal GQA) and D 80 Δ,
    the tensor-core dK/dV kernel and the dQ kernel — no FFMA tile kernel
    and no dQ sums; bf16 at D 40 and the DiT's float32 training shape Δ,
    the FFMA tile kernel and its dQ sums.  ``bwd_design`` names the route
    that ran."""
    from repro_torch.kernels.flash_attention import (bwd_design,
                                                     flash_attention,
                                                     flash_attention_bwd)

    gen = torch.Generator(device=cuda).manual_seed(s + d)

    def draw(h):
        return torch.randn(b, s, h, d, generator=gen, device=cuda).to(
            dtype).transpose(1, 2)
    q, k, v, do = draw(hq), draw(hkv), draw(hkv), draw(hq)
    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    assert bwd_design(q, k, v, do) == route
    assert _kernels_launched(lambda: flash_attention_bwd(
        q, k, v, out, lse, do, causal=causal)) == BWD_ROUTES[route]


def test_flash_attention_bwd_scratch_is_delta_on_the_tc_route(cuda):
    """The tensor-core route's float32 scratch is Δ alone, ``B·H·S``
    floats, at both LM training shapes (causal, as the models lay out
    q, k, v and dO); the FFMA route's (the DiT's float32 shape) also holds
    its dQ shares."""
    from repro_torch.kernels.flash_attention import bwd_scratch_floats

    def bshd(b, s, h, d, dtype=torch.bfloat16):
        return torch.empty(b, s, h, d, dtype=dtype,
                           device=cuda).transpose(1, 2)

    for b, hq, hkv, s, d in ((4, 16, 8, 1024, 128), (4, 32, 32, 1024, 80)):
        q, kv = bshd(b, s, hq, d), bshd(b, s, hkv, d)
        assert bwd_scratch_floats(q, kv, kv, q, q, causal=True) == b * hq * s
    f = bshd(32, 256, 12, 64, torch.float32)
    assert bwd_scratch_floats(f, f, f, f, f) > 32 * 12 * 256


#: (B, Hq, Hkv, Sq, Skv, D) of the cross-attention cases: whisper's
#: decoder over its 1500 frames (reduced: 24 over 16), more queries than
#: keys, partial tiles on both lengths, a GQA group, D 80 and D 40 (bf16
#: on the FFMA template there)
CROSS = [(2, 4, 4, 24, 16, 64), (1, 3, 3, 200, 70, 64),
         (2, 4, 2, 129, 1000, 128), (1, 2, 2, 63, 300, 80),
         (1, 2, 1, 90, 33, 40), (4, 20, 20, 1024, 1500, 64)]
CROSS_IDS = ["whisper_reduced", "more_queries", "gqa_d128", "d80", "d40",
             "whisper_cross"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", CROSS, ids=CROSS_IDS)
def test_flash_attention_cross_lengths_match_plain(cuda, b, hq, hkv, sq, skv,
                                                   d, dtype):
    """``Sq`` query rows over ``Skv`` keys (the cross-attention's own kv
    length), non-causal, on ``(B, S, H, D)`` projections seen as ``(B, H,
    S, D)``: float32 on the FFMA template, bf16 at D a multiple of 16 on
    the tensor-core kernel; the output against the plain version and the
    row log-sum-exp within ``1e-5`` of its largest magnitude."""
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=cuda).manual_seed(sq + skv + d)
    q = torch.randn(b, sq, hq, d, generator=gen, device=cuda).to(
        dtype).transpose(1, 2)
    k, v = (torch.randn(b, skv, hkv, d, generator=gen, device=cuda)
            .to(dtype).transpose(1, 2) for _ in range(2))
    tc = dtype == torch.bfloat16 and d % 16 == 0
    assert flash_design(q, k, v) == ("wgmma bf16" if tc else "FFMA")
    ops.reset_launches()
    got = ops.flash_attention_gqa(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1 and got.shape == q.shape
    rep = hq // hkv
    kr, vr = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    _close(got, ref.ref_flash_attention(q, kr, vr, causal=False))
    again, lse = flash_attention(q, k, v, causal=False, with_lse=True)
    assert torch.equal(again, got)
    want = _plain_lse(q, kr, False, 0, d ** -0.5)
    assert lse.shape == want.shape
    err = (lse - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", CROSS[:5], ids=CROSS_IDS[:5])
def test_flash_attention_bwd_kernel_cross_lengths(cuda, b, hq, hkv, sq, skv,
                                                  d, dtype):
    """The backward at ``Sq ≠ Skv`` on both routes (float32 and bf16 at D
    40: the FFMA tile kernel, its dQ shares sized by the two lengths; bf16
    at D a multiple of 16: the tensor-core dK/dV kernel over the key tiles
    of ``Skv`` and the dQ kernel over the query tiles of ``Sq``), as
    ``_bwd_check`` holds it."""
    _bwd_check(cuda, b, hq, hkv, sq, d, False, 0, dtype, skv=skv)


@pytest.mark.parametrize("sq,skv,causal", [(1500, 1500, False),
                                           (1024, 1500, False),
                                           (1024, 1024, True)],
                         ids=["encoder", "cross", "decoder"])
def test_flash_attention_whisper_bf16_on_wgmma(cuda, sq, skv, causal):
    """Whisper-large-v3's encoder self-attention (B 4, 20 heads of D 64, S
    1500: a partial query tile of 128 and a partial key tile of 64 that
    no causal mask cuts off), its cross-attention (1024 decoder rows over
    the 1500 frames), both non-causal, and its decoder's causal
    self-attention (S 1024), bf16: forward and backward on the
    tensor-core kernels, against the plain version as ``_bwd_check``
    holds it; under the profiler the backward launches the tensor-core
    route's three kernels."""
    from repro_torch.kernels.flash_attention import (bwd_design,
                                                     flash_attention,
                                                     flash_attention_bwd)

    _bwd_check(cuda, 4, 20, 20, sq, 64, causal, 0, torch.bfloat16, skv=skv)
    gen = torch.Generator(device=cuda).manual_seed(sq)
    q, do = (torch.randn(4, sq, 20, 64, generator=gen, device=cuda).to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(4, skv, 20, 64, generator=gen, device=cuda).to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    assert flash_design(q, k, v) == bwd_design(q, k, v, do) == "wgmma bf16"
    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    assert _kernels_launched(lambda: flash_attention_bwd(
        q, k, v, out, lse, do, causal=causal)) == BWD_ROUTES["wgmma bf16"]


def test_flash_attention_bwd_scratch_at_cross_lengths(cuda):
    """The scratch at ``Sq ≠ Skv``: Δ alone, ``B·H·Sq`` floats, on the
    tensor-core route; on the FFMA route every (key tile of ``Skv``, query
    tile of ``Sq``) pair's dQ share, ``B·H·64·D`` floats each, and Δ."""
    from repro_torch.kernels.flash_attention import bwd_scratch_floats

    b, h, sq, skv, d = 2, 4, 100, 300, 64
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.empty(b, sq, h, d, dtype=dtype, device=cuda).transpose(1, 2)
        kv = torch.empty(b, skv, h, d, dtype=dtype,
                         device=cuda).transpose(1, 2)
        pairs = -(-skv // 64) * -(-sq // 64)
        want = b * h * sq + (0 if dtype == torch.bfloat16
                             else pairs * b * h * 64 * d)
        assert bwd_scratch_floats(q, kv, kv, q, q) == want


def test_whisper_reduced_on_the_card_matches_the_cpu(cuda):
    """The reduced float32 whisper-large-v3 (2 encoder and 2 decoder
    layers, 16 frames) on the card against the CPU run (plain versions),
    from the same parameters, tokens and frames: ``forward_train`` logits
    (6 attention launches: 2 encoder, 2 self, 2 cross over the frames),
    ``prefill`` logits and every cache leaf (6 launches), a ``decode_step``
    (none), each within ``1e-4 · max|out|``; one ``make_lm_train_step``
    step: 12 attention launches under remat's recompute, 6 backward
    launches, the loss within ``1e-4`` and every gradient leaf within
    ``1e-4`` of its largest — a leaf at rounding level (at most 2⁻¹⁷ of
    the model's largest gradient: a key projection's bias, whose exact
    gradient is 0, the softmax cancels ``q·b``) within ``1e-4`` of the
    model's largest gradient."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("whisper-large-v3").reduced()
    params = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=gen)
    frames = torch.randn(2, cfg.encoder_seq_len, cfg.d_model, generator=gen)
    card = tree_map(lambda a: a.to(cuda), params)

    def on(dev, n=40, **more):
        return {"tokens": toks[:, :n].to(dev), "audio_embeds": frames.to(dev),
                **{k: v.to(dev) for k, v in more.items()}}

    def close(got, want, rel=1e-4):
        err = (got.detach().cpu() - want.detach()).abs().max().item()
        assert err <= rel * want.abs().max().item(), err

    want, _ = zoo.forward_train(cfg, params, on("cpu"))
    ops.reset_launches()
    got, _ = zoo.forward_train(cfg, card, on(cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 6
    close(got, want)
    wl, wc = zoo.prefill(cfg, params, on("cpu", 24))
    ops.reset_launches()
    gl, gcache = zoo.prefill(cfg, card, on(cuda, 24))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 6
    close(gl, wl)
    for key in wc:
        if key == "pos":
            assert torch.equal(gcache[key].cpu(), wc[key])
        else:
            close(gcache[key], wc[key])
    pos = torch.full((2,), 24, dtype=torch.int32)
    wd, _ = zoo.decode_step(cfg, params, wc, toks[:, 24:25], pos)
    ops.reset_launches()
    gd, _ = zoo.decode_step(cfg, card, gcache, toks[:, 24:25].to(cuda),
                            pos.to(cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 0
    close(gd, wd)

    rc = dataclasses.replace(cfg, remat=True)
    labels = {"labels": toks[:, 1:]}
    (wloss, _), wg = value_and_grad(
        lambda p: zoo.loss_fn(rc, p, on("cpu", **labels)), params,
        has_aux=True)
    ops.reset_launches()
    (gloss, _), gg = value_and_grad(
        lambda p: zoo.loss_fn(rc, p, on(cuda, **labels)), card,
        has_aux=True)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "flash_attention": 12, "flash_attention_bwd": 6}
    close(gloss, wloss)
    own = [w.abs().max().item() for w in tree_leaves(wg)]
    top = max(own)
    for i, (g, w) in enumerate(zip(tree_leaves(gg), tree_leaves(wg))):
        err = (g.cpu() - w).abs().max().item()
        scale = top if own[i] <= 2.0 ** -17 * top else own[i]
        assert err <= 1e-4 * scale, (i, err)


def test_unsupported_grad_calls_raise(cuda):
    """On a CUDA tensor that requires grad, a call the backward does not
    take (D > 256, float16, mixed dtypes) raises; it never returns a
    tensor without a ``grad_fn``.  Causal, windowed, prefix, grouped and
    bf16 attention, D up to 256, take the backward kernel."""
    q = torch.randn(1, 4, 16, 32, device=cuda, requires_grad=True)
    kv = torch.randn(1, 2, 16, 32, device=cuda)
    wide = torch.randn(1, 2, 16, 264, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="D ≤ 256"):
        ops.flash_attention(wide, wide, wide, causal=True)
    half = q.detach().to(torch.float16).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="float32 or bf16"):
        ops.flash_attention(half, half, half, causal=True)
    with pytest.raises(NotImplementedError, match="one dtype"):
        ops.flash_attention(q, kv.to(torch.bfloat16), kv, causal=True)
    x = torch.randn(2, 8, 64, device=cuda, requires_grad=True)
    g16 = torch.zeros(2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float32"):
        ops.adaln_modulate(x, g16, g16, round_scale=True)
    with pytest.raises(NotImplementedError, match="float32"):
        ops.layernorm(x.to(torch.bfloat16))
    q16 = q.detach().to(torch.bfloat16).requires_grad_(True)
    w256 = torch.randn(1, 2, 16, 256, device=cuda, requires_grad=True)
    for out in (ops.flash_attention(q, q, q, causal=False),
                ops.flash_attention(q, q, q, causal=True),
                ops.flash_attention(q, q, q, causal=False, window=4),
                ops.flash_attention(q, kv, kv, causal=True),
                ops.flash_attention(q, kv, kv, causal=True, prefix_len=5),
                ops.flash_attention(w256, w256, w256, causal=True),
                ops.flash_attention(q16, q16, q16, causal=True)):
        assert out.grad_fn is not None
    assert ops.layernorm(x).grad_fn is not None


def test_no_grad_forwards_are_the_serving_launch(cuda):
    """Under ``torch.no_grad()`` (the serving paths) inputs that require
    grad take the plain forward launch: bitwise the launch on inputs that
    do not, no ``grad_fn``, no backward counted; the forward under
    autograd gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4, 256, 768, generator=gen, device=cuda)
    mods = 0.3 * torch.randn(4, 6, 768, generator=gen, device=cuda)
    q = torch.randn(4, 256, 12, 64, generator=gen,
                    device=cuda).transpose(1, 2)
    want_a = ops.adaln_modulate(x, mods[:, 0], mods[:, 1], round_scale=True)
    want_l = ops.layernorm(x)
    want_f = ops.flash_attention(q, q, q, causal=False)
    xg, mg, qg = (a.detach().requires_grad_(True) for a in (x, mods, q))
    ops.reset_launches()
    with torch.no_grad():
        got = (ops.adaln_modulate(xg, mg[:, 0], mg[:, 1], round_scale=True),
               ops.layernorm(xg), ops.flash_attention(qg, qg, qg,
                                                      causal=False))
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "adaln_fuse": 2, "flash_attention": 1}
    for g, w in zip(got, (want_a, want_l, want_f)):
        assert g.grad_fn is None and torch.equal(g, w)
    with_grad = (ops.adaln_modulate(xg, mg[:, 0], mg[:, 1], round_scale=True),
                 ops.layernorm(xg),
                 ops.flash_attention(qg, qg, qg, causal=False))
    for g, w in zip(with_grad, (want_a, want_l, want_f)):
        assert g.grad_fn is not None and torch.equal(g.detach(), w)


@pytest.mark.parametrize("router", [False, True], ids=["expert", "router"])
def test_dense_dit_gradients_on_the_card_match_the_cpu(cuda, router):
    """One loss through the reduced dense DiT on the card (every LayerNorm
    and self-attention through the kernels and their backward kernels)
    against the same loss on the CPU (plain versions): every parameter
    leaf's gradient within ``1e-4 · max |want|`` (float32 GEMM chains
    through two layers in another order), and non-zero wherever the CPU's
    is (the router's unused final layer gets zeros on both); launches
    ``(3L + 1)`` AdaLN (``2L`` for the router) and ``L`` attention,
    forward and backward alike."""
    from repro_torch.models import dit as D
    from repro_torch.models.config import dit_b2, router_b2
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg = (router_b2(num_clusters=3) if router else dit_b2()).reduced(
        latent_size=16)
    gen = torch.Generator().manual_seed(11)
    params = tree_map(lambda a: a + 0.02 * torch.randn(a.shape, generator=gen),
                      D.init(cfg, gen))
    x = torch.randn(3, 16, 16, 4, generator=gen)
    t = torch.rand(3, generator=gen)
    text = torch.randn(3, cfg.text_len, cfg.text_dim, generator=gen)
    drop = torch.tensor([False, True, False])

    def grads(dev):
        cond = {} if router else dict(text_emb=text.to(dev),
                                      drop_mask=drop.to(dev))
        loss, g = value_and_grad(lambda p: (D.apply(
            cfg, p, x.to(dev), t.to(dev), **cond) ** 2).mean(),
            tree_map(lambda a: a.to(dev), params))
        return loss, tree_leaves(g)

    want_loss, want = grads("cpu")
    ops.reset_launches()
    got_loss, got = grads(cuda)
    torch.cuda.synchronize()
    layers = cfg.num_layers
    n_ln = 2 * layers if router else 3 * layers + 1
    assert ops.LAUNCHES["adaln_fuse"] == ops.LAUNCHES["adaln_fuse_bwd"] \
        == n_ln
    assert ops.LAUNCHES["flash_attention"] == \
        ops.LAUNCHES["flash_attention_bwd"] == layers
    assert abs(got_loss.item() - want_loss.item()) <= \
        1e-5 * abs(want_loss.item())
    for g, w in zip(got, want):
        g = g.cpu()
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-4 * scale
        assert scale == 0.0 or g.abs().max().item() > 0.0


# ---------------------------------------------------------------------------
# The SSD scan's backward kernel and LM training on the card
# ---------------------------------------------------------------------------

#: ssd_scan_bwd against ref_ssd_scan_bwd, each float32 gradient within
#: ``SSD_BWD_REL · max |want|``: both compute the chunked backward in
#: float32 from the same decay factors, summing in another order (sums
#: of up to 128·64 products, a reverse cumulative sum of 128 terms of
#: both signs for ddt, and Σ over every position and batch for dA); bf16
#: gradients (dx, dB, dC of bf16 inputs) round once from float32 on both
#: sides: one bf16 ulp (2⁻⁷ of max).
SSD_BWD_REL = 1e-4


def _ssd_bwd_check(cuda, b, h, s, p, n, dtype, chunk, seed, with_dstate,
                   skew=0):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

    x, dt, A, B, C = _ssd_views(cuda, b, h, s, p, n, dtype, seed=seed,
                                skew=skew)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    dy = torch.randn(b, s, h, p, generator=gen, device=cuda).to(
        dtype).transpose(1, 2)
    ds = (torch.randn(b, h, p, n, generator=gen, device=cuda)
          if with_dstate else None)
    y, state, starts = ssd_scan(x, dt, A, B, C, chunk=chunk,
                                with_starts=True)
    got = ssd_scan_bwd(x, dt, A, B, C, starts, dy, ds, chunk=chunk)
    want = ref.ref_ssd_scan_bwd(x, dt, A, B, C, dy, ds, chunk=chunk)
    again = ssd_scan_bwd(x, dt, A, B, C, starts, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    for name, g, w, g2 in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                              again):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        rel = 2.0 ** -7 if g.dtype == torch.bfloat16 else SSD_BWD_REL
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rel * w.float().abs().max().item(), (name, err)
        assert torch.equal(g, g2), name               # no atomics
    # the tile-start states are the final states of the prefixes
    for k in range(1, starts.shape[2]):
        _, sk = ops.ssd_scan(x[:, :, :k * chunk], dt[..., :k * chunk], A,
                             B[:, :k * chunk], C[:, :k * chunk], chunk=chunk)
        assert torch.equal(starts[:, :, k], sk)
    assert not bool(starts[:, :, 0].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_dstate", [False, True], ids=["ds0", "ds"])
@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (2, 8, 512, 64, 128, 128),      # mamba2-2.7b head shape, 4 tiles
    (1, 4, 100, 64, 128, 128),      # S < chunk: one partial tile
    (2, 3, 64, 32, 16, 16),         # the reduced config's shape
    (1, 2, 48, 8, 32, 8),           # small head and state, chunk 8
    (1, 3, 300, 36, 24, 128),       # a partial last tile, P 36, N 24
])
def test_ssd_scan_bwd_kernel_matches_plain(cuda, dtype, with_dstate, b, h, s,
                                           p, n, chunk):
    """The backward kernel against its plain version: every gradient
    within its tolerance, bitwise repeatable, and the forward's tile-start
    states equal to the prefixes' final states."""
    _ssd_bwd_check(cuda, b, h, s, p, n, dtype, chunk, s + p + n,
                   with_dstate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_scan_bwd_kernel_unaligned_views(cuda, dtype):
    """x, B and C rows off 16-byte alignment (the prep's element path)."""
    _ssd_bwd_check(cuda, 2, 3, 200, 64, 128, dtype, 40, 3, True, skew=1)


def test_ssd_scan_bwd_kernel_mixer_shape(cuda):
    """mamba2-2.7b's mixer in one training step, bf16."""
    _ssd_bwd_check(cuda, 4, 80, 1024, 64, 128, torch.bfloat16, 128, 16,
                   False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,s,p,n,chunk,with_dstate", [
    (2, 1, 256, 64, 128, 128, True),     # one head: one group of 16
    (2, 7, 256, 64, 128, 128, False),    # 7 heads: a partial group
    (1, 83, 256, 64, 128, 128, True),    # 83 heads: 5 groups and 3 heads
    (2, 4, 129, 64, 128, 128, True),     # one position in the last tile
    (1, 3, 40, 16, 16, 1, True),         # chunk 1: 40 tiles of 1 position
    (1, 5, 128, 64, 128, 128, True),     # batch 1, one tile
])
def test_ssd_scan_bwd_kernel_grid_edges(cuda, dtype, b, h, s, p, n, chunk,
                                        with_dstate):
    """The backward's grid at its edges: head counts that do not fill the
    16-head groups of the main kernel, a last tile of one position, tiles
    of one position, and one tile (no carry)."""
    _ssd_bwd_check(cuda, b, h, s, p, n, dtype, chunk, s + h + chunk,
                   with_dstate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_dstate", [False, True], ids=["ds0", "ds"])
@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (2, 8, 512, 64, 128, 128),      # mamba2-2.7b head shape, 4 tiles
    (2, 3, 64, 32, 16, 16),         # the reduced config's shape
    (1, 3, 300, 36, 24, 128),       # a partial last tile, P 36, N 24
    (1, 2, 40, 8, 8, 1),            # chunk 1
])
def test_ssd_scan_bwd_states_kernel_matches_plain(cuda, dtype, with_dstate,
                                                  b, h, s, p, n, chunk):
    """The backward's first stage (the tiles' local sums and their carry)
    against ``ref_ssd_scan_bwd_states``: the gradient of the state at each
    tile's end within ``SSD_BWD_REL`` of max (sums of 128 products in
    another order, then up to 8 steps of the carry), bitwise repeatable;
    the last tile's is ``d_state`` (or zero) itself."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_states

    x, dt, A, B, C = _ssd_views(cuda, b, h, s, p, n, dtype, seed=s + n)
    gen = torch.Generator(device=cuda).manual_seed(s)
    dy = torch.randn(b, s, h, p, generator=gen, device=cuda).to(
        dtype).transpose(1, 2)
    ds = (torch.randn(b, h, p, n, generator=gen, device=cuda)
          if with_dstate else None)
    got = ssd_scan_bwd_states(x, dt, A, B, C, dy, ds, chunk=chunk)
    again = ssd_scan_bwd_states(x, dt, A, B, C, dy, ds, chunk=chunk)
    want = ref.ref_ssd_scan_bwd_states(dt, A, C, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, h, -(-s // chunk), p, n)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= SSD_BWD_REL * want.abs().max().item(), err
    assert torch.equal(got, again)
    assert torch.equal(got[:, :, -1], ds if with_dstate
                       else torch.zeros_like(got[:, :, -1]))


def test_ssd_scan_grad_calls_the_backward_kernel(cuda):
    """``ops.ssd_scan`` on inputs that require grad: one forward and one
    backward launch, the gradients those of the launcher; a call the
    backward does not take raises ``NotImplementedError``."""
    x, dt, A, B, C = _ssd_views(cuda, 2, 3, 64, 32, 16, torch.float32, 9)
    leaves = [a.detach().requires_grad_(True) for a in (x, dt, A, B, C)]
    ops.reset_launches()
    y, state = ops.ssd_scan(*leaves, chunk=16)
    assert y.grad_fn is not None
    dy = torch.randn_like(y)
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "ssd_scan": 1, "ssd_scan_bwd": 1}
    want = ref.ref_ssd_scan_bwd(x, dt, A, B, C, dy, chunk=16)
    for g, w in zip(grads, want):
        err = (g - w).abs().max().item()
        assert err <= SSD_BWD_REL * w.abs().max().item(), err
    xg = leaves[0]
    with pytest.raises(NotImplementedError, match="ssd_scan backward"):
        ops.ssd_scan(xg.to(torch.float16), dt, A, B.to(torch.float16),
                     C.to(torch.float16), chunk=16)
    with pytest.raises(NotImplementedError, match="ssd_scan backward"):
        ops.ssd_scan(xg, dt, A, B.to(torch.bfloat16), C, chunk=16)
    big = torch.randn(1, 2, 16, 128, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="P ≤ 64"):
        ops.ssd_scan(big, dt[:1, :2, :16], A[:2], B[:1, :16], C[:1, :16],
                     chunk=16)
    with torch.no_grad():
        y0, s0 = ops.ssd_scan(*leaves, chunk=16)
    assert y0.grad_fn is None
    assert torch.equal(y0, y.detach()) and torch.equal(s0, state.detach())


def _old_forward(cfg, params, tokens):
    """``forward_train`` as it ran before the layers' leaves were unbound:
    each layer's parameters ``a[i]`` of the stacks."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.tree import tree_map

    h = L.embed(params["embed"], tokens, cfg.activation_dtype)
    for i in range(cfg.num_layers):
        bp = tree_map(lambda a: a[i], params["blocks"])
        y, _ = M.mixer_apply(cfg, bp["mixer"],
                             L.rmsnorm(bp["ln"], h, cfg.norm_eps))
        h = h + y
    h = L.rmsnorm(params["ln_final"], h, cfg.norm_eps)
    return L.dense(params["unembed"], h)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_mamba2_layers_unbound_are_bitwise_the_stack_views(cuda, bf16):
    """Serving unchanged: ``forward_train``'s logits and ``prefill``'s
    cache bitwise those of layers taken as ``a[i]`` views; under grad with
    remat on and off, the logits are the same bits as well."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import zoo
    from repro_torch.tree import tree_map

    over = dict(param_dtype=torch.bfloat16,
                activation_dtype=torch.bfloat16) if bf16 else {}
    cfg = get_config("mamba2-2.7b").reduced(**over)
    params = zoo.init(cfg, torch.Generator(device=cuda).manual_seed(3), cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(4))
    with torch.no_grad():
        want = _old_forward(cfg, params, toks)
        got, _ = zoo.forward_train(cfg, params, {"tokens": toks})
        last, cache = zoo.prefill(cfg, params, {"tokens": toks})
        h = L.embed(params["embed"], toks, cfg.activation_dtype)
        caches = []
        for i in range(cfg.num_layers):
            bp = tree_map(lambda a: a[i], params["blocks"])
            y, c = M.mixer_apply(cfg, bp["mixer"],
                                 L.rmsnorm(bp["ln"], h, cfg.norm_eps))
            h = h + y
            caches.append(c)
        hl = L.rmsnorm(params["ln_final"], h[:, -1:], cfg.norm_eps)
        want_last = L.dense(params["unembed"], hl)[:, 0]
    assert torch.equal(got, want)
    assert torch.equal(last, want_last)
    assert torch.equal(cache["conv"], torch.stack([c for c, _ in caches]))
    assert torch.equal(cache["ssm"], torch.stack([s for _, s in caches]))
    live = tree_map(lambda a: a.detach().requires_grad_(True), params)
    for remat in (False, True):
        lg, _ = zoo.forward_train(dataclasses.replace(cfg, remat=remat),
                                  live, {"tokens": toks})
        assert lg.grad_fn is not None and torch.equal(lg.detach(), want)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_mamba2_gradients_on_the_card_match_the_cpu(cuda, remat):
    """A loss through ``zoo.loss_fn`` of the reduced float32 mamba2 on the
    card (every mixer's scan through the scan kernel and its backward
    kernel) against the CPU (plain versions): every leaf's gradient within
    ``1e-4 · max |want|`` and non-zero wherever the CPU's is — the scan's
    output carries a gradient into x, B, C, dt, A_log, dt_bias, the conv
    and ``in_proj``, not only through the D skip and the gate.  Launches:
    one scan and one backward a layer (two scans under remat)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(),
                              remat=remat, logits_chunk=16)
    params = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def grads(dev):
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, g = value_and_grad(lambda p: zoo.loss_fn(cfg, p, b),
                                 tree_map(lambda a: a.to(dev), params),
                                 has_aux=True)
        return loss[0], tree_leaves(g)

    want_loss, want = grads("cpu")
    ops.reset_launches()
    got_loss, got = grads(cuda)
    torch.cuda.synchronize()
    layers = cfg.num_layers
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "ssd_scan": layers * (2 if remat else 1), "ssd_scan_bwd": layers}
    assert abs(got_loss.item() - want_loss.item()) <= \
        1e-5 * abs(want_loss.item())
    for g, w in zip(got, want):
        g = g.cpu()
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-4 * scale
        assert scale == 0.0 or g.abs().max().item() > 0.0


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch,over", [
    ("internlm2-1.8b", dict(num_kv_heads=2)),   # GQA 4/2
    ("zamba2-2.7b", {}),
    ("zamba2-2.7b", dict(head_dim=80)),         # the full model's head
], ids=["dense", "hybrid", "hybrid_D80"])
def test_dense_and_hybrid_gradients_on_the_card_match_the_cpu(cuda, arch,
                                                              over, remat):
    """A loss through ``zoo.loss_fn`` of the reduced float32 dense and
    hybrid models on the card (every causal attention through the
    attention kernel and its backward kernel, every mixer's scan through
    the scan kernels) against the CPU (plain versions): the loss within
    ``1e-5``, every leaf's gradient within ``1e-4 · max |want|`` and
    non-zero wherever the CPU's is.  Launches: one attention forward and
    one backward a layer (a shared-block application for the hybrid), the
    forward twice under remat; the hybrid's scans as the mamba2 test's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import hybrid, zoo
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(arch).reduced(**over), remat=remat,
                              logits_chunk=16)
    params = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def grads(dev):
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, g = value_and_grad(lambda p: zoo.loss_fn(cfg, p, b),
                                 tree_map(lambda a: a.to(dev), params),
                                 has_aux=True)
        return loss[0], tree_leaves(g)

    want_loss, want = grads("cpu")
    ops.reset_launches()
    got_loss, got = grads(cuda)
    torch.cuda.synchronize()
    fwd = 2 if remat else 1
    if cfg.arch_type == "dense":
        attn, scans = cfg.num_layers, 0
    else:
        attn, scans = hybrid.num_groups(cfg), cfg.num_layers
    expect = {"flash_attention": attn * fwd, "flash_attention_bwd": attn}
    if scans:
        expect.update(ssd_scan=scans * fwd, ssd_scan_bwd=scans)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == expect
    assert abs(got_loss.item() - want_loss.item()) <= \
        1e-5 * abs(want_loss.item())
    for g, w in zip(got, want):
        g = g.cpu()
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-4 * scale
        assert scale == 0.0 or g.abs().max().item() > 0.0


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
def test_inplace_adamw_is_bitwise_the_functional_update_on_the_card(cuda,
                                                                   clip):
    """``adamw_update_`` (in place, a slice of each leaf at a time)
    against ``adamw_update`` on the card, three steps: parameters,
    moments, grad norm and lr bitwise equal (the same elementwise
    operations, and the norm's sums over the same whole leaves)."""
    from repro_torch.training import optimizer as Opt
    from repro_torch.tree import tree_leaves, tree_map

    g = torch.Generator(device=cuda).manual_seed(8)
    params = {"stack": torch.randn(4, 300, 257, generator=g, device=cuda)
              .to(torch.bfloat16),
              "w": torch.randn(1000, 33, generator=g, device=cuda),
              "s": torch.randn((), generator=g, device=cuda)}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g, device=cuda)
                     .to(p.dtype), params)
    cfg = Opt.AdamWConfig(learning_rate=1e-2, warmup_steps=2,
                          clip_norm=clip, weight_decay=1e-2)
    old = Opt.SLICE_ELEMS
    Opt.SLICE_ELEMS = 4096
    try:
        p1, s1 = params, Opt.adamw_init(params)
        p2 = tree_map(torch.clone, params)
        s2 = Opt.adamw_init(p2)
        for _ in range(3):
            p1, s1, m1 = Opt.adamw_update(cfg, grads, s1, p1)
            p2, s2, m2 = Opt.adamw_update_(cfg, grads, s2, p2)
            assert torch.equal(m1["grad_norm"], m2["grad_norm"])
            assert torch.equal(m1["lr"], m2["lr"])
            for a, b in zip(tree_leaves((p1, s1.mu, s1.nu)),
                            tree_leaves((p2, s2.mu, s2.nu))):
                assert torch.equal(a, b)
    finally:
        Opt.SLICE_ELEMS = old


# ---------------------------------------------------------------------------
# The prefix-LM mask (paligemma-3b) and the D 256 backward
# ---------------------------------------------------------------------------

#: (B, Hq, Hkv, S, D, P) of the prefix-LM cases: paligemma's MQA (8 query
#: heads over 1) at D 64, 128 and its own 256, a prefix past a query
#: tile, a prefix of 1, a prefix past S (no mask at all), ragged S, a GQA
#: group
PREFIX = [(2, 8, 1, 200, 64, 40), (1, 4, 2, 130, 128, 64),
          (2, 8, 1, 150, 256, 70), (1, 2, 1, 100, 256, 1),
          (1, 2, 2, 77, 128, 90), (2, 8, 1, 320, 256, 256)]
PREFIX_IDS = ["mqa_d64", "gqa_d128_tile", "mqa_d256", "d256_p1",
              "d128_past_s", "paligemma_d256"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,prefix", PREFIX, ids=PREFIX_IDS)
def test_flash_attention_prefix_matches_plain(cuda, b, hq, hkv, s, d, prefix,
                                              dtype):
    """The forward kernel under the prefix-LM mask, causal, on ``(B, S, H,
    D)`` projections seen as ``(B, H, S, D)`` (as ``transformer._attn_full``
    hands them over): one launch on the FFMA template (bf16 at D 64 and
    128 too: a prefix never takes the tensor-core kernel), the output
    against the plain version and the row log-sum-exp against the plain
    one within ``1e-5`` of its largest magnitude."""
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=cuda).manual_seed(s + d + prefix)
    q = torch.randn(b, s, hq, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    assert flash_design(q, k, v, prefix_len=prefix) == "FFMA"
    ops.reset_launches()
    got = ops.flash_attention_gqa(q, k, v, causal=True, prefix_len=prefix)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    rep = hq // hkv
    kr, vr = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    _close(got, ref.ref_flash_attention(q, kr, vr, causal=True,
                                        prefix_len=prefix))
    again, lse = flash_attention(q, k, v, causal=True, prefix_len=prefix,
                                 with_lse=True)
    assert torch.equal(again, got)
    want = _plain_lse(q, kr, True, 0, d ** -0.5, prefix)
    err = (lse - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,prefix", PREFIX, ids=PREFIX_IDS)
def test_flash_attention_bwd_kernel_prefix(cuda, b, hq, hkv, s, d, prefix,
                                           dtype):
    """The backward kernel under the prefix-LM mask (the FFMA route: key
    tiles below P see every query tile; D 256 on key tiles of 32) against
    the plain version, bitwise repeatable, one forward and one backward
    launch under autograd (``_bwd_check``)."""
    _bwd_check(cuda, b, hq, hkv, s, d, True, 0, dtype, prefix=prefix)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (2, 4, 2, 257, 64, 70),           # a window with a prefix of 100
    (1, 8, 1, 200, 256, 0),           # D 256 causal, no prefix
    (1, 4, 4, 130, 192, 0),           # D 192 on the D 256 template
])
def test_flash_attention_bwd_kernel_wide_and_windowed_prefix(
        cuda, b, hq, hkv, s, d, window, dtype):
    """The FFMA backward with a window and a prefix together (a prefix
    query sees every prefix key, a later one the window's), and at D 256
    and 192 (the D 256 instance, its lanes past D idle) without a prefix,
    against the plain version."""
    prefix = 100 if window else 0
    _bwd_check(cuda, b, hq, hkv, s, d, True, window, dtype, prefix=prefix)


def test_flash_attention_prefix_route_by_profiler(cuda):
    """Under ``torch.profiler``: a bf16 prefix call at D 128 with 16-byte
    staging — which the tensor-core rule takes without a prefix — launches
    the FFMA forward template alone, and its backward Δ, the FFMA tile
    kernel and the dQ sums; paligemma's D 256 the same.  Without the
    prefix the D 128 call runs the tensor-core kernels."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    gen = torch.Generator(device=cuda).manual_seed(33)
    for d, p in ((128, 64), (256, 64), (128, 0)):
        q, k, v, do = (torch.randn(2, 256, h, d, generator=gen, device=cuda)
                       .to(torch.bfloat16).transpose(1, 2)
                       for h in (8, 1, 1, 8))
        kw = dict(causal=True, prefix_len=p)
        fwd = _kernels_launched(lambda: flash_attention(q, k, v, **kw))
        out, lse = flash_attention(q, k, v, with_lse=True, **kw)
        bwd = _kernels_launched(lambda: flash_attention_bwd(
            q, k, v, out, lse, do, **kw))
        route = "wgmma bf16" if p == 0 else "FFMA"
        assert fwd == ({"flash_attention_bf16_tc_kernel": 1} if p == 0
                       else {"flash_attention_kernel": 1}), (d, p, fwd)
        assert bwd == BWD_ROUTES[route], (d, p, bwd)


def test_bwd_tile_attrs_at_every_width(cuda):
    """The FFMA tile kernel's registers, spill bytes and shared bytes as
    built, at each width's instance: at most 255 registers, shared memory
    within a block's 227 KB (D 256 float32: key tiles of 32, 220,672
    bytes)."""
    from repro_torch.kernels.flash_attention import bwd_tile_attrs

    for d in (64, 128, 256):
        for dtype in (torch.float32, torch.bfloat16):
            a = bwd_tile_attrs(d, dtype)
            print(f"flash_attention_bwd_tile D {d} {dtype}: {a}")
            assert 0 < a["registers"] <= 255
            assert a["smem_bytes"] <= 232448
    assert bwd_tile_attrs(256, torch.float32)["smem_bytes"] == 220672


@pytest.mark.parametrize("over", [{}, dict(head_dim=256)],
                         ids=["d64", "d256"])
def test_paligemma_reduced_on_the_card_matches_the_cpu(cuda, over):
    """The reduced float32 paligemma-3b (2 layers, d 256, 4 query heads
    over 1 of D 64, and of D 256; 8 patches) on the card against the CPU
    run (plain versions), from the same parameters, tokens and patches:
    ``forward_train`` logits and ``prefill`` logits and every cache leaf
    (2 prefix attention launches each), a ``decode_step`` (none), each
    within ``1e-4 · max|out|``; one gradient step of ``loss_fn`` under
    remat: 4 attention launches (the recompute's too) and 2 backward
    launches, the loss within ``1e-4`` and every gradient leaf within
    ``1e-4`` of its largest."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.models.frontend_stubs import vision_patch_embeddings
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("paligemma-3b").reduced(**over)
    params = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=gen)
    patches = vision_patch_embeddings(cfg, 2, seed=2, device="cpu")
    card = tree_map(lambda a: a.to(cuda), params)

    def on(dev, n=40, **more):
        return {"tokens": toks[:, :n].to(dev),
                "vision_embeds": patches.to(dev),
                **{k: v.to(dev) for k, v in more.items()}}

    def close(got, want, rel=1e-4):
        err = (got.detach().cpu() - want.detach()).abs().max().item()
        assert err <= rel * want.abs().max().item(), err

    want, _ = zoo.forward_train(cfg, params, on("cpu"))
    ops.reset_launches()
    got, _ = zoo.forward_train(cfg, card, on(cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 2
    close(got, want)
    wl, wc = zoo.prefill(cfg, params, on("cpu", 24))
    ops.reset_launches()
    gl, gcache = zoo.prefill(cfg, card, on(cuda, 24))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 2
    close(gl, wl)
    for key in wc:
        if key == "pos":
            assert torch.equal(gcache[key].cpu(), wc[key])
        else:
            close(gcache[key], wc[key])
    pos = torch.full((2,), cfg.vision_prefix_len + 24, dtype=torch.int32)
    wd, _ = zoo.decode_step(cfg, params, wc, toks[:, 24:25], pos)
    ops.reset_launches()
    gd, _ = zoo.decode_step(cfg, card, gcache, toks[:, 24:25].to(cuda),
                            pos.to(cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 0
    close(gd, wd)
    rc = dataclasses.replace(cfg, remat=True)
    labels = {"labels": toks[:, 1:]}
    (wloss, _), wg = value_and_grad(
        lambda p: zoo.loss_fn(rc, p, on("cpu", **labels)), params,
        has_aux=True)
    ops.reset_launches()
    (gloss, _), gg = value_and_grad(
        lambda p: zoo.loss_fn(rc, p, on(cuda, **labels)), card,
        has_aux=True)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "flash_attention": 4, "flash_attention_bwd": 2}
    close(gloss, wloss)
    for i, (g, w) in enumerate(zip(tree_leaves(gg), tree_leaves(wg))):
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (i, err)
