"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX, so on a GPU
machine without JAX they run with::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: the GEMM kernel sums in another order than cuBLAS/ATen
(``rtol = atol = 1e-5`` relative to O(1) operands scaled by ``1/sqrt(D)``);
the step kernel is built without FMA contraction and matches its plain
version's operation order, so it is compared at ``max |Δ| ≤ 1e-6 ·
max |out|``.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ops, ref


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
