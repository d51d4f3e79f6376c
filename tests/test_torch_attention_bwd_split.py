"""The bf16 attention backward's tensor-core arithmetic, written in plain
torch, against ``jax.vjp`` of the reference's training attention on the
CPU.

On the card, bf16 attention gradients at a head dim that is a multiple of
16 (up to 128) go through two ``wgmma`` kernels
(``csrc/flash_attention_bwd.cu``, ``bwd::tc``): S = q·kᵀ and dP = dO·vᵀ
as float32 sums of exact bf16 products, P = exp(S·scale − lse) and
dS = P ∘ (dP − Δ) in float32, then dV = Pᵀ·dO, dK = scale·dSᵀ·q and
dQ = scale·dS·k with P and dS each split in two bf16 terms
(hi = bf16(x), lo = bf16(x − hi)) through the tensor cores into float32,
and dq, dk, dv rounded to bf16 once.  ``_tensor_core_bwd`` writes that
rounding out; the same seeded numpy inputs, rounded to bf16, go through
``jax.vjp`` of ``repro.models.layers.chunked_attention`` (float32
softmax, on float32 copies of the bf16 values, as the reference widens
them) at a reduced causal shape of each LM: internlm2-1.8b's head (D 128,
GQA 16/8 cut to 4/2) and zamba2-2.7b's (D 80, MHA 4/4), S 256.

The card's tolerance: each gradient within ``GRAD_REL`` of the largest of
the three plus ``BF16_GRAD_REL`` (2⁻⁷) of its own largest |value| (the
final rounding and Δ from the forward's bf16 output,
``tests/test_torch_cuda.py``).  With one bf16 term of P and dS the error
grows: the test measures both, so it shows why the split is there.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

GRAD_REL = 1e-5
BF16_GRAD_REL = 2.0 ** -7
#: the split's own error, against the same arithmetic with P and dS
#: unsplit in float32, as a share of each gradient's largest |value|: two
#: bf16 terms keep 16 bits (measured 2.2e-6 – 3.6e-6, near 2⁻¹⁸); one
#: term keeps 8 (1.6e-3 – 2.4e-3, near 2⁻⁹), most of the card's 2⁻⁷
SPLIT_TWO, SPLIT_ONE = 2.0 ** -15, 2.0 ** -12


def _terms(x: torch.Tensor, terms: int) -> torch.Tensor:
    """``x`` as the sum of its ``terms`` bf16 terms in float32 (0: ``x``
    itself, unsplit)."""
    if terms == 0:
        return x
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if terms == 2 else hi


def _tensor_core_bwd(q, k, v, do, *, causal, terms, rounded=True):
    """The tensor-core route's arithmetic on bf16 ``(B, H, S, D)`` q, dO
    and ``(B, Hkv, S, D)`` k, v: the forward's row lse (float32) and its
    output rounded to bf16, Δ = Σ dO·out in float32, P and dS in float32
    split in ``terms`` bf16 terms before the three products (0: left
    unsplit, the same arithmetic in float32), dk and dv
    summed over each group of query heads in float32; ``(dq, dk, dv)``
    rounded once to bf16 (``rounded``) or left in float32."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    scale = 1.0 / d ** 0.5
    qf, dof = q.float(), do.float()
    kf, vf = (a.float().repeat_interleave(g, dim=1) for a in (k, v))
    logits = (qf @ kf.transpose(-1, -2)) * scale
    pos = torch.arange(s)
    if causal:
        logits = logits.masked_fill(pos[None] > pos[:, None], -torch.inf)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - lse)
    out = (p @ vf).to(torch.bfloat16).float()
    delta = (dof * out).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    p2, ds2 = _terms(p, terms), _terms(ds, terms)
    dv = p2.transpose(-1, -2) @ dof
    dk = (ds2.transpose(-1, -2) @ qf) * scale
    dq = (ds2 @ kf) * scale
    dk, dv = (a.reshape(b, h // g, g, s, d).sum(dim=2) for a in (dk, dv))
    grads = (dq, dk, dv)
    if rounded:
        grads = tuple(a.to(torch.bfloat16).float() for a in grads)
    return grads


def _jax_grads(q, k, v, do, causal):
    """``jax.vjp`` of ``chunked_attention`` on float32 copies of the bf16
    values, in the kernel's ``(B, H, S, D)`` layout."""
    s = q.shape[2]
    pos = jnp.arange(s)

    def f(q, k, v):
        return JL.chunked_attention(q, k, v, q_positions=pos,
                                    kv_positions=pos, causal=causal,
                                    chunk_size=64)

    def bshd(a):
        return jnp.asarray(a.float().numpy().transpose(0, 2, 1, 3))

    _, vjp = jax.vjp(f, bshd(q), bshd(k), bshd(v))
    return [torch.from_numpy(np.array(w).transpose(0, 2, 1, 3))
            for w in vjp(bshd(do))]


#: (id, B, Hq, Hkv, S, D): each LM's attention head at a reduced width
LM_HEADS = [("internlm2_D128_gqa4_2", 1, 4, 2, 256, 128),
            ("zamba2_D80_mha4", 1, 4, 4, 256, 80)]


@pytest.mark.parametrize("b,hq,hkv,s,d", [c[1:] for c in LM_HEADS],
                         ids=[c[0] for c in LM_HEADS])
def test_two_term_backward_matches_jax_vjp(b, hq, hkv, s, d):
    """Causal bf16 gradients through the tensor-core route's arithmetic
    are within the card's tolerance of ``jax.vjp`` of ``chunked_attention``;
    the split's own error is ``SPLIT_TWO`` at most with two bf16 terms of P
    and dS, and at least ``SPLIT_ONE`` with one."""
    rng = np.random.default_rng(b * hq + s + d)

    def draw(h, sd=1.0):
        a = (sd * rng.standard_normal((b, h, s, d))).astype(np.float32)
        return torch.from_numpy(a).to(torch.bfloat16)
    q, k, v, do = draw(hq), draw(hkv), draw(hkv), draw(hq, 0.1)
    want = _jax_grads(q, k, v, do, True)
    got = _tensor_core_bwd(q, k, v, do, causal=True, terms=2)
    top = max(w.abs().max().item() for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g - w).abs().max().item()
        tol = GRAD_REL * top + BF16_GRAD_REL * w.abs().max().item()
        assert err <= tol, (name, err, tol)
    # the split alone: against the same arithmetic with P and dS unsplit
    exact, two, one = (_tensor_core_bwd(q, k, v, do, causal=True,
                                        terms=t, rounded=False)
                       for t in (0, 2, 1))
    for name, x, a, c, w in zip(("dq", "dk", "dv"), exact, two, one, want):
        top_w = w.abs().max().item()
        err_two, err_one = ((y - x).abs().max().item() / top_w
                            for y in (a, c))
        note = (f"{name}: two bf16 terms {err_two:.3g} of max|grad|, one "
                f"term {err_one:.3g}")
        assert err_two <= SPLIT_TWO, note
        assert err_one >= SPLIT_ONE, note


def test_bwd_design_rule():
    """``bwd_design`` mirrors the backward launcher's rule: bf16 with D a
    multiple of 16 up to 128 and 16-byte staging of q, k, v, dO and the
    gradients takes the tensor-core route — the LM training shapes as the
    models lay them out (``(B, S, H, D)`` projections seen as ``(B, H, S,
    D)``) too; float32 (the DiT), bf16 at D 40 or 72, and a view one
    element off 16-byte alignment take the FFMA route."""
    from repro_torch.kernels.flash_attention import bwd_design

    def bshd(b, s, h, d, dtype=torch.bfloat16):
        return torch.zeros(b, s, h, d, dtype=dtype).transpose(1, 2)

    q, kv = bshd(4, 1024, 16, 128), bshd(4, 1024, 8, 128)
    assert bwd_design(q, kv, kv, q) == "wgmma bf16"
    z = bshd(4, 1024, 32, 80)
    assert bwd_design(z, z, z, z) == "wgmma bf16"
    for d in (16, 48, 112):
        x = torch.zeros(2, 3, 100, d, dtype=torch.bfloat16)
        assert bwd_design(x, x, x, x) == "wgmma bf16"
    f = bshd(32, 256, 12, 64, torch.float32)
    assert bwd_design(f, f, f, f) == "FFMA"
    for d in (40, 72):
        x = torch.zeros(1, 3, 77, d, dtype=torch.bfloat16)
        assert bwd_design(x, x, x, x) == "FFMA"
    flat = torch.zeros(2 * 4 * 150 * 64 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(2, 150, 4, 64).transpose(1, 2)
    assert bwd_design(off, off, off, off) == "FFMA"
    # dO alone off alignment
    flat = torch.zeros(4 * 1024 * 16 * 128 + 1, dtype=torch.bfloat16)
    do = flat[1:].view(4, 1024, 16, 128).transpose(1, 2)
    assert bwd_design(q, kv, kv, do) == "FFMA"
