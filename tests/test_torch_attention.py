"""The port's AdaLN, attention and flag-form fuse wrappers against the JAX
package's, on the CPU, and the served DiT through them.

The same numpy inputs, drawn from a seed, go through the reference's
``kernels/ops.py`` wrapper — under its oracle (``REPRO_FORCE_PALLAS=0``)
and under ``REPRO_FORCE_PALLAS=1``, which runs the Pallas kernel in
interpret mode — and through the port's wrapper, which on CPU tensors
runs the kernel's plain version (``repro_torch/kernels/ref.py``).  The
shape sweeps mirror ``tests/test_kernels.py``.  The CUDA kernels are held
against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances, each relative to the output's scale ``max|want|``:

* float32 attention and AdaLN: ``1e-5`` — float32 sums in another order
  (XLA's dot and reductions against ATen's; the Pallas kernel's online
  softmax rescales as it goes);
* bf16 outputs: ``2⁻⁷`` — both sides compute in float32 from the same
  bf16 inputs and round once, so an ulp-level float32 difference can flip
  one bf16 rounding (one ulp ≤ 2⁻⁷ of the value);
* ``fused_convert_and_fuse``: analytic derivatives ``1e-5``; with
  ``derivative_mode="fd"`` the §8.3.3 differences move by up to 6e-4
  (one ulp of ``cos``/``sin`` over ``2h``, see ``tests/test_torch_core.py``),
  times ``|x̂0| ≤ clamp`` and ``|ε|``: ``max|Δ| ≤ 6e-4 · (clamp + max|ε|)``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.conversion import ConversionConfig as JConversionConfig
from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.core.schedules import get_schedule as j_get_schedule
from repro.kernels import ops as jops
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models import layers as JL
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro.training import checkpoint as jckpt
from repro_torch.core.conversion import ConversionConfig
from repro_torch.core.sampling import SamplerConfig
from repro_torch.core.schedules import get_schedule
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.tree import tree_map

F32_REL = 1e-5
BF16_REL = 2.0 ** -7
FD_DERIV_ATOL = 6e-4

PALLAS = pytest.mark.parametrize("pallas", ["0", "1"],
                                 ids=["oracle", "pallas"])


def _draw(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _pair(a, dtype):
    """The same values for both packages, rounded once to ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(a)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return j, t


def _assert_rel(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# --- flash attention ---------------------------------------------------------

FLASH_CASES = [
    # (b, h, s, d, causal, window, dtype, bq, bk) — tests/test_kernels.py
    (2, 3, 128, 32, True, 0, jnp.float32, 64, 64),
    (1, 2, 256, 64, True, 64, jnp.float32, 64, 128),
    (2, 2, 128, 16, False, 0, jnp.float32, 32, 64),
    (1, 4, 256, 32, True, 0, jnp.bfloat16, 128, 128),
    (1, 1, 64, 128, True, 16, jnp.bfloat16, 64, 32),
    # the DiT's self-attention: non-causal, 64 tokens at the reduced width
    (4, 4, 64, 32, False, 0, jnp.float32, 64, 64),
    # non-causal sliding window
    (1, 2, 128, 32, False, 24, jnp.float32, 64, 64),
]


@PALLAS
@pytest.mark.parametrize("b,h,s,d,causal,window,dtype,bq,bk", FLASH_CASES)
def test_flash_attention_matches_jax_ops(monkeypatch, pallas, b, h, s, d,
                                         causal, window, dtype, bq, bk):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", pallas)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_draw((b, h, s, d), i), dtype)
                                    for i in range(3))
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=bq, block_k=bk)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype
    _assert_rel(got, want, F32_REL if dtype == jnp.float32 else BF16_REL)


def test_flash_attention_softmax_scale_matches_the_pallas_kernel(
        monkeypatch):
    """``softmax_scale`` reaches the reference's kernel only: its oracle
    path (``REPRO_FORCE_PALLAS=0``) drops the keyword.  The port applies it
    on both devices, as the kernel does."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_draw((2, 2, 128, 32), 10 + i),
                                          jnp.float32) for i in range(3))
    want = jops.flash_attention(jq, jk, jv, causal=True, softmax_scale=0.3)
    got = ops.flash_attention(tq, tk, tv, causal=True, softmax_scale=0.3)
    _assert_rel(got, want, F32_REL)


@PALLAS
@pytest.mark.parametrize("hq,hkv,causal,window", [
    (8, 2, True, 48), (4, 1, True, 0), (6, 3, False, 0)])
def test_flash_attention_gqa_matches_jax_ops(monkeypatch, pallas, hq, hkv,
                                             causal, window):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", pallas)
    jq, tq = _pair(_draw((2, hq, 128, 32), 20), jnp.float32)
    (jk, tk), (jv, tv) = (_pair(_draw((2, hkv, 128, 32), 21 + i),
                                jnp.float32) for i in range(2))
    want = jops.flash_attention_gqa(jq, jk, jv, causal=causal, window=window)
    got = ops.flash_attention_gqa(tq, tk, tv, causal=causal, window=window)
    _assert_rel(got, want, F32_REL)


# --- the tensor-core kernel's bf16 p·v ---------------------------------------


def _split_pv(q, k, v, causal, window, terms):
    """The bf16 tensor-core kernel's arithmetic written in torch: float32
    logits of the bf16 values (each product exact), ``p = exp(s − m)`` in
    float32 with masked logits at probability 0, then ``p·v`` with p as
    ``terms`` bf16 terms — 2: ``p_hi = bf16(p)`` and
    ``p_lo = bf16(p − p_hi)``, 1: ``p_hi`` alone — each product exact and
    summed in float32, over ``l = Σ p``.  The float32 output before the
    kernel's one rounding to bf16."""
    s, d = q.shape[2], q.shape[3]
    logits = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / d ** 0.5)
    pos = torch.arange(s)
    mask = torch.ones(s, s, dtype=torch.bool)
    if causal:
        mask &= pos[None] <= pos[:, None]
    if window:
        mask &= pos[:, None] - pos[None] < window
    logits = logits.masked_fill(~mask, -torch.inf)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    acc = hi @ v.float()
    if terms == 2:
        acc = acc + (p - hi).to(torch.bfloat16).float() @ v.float()
    return acc / p.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("d,causal,window", [
    (80, True, 0),          # zamba2's head dim, causal
    (128, False, 0),        # internlm2's head dim, unmasked
    (64, True, 96),         # causal with a window
], ids=["D80_causal", "D128_full", "D64_causal_w96"])
def test_bf16_two_term_p_split_matches_the_reference_kernel(monkeypatch, d,
                                                            causal, window):
    """Why the bf16 tensor-core kernel splits p: q, k, v drawn from a seed
    and rounded to bf16 go through the reference's Pallas kernel
    (interpret mode) and through ``_split_pv``.  With p as two bf16 terms
    the output is within one bf16 ulp of ``max|out|`` of the reference's
    bf16 output, and within ``2⁻¹⁵`` of ``max|out|`` of its float32 output
    (the same bf16 values in float32: the reference before its rounding):
    16 bits of p, an error near 2⁻¹⁷.  One bf16 term keeps 8 bits; its
    larger error is reported in the messages, not asserted."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    pairs = [_pair(_draw((1, 2, 256, d), 60 + i), jnp.bfloat16)
             for i in range(3)]
    kw = dict(causal=causal, window=window, block_q=128, block_k=128)
    want16 = np.asarray(jops.flash_attention(*(j for j, _ in pairs), **kw)
                        .astype(jnp.float32))
    want32 = np.asarray(jops.flash_attention(
        *(j.astype(jnp.float32) for j, _ in pairs), **kw))
    tq, tk, tv = (t for _, t in pairs)
    two = _split_pv(tq, tk, tv, causal, window, terms=2)
    one = _split_pv(tq, tk, tv, causal, window, terms=1)
    top = np.abs(want32).max()
    rel_two = np.abs(two.numpy() - want32).max() / top
    rel_one = np.abs(one.numpy() - want32).max() / top
    note = (f"two bf16 terms: {rel_two:.3g} of max|out|; one bf16 term: "
            f"{rel_one:.3g}")
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want16).max())) - 7)
    err16 = np.abs(two.to(torch.bfloat16).float().numpy() - want16).max()
    assert err16 <= ulp, (err16, ulp, note)
    assert rel_two <= 2.0 ** -15, note


def test_flash_design_rule():
    """``design`` mirrors the launcher's rule: bf16 with D a multiple of
    16 up to 128 and 16-byte staging runs the tensor-core kernel — also on
    the DiT's and the LM's ``(B, S, H, D)`` projections seen as ``(B, H,
    S, D)`` — and float32, bf16 at D 72 or 144, and a view one element off
    16-byte alignment run the FFMA template."""
    from repro_torch.kernels.flash_attention import design

    def bshd(b, s, h, d, dtype=torch.bfloat16):
        return torch.zeros(b, s, h, d, dtype=dtype).transpose(1, 2)

    q, kv = bshd(4, 1024, 16, 128), bshd(4, 1024, 8, 128)
    assert design(q, kv, kv) == "wgmma bf16"
    z = bshd(4, 1024, 32, 80)
    assert design(z, z, z) == "wgmma bf16"
    for d in (16, 48, 112):
        x = torch.zeros(2, 3, 100, d, dtype=torch.bfloat16)
        assert design(x, x, x) == "wgmma bf16"
    f = bshd(32, 256, 12, 64, torch.float32)
    assert design(f, f, f) == "FFMA"
    for d in (72, 144):
        x = torch.zeros(2, 3, 100, d, dtype=torch.bfloat16)
        assert design(x, x, x) == "FFMA"
    flat = torch.zeros(2 * 3 * 100 * 64 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(2, 3, 100, 64)
    assert design(off, off, off) == "FFMA"


# --- AdaLN fuse --------------------------------------------------------------


@PALLAS
@pytest.mark.parametrize("b,s,d,bs,dtype", [
    # tests/test_kernels.py
    (3, 64, 48, 16, jnp.float32),
    (1, 256, 128, 64, jnp.float32),
    (2, 64, 64, 64, jnp.bfloat16),
    # the DiT's modulate sites at the reduced width (64 tokens, d 128)
    (4, 64, 128, 64, jnp.float32),
])
def test_adaln_modulate_matches_jax_ops(monkeypatch, pallas, b, s, d, bs,
                                        dtype):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", pallas)
    jx, tx = _pair(_draw((b, s, d), 0, 3.0), dtype)
    jg, tg = _pair(_draw((b, d), 1, 0.5), dtype)
    jb, tb = _pair(_draw((b, d), 2, 0.5), dtype)
    want = jops.adaln_modulate(jx, jg, jb, block_s=bs)
    got = ops.adaln_modulate(tx, tg, tb)
    assert got.dtype == tx.dtype
    _assert_rel(got, want, F32_REL if dtype == jnp.float32 else BF16_REL)


def test_adaln_round_scale_is_the_reference_dits_expression():
    """bf16 modulations on float32 activations (a bf16 store): the
    reference DiT computes ``L.layernorm({}, h) * (1.0 + γ) + β`` with
    ``1.0 + γ`` in bf16; ``round_scale`` gives that, and the plain
    ``adaln_modulate`` (``1 + γ`` in float32, as the reference's kernel
    and wrapper compute it) differs from it by more than rounding."""
    jx, tx = _pair(_draw((2, 64, 128), 3, 2.0), jnp.float32)
    jg, tg = _pair(_draw((2, 128), 4, 0.05), jnp.bfloat16)
    jb, tb = _pair(_draw((2, 128), 5, 0.05), jnp.bfloat16)
    want = JL.layernorm({}, jx) * (1.0 + jg[:, None]) + jb[:, None]
    got = ops.adaln_modulate(tx, tg, tb, round_scale=True)
    _assert_rel(got, want, F32_REL)
    loose = ops.adaln_modulate(tx, tg, tb)
    assert np.abs(loose.numpy() - np.asarray(want)).max() > 1e-3
    _assert_rel(loose, jops.adaln_modulate(jx, jg, jb), F32_REL)


def test_adaln_broadcast_view_and_layernorm():
    """The ragged forward's ``(P, g, T, d)`` replica view with per-pair
    γ/β, and the un-modulated LayerNorm (γ = β = 0), against the
    reference's LayerNorm and modulation."""
    jx, tx = _pair(_draw((3, 16, 32), 6, 2.0), jnp.float32)
    jg, tg = _pair(_draw((3, 32), 7, 0.5), jnp.float32)
    jb, tb = _pair(_draw((3, 32), 8, 0.5), jnp.float32)
    view = tx[:, None].expand(3, 2, 16, 32)
    got = ops.adaln_modulate(view, tg, tb)
    want = JL.layernorm({}, jx) * (1.0 + jg[:, None]) + jb[:, None]
    _assert_rel(got, np.broadcast_to(np.asarray(want)[:, None],
                                     (3, 2, 16, 32)), F32_REL)
    _assert_rel(ops.layernorm(view),
                np.broadcast_to(np.asarray(JL.layernorm({}, jx))[:, None],
                                (3, 2, 16, 32)), F32_REL)


# --- hetero fuse (flag form) -------------------------------------------------


@PALLAS
@pytest.mark.parametrize("derivative_mode", ["analytic", "fd"])
@pytest.mark.parametrize("velocity_scaling", ["piecewise", "sigmoid"])
def test_fused_convert_and_fuse_matches_jax_ops(monkeypatch, pallas,
                                                derivative_mode,
                                                velocity_scaling):
    """2 DDPM/cosine + 2 FM/linear experts over ``(B, 8, 8, 4)`` latents;
    one sample near ``t = 1`` puts α below α_min and x̂0 at the clamp."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", pallas)
    objectives = ["ddpm", "fm", "ddpm", "fm"]
    names = ["cosine", "linear", "cosine", "linear"]
    b = 3
    preds = _draw((4, b, 8, 8, 4), 30, 2.0)
    x = _draw((b, 8, 8, 4), 31, 2.0)
    w = np.random.default_rng(32).dirichlet(np.ones(4), b).astype(np.float32)
    t = np.array([0.3, 0.7, 0.995], np.float32)
    kw = dict(derivative_mode=derivative_mode,
              velocity_scaling=velocity_scaling)
    want = jops.fused_convert_and_fuse(
        jnp.asarray(preds), jnp.asarray(x), jnp.asarray(w), objectives,
        [j_get_schedule(n) for n in names], jnp.asarray(t),
        JConversionConfig(**kw))
    got = ops.fused_convert_and_fuse(
        torch.from_numpy(preds), torch.from_numpy(x), torch.from_numpy(w),
        objectives, [get_schedule(n) for n in names], torch.from_numpy(t),
        ConversionConfig(**kw))
    assert got.shape == (b, 8, 8, 4)
    if derivative_mode == "analytic":
        _assert_rel(got, want, F32_REL)
    else:
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err <= FD_DERIV_ATOL * (20.0 + np.abs(preds).max()), err


def test_fused_convert_and_fuse_rejects_unknown_objectives():
    with pytest.raises(ValueError):
        ops.fused_convert_and_fuse(
            torch.zeros(1, 1, 4), torch.zeros(1, 4), torch.ones(1, 1),
            ["edm"], [get_schedule("linear")], torch.zeros(1))


# --- the served slice --------------------------------------------------------

BATCH, STEPS = 4, 4
MIX = [("ddpm", "cosine")] * 2 + [("fm", "linear")] * 6


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("attention_ensemble"))
    cfg = dit_b2().reduced(latent_size=8)
    rcfg = router_b2(num_clusters=8).reduced(latent_size=8)

    def params(c, seed):
        gen = torch.Generator().manual_seed(seed)
        return tree_map(
            lambda a: (a + 0.02 * torch.randn(a.shape, generator=gen)
                       ).numpy(), D.init(c, gen))

    for i, (obj, sched) in enumerate(MIX):
        jckpt.save_checkpoint(
            os.path.join(path, f"expert{i}.npz"), params(cfg, 40 + i),
            metadata=jckpt.expert_metadata(
                name=f"e{i}", objective=obj, schedule=sched, cluster_id=i,
                arch=cfg.name))
    jckpt.save_checkpoint(os.path.join(path, "router.npz"),
                          params(rcfg, 49), metadata={})
    return dict(path=path, cfg=cfg, rcfg=rcfg,
                text=_draw((BATCH, cfg.text_len, cfg.text_dim), 50))


@pytest.mark.parametrize("param_dtype,rel", [("native", 1e-4),
                                             ("bf16", 1e-2)])
def test_served_request_goes_through_the_new_wrappers(
        monkeypatch, ensemble, param_dtype, rel):
    """``ServingEngine.generate`` at the reduced width: every LayerNorm of
    the router and the experts goes through ``adaln_modulate``/
    ``layernorm`` and every self-attention through ``flash_attention``,
    as many times as the config says, and the latents match the JAX
    engine — native within ``1e-4 · max|latent|``, bf16 within
    ``1e-2 · max|latent|`` (the jitted JAX engine keeps bf16
    intermediates in float32; ``tests/test_torch_quant.py``)."""
    calls = {"adaln": 0, "flash": 0}

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(ops, "adaln_modulate",
                        counted("adaln", ops.adaln_modulate))
    monkeypatch.setattr(ops, "layernorm", counted("adaln", ops.layernorm))
    monkeypatch.setattr(ops, "flash_attention",
                        counted("flash", ops.flash_attention))
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (BATCH, 8, 8, 4),
                                         dtype=jnp.float32))
    eng = ServingEngine.from_checkpoint_dir(
        ensemble["path"], dit_cfg=ensemble["cfg"],
        router_cfg=ensemble["rcfg"],
        sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2),
        param_dtype=param_dtype, device="cpu")
    got = eng.generate(0, ensemble["text"], BATCH, noise=noise)
    layers = ensemble["cfg"].num_layers
    # per step: the router (msa + mlp per layer) and one batched-CFG
    # expert forward (msa, cross-attention LayerNorm, mlp, final layer)
    assert calls["adaln"] == STEPS * (2 * layers + 3 * layers + 1)
    assert calls["flash"] == STEPS * 2 * layers
    jeng = JServingEngine.from_checkpoint_dir(
        ensemble["path"], dit_cfg=j_dit_b2().reduced(latent_size=8),
        router_cfg=j_router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=JSamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2),
        param_dtype=param_dtype)
    want = np.asarray(jeng.generate(key, ensemble["text"], BATCH))
    _assert_rel(got, want, rel)
