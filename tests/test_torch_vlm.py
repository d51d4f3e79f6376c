"""The port's VLM-prefix backbone (``models/transformer.py``'s ``vlm``
family, paligemma-3b), the attention kernel's prefix-LM mask and
``layers.chunked_attention`` against the JAX package, on the CPU, at
``reduced()`` shapes (2 layers, d 256, 4 query heads over 1 kv head of D
64 — and of D 256 with ``reduced(head_dim=256)``, paligemma's own head
width —, 8 patches, vocab 512).

JAX parameters pass to the port through ``np.asarray`` and
``params_from_numpy``; tokens are seeded numpy and the patches the
reference's ``vision_patch_embeddings`` through ``np.asarray``.  Every
attention of ``forward_train`` and ``prefill`` runs the attention
kernel's plain version here (CPU tensors) under the prefix-LM mask; the
kernel and its backward are held to it on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, relative to ``max|want|``, as
``tests/test_torch_transformer.py`` states them: ``MODEL_REL = 1e-5``
for float32 logits and cache leaves (GEMMs, RMSNorms and attention
summed in another order by XLA and ATen), ``LOSS_REL = 1e-5``,
``GRAD_REL = 1e-4`` per gradient leaf, ``BF16_MODEL_REL = 2⁻⁶`` (two bf16
ulps of max |logit|) for the bf16 variant against the JAX model run op
by op without jit, and ``ATTN_REL = 1e-5`` for the attention's float32
outputs and gradients against the reference's ``chunked_attention``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.launch import steps as JSteps
from repro.models import layers as JL
from repro.models import transformer as JTr
from repro.models import zoo as jzoo
from repro.models.frontend_stubs import vision_patch_embeddings as j_patches
from repro_torch.configs import get_config, get_shape
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (bwd_design, check_lengths,
                                                 design)
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import transformer as Tr
from repro_torch.models import zoo
from repro_torch.training import trainer as T
from repro_torch.tree import tree_leaves
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_transformer import (_rel, _struct, _t, assert_cache_close,
                                    carried, reduced_pair, tokens)

ARCH = "paligemma-3b"
MODEL_REL = 1e-5
BF16_MODEL_REL = 2.0 ** -6
LOSS_REL = 1e-5
GRAD_REL = 1e-4
ATTN_REL = 1e-5
#: the full model's parameters (the reference's ``jax.eval_shape`` of
#: ``zoo.init``: 18 layers, d 2048, d_ff 16384, vocab 257216)
N_PARAMS = 3_039_635_456

#: the reduced widths of these tests: D 64 (``reduced()``'s d // heads)
#: and paligemma's own D 256
WIDTHS = [{}, dict(head_dim=256)]
WIDTH_IDS = ["d64", "d256"]


def patches(jcfg, batch: int, seed: int) -> np.ndarray:
    """The reference's stubbed patch embeddings ``(B, P, d)``."""
    return np.asarray(j_patches(jcfg, batch, seed=seed))


def _jb(toks, vis, **more):
    return {"tokens": toks, "vision_embeds": vis, **more}


def _tb(toks, vis, **more):
    return {"tokens": _t(toks), "vision_embeds": _t(vis),
            **{k: _t(v) for k, v in more.items()}}


# ---------------------------------------------------------------------------
# The reduced backbone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over", WIDTHS, ids=WIDTH_IDS)
def test_forward_prefill_decode_match_jax(one_torch_thread, over):
    """``forward_train`` logits over 8 patches and 40 tokens (the prefix
    rows dropped before the unembedding), ``prefill`` of the patches and
    a 24-token prompt (a 32-slot cache): logits and every cache leaf;
    then three ``decode_step``s at positions 32, 33, 34, which write ring
    slots 0, 1, 2 of the prompt's cache under the decode window, over the
    patches' keys, as the reference does: each step's logits and every
    cache leaf.  The prefill cache copied into room for 48 positions, a
    decode step at 32 reproduces ``forward_train``'s logits at token
    24."""
    jcfg, cfg = reduced_pair(ARCH, **over)
    jp, tp = carried(jcfg, seed=1)
    assert sorted(tp) == ["blocks", "embed", "ln_final", "unembed",
                          "vision_proj"]
    toks = tokens(cfg.vocab_size, (2, 40), 11)
    vis = patches(jcfg, 2, 12)
    p = cfg.vision_prefix_len
    jlog, _ = jzoo.forward_train(jcfg, jp, _jb(toks, vis))
    log, aux = zoo.forward_train(cfg, tp, _tb(toks, vis))
    assert log.shape == (2, 40, cfg.vocab_size) and float(aux) == 0.0
    assert _rel(log, jlog) <= MODEL_REL

    jl, jc = jzoo.prefill(jcfg, jp, _jb(toks[:, :24], vis))
    pl, pc = zoo.prefill(cfg, tp, _tb(toks[:, :24], vis))
    assert _rel(pl, jl) <= MODEL_REL
    assert_cache_close(pc, jc, MODEL_REL)
    assert pc["k"].shape[2] == p + 24
    first = pc
    for i in range(3):
        pos = np.full((2,), p + 24 + i, np.int32)
        tok = toks[:, 24 + i:25 + i]
        jd, jc = jzoo.decode_step(jcfg, jp, jc, tok, pos)
        dl, pc = zoo.decode_step(cfg, tp, pc, _t(tok), _t(pos))
        assert _rel(dl, jd) <= MODEL_REL, i
        assert_cache_close(pc, jc, MODEL_REL)
    assert pc["pos"][0, :4].tolist() == [p + 24, p + 25, p + 26, 3]

    room = zoo.make_cache(cfg, 2, p + 40, "cpu")
    for key, a in first.items():
        if key == "pos":
            room[key][:, :p + 24] = a
        else:
            room[key][:, :, :p + 24] = a
    pos = np.full((2,), p + 24, np.int32)
    step, _ = zoo.decode_step(cfg, tp, room, _t(toks[:, 24:25]), _t(pos))
    assert _rel(step, log[:, 24].numpy()) <= MODEL_REL


@pytest.mark.parametrize("over", WIDTHS, ids=WIDTH_IDS)
def test_loss_and_gradients_match_jax(one_torch_thread, over):
    """``zoo.loss_fn`` (10-token CE chunks over 24 token positions: the
    remainder left out, as the reference does) with 8 patches: the loss
    and its metrics within ``LOSS_REL`` and every gradient leaf —
    ``vision_proj`` too — within ``GRAD_REL`` of ``jax.value_and_grad``;
    with remat on, bitwise the numbers with it off; every leaf has a
    gradient."""
    jcfg, cfg = reduced_pair(ARCH, logits_chunk=10, **over)
    jp, tp = carried(jcfg, seed=3)
    toks = tokens(cfg.vocab_size, (2, 25), 13)
    vis = patches(jcfg, 2, 14)
    jb = _jb(toks[:, :-1], vis, labels=toks[:, 1:])
    tb = _tb(toks[:, :-1], vis, labels=toks[:, 1:])
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jzoo.loss_fn(jcfg, p, jb), has_aux=True))(jp)
    runs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        runs.append(T.value_and_grad(lambda p: zoo.loss_fn(c, p, tb), tp,
                                     has_aux=True))
    ((loss, m), g), ((rloss, _), rg) = runs
    assert abs(loss.item() - float(jloss)) <= LOSS_REL * abs(float(jloss))
    assert sorted(m) == sorted(jm)
    for key in m:
        assert abs(m[key].item() - float(jm[key])) <= \
            LOSS_REL * abs(float(jm[key])), key
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tree_leaves(g)) == len(jleaves)
    for i, (a, w) in enumerate(zip(tree_leaves(g), jleaves)):
        assert _rel(a, w) <= GRAD_REL, i
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g),
                                                 tree_leaves(rg)))
    assert all(bool(a.abs().max() > 0) for a in tree_leaves(g))


def test_bf16_matches_unjitted_jax(one_torch_thread):
    """The reduced bf16 backbone with bf16 patches against the JAX model
    run op by op without jit: ``forward_train`` logits, ``prefill`` logits
    and every cache leaf, and a ``decode_step`` from that cache, within
    ``BF16_MODEL_REL`` of max |logit|."""
    jcfg, cfg = reduced_pair(ARCH, bf16=True)
    jp, tp = carried(jcfg, seed=2)
    assert tp["vision_proj"]["w"].dtype == torch.bfloat16
    toks = tokens(cfg.vocab_size, (2, 20), 15)
    vis = patches(jcfg, 2, 16)
    pos = np.full((2,), cfg.vision_prefix_len + 12, np.int32)
    with jax.disable_jit():
        jlog, _ = jzoo.forward_train(jcfg, jp, _jb(toks, vis))
        jl, jc = jzoo.prefill(jcfg, jp, _jb(toks[:, :12], vis))
        jd, _ = jzoo.decode_step(jcfg, jp, jc, toks[:, 12:13], pos)
    tvis = _t(vis.astype(np.float32)).to(torch.bfloat16)
    log, _ = zoo.forward_train(cfg, tp, {"tokens": _t(toks),
                                         "vision_embeds": tvis})
    pl, pc = zoo.prefill(cfg, tp, {"tokens": _t(toks[:, :12]),
                                   "vision_embeds": tvis})
    dl, _ = zoo.decode_step(cfg, tp, pc, _t(toks[:, 12:13]), _t(pos))
    assert log.dtype == torch.bfloat16
    for name, got, want in (("forward", log, jlog), ("prefill", pl, jl),
                            ("decode", dl, jd)):
        rel = _rel(got, np.asarray(want, np.float32))
        print(f"bf16 {name} logits max|Δ|/max|want| = {rel:.3g}")
        assert rel <= BF16_MODEL_REL, name
    assert_cache_close(
        {k: v.float() if v.is_floating_point() else v for k, v in pc.items()},
        {k: np.asarray(v, np.float32) if k != "pos" else v
         for k, v in jc.items()}, BF16_MODEL_REL)


def test_without_vision_embeds_runs_without_prefix(one_torch_thread):
    """The backbone called without ``vision_embeds`` (the zoo's batch
    always carries them) has no prefix (P 0): the tokens alone, causal,
    as the reference runs them — ``forward_train`` and ``prefill`` logits
    and cache within ``MODEL_REL``; ``vision_proj`` gets no gradient from
    such a call on either side."""
    jcfg, cfg = reduced_pair(ARCH)
    jp, tp = carried(jcfg, seed=4)
    toks = tokens(cfg.vocab_size, (2, 30), 17)
    jlog, _ = JTr.forward_train(jcfg, jp, toks)
    log, _ = Tr.forward_train(cfg, tp, _t(toks))
    assert log.shape == (2, 30, cfg.vocab_size)
    assert _rel(log, jlog) <= MODEL_REL
    jl, jc = JTr.prefill(jcfg, jp, toks)
    pl, pc = Tr.prefill(cfg, tp, _t(toks))
    assert _rel(pl, jl) <= MODEL_REL
    assert_cache_close(pc, jc, MODEL_REL)
    assert pc["k"].shape[2] == 30
    jg = jax.grad(lambda p: JTr.loss_fn(jcfg, p, toks[:, :-1],
                                        toks[:, 1:])[0])(jp)
    _, g = T.value_and_grad(lambda p: Tr.loss_fn(cfg, p, _t(toks[:, :-1]),
                                                 _t(toks[:, 1:]))[0], tp)
    assert float(np.abs(np.asarray(jg["vision_proj"]["w"])).max()) == 0.0
    assert float(g["vision_proj"]["w"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# The prefix-LM attention and its backward
# ---------------------------------------------------------------------------

PREFIX_S = 24


@pytest.mark.parametrize("prefix", [0, 1, 5, PREFIX_S],
                         ids=["p0", "p1", "p5", "pS"])
@pytest.mark.parametrize("d", [64, 256], ids=["d64", "d256"])
def test_prefix_attention_matches_chunked_attention(one_torch_thread, d,
                                                    prefix):
    """``ops.flash_attention_gqa(causal=True, prefix_len=P)`` on the CPU, 8
    query heads over 1 (paligemma's MQA), S 24, against the reference's
    ``chunked_attention(causal=True, prefix_len=P)`` (chunks of 16
    queries): the output within ``ATTN_REL`` of its max; autograd's dq,
    dk, dv and ``ref_flash_attention_bwd(prefix_len=P)``'s against
    ``jax.vjp`` of it on a seeded cotangent, each within ``ATTN_REL`` of
    its max.  P 0 is the causal mask, P = S no mask at all."""
    b, hq, hkv, s = 2, 8, 1, PREFIX_S
    rng = np.random.default_rng(d + prefix)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((b, s, hq, d)).astype(np.float32)

    def jfn(q, k, v):
        return JL.chunked_attention(q, k, v, q_positions=jnp.arange(s),
                                    kv_positions=jnp.arange(s), causal=True,
                                    prefix_len=prefix, chunk_size=16)

    jout, vjp = jax.vjp(jfn, q, k, v)
    jgrads = vjp(jnp.asarray(w))
    leaves = [_t(a).transpose(1, 2).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention_gqa(*leaves, causal=True, prefix_len=prefix)
    assert out.shape == (b, hq, s, d)
    assert _rel(out.detach().transpose(1, 2), jout) <= ATTN_REL
    d_out = _t(w).transpose(1, 2)
    out.backward(d_out)
    formula = ref.ref_flash_attention_bwd(*(a.detach() for a in leaves),
                                          d_out, causal=True,
                                          prefix_len=prefix)
    for leaf, got, want in zip(leaves, formula, jgrads):
        assert _rel(leaf.grad.transpose(1, 2), want) <= ATTN_REL
        assert _rel(got.transpose(1, 2), want) <= ATTN_REL


def test_prefix_routes_to_ffma_and_takes_causal():
    """Any prefix call takes the FFMA route in both directions: a bf16 call
    at D 128 with 16-byte staging, which the tensor-core rule takes
    without a prefix, reports ``"FFMA"`` with one (``design``,
    ``bwd_design``).  A prefix without ``causal``, a negative prefix, or a
    prefix over unequal lengths raises in the launcher's check, the
    wrapper and both plain versions."""
    q = torch.zeros((2, 16, 64, 128), dtype=torch.bfloat16)
    kv = torch.zeros((2, 8, 64, 128), dtype=torch.bfloat16)
    assert design(q, kv, kv) == "wgmma bf16"
    assert bwd_design(q, kv, kv, q) == "wgmma bf16"
    assert design(q, kv, kv, prefix_len=16) == "FFMA"
    assert bwd_design(q, kv, kv, q, prefix_len=16) == "FFMA"
    f = q.float()
    for kw in (dict(causal=False, prefix_len=4),
               dict(causal=True, prefix_len=-1)):
        with pytest.raises(ValueError, match="prefix-LM"):
            check_lengths(f, f, window=0, **kw)
        with pytest.raises(ValueError, match="prefix-LM"):
            ops.flash_attention(f, f, f, **kw)
        with pytest.raises(ValueError, match="prefix-LM"):
            ref.ref_flash_attention(f, f, f, **kw)
        with pytest.raises(ValueError, match="prefix-LM"):
            ref.ref_flash_attention_bwd(f, f, f, f, **kw)
    with pytest.raises(ValueError, match="equal q and kv lengths"):
        ops.flash_attention(f, f[:, :, :32], f[:, :, :32], causal=True,
                            prefix_len=4)


# ---------------------------------------------------------------------------
# layers.chunked_attention, the reference's function with every mask
# ---------------------------------------------------------------------------

#: (case, B, Sq, Skv, Hq, Hkv, D, chunk_size, kwargs); ``positions``
#: ``"2d"`` gives each batch row its own offset, ``"valid"`` a seeded
#: valid-slot mask
CHUNKED = [
    ("positions_1d", 2, 40, 40, 4, 2, 16, 16, dict(causal=True)),
    ("positions_2d", 2, 24, 24, 4, 1, 16, 8,
     dict(causal=True, prefix_len=5, positions="2d")),
    ("window_prefix", 2, 33, 33, 4, 2, 16, 16,
     dict(causal=True, window=6, prefix_len=5)),
    ("kv_valid", 2, 20, 20, 2, 2, 32, 16,
     dict(causal=True, prefix_len=3, valid=True)),
    ("online", 2, 30, 32, 4, 1, 16, 16,
     dict(causal=True, window=10, prefix_len=5, kv_chunk=8, valid=True)),
    ("prefix_without_causal", 1, 20, 20, 2, 2, 16, 16,
     dict(causal=False, prefix_len=5)),
    ("cross", 2, 21, 9, 4, 4, 16, 16, dict(causal=False)),
]


@pytest.mark.parametrize("case", CHUNKED, ids=[c[0] for c in CHUNKED])
def test_chunked_attention_matches_jax(one_torch_thread, case):
    """``layers.chunked_attention`` against the reference's on the same
    arrays within ``ATTN_REL``: positions of shape (S,) and (B, S), a
    window with a prefix, a valid-slot mask, the online ``kv_chunk``
    variant, ``Sq`` not a multiple of ``chunk_size``, a prefix without
    ``causal`` (ignored, as in the reference) and a cross-attention;
    ``f32_softmax=False`` raises."""
    _, b, sq, skv, hq, hkv, d, chunk, kw = case
    kw = dict(kw)
    rng = np.random.default_rng(sq * skv + d)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    qpos, kpos = np.arange(sq, dtype=np.int32), np.arange(skv, dtype=np.int32)
    if kw.pop("positions", None) == "2d":
        off = np.arange(b, dtype=np.int32)[:, None] * 3
        qpos, kpos = qpos[None] + off, kpos[None] + off
    valid = None
    if kw.pop("valid", False):
        valid = rng.random((b, skv)) < 0.7
        valid[:, 0] = True
    want = JL.chunked_attention(
        q, k, v, q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        kv_valid=None if valid is None else jnp.asarray(valid),
        chunk_size=chunk, **kw)
    got = L.chunked_attention(
        _t(q), _t(k), _t(v), q_positions=_t(qpos), kv_positions=_t(kpos),
        kv_valid=None if valid is None else _t(valid), chunk_size=chunk,
        **kw)
    assert got.shape == (b, sq, hq, d) and got.dtype == torch.float32
    assert _rel(got, want) <= ATTN_REL
    with pytest.raises(NotImplementedError, match="f32_softmax"):
        L.chunked_attention(_t(q), _t(k), _t(v), q_positions=_t(qpos),
                            kv_positions=_t(kpos), f32_softmax=False)


# ---------------------------------------------------------------------------
# Shapes, launch.steps, the zoo
# ---------------------------------------------------------------------------


def test_param_shapes_and_input_specs_match_jax():
    """``param_shapes`` of the full paligemma-3b leaf for leaf against the
    reference's ``jax.eval_shape`` of ``zoo.init`` (3,039,635,456
    parameters, ``vision_proj`` among them), and ``input_specs`` at every
    shape (the training and prefill batches' patch embeddings, the
    decode shapes' KV caches): meta tensors with the reference's shapes
    and dtypes."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    got, want = steps.param_shapes(cfg), JSteps.param_shapes(jcfg)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert [_struct(t) for t in tree_leaves(got)] == \
        [_struct(t) for t in jax.tree_util.tree_leaves(want)]
    assert sum(t.numel() for t in tree_leaves(got)) == N_PARAMS
    assert tuple(got["vision_proj"]["w"].shape) == (2048, 2048)
    for name, jshape in J_SHAPES.items():
        want = JSteps.input_specs(jcfg, jshape)
        got = steps.input_specs(cfg, get_shape(name))
        assert all(t.device.type == "meta" for t in tree_leaves(got))
        assert [_struct(t) for t in tree_leaves(got)] == \
            [_struct(t) for t in jax.tree_util.tree_leaves(want)], name
    train = steps.input_specs(cfg, get_shape("train_4k"))["batch"]
    assert tuple(train["vision_embeds"].shape)[1:] == (256, 2048)


def test_steps_prefill_and_serve_match_jax(one_torch_thread):
    """``make_prefill_step`` on a batch with patches and
    ``make_serve_step`` (decode_32k: the full cache, no ring) from its
    cache, on carried weights: logits and every cache leaf within
    ``MODEL_REL``."""
    jcfg, cfg = reduced_pair(ARCH)
    jp, tp = carried(jcfg, seed=5)
    toks = tokens(cfg.vocab_size, (2, 20), 18)
    vis = patches(jcfg, 2, 19)
    jl, jc = JSteps.make_prefill_step(jcfg)(jp, _jb(toks, vis))
    tl, tc = steps.make_prefill_step(cfg)(tp, _tb(toks, vis))
    assert _rel(tl, jl) <= MODEL_REL
    assert_cache_close(tc, jc, MODEL_REL)
    pos = np.full((2,), cfg.vision_prefix_len + 20, np.int32)
    jl2, jc2 = JSteps.make_serve_step(jcfg, J_SHAPES["decode_32k"])(
        jp, jc, toks[:, :1], pos)
    tl2, tc2 = steps.make_serve_step(cfg, get_shape("decode_32k"))(
        tp, tc, _t(toks[:, :1]), _t(pos))
    assert _rel(tl2, jl2) <= MODEL_REL
    assert_cache_close(tc2, jc2, MODEL_REL)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_supports_long_context_matches_jax(arch):
    """``zoo.supports_long_context`` of every architecture id, full and
    reduced, equals the reference's."""
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (get_config(arch).reduced(),
                       j_get_config(arch).reduced())):
        assert zoo.supports_long_context(cfg) == \
            jzoo.supports_long_context(jcfg)
