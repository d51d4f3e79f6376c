"""The port's encoder-decoder backbone (``models/encdec.py``, whisper-
large-v3) and the attention kernel's separate kv length against the JAX
package, on the CPU, at ``reduced()`` shapes (2 encoder and 2 decoder
layers, d 256, 4 heads of D 64, 16 encoder frames, vocab 512).

JAX parameters pass to the port through ``np.asarray`` and
``params_from_numpy``; tokens and frames are seeded numpy.  Every
attention of ``encode``, ``forward_train`` and ``prefill`` runs the
attention kernel's plain version here (CPU tensors) — the decoder's
cross-attention with its own kv length, ``S`` rows over the 16 frames;
the kernel is held to it on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances, relative to ``max|want|``, as
``tests/test_torch_transformer.py`` states them: ``MODEL_REL = 1e-5``
for float32 outputs and cache leaves (GEMMs, LayerNorms and attention
summed in another order by XLA and ATen), ``LOSS_REL = 1e-5`` and
``GRAD_REL = 1e-4`` per gradient leaf, and ``BF16_MODEL_REL = 2⁻⁶`` (two
bf16 ulps of max |logit|) for the bf16 variant against the JAX model run
op by op without jit.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.launch import steps as JSteps
from repro.models import encdec as jencdec
from repro.models import layers as JL
from repro.models import zoo as jzoo
from repro_torch.configs import get_config, get_shape
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.models import encdec, zoo
from repro_torch.training import trainer as T
from repro_torch.tree import tree_leaves
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_transformer import (_rel, _struct, _t, assert_cache_close,
                                    carried, reduced_pair, tokens)

ARCH = "whisper-large-v3"
MODEL_REL = 1e-5
BF16_MODEL_REL = 2.0 ** -6
LOSS_REL = 1e-5
GRAD_REL = 1e-4
#: the attention's float32 outputs and gradients against the reference's
#: ``chunked_attention`` (sums in another order)
ATTN_REL = 1e-5
#: a gradient leaf whose largest |gradient| is at most this share of the
#: model's largest is rounding noise around an exact 0 (``chip_smoke.py``'s
#: ``ZERO_GRAD_SHARE``)
ZERO_GRAD_SHARE = 2.0 ** -17


def frames(cfg, batch: int, seed: int) -> np.ndarray:
    """Seeded standard-normal frame embeddings ``(B, m, d)`` float32."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


def _jb(toks, fr, **more):
    return {"tokens": toks, "audio_embeds": fr, **more}


def _tb(toks, fr, **more):
    return {"tokens": _t(toks), "audio_embeds": _t(fr),
            **{k: _t(v) for k, v in more.items()}}


@pytest.fixture
def float32_pair(one_torch_thread):
    jcfg, cfg = reduced_pair(ARCH)
    return jcfg, cfg, *carried(jcfg, seed=1)


def test_encode_matches_jax(float32_pair):
    """``encode`` (bidirectional attention over the 16 frames) within
    ``MODEL_REL``."""
    jcfg, cfg, jp, tp = float32_pair
    fr = frames(cfg, 2, 10)
    want = jencdec.encode(jcfg, jp, fr)
    got = encdec.encode(cfg, tp, _t(fr))
    assert got.shape == (2, cfg.encoder_seq_len, cfg.d_model)
    assert _rel(got, want) <= MODEL_REL


def test_forward_prefill_decode_match_jax(float32_pair):
    """``forward_train`` logits over 24 decoder tokens (cross-attention 24
    rows over 16 frames), ``prefill`` of a 12-token prompt (12 over 16):
    logits and every cache leaf; then three ``decode_step``s past the
    prompt (positions 12, 13, 14 write ring slots 0, 1, 2 of the prompt's
    12-slot cache under the decode window, as the reference does): each
    step's logits and every cache leaf."""
    jcfg, cfg, jp, tp = float32_pair
    toks = tokens(cfg.vocab_size, (2, 24), 11)
    fr = frames(cfg, 2, 12)
    jlog, _ = jzoo.forward_train(jcfg, jp, _jb(toks, fr))
    log, aux = zoo.forward_train(cfg, tp, _tb(toks, fr))
    assert log.shape == (2, 24, cfg.vocab_size) and float(aux) == 0.0
    assert _rel(log, jlog) <= MODEL_REL

    jl, jc = jzoo.prefill(jcfg, jp, _jb(toks[:, :12], fr))
    pl, pc = zoo.prefill(cfg, tp, _tb(toks[:, :12], fr))
    assert _rel(pl, jl) <= MODEL_REL
    assert_cache_close(pc, jc, MODEL_REL)
    assert pc["k"].shape[2] == 12 and pc["cross_k"].shape[2] == 16
    for i in range(3):
        pos = np.full((2,), 12 + i, np.int32)
        tok = toks[:, 12 + i:13 + i]
        jd, jc = jzoo.decode_step(jcfg, jp, jc, tok, pos)
        dl, pc = zoo.decode_step(cfg, tp, pc, _t(tok), _t(pos))
        assert _rel(dl, jd) <= MODEL_REL, i
        assert_cache_close(pc, jc, MODEL_REL)
    assert pc["pos"][0, :4].tolist() == [12, 13, 14, 3]


def test_loss_and_gradients_match_jax(float32_pair):
    """``zoo.loss_fn`` (10-token CE chunks over 24 positions: the
    remainder left out, as the reference does): the loss within
    ``LOSS_REL`` and every gradient leaf within ``GRAD_REL`` of
    ``jax.value_and_grad``; with remat on, bitwise the numbers with it
    off; every leaf has a gradient.  A key projection's bias adds
    ``q·b`` to every logit of a query row, which the softmax cancels: its
    exact gradient is 0, and both packages give rounding noise (~3e-9 of
    the model's largest gradient; every other leaf's is over 2e-2 of it),
    so the leaves at most ``ZERO_GRAD_SHARE`` of the largest — exactly
    those three — are held within ``GRAD_REL`` of the largest gradient of
    the model instead of their own."""
    jcfg, cfg, jp, tp = float32_pair
    jcfg = dataclasses.replace(jcfg, logits_chunk=10)
    cfg = dataclasses.replace(cfg, logits_chunk=10)
    toks = tokens(cfg.vocab_size, (2, 25), 13)
    fr = frames(cfg, 2, 14)
    jb = _jb(toks[:, :-1], fr, labels=toks[:, 1:])
    tb = _tb(toks[:, :-1], fr, labels=toks[:, 1:])
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jzoo.loss_fn(jcfg, p, jb), has_aux=True))(jp)
    runs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        runs.append(T.value_and_grad(lambda p: zoo.loss_fn(c, p, tb), tp,
                                     has_aux=True))
    ((loss, m), g), ((rloss, _), rg) = runs
    assert abs(loss.item() - float(jloss)) <= LOSS_REL * abs(float(jloss))
    assert sorted(m) == sorted(jm) == ["ce"]
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tree_leaves(g)) == len(jleaves)
    own = [float(np.abs(np.asarray(w)).max()) for w in jleaves]
    top = max(own)
    noise = [o <= ZERO_GRAD_SHARE * top for o in own]
    assert sum(noise) == 3
    for i, (a, w) in enumerate(zip(tree_leaves(g), jleaves)):
        if noise[i]:
            err = float(np.abs(a.numpy() - np.asarray(w)).max())
            assert err <= GRAD_REL * top, i
        else:
            assert _rel(a, w) <= GRAD_REL, i
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g),
                                                 tree_leaves(rg)))
    assert all(bool(a.abs().max() > 0) for a in tree_leaves(g))


def test_bf16_matches_unjitted_jax(one_torch_thread):
    """The reduced bf16 backbone against the JAX model run op by op
    without jit: ``forward_train`` logits, ``prefill`` logits and every
    cache leaf, and a ``decode_step`` from that cache, within
    ``BF16_MODEL_REL`` of max |logit|."""
    jcfg, cfg = reduced_pair(ARCH, bf16=True)
    jp, tp = carried(jcfg, seed=2)
    assert tp["embed"]["emb"].dtype == torch.bfloat16
    toks = tokens(cfg.vocab_size, (2, 20), 15)
    fr = frames(cfg, 2, 16)
    pos = np.full((2,), 12, np.int32)
    with jax.disable_jit():
        jfr = jnp.asarray(fr, jnp.bfloat16)
        jlog, _ = jzoo.forward_train(jcfg, jp, _jb(toks, jfr))
        jl, jc = jzoo.prefill(jcfg, jp, _jb(toks[:, :12], jfr))
        jd, _ = jzoo.decode_step(jcfg, jp, jc, toks[:, 12:13], pos)
    tfr = _t(fr).to(torch.bfloat16)
    log, _ = zoo.forward_train(cfg, tp, {"tokens": _t(toks),
                                         "audio_embeds": tfr})
    pl, pc = zoo.prefill(cfg, tp, {"tokens": _t(toks[:, :12]),
                                   "audio_embeds": tfr})
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


# ---------------------------------------------------------------------------
# The attention with a kv length of its own (the cross-attention's)
# ---------------------------------------------------------------------------

#: (B, Hq, Hkv, Sq, Skv, D): whisper's cross shape reduced (queries fewer
#: than keys), more queries than keys, and a GQA group over 70 keys
CROSS = [(2, 4, 4, 24, 16, 64), (1, 3, 3, 40, 9, 32), (2, 4, 2, 33, 70, 16)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", CROSS)
def test_flash_attention_unequal_lengths_match_chunked_attention(
        one_torch_thread, b, hq, hkv, sq, skv, d):
    """``ops.flash_attention`` on the CPU with ``Sq ≠ Skv`` (non-causal,
    the cross-attention) against the reference's ``chunked_attention``
    (float32 softmax, chunks of 16 queries): the output within
    ``ATTN_REL`` of its max, and autograd's dq, dk, dv against
    ``jax.grad`` of a seeded projection of the output, each within
    ``ATTN_REL`` of its max; ``ref_flash_attention_bwd`` gives the same
    gradients."""
    rng = np.random.default_rng(sq * skv + d)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((b, sq, hq, d)).astype(np.float32)

    def jfn(q, k, v):
        out = JL.chunked_attention(q, k, v, q_positions=jnp.arange(sq),
                                   kv_positions=jnp.arange(skv), causal=False,
                                   chunk_size=16)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    leaves = [_t(a).transpose(1, 2).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention_gqa(*leaves, causal=False)
    assert out.shape == (b, hq, sq, d)
    assert _rel(out.detach().transpose(1, 2), jout) <= ATTN_REL
    (out * _t(w).transpose(1, 2)).sum().backward()
    for leaf, want in zip(leaves, jgrads):
        assert _rel(leaf.grad.transpose(1, 2), want) <= ATTN_REL
    d_out = _t(w).transpose(1, 2)
    formula = ref.ref_flash_attention_bwd(*(a.detach() for a in leaves),
                                          d_out, causal=False)
    for got, want in zip(formula, jgrads):
        assert _rel(got.transpose(1, 2), want) <= ATTN_REL


@pytest.mark.parametrize("mask", [dict(causal=True), dict(causal=False,
                                                          window=8),
                                  dict(causal=True, window=8)],
                         ids=["causal", "window", "causal_window"])
def test_masked_attention_with_unequal_lengths_raises(mask):
    """A causal or windowed attention over ``Sq ≠ Skv`` has no meaning the
    reference uses (its cross-attention is unmasked): the wrapper, the
    plain forward and the plain backward raise."""
    q = torch.zeros((1, 2, 6, 16))
    k = torch.zeros((1, 2, 9, 16))
    with pytest.raises(ValueError, match="equal q and kv lengths"):
        ops.flash_attention(q, k, k, **mask)
    with pytest.raises(ValueError, match="equal q and kv lengths"):
        ref.ref_flash_attention(q, k, k, **mask)
    with pytest.raises(ValueError, match="equal q and kv lengths"):
        ref.ref_flash_attention_bwd(q, k, k, q, **mask)


# ---------------------------------------------------------------------------
# Shapes, launch.steps, the train CLI and the LM example
# ---------------------------------------------------------------------------


def test_param_shapes_and_input_specs_match_jax():
    """``param_shapes`` of the full whisper-large-v3 leaf for leaf against
    the reference's ``jax.eval_shape`` of ``zoo.init`` (1,614,382,080
    parameters), and ``input_specs`` at every shape (the training and
    prefill batches' frame embeddings, the decode shapes' self and cross
    caches): meta tensors with the reference's shapes and dtypes."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    got, want = steps.param_shapes(cfg), JSteps.param_shapes(jcfg)
    assert [_struct(t) for t in tree_leaves(got)] == \
        [_struct(t) for t in jax.tree_util.tree_leaves(want)]
    assert sum(t.numel() for t in tree_leaves(got)) == 1_614_382_080
    for name, jshape in J_SHAPES.items():
        want = JSteps.input_specs(jcfg, jshape)
        got = steps.input_specs(cfg, get_shape(name))
        assert all(t.device.type == "meta" for t in tree_leaves(got))
        assert [_struct(t) for t in tree_leaves(got)] == \
            [_struct(t) for t in jax.tree_util.tree_leaves(want)], name
    train = steps.input_specs(cfg, get_shape("train_4k"))["batch"]
    assert tuple(train["audio_embeds"].shape)[1:] == (1500, 1280)


def test_steps_prefill_and_serve_match_jax(float32_pair):
    """``make_prefill_step`` on a batch with frames and ``make_serve_step``
    (decode_32k: the full cache, no ring) from its cache, on carried
    weights: logits and every cache leaf within ``MODEL_REL``."""
    jcfg, cfg, jp, tp = float32_pair
    toks = tokens(cfg.vocab_size, (2, 20), 17)
    fr = frames(cfg, 2, 18)
    jl, jc = JSteps.make_prefill_step(jcfg)(jp, _jb(toks, fr))
    tl, tc = steps.make_prefill_step(cfg)(tp, _tb(toks, fr))
    assert _rel(tl, jl) <= MODEL_REL
    pos = np.full((2,), 20, np.int32)
    jl2, jc2 = JSteps.make_serve_step(jcfg, J_SHAPES["decode_32k"])(
        jp, jc, toks[:, :1], pos)
    tl2, tc2 = steps.make_serve_step(cfg, get_shape("decode_32k"))(
        tp, tc, _t(toks[:, :1]), _t(pos))
    assert _rel(tl2, jl2) <= MODEL_REL
    assert_cache_close(tc2, jc2, MODEL_REL)


def test_train_cli_trains_whisper(one_torch_thread, capsys):
    """``--mode lm --arch whisper-large-v3`` trains the reduced model 2
    steps on the CPU, each batch with ``audio_frame_embeddings(seed=i)``,
    and prints the reference's ``step    i loss …`` lines."""
    from repro_torch.launch import train

    train.main(["--mode", "lm", "--arch", ARCH, "--steps", "2", "--seq-len",
                "24", "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:15] for ln in lines] == ["step    0 loss ", "step    1 loss "]
    assert all(math.isfinite(float(ln.split()[-1])) for ln in lines)


def test_lm_example_prints_the_reference_note(capsys):
    """The LM example passes tokens only (as the reference's ensemble
    does): for whisper-large-v3 and paligemma-3b, whose experts need the
    frontend stubs, it prints the reference's note and returns; an
    unknown id raises (argparse's choices)."""
    from repro_torch.examples import decentralized_lm_experts as ex

    for arch in (ARCH, "paligemma-3b"):
        ex.main(["--arch", arch, "--device", "cpu"])
        out = capsys.readouterr().out.splitlines()
        assert out == [f"note: {arch} needs frontend stubs; using tokens "
                       "only via the dense path is unsupported here — pick "
                       "a decoder arch for this demo."]
    with pytest.raises(SystemExit):
        ex.main(["--arch", "gpt-9", "--device", "cpu"])


def test_zoo_refuses_the_vlm_and_checks_the_family():
    """``zoo`` maps ``audio`` to ``models.encdec`` and ``vlm`` to
    ``models.transformer`` (paligemma-3b's reduced tree has its
    ``vision_proj``); an unknown family raises; ``encdec`` refuses
    another family."""
    from repro_torch.models import transformer

    cfg = get_config(ARCH).reduced()
    assert zoo.backbone(cfg) is encdec
    vlm = get_config("paligemma-3b").reduced()
    assert zoo.backbone(vlm) is transformer
    assert "vision_proj" in zoo.init(vlm, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="unknown arch_type"):
        zoo.init(dataclasses.replace(cfg, arch_type="vision"),
                 torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError, match="audio"):
        encdec.make_cache(get_config("internlm2-1.8b").reduced(), 1, 4,
                          "cpu")
