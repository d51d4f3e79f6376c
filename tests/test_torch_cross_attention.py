"""The DiT's cross-attention on the attention kernel's wrapper, on the CPU.

Every DiT attention — the self-attention over the latent tokens and the
cross-attention of those tokens over the text tokens — goes through
``kernels.ops.flash_attention`` (non-causal, unmasked; on the card the
attention kernel and, under grad, its backward kernel; here its plain
version).  The reduced DiT has 16 latent tokens over ``text_len`` 8 text
tokens, so the cross-attention's query and key lengths differ.

Held to the JAX package (whose DiT computes the cross-attention with
``chunked_attention(..., causal=False)``) at the tolerances of
``tests/test_torch_dit.py`` (forwards, ``rtol = atol = 1e-5``) and
``tests/test_torch_training.py`` (one training step: the loss within
``1e-5`` relative, every gradient leaf within ``1e-4 · max |want|``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.param_store import DenseStore as JDense
from repro.models import dit as JD
from repro.training import optimizer as JOpt
from repro.training import trainer as JT
from repro_torch.kernels import ops
from repro_torch.models import dit as D
from repro_torch.training import optimizer as Opt
from repro_torch.training import trainer as T
from repro_torch.weights import params_from_numpy
from test_torch_dit import TOL, _inputs, models  # noqa: F401  (a fixture)
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_training import (GRAD_REL, OPT, _expert_draws,
                                 _leaves_close, _torch_draws)


@pytest.fixture
def attention_calls(monkeypatch):
    """Every ``ops.flash_attention`` call's query and key lengths, in
    call order (the wrapped function still computes the call)."""
    calls = []
    real = ops.flash_attention

    def recording(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw.get("causal", True)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", recording)
    return calls


def _want_calls(cfg, text: bool):
    """Per layer: the self-attention over the latent tokens, then (with
    text) the cross-attention of those tokens over the text tokens."""
    per_layer = [(cfg.num_tokens, cfg.num_tokens, False)]
    if text:
        per_layer.append((cfg.num_tokens, cfg.text_len, False))
    return per_layer * cfg.num_layers


@pytest.mark.parametrize("text_mode", ["text", "null", "drop_mask"])
def test_dense_cross_attention_reaches_the_kernel_and_matches_jax(
        models, attention_calls, text_mode):
    cfg = models["cfg"]
    assert cfg.num_tokens != cfg.text_len
    x, t, text = _inputs(cfg, 3, seed=4)
    jkw, kw = {}, {}
    if text_mode != "null":
        jkw["text_emb"], kw["text_emb"] = text, torch.from_numpy(text)
    if text_mode == "drop_mask":
        drop = np.array([True, False, True])
        jkw["drop_mask"], kw["drop_mask"] = drop, torch.from_numpy(drop)
    want = np.asarray(JD.apply(models["jcfg"], models["jexperts"][1], x, t,
                               **jkw))
    got = D.apply(cfg, models["experts"][1], torch.from_numpy(x),
                  torch.from_numpy(t), **kw)
    assert attention_calls == _want_calls(cfg, text=True)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_router_has_no_cross_attention(models, attention_calls):
    x, t, _ = _inputs(models["cfg"], 2, seed=5)
    D.make_router_fn(models["rcfg"], models["router"])(torch.from_numpy(x),
                                                        torch.from_numpy(t))
    assert attention_calls == _want_calls(models["rcfg"], text=False)


@pytest.mark.parametrize("g", [2, 1])
def test_ragged_cross_attention_reaches_the_kernel_and_matches_jax(
        models, attention_calls, g):
    """The serving forward over (pair, replica) rows: q ``(P·g, 16, H,
    hd)`` over k/v ``(P·g, 8, H, hd)``; layer 0's self-attention runs on
    the ``P`` per-pair rows, every later one and every cross-attention on
    all ``P·g``."""
    cfg = models["cfg"]
    pe = np.array([1, 0, 2, 2], np.int32)
    x, t, _ = _inputs(cfg, len(pe), seed=6)
    text = np.random.default_rng(7).standard_normal(
        (len(pe), g, cfg.text_len, cfg.text_dim)).astype(np.float32)
    jview = JDense.from_stacked(
        JD.stack_expert_params(models["jexperts"])).ragged_view()
    want = np.asarray(jax.jit(JD.make_ragged_expert_apply(models["jcfg"]),
                              static_argnums=5)(
        jview, x, t, {"text_emb": jnp.asarray(text)}, jnp.asarray(pe), g))
    got = D.make_ragged_expert_apply(cfg)(
        D.stack_expert_params(models["experts"]), torch.from_numpy(x),
        torch.from_numpy(t), {"text_emb": torch.from_numpy(text)},
        torch.from_numpy(pe), g)
    assert attention_calls == _want_calls(cfg, text=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_training_step_gradients_through_the_cross_attention_match_jax(
        one_torch_thread, models):
    """One FM expert step's loss and every gradient leaf from the
    reference's draws; the cross-attention's projections get gradients
    (the backward runs through the wrapper)."""
    cfg, jcfg = models["cfg"], models["jcfg"]
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    text = rng.standard_normal((4, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    jparams = models["jexperts"][2]
    jtr = JT.ExpertTrainer(apply_fn=JD.make_expert_apply(jcfg),
                           objective="fm", schedule_name="linear",
                           opt=JOpt.AdamWConfig(**OPT))
    tr = T.ExpertTrainer(apply_fn=D.make_expert_apply(cfg), objective="fm",
                         schedule_name="linear", opt=Opt.AdamWConfig(**OPT),
                         device="cpu")
    key = jax.random.PRNGKey(9)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jtr.loss(p, key, jnp.asarray(lat), jnp.asarray(text)))(
        jparams)
    draws = _torch_draws(_expert_draws(key, "fm", lat.shape))
    got_loss, got_grads = T.value_and_grad(
        lambda p: tr.loss(p, draws, torch.from_numpy(lat),
                          torch.from_numpy(text)),
        params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    _leaves_close(got_grads, want_grads, GRAD_REL)
    for name in ("wq", "wk", "wv"):
        assert got_grads["cross_attn"][name]["w"].abs().max() > 0
