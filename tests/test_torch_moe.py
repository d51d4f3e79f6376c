"""The port's MoE layer (``layers.moe_route`` / ``moe_apply``) and the MoE
transformer backbone (mixtral-8x7b's ``arch_type="moe"``) against the JAX
package, on the CPU.

Reduced configs: mixtral-8x7b's ``reduced()`` — 2 layers, d 256, 4
experts of F 512, top-2, window 64, vocab 512 — with 4 query heads over 2
kv heads (``num_kv_heads=2``: the reference's own reduction leaves it
4/4); sequences of 128 tokens, so that the window masks.  JAX parameters
pass to the port through ``np.asarray`` and ``params_from_numpy``; tokens
and hidden states are seeded numpy.  The carried weights are shared by
module-scoped fixtures.

Tolerances, relative to ``max|want|`` (``tests/test_torch_transformer.py``
states them):

* ``MODEL_REL = 1e-5``: ``moe_apply``'s output and aux loss under each of
  the four ``impl``s, at a capacity that never drops and at one that
  drops (a different drop set would move a row by an expert's whole
  output, far past it); the backbone's logits, aux, prefill logits and
  every cache leaf, and ``decode_step`` under ``dropping`` at B 2 with
  capacity 1 (decode drops);
* ``LOSS_REL`` for the loss, ``ce`` and ``moe_aux``; ``GRAD_REL`` for
  every gradient leaf, the router's included;
* ``LM_REL`` for the ensemble, greedy tokens equal;
* ``BF16_MODEL_REL`` for the reduced bf16 backbone against the unjitted
  JAX model.

A router near-tie can send a token to another expert after a one-ulp
difference upstream, so each comparison of a whole model prints the
smallest gap between a token's k-th and (k+1)-th router probability
(``layers.MoERecorder``), as the greedy checks print their top-1/top-2 gap.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import zoo as jzoo
from repro_torch.models import layers as L
from repro_torch.models import zoo
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy
from test_torch_transformer import (BF16_MODEL_REL, MODEL_REL, _rel, _t,
                                    assert_cache_close, carried,
                                    check_ensemble, check_loss_and_gradients,
                                    reduced_pair, tokens)

ARCH = "mixtral-8x7b"
OVER = dict(num_kv_heads=2)
E, K, D, FF = 4, 2, 256, 512
#: capacity factors: E/k, at which no expert can overflow (capacity T),
#: and one at which experts overflow
NO_DROP, DROPS = E / K, 0.5
IMPLS = ("dense", "dense_scan", "dense_fused", "dropping")
#: the reference backbone's functions, jitted once for the module (run
#: eagerly, each op compiles on its first call)
J_FORWARD, J_PREFILL, J_DECODE = (
    jax.jit(f, static_argnums=0)
    for f in (jzoo.forward_train, jzoo.prefill, jzoo.decode_step))


@contextlib.contextmanager
def unoptimised_xla():
    """XLA's optimisation passes off while inside: an unjitted reference
    compiles each op on its first call, and a single op's program is the
    same without them (the bf16 test's numbers are bitwise the same
    either way), in about two thirds of the time."""
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", saved)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer():
    """One MoE layer of the JAX init, carried over, and seeded hidden
    states (2, 128, 256)."""
    jp = JL.moe_init(jax.random.PRNGKey(0), D, FF, E)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(1).standard_normal((2, 128, D)).astype(
        np.float32)
    return jp, tp, x


@pytest.mark.parametrize("cf", [NO_DROP, DROPS], ids=["nodrop", "drops"])
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_apply_matches_jax(layer, impl, cf):
    """Each ``impl`` at a capacity that never drops and at one that drops:
    the output and the aux loss within ``MODEL_REL`` of the reference's;
    the dispatch drops none, or some, as its capacity says."""
    jp, tp, x = layer
    jy, jaux = JL.moe_apply(jp, jnp.asarray(x), num_experts_per_tok=K,
                            capacity_factor=cf, impl=impl)
    with L.MoERecorder() as seen:
        y, aux = L.moe_apply(tp, _t(x), num_experts_per_tok=K,
                             capacity_factor=cf, impl=impl)
    print(f"{impl} cf {cf}: smallest router gap {seen.min_gap:.3g}, "
          f"drops {seen.drops}")
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    assert _rel(y, jy) <= MODEL_REL
    assert abs(aux.item() - float(jaux)) <= MODEL_REL * abs(float(jaux))
    if impl == "dropping":
        assert (seen.drops[0] > 0) == (cf == DROPS)


def test_moe_unknown_impl_runs_the_capacity_dispatch(layer):
    """Any other ``impl`` string runs the capacity dispatch, as the
    reference's fall-through does: bitwise ``dropping``, and within
    ``MODEL_REL`` of the reference given the same string."""
    jp, tp, x = layer
    kw = dict(num_experts_per_tok=K, capacity_factor=DROPS)
    y, _ = L.moe_apply(tp, _t(x), impl="gshard", **kw)
    want, _ = L.moe_apply(tp, _t(x), impl="dropping", **kw)
    assert torch.equal(y, want)
    jy, _ = JL.moe_apply(jp, jnp.asarray(x), impl="gshard", **kw)
    assert _rel(y, jy) <= MODEL_REL


def test_moe_dispatch_counts_token_major_then_k():
    """Slots follow the token-major, then k, flattening: the exclusive
    count of earlier assignments to the same expert; at or past the
    capacity an assignment goes to the overflow row."""
    tope = torch.tensor([[0, 1], [1, 0], [0, 2], [1, 2]])
    slot, keep = L.moe_dispatch(tope, 3, 2)
    # positions: e0 -> 0, 1, 2 (dropped); e1 -> 0, 1, 2 (dropped); e2 -> 0, 1
    assert keep.tolist() == [True, True, True, True, False, True, False,
                             True]
    assert slot.tolist() == [0, 2, 3, 1, 6, 4, 6, 5]
    assert L.moe_capacity(4, 2, 3, 1.0) == 3
    assert L.moe_capacity(1, 1, 8, 0.5) == 1


# ---------------------------------------------------------------------------
# The backbone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def backbone():
    """The reduced float32 mixtral of both packages and carried weights."""
    jcfg, cfg = reduced_pair(ARCH, **OVER)
    assert (cfg.num_experts, cfg.d_ff, cfg.d_model, cfg.sliding_window,
            cfg.moe_impl) == (E, FF, D, 64, "dense_scan")
    jp, tp = carried(jcfg, seed=5)
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("impl,cf", [("dense_scan", 1.25), ("dropping", 1.0)],
                         ids=["dense_scan", "dropping"])
def test_moe_forward_prefill_decode_match_jax(backbone, impl, cf):
    """``forward_train`` logits and aux over 2 × 128 tokens (the window
    of 64 masks), ``prefill`` of 96 tokens (logits, every cache leaf),
    then one ``decode_step`` at position 96 of the B 2 tokens — under
    ``dropping`` at capacity factor 1 their capacity is 1, so it drops —
    within ``MODEL_REL``.  Under ``dense_scan`` (no capacity) a prefill's
    cache copied into a ``make_cache`` of room 128, a decode step at 96
    reproduces ``forward_train``'s logits there."""
    jcfg, cfg, jp, tp = backbone
    jcfg = dataclasses.replace(jcfg, moe_impl=impl, moe_capacity_factor=cf)
    cfg = dataclasses.replace(cfg, moe_impl=impl, moe_capacity_factor=cf)
    toks = tokens(cfg.vocab_size, (2, 128), 6)
    with L.MoERecorder() as seen:
        log, aux = zoo.forward_train(cfg, tp, {"tokens": _t(toks)})
    jlog, jaux = J_FORWARD(jcfg, jp, {"tokens": toks})
    print(f"{impl}: smallest router gap {seen.min_gap:.3g}, forward "
          f"drops {seen.drops}")
    assert _rel(log, jlog) <= MODEL_REL
    assert aux.item() > 0
    assert abs(aux.item() - float(jaux)) <= MODEL_REL * float(jaux)

    jl, jc = J_PREFILL(jcfg, jp, {"tokens": toks[:, :96]})
    pl, pc = zoo.prefill(cfg, tp, {"tokens": _t(toks[:, :96])})
    assert _rel(pl, jl) <= MODEL_REL
    assert_cache_close(pc, jc, MODEL_REL)

    pos = np.full((2,), 96, np.int32)
    jd, jc2 = J_DECODE(jcfg, jp, jc, toks[:, 96:97], pos)
    with L.MoERecorder() as seen:
        dl, dc = zoo.decode_step(cfg, tp, pc, _t(toks[:, 96:97]), _t(pos))
    print(f"{impl} decode: smallest router gap {seen.min_gap:.3g}, "
          f"drops {seen.drops}")
    assert _rel(dl, jd) <= MODEL_REL
    assert_cache_close(dc, jc2, MODEL_REL)
    if impl == "dropping":
        assert L.moe_capacity(2, K, E, cf) == 1 and sum(seen.drops) > 0
        return
    room = zoo.make_cache(cfg, 2, 128, "cpu")
    room["k"][:, :, :96], room["v"][:, :, :96] = pc["k"], pc["v"]
    room["pos"][:, :96] = pc["pos"]
    step, _ = zoo.decode_step(cfg, tp, room, _t(toks[:, 96:97]), _t(pos))
    assert _rel(step, log[:, 96].numpy()) <= MODEL_REL


@pytest.mark.parametrize("impl", ["dense_scan", "dropping"])
def test_moe_loss_and_gradients_match_jax(impl):
    """``loss_fn`` = ce + ``aux_loss_weight`` · aux: the loss, ``ce`` and
    ``moe_aux`` within ``LOSS_REL`` and every gradient leaf (the
    router's, every expert's) within ``GRAD_REL`` of
    ``jax.value_and_grad``; remat bitwise the same; no leaf without a
    gradient (``check_loss_and_gradients``)."""
    check_loss_and_gradients(ARCH, dict(OVER, moe_impl=impl), seed=7)


def test_moe_bf16_matches_unjitted_jax():
    """The reduced bf16 backbone (router float32) against the JAX model
    run op by op without jit (under jit XLA keeps bf16 intermediates in
    float32): ``forward_train`` logits and ``prefill`` logits and cache
    of the same 2 × 48 tokens, within ``BF16_MODEL_REL``; the router gap
    printed.  (``decode_step`` in bf16 is the dense tests'; the MoE's
    decode is held in float32 above.)"""
    jcfg, cfg = reduced_pair(ARCH, bf16=True, **OVER)
    jp, tp = carried(jcfg, seed=8)
    toks = tokens(cfg.vocab_size, (2, 48), 68)
    with jax.disable_jit(), unoptimised_xla():
        jlog, jaux = jzoo.forward_train(jcfg, jp, {"tokens": toks})
        jl, jc = jzoo.prefill(jcfg, jp, {"tokens": toks})
    with L.MoERecorder() as seen:
        log, aux = zoo.forward_train(cfg, tp, {"tokens": _t(toks)})
        pl, pc = zoo.prefill(cfg, tp, {"tokens": _t(toks)})
    assert log.dtype == torch.bfloat16 and aux.dtype == torch.float32
    rels = {name: _rel(got, np.asarray(want, np.float32)) for name, got, want
            in (("forward", log, jlog), ("prefill", pl, jl))}
    print(f"bf16 logits max|Δ|/max|want| {rels}, aux {aux.item():.6g} vs "
          f"{float(jaux):.6g}; smallest router gap {seen.min_gap:.3g}")
    assert max(rels.values()) <= BF16_MODEL_REL
    assert abs(aux.item() - float(jaux)) <= BF16_MODEL_REL * float(jaux)
    assert_cache_close(
        {k: v.float() if v.is_floating_point() else v for k, v in pc.items()},
        {k: np.asarray(v, np.float32) if k != "pos" else v
         for k, v in jc.items()}, BF16_MODEL_REL)


def test_moe_ensemble_matches_jax(monkeypatch):
    """Two reduced MoE experts and a prototype router, top-1:
    ``fused_logprobs``, ``perplexity`` within ``LM_REL``, greedy tokens
    equal (``check_ensemble``).  The reference ensemble runs its zoo's
    ``forward_train`` and ``decode_step`` under ``jax.jit`` here (the
    same functions; run eagerly, each decode step's scan compiles anew
    and the check takes half a minute)."""
    for name in ("forward_train", "decode_step"):
        monkeypatch.setattr(jzoo, name, jax.jit(getattr(jzoo, name),
                                                static_argnums=0))
    with L.MoERecorder() as seen:
        check_ensemble(ARCH, OVER)
    print(f"ensemble: smallest router gap {seen.min_gap:.3g}")


def test_moe_params_have_the_reference_layout():
    """``init`` draws the reference's tree (keys, shapes, dtypes), the
    router float32 in a bf16 config — also after ``params_from_numpy`` of
    the reference's bf16 tree."""
    jcfg, cfg = reduced_pair(ARCH, bf16=True, **OVER)
    jp = jzoo.init(jcfg, jax.random.PRNGKey(0))
    tp = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    carried_tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    want = [(a.shape, jnp.dtype(a.dtype).name)
            for a in jax.tree_util.tree_leaves(jp)]
    for tree in (tp, carried_tp):
        assert [(tuple(a.shape), str(a.dtype).split(".")[-1])
                for a in tree_leaves(tree)] == want
        moe = tree["blocks"]["moe"]
        assert moe["router"]["w"].dtype == torch.float32
        assert moe["w_gate"].dtype == torch.bfloat16
        assert tuple(moe["w_down"].shape) == (cfg.num_layers, E, FF, D)
