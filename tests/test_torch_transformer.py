"""The port's dense GQA transformer backbone (``models/transformer.py``)
and its configs against the JAX package, on the CPU — reduced
internlm2-1.8b with 4 query heads over 2 kv heads
(``reduced(num_kv_heads=2)``: the reference's own reduction leaves it
4/4), reduced stablelm-1.6b (MHA), reduced deepseek-67b (4 over 2) and
deepseek-coder-33b with 7 query heads over 1 kv head (its full model's
group of 7; rope θ 1e5) — and what the hybrid and MoE backbones' tests
(``tests/test_torch_hybrid.py``, ``tests/test_torch_moe.py``) share with
these.

JAX parameters pass to the port through ``np.asarray`` and
``params_from_numpy``; token batches are seeded numpy.  The attention of
``forward_train`` and ``prefill`` runs the attention kernel's plain
version here (CPU tensors); the kernel is held to it on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, relative to ``max|want|`` (as ``tests/test_torch_mamba2.py``
and ``tests/test_torch_lm_training.py`` state them):

* ``MODEL_REL = 1e-5``: logits and every cache leaf of the reduced
  float32 backbone — GEMMs, RMSNorms and attention summed in another
  order by XLA and ATen;
* ``BF16_MODEL_REL = 2⁻⁶``: the reduced bf16 backbone against the JAX
  model run op by op without jit.  Both round every op to bf16, and a GEMM
  summed in another order can flip the rounding of a bf16 value by one
  ulp (≤ 2⁻⁷ of it; the attention and SwiGLU outputs alone agree within
  1.4e-3 of max).  Such a flip in the first layer's residual stream
  reaches the logits through the second layer and the unembedding as up
  to one ulp more, on top of the logits' own rounding: two ulps of max
  (mamba2, one GEMM chain a layer, stays within one: 0.45–0.71 × 2⁻⁷
  over seeds 0–5; these backbones read 0.67–1.27 × 2⁻⁷ over them);
* ``LOSS_REL = 1e-5`` for the loss, ``GRAD_REL = 1e-4`` per gradient
  leaf (two reduced layers forward and backward);
* ensemble log-probabilities and perplexities ``LM_REL = 1e-5``, greedy
  tokens exactly equal (the smallest top-1/top-2 gap is printed).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.core.lm_ensemble import LMExpertEnsemble as JEnsemble
from repro.core.lm_ensemble import TokenPrototypeRouter as JRouter
from repro.core.lm_ensemble import expert_perplexity as j_expert_perplexity
from repro.launch import steps as JSteps
from repro.models import zoo as jzoo
from repro_torch.configs import get_config, get_shape
from repro_torch.core.lm_ensemble import (LMExpertEnsemble,
                                          TokenPrototypeRouter,
                                          expert_perplexity)
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import transformer as Tr
from repro_torch.models import zoo
from repro_torch.training import trainer as T
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

MODEL_REL = 1e-5
BF16_MODEL_REL = 2.0 ** -6
LOSS_REL = 1e-5
GRAD_REL = 1e-4
LM_REL = 1e-5

#: the reduced dense models of these tests: (arch, reduced() overrides)
DENSE = [("internlm2-1.8b", dict(num_kv_heads=2)), ("stablelm-1.6b", {}),
         ("deepseek-67b", dict(num_kv_heads=2)),
         ("deepseek-coder-33b", dict(num_heads=7, num_kv_heads=1))]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def reduced_pair(arch: str, bf16: bool = False, **over):
    """The reduced config of both packages, with the same overrides."""
    jover, tover = dict(over), dict(over)
    if bf16:
        jover.update(param_dtype=jnp.bfloat16, activation_dtype=jnp.bfloat16)
        tover.update(param_dtype=torch.bfloat16,
                     activation_dtype=torch.bfloat16)
    return (j_get_config(arch).reduced(**jover),
            get_config(arch).reduced(**tover))


def carried(jcfg, seed: int):
    """JAX init, carried to the port leaf by leaf through numpy."""
    jp = jzoo.init(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def assert_cache_close(got: dict, want: dict, rel: float) -> None:
    """Every cache leaf: slot positions equal, the rest within ``rel``."""
    assert sorted(got) == sorted(want)
    for key, a in got.items():
        if key == "pos":
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(want[key]))
        else:
            assert _rel(a, want[key]) <= rel, key


def check_forward_prefill_decode(arch: str, over: dict, seed: int) -> None:
    """The reduced float32 backbone on carried weights: ``forward_train``
    logits over 80 tokens (not a multiple of the attention chunk 64 nor,
    for the prefill's 48, of anything but the scan chunk), ``prefill``
    logits and every cache leaf, then one ``decode_step`` at position 48
    from the prefill's cache (its ring slot 0, as the reference writes
    it): logits and every cache leaf.  Then the reference's invariant on
    the port: the prefill cache copied into a ``make_cache`` of room 80,
    a decode step at 48 reproduces ``forward_train``'s logits there."""
    jcfg, cfg = reduced_pair(arch, **over)
    jp, tp = carried(jcfg, seed)
    toks = tokens(cfg.vocab_size, (2, 80), seed + 50)
    jlog, _ = jzoo.forward_train(jcfg, jp, {"tokens": toks})
    log, aux = zoo.forward_train(cfg, tp, {"tokens": _t(toks)})
    assert log.shape == (2, 80, cfg.vocab_size) and float(aux) == 0.0
    assert _rel(log, jlog) <= MODEL_REL

    head = toks[:, :48]
    jl, jc = jzoo.prefill(jcfg, jp, {"tokens": head})
    pl, pc = zoo.prefill(cfg, tp, {"tokens": _t(head)})
    assert _rel(pl, jl) <= MODEL_REL
    assert_cache_close(pc, jc, MODEL_REL)

    pos = np.full((2,), 48, np.int32)
    jd, jc2 = jzoo.decode_step(jcfg, jp, jc, toks[:, 48:49], pos)
    dl, dc = zoo.decode_step(cfg, tp, pc, _t(toks[:, 48:49]), _t(pos))
    assert _rel(dl, jd) <= MODEL_REL
    assert_cache_close(dc, jc2, MODEL_REL)
    assert int(pc["pos"][0, 0]) == 0             # the input cache is kept

    room = zoo.make_cache(cfg, 2, 80, "cpu")
    for key, a in pc.items():
        if key in ("k", "v"):
            room[key][:, :, :48] = a
        elif key == "pos":
            room[key][:, :48] = a
        else:
            room[key] = a
    step, _ = zoo.decode_step(cfg, tp, room, _t(toks[:, 48:49]), _t(pos))
    assert _rel(step, log[:, 48].numpy()) <= MODEL_REL


def check_bf16_matches_unjitted_jax(arch: str, over: dict, seed: int) -> None:
    """The reduced bf16 backbone against the JAX model run op by op without
    jit (under jit XLA keeps bf16 intermediates in float32):
    ``forward_train`` logits, ``prefill`` logits and cache, and a
    ``decode_step`` from it."""
    jcfg, cfg = reduced_pair(arch, bf16=True, **over)
    jp, tp = carried(jcfg, seed)
    assert tp["embed"]["emb"].dtype == torch.bfloat16
    toks = tokens(cfg.vocab_size, (2, 48), seed + 60)
    pos = np.full((2,), 32, np.int32)
    with jax.disable_jit():
        jlog, _ = jzoo.forward_train(jcfg, jp, {"tokens": toks})
        jl, jc = jzoo.prefill(jcfg, jp, {"tokens": toks[:, :32]})
        jd, _ = jzoo.decode_step(jcfg, jp, jc, toks[:, 32:33], pos)
    log, _ = zoo.forward_train(cfg, tp, {"tokens": _t(toks)})
    pl, pc = zoo.prefill(cfg, tp, {"tokens": _t(toks[:, :32])})
    dl, _ = zoo.decode_step(cfg, tp, pc, _t(toks[:, 32:33]), _t(pos))
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


def check_loss_and_gradients(arch: str, over: dict, seed: int) -> None:
    """``zoo.loss_fn`` (its 20-token CE chunks over 48 positions leave a
    remainder out, as the reference does) on carried weights: the loss
    and metrics within ``LOSS_REL`` and every gradient leaf within
    ``GRAD_REL`` of ``jax.value_and_grad``; with remat on, bitwise the
    numbers with it off; every leaf has a gradient."""
    jcfg, cfg = reduced_pair(arch, logits_chunk=20, **over)
    jp, tp = carried(jcfg, seed)
    toks = tokens(cfg.vocab_size, (2, 49), seed + 70)
    jb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tb = {k: _t(v) for k, v in jb.items()}
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
    assert max(_rel(a, w) for a, w in zip(
        tree_leaves(g), jax.tree_util.tree_leaves(jg))) <= GRAD_REL
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g),
                                                 tree_leaves(rg)))
    assert all(bool(a.abs().max() > 0) for a in tree_leaves(g))


def _cluster_tokens(rng, shape, vocab, cluster):
    half = vocab // 2
    return rng.integers(cluster * half, (cluster + 1) * half, shape,
                        dtype=np.int32)


def check_ensemble(arch: str, over: dict) -> None:
    """Two reduced experts (JAX init, carried over) and a prototype router
    on two seeded corpora, top-1: ``fused_logprobs`` and ``perplexity``
    within ``LM_REL``, one expert's ``expert_perplexity`` too, and
    ``decode_greedy`` (an 8-token prompt replayed, 6 new tokens) equal
    token for token."""
    jcfg, cfg = reduced_pair(arch, **over)
    pairs = [carried(jcfg, 10 + k) for k in (0, 1)]
    jexperts, experts = [p[0] for p in pairs], [p[1] for p in pairs]
    rng = np.random.default_rng(0)
    corpora = [_cluster_tokens(rng, (8, 128), cfg.vocab_size, c)
               for c in (0, 1)]
    kw = dict(strategy="topk", top_k=1)
    jens = JEnsemble(cfg=jcfg, expert_params=jexperts,
                     router=JRouter.fit([jnp.asarray(c) for c in corpora],
                                        vocab=cfg.vocab_size), **kw)
    ens = LMExpertEnsemble(cfg=cfg, expert_params=experts,
                           router=TokenPrototypeRouter.fit(
                               corpora, vocab=cfg.vocab_size), **kw)
    rng = np.random.default_rng(2)
    toks = np.concatenate([_cluster_tokens(rng, (2, 33), cfg.vocab_size, c)
                           for c in (0, 1)])
    x, y = toks[:, :-1], toks[:, 1:]
    lp = ens.fused_logprobs(_t(x))
    assert _rel(lp, jens.fused_logprobs(jnp.asarray(x))) <= LM_REL
    ppl = ens.perplexity(_t(x), _t(y))
    jppl = jens.perplexity(jnp.asarray(x), jnp.asarray(y))
    assert abs(ppl - jppl) <= LM_REL * jppl
    eppl = expert_perplexity(cfg, experts[1], _t(x), _t(y))
    jeppl = j_expert_perplexity(jcfg, jexperts[1], jnp.asarray(x),
                                jnp.asarray(y))
    assert abs(eppl - jeppl) <= LM_REL * jeppl

    prompt = toks[1:3, :8]                 # one prompt of each cluster
    want = np.asarray(jens.decode_greedy(jnp.asarray(prompt), 6))
    got = ens.decode_greedy(_t(prompt), 6)
    assert got.dtype == torch.int32 and got.shape == (2, 14)
    glp = ens.fused_logprobs(got[:, :-1])[:, 7:]
    top2 = torch.topk(glp, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).min().item()
    print(f"smallest top-1/top-2 fused log-prob margin: {margin:.3g}")
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The dense backbone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,over", DENSE, ids=[a for a, _ in DENSE])
def test_dense_forward_prefill_decode_match_jax(arch, over):
    check_forward_prefill_decode(arch, over, seed=1)


@pytest.mark.parametrize("arch,over", DENSE, ids=[a for a, _ in DENSE])
def test_dense_bf16_matches_unjitted_jax(arch, over):
    check_bf16_matches_unjitted_jax(arch, over, seed=2)


@pytest.mark.parametrize("arch,over", DENSE, ids=[a for a, _ in DENSE])
def test_dense_loss_and_gradients_match_jax(arch, over):
    check_loss_and_gradients(arch, over, seed=3)


def test_dense_ensemble_matches_jax():
    check_ensemble(*DENSE[0])


@pytest.mark.parametrize("arch,over", DENSE[2:], ids=[a for a, _ in DENSE[2:]])
def test_ring_buffer_decode_wraps_match_jax(arch, over):
    """The deepseek configs decode under their ``decode_window`` (8192,
    reduced to 64) through a ring of that size: 80 tokens fed one at a
    time from an empty ``make_cache`` of 64 slots wrap it (slot
    ``pos % 64``), each step's logits and the final cache within
    ``MODEL_REL`` of the reference's ``decode_step`` (jitted) on carried
    weights; the window masks the overwritten positions."""
    jcfg, cfg = reduced_pair(arch, **over)
    assert cfg.decode_window == 64 and not cfg.sliding_window
    jp, tp = carried(jcfg, seed=9)
    toks = tokens(cfg.vocab_size, (2, 80), 9)
    jstep = jax.jit(lambda c, t, p: jzoo.decode_step(jcfg, jp, c, t, p))
    jc, tc = jzoo.make_cache(jcfg, 2, 64), zoo.make_cache(cfg, 2, 64, "cpu")
    jl, tl = [], []
    for i in range(80):
        pos = np.full((2,), i, np.int32)
        lg, jc = jstep(jc, toks[:, i:i + 1], pos)
        jl.append(np.asarray(lg))
        lg, tc = zoo.decode_step(cfg, tp, tc, _t(toks[:, i:i + 1]), _t(pos))
        tl.append(lg)
    assert _rel(torch.stack(tl), np.stack(jl)) <= MODEL_REL
    assert_cache_close(tc, jc, MODEL_REL)
    assert tc["pos"][0].tolist() == list(range(64, 80)) + list(range(16, 64))


def test_dense_params_and_cache_have_the_reference_layout():
    """``init`` draws the reference's tree (keys, shapes, dtypes) and
    ``make_cache`` its zeros and empty slots."""
    jcfg, cfg = reduced_pair(*DENSE[0][:1], **DENSE[0][1])
    jp = jzoo.init(jcfg, jax.random.PRNGKey(0))
    tp = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(a.shape) for a in tree_leaves(tp)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jp)]
    jc, c = jzoo.make_cache(jcfg, 3, 24), zoo.make_cache(cfg, 3, 24, "cpu")
    assert_cache_close(c, jc, 0.0)


# ---------------------------------------------------------------------------
# Configs, the zoo's families, launch.steps, the train CLI
# ---------------------------------------------------------------------------

PORTED = ("mamba2-2.7b", "zamba2-2.7b", "internlm2-1.8b", "stablelm-1.6b",
          "deepseek-67b", "deepseek-coder-33b", "mixtral-8x7b",
          "mixtral-8x22b", "whisper-large-v3", "paligemma-3b")


def _same_fields(c, jc) -> None:
    for f in dataclasses.fields(c):
        got, want = getattr(c, f.name), getattr(jc, f.name)
        if isinstance(got, torch.dtype):
            got, want = str(got).split(".")[-1], jnp.dtype(want).name
        assert got == want, f.name
    if c.num_heads:
        assert c.resolved_head_dim == jc.resolved_head_dim


@pytest.mark.parametrize("arch", PORTED)
def test_get_config_matches_jax_field_for_field(arch):
    """Every field the port keeps, full and reduced (also with the
    overrides the tests use), equals the reference's."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for over in ({}, dict(num_kv_heads=2), dict(head_dim=80)):
        _same_fields(cfg.reduced(**over), jcfg.reduced(**over))
    _same_fields(cfg, jcfg)


def test_unported_families_still_raise():
    """Every id of the reference is ported, the VLM paligemma-3b the last
    (``tests/test_torch_vlm.py``): ``get_config`` returns each, and the
    ``vlm`` family runs through the zoo, ``make_cache`` and
    ``launch.steps``.  An unknown id or family raises, at ``get_config``,
    the zoo, ``launch.steps`` and the transformer module."""
    assert sorted(set(J_ARCH_IDS) - set(PORTED)) == []
    for arch in J_ARCH_IDS:
        assert get_config(arch).name == arch
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-9")
    cfg = get_config("internlm2-1.8b").reduced()
    vlm = dataclasses.replace(cfg, arch_type="vlm")
    assert zoo.backbone(vlm) is Tr
    assert sorted(zoo.make_cache(vlm, 1, 8, "cpu")) == ["k", "pos", "v"]
    spec = steps.input_specs(get_config("paligemma-3b"), get_shape(
        "prefill_32k"))["batch"]
    assert sorted(spec) == ["tokens", "vision_embeds"]
    other = dataclasses.replace(cfg, arch_type="vision")
    with pytest.raises(ValueError, match="unknown arch_type"):
        zoo.init(other, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="unknown arch_type"):
        zoo.make_cache(other, 1, 8, "cpu")
    with pytest.raises(ValueError, match="unknown arch_type"):
        steps.input_specs(other, get_shape("decode_32k"))
    with pytest.raises(ValueError, match="VLM-prefix backbone"):
        Tr.init(dataclasses.replace(cfg, arch_type="ssm"),
                torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError, match="attn_f32_softmax"):
        zoo.forward_train(dataclasses.replace(cfg, attn_f32_softmax=False),
                          zoo.init(cfg, torch.Generator(), "cpu"),
                          {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def _struct(t):
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), str(t.dtype).split(".")[-1]
    return tuple(t.shape), jnp.dtype(t.dtype).name


@pytest.mark.parametrize("arch,n_params", [
    ("zamba2-2.7b", 2_422_670_240), ("internlm2-1.8b", 1_889_110_016),
    ("stablelm-1.6b", None), ("mixtral-8x7b", 46_702_792_704),
    ("mixtral-8x22b", 140_630_071_296), ("deepseek-67b", 67_425_001_472),
    ("deepseek-coder-33b", 33_342_991_360)])
def test_specs_and_param_shapes_match_jax(arch, n_params):
    """``input_specs`` at every shape (the decode shapes' caches hold the
    KV leaves) and ``param_shapes`` of the full model: meta tensors with
    the reference's shapes and dtypes, leaf for leaf."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for name, jshape in J_SHAPES.items():
        want = JSteps.input_specs(jcfg, jshape)
        got = steps.input_specs(cfg, get_shape(name))
        assert all(t.device.type == "meta" for t in tree_leaves(got))
        assert [_struct(t) for t in tree_leaves(got)] == \
            [_struct(t) for t in jax.tree_util.tree_leaves(want)], name
    got, want = steps.param_shapes(cfg), JSteps.param_shapes(jcfg)
    assert [_struct(t) for t in tree_leaves(got)] == \
        [_struct(t) for t in jax.tree_util.tree_leaves(want)]
    if n_params is not None:
        assert sum(t.numel() for t in tree_leaves(got)) == n_params


@pytest.mark.parametrize("arch,over", [DENSE[0], ("zamba2-2.7b", {})],
                         ids=["dense", "hybrid"])
def test_steps_prefill_and_serve_match_jax(one_torch_thread, arch, over):
    """``make_prefill_step`` and ``make_serve_step`` (decode_32k: the
    cache of the prompt's length, the new token at its last slot) on
    carried weights: logits and every cache leaf within ``MODEL_REL``."""
    jcfg, cfg = reduced_pair(arch, **over)
    jp, tp = carried(jcfg, seed=4)
    toks = tokens(cfg.vocab_size, (2, 32), 3)
    jl, jc = JSteps.make_prefill_step(jcfg)(jp, {"tokens": toks})
    tl, tc = steps.make_prefill_step(cfg)(tp, {"tokens": _t(toks)})
    assert _rel(tl, jl) <= MODEL_REL
    pos = np.full((2,), 32, np.int32)
    jl2, jc2 = JSteps.make_serve_step(jcfg, J_SHAPES["decode_32k"])(
        jp, jc, toks[:, :1], pos)
    tl2, tc2 = steps.make_serve_step(cfg, get_shape("decode_32k"))(
        tp, tc, _t(toks[:, :1]), _t(pos))
    assert _rel(tl2, jl2) <= MODEL_REL
    assert_cache_close(tc2, jc2, MODEL_REL)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "stablelm-1.6b",
                                  "zamba2-2.7b", "deepseek-coder-33b",
                                  "mixtral-8x7b"])
def test_train_cli_refuses_dense_and_hybrid(one_torch_thread, capsys, arch):
    """``--mode lm`` no longer refuses the dense and hybrid families: each
    id trains 2 reduced steps on the CPU and prints the reference's
    ``step    i loss …`` lines, the default arch (internlm2-1.8b) without
    ``--arch``; an unknown id raises (argparse's choices)."""
    from repro_torch.launch import train

    pick = [] if arch == "internlm2-1.8b" else ["--arch", arch]
    train.main(["--mode", "lm", *pick, "--steps", "2", "--seq-len", "32",
                "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:15] for ln in lines] == ["step    0 loss ", "step    1 loss "]
    assert all(math.isfinite(float(ln.split()[-1])) for ln in lines)
    with pytest.raises(SystemExit):
        train.main(["--mode", "lm", "--arch", "gpt-9", "--device", "cpu"])


def test_lm_example_trains_dense_experts_on_the_cpu(one_torch_thread,
                                                    capsys):
    """The LM example with ``--arch internlm2-1.8b --device cpu``: two
    experts train, and each cluster's right expert scores below its wrong
    one, the routed ensemble with it."""
    from repro_torch.examples import decentralized_lm_experts as ex

    ex.main(["--arch", "internlm2-1.8b", "--steps", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("training 2 isolated internlm2-1.8b experts")
    for line in lines[3:5]:
        words = line.split()
        right, wrong, routed = (float(words[i]) for i in (4, 7, 10))
        assert right < wrong and routed == right
