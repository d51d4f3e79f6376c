"""Parity of the port's training side with the JAX package, on the CPU:
objectives and the Prop. 1 weights, AdamW (learning-rate schedule,
clipping, updates, EMA), the expert and router trainers, and the training
CLI.

The trainers draw their random numbers from a ``torch.Generator``; here
they take the reference's draws (t, ε, the drop mask, the router's coin),
made from the same JAX key the reference trainer splits, through
``train_step(draws=...)``.  Parameters are seeded, jittered
``dit_b2().reduced(latent_size=8)`` trees (fresh init zeroes the output
layers) handed to both packages as numpy arrays.

Tolerances: objectives and the schedule elementwise float32
(``rtol = 1e-6``, ``atol = 1e-7``; XLA's and ATen's ``cos``/``pow`` differ
by an ulp); one training step's loss within ``1e-5`` relative and every
gradient leaf within ``1e-4 · max |want|`` (float32 GEMM chains through
two transformer layers and their backward, summed in another order); after
5 AdamW steps the moments within ``1e-5 · max |want| + 1e-7`` of the
reference, the parameters and EMA within ``1e-5 · max |want| + lr / 100``:
Adam divides each gradient by its running RMS, so the few entries whose
gradient is at rounding level (a handful in 10⁵) move by a slightly
different fraction of one step (measured: up to 0.006·lr).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import objectives as JO
from repro.core import schedules as JS
from repro.models import dit as JD
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro.training import optimizer as JOpt
from repro.training import trainer as JT
from repro_torch.core import objectives as O
from repro_torch.core.schedules import get_schedule
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.training import optimizer as Opt
from repro_torch.training import trainer as T
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy
from test_torch_dit import jittered_numpy_params
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

ELEM = dict(rtol=1e-6, atol=1e-7)
GRAD_REL = 1e-4
STATE_REL, STATE_ABS = 1e-5, 1e-7
#: a hundredth of one Adam step of the trainers' tests (lr 1e-3)
STEP_ABS = 1e-5


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor)
                      else a)


def _leaves_close(got, want, rel, abs_=0.0):
    """Every leaf of ``got`` (port tree) within ``rel · max|want| + abs``
    of the matching leaf of ``want`` (reference tree)."""
    g_leaves = tree_leaves(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape
        err = float(np.abs(g - w).max()) if g.size else 0.0
        assert err <= rel * float(np.abs(w).max(initial=0.0)) + abs_, err


# ---------------------------------------------------------------------------
# Objectives
# ---------------------------------------------------------------------------


def _x0_eps_t(b=5, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((b, 4, 4, 2)).astype(np.float32)
    eps = rng.standard_normal((b, 4, 4, 2)).astype(np.float32)
    t = rng.uniform(0.01, 0.99, (b,)).astype(np.float32)
    return x0, eps, t


@pytest.mark.parametrize("objective,schedule",
                         [("ddpm", "cosine"), ("fm", "linear"),
                          ("fm", "cosine")])
def test_target_and_loss_match_reference(objective, schedule):
    x0, eps, t = _x0_eps_t()
    w = np.float32(0.7)
    js, ps = JS.get_schedule(schedule), get_schedule(schedule)
    want = JO.target_for(objective, js, jnp.asarray(x0), jnp.asarray(eps),
                         jnp.asarray(t))
    got = O.target_for(objective, ps, torch.from_numpy(x0),
                       torch.from_numpy(eps), torch.from_numpy(t))
    np.testing.assert_allclose(_np(got), np.asarray(want), **ELEM)

    def j_apply(p, x, tt):
        return p["w"] * x + tt[:, None, None, None]

    def p_apply(p, x, tt):
        return p["w"] * x + tt[:, None, None, None]

    jl = JO.diffusion_loss(j_apply, {"w": jnp.asarray(w)}, jnp.asarray(x0),
                           jnp.asarray(eps), jnp.asarray(t),
                           objective=objective, schedule=js)
    pl = O.diffusion_loss(p_apply, {"w": torch.tensor(w)},
                          torch.from_numpy(x0), torch.from_numpy(eps),
                          torch.from_numpy(t), objective=objective,
                          schedule=ps)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_prop1_weights_and_v_param_match_reference(schedule):
    x0, eps, t = _x0_eps_t(seed=1)
    js, ps = JS.get_schedule(schedule), get_schedule(schedule)
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    for name in ("w_eps", "w_v", "weight_ratio"):
        np.testing.assert_allclose(_np(getattr(O, name)(ps, tt)),
                                   np.asarray(getattr(JO, name)(js, jt)),
                                   **ELEM)
    v = O.sh_v_target(ps, torch.from_numpy(x0), torch.from_numpy(eps), tt)
    np.testing.assert_allclose(
        _np(v), np.asarray(JO.sh_v_target(js, jnp.asarray(x0),
                                          jnp.asarray(eps), jt)), **ELEM)
    np.testing.assert_allclose(
        _np(O.sh_v_to_x0(ps, torch.from_numpy(x0), v, tt)),
        np.asarray(JO.sh_v_to_x0(js, jnp.asarray(x0), jnp.asarray(_np(v)),
                                 jt)), **ELEM)
    np.testing.assert_allclose(
        _np(ps.perturb(torch.from_numpy(x0), torch.from_numpy(eps), tt)),
        np.asarray(js.perturb(jnp.asarray(x0), jnp.asarray(eps), jt)),
        **ELEM)


def test_objectives_and_timestep_domains():
    assert O.get_objective("ddpm") == O.Objective("ddpm", "cosine")
    assert O.get_objective("fm").predicts == "velocity"
    with pytest.raises(ValueError, match="unknown objective"):
        O.get_objective("edm")
    with pytest.raises(ValueError, match="unknown objective"):
        O.target_for("edm", get_schedule("linear"), torch.zeros(1),
                     torch.zeros(1), torch.zeros(1))
    gen = torch.Generator().manual_seed(0)
    t = O.sample_timesteps(gen, 4096, objective="ddpm")
    idx = t * 999.0
    assert t.dtype == torch.float32
    assert torch.allclose(idx, torch.round(idx), atol=1e-3)
    assert t.min() >= 0 and t.max() <= 1 and len(torch.unique(t)) > 900
    # the reference's grid: integer / 999.0 in float32
    want = np.arange(1000, dtype=np.float32) / np.float32(999.0)
    assert set(_np(t).tolist()) <= set(want.tolist())
    u = O.sample_timesteps(gen, 4096, objective="fm")
    assert u.min() >= 0 and u.max() < 1 and len(torch.unique(u)) > 4000


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(warmup_steps=100),                                 # warmup
    dict(warmup_steps=0),                                   # constant
    dict(warmup_steps=50, total_steps=1000, cosine_decay=True,
         min_lr_ratio=0.1),                                 # cosine
], ids=["warmup", "constant", "cosine"])
def test_lr_schedule_matches_reference(cfg):
    steps = np.array([0, 1, 7, 49, 50, 99, 100, 101, 500, 999, 1000, 5000],
                     dtype=np.int32)
    jc = JOpt.AdamWConfig(learning_rate=3e-4, **cfg)
    pc = Opt.AdamWConfig(learning_rate=3e-4, **cfg)
    want = [float(JOpt.lr_schedule(jc, jnp.asarray(s))) for s in steps]
    got = [Opt.lr_schedule(pc, torch.tensor(s)).item() for s in steps]
    np.testing.assert_allclose(got, want, **ELEM)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        want, wnorm = JOpt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        got, gnorm = Opt.clip_by_global_norm(
            params_from_numpy(tree, "cpu"), max_norm)
        np.testing.assert_allclose(gnorm.item(), float(wnorm), rtol=1e-6)
        _leaves_close(got, want, 1e-6)
    assert Opt.global_norm(params_from_numpy(tree, "cpu")).item() \
        == pytest.approx(float(wnorm), rel=1e-6)


@pytest.mark.parametrize("weight_decay,clip", [(0.0, 1.0), (1e-2, 0.0)])
def test_adamw_and_ema_match_reference(weight_decay, clip):
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((6, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    cfg = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=weight_decay,
               clip_norm=clip)
    jc, pc = JOpt.AdamWConfig(**cfg), Opt.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    pp = params_from_numpy(params, "cpu")
    js, ps = JOpt.adamw_init(jp), Opt.adamw_init(pp)
    je, pe = JOpt.ema_init(jp), Opt.ema_init(pp)
    for i in range(4):
        g = {"w": rng.standard_normal((6, 3)).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32)}
        jp, js, jm = JOpt.adamw_update(jc, jax.tree.map(jnp.asarray, g), js,
                                       jp)
        pp, ps, pm = Opt.adamw_update(pc, params_from_numpy(g, "cpu"), ps,
                                      pp)
        je, pe = JOpt.ema_update(je, jp, 0.9), Opt.ema_update(pe, pp, 0.9)
        assert int(ps.step) == int(js.step) == i + 1
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(pm[name].item(), float(jm[name]),
                                       rtol=1e-6)
        for got, want in ((pp, jp), (ps.mu, js.mu), (ps.nu, js.nu),
                          (pe, je)):
            _leaves_close(got, want, STATE_REL, STATE_ABS)


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------

B = 4


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    return {
        "latents": rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
        "text_emb": rng.standard_normal((B, 8, 32)).astype(np.float32),
        "cluster": np.array([0, 2, 1, 2], dtype=np.int32),
    }


def _expert_draws(key, objective, shape):
    """The reference ``ExpertTrainer.loss``'s draws from ``key``."""
    k_t, k_eps, k_drop = jax.random.split(key, 3)
    return {"t": JO.sample_timesteps(k_t, shape[0], objective=objective),
            "eps": jax.random.normal(k_eps, shape),
            "drop": jax.random.bernoulli(k_drop, 0.1, (shape[0],))}


def _router_draws(key, shape):
    k_t, k_eps, k_mix = jax.random.split(key, 3)
    return {"t": jax.random.uniform(k_t, (shape[0],)),
            "eps": jax.random.normal(k_eps, shape),
            "use_cos": jax.random.bernoulli(k_mix, 0.5, (shape[0],))}


def _torch_draws(d):
    return {n: torch.from_numpy(np.array(a)) for n, a in d.items()}


OPT = dict(learning_rate=1e-3, warmup_steps=2)


@pytest.mark.parametrize("objective,schedule",
                         [("ddpm", "cosine"), ("fm", "linear")])
def test_expert_trainer_matches_reference(one_torch_thread, batch, objective,
                                          schedule):
    """One step's loss and every gradient leaf, then parameters, moments
    and EMA after 5 AdamW steps, from the reference's draws."""
    cfg, jcfg = dit_b2().reduced(latent_size=8), j_dit_b2().reduced(
        latent_size=8)
    params = jittered_numpy_params(cfg, 21)
    jtr = JT.ExpertTrainer(apply_fn=JD.make_expert_apply(jcfg),
                           objective=objective, schedule_name=schedule,
                           opt=JOpt.AdamWConfig(**OPT), ema_decay=0.9)
    tr = T.ExpertTrainer(apply_fn=D.make_expert_apply(cfg),
                         objective=objective, schedule_name=schedule,
                         opt=Opt.AdamWConfig(**OPT), ema_decay=0.9,
                         device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    lat, text = batch["latents"], batch["text_emb"]
    key = jax.random.PRNGKey(5)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jtr.loss(p, key, jnp.asarray(lat), jnp.asarray(text)))(
        jparams)
    draws = _torch_draws(_expert_draws(key, objective, lat.shape))
    got_loss, got_grads = T.value_and_grad(
        lambda p: tr.loss(p, draws, torch.from_numpy(lat),
                          torch.from_numpy(text)),
        params_from_numpy(params, "cpu"))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    _leaves_close(got_grads, want_grads, GRAD_REL)

    jstate = jtr.init_state(jparams)
    state = tr.init_state(params_from_numpy(params, "cpu"))
    tb = {n: torch.from_numpy(batch[n]) for n in ("latents", "text_emb")}
    for i in range(5):
        k = jax.random.PRNGKey(100 + i)
        jstate, jm = jtr.train_step(jstate, k, {
            "latents": jnp.asarray(lat), "text_emb": jnp.asarray(text)})
        state, m = tr.train_step(state, None, tb, draws=_torch_draws(
            _expert_draws(k, objective, lat.shape)))
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["lr"], jm["lr"], rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=1e-4)
    assert state.step == jstate.step == 5
    for got, want in ((state.opt_state.mu, jstate.opt_state.mu),
                      (state.opt_state.nu, jstate.opt_state.nu)):
        _leaves_close(got, want, STATE_REL, STATE_ABS)
    for got, want in ((state.params, jstate.params), (state.ema, jstate.ema)):
        _leaves_close(got, want, STATE_REL, STEP_ABS)


def test_router_trainer_matches_reference(one_torch_thread, batch):
    """One router step: loss, accuracy and every gradient leaf, then the
    metrics and parameters of a second step."""
    cfg = router_b2(num_clusters=3).reduced(latent_size=8)
    jcfg = j_router_b2(num_clusters=3).reduced(latent_size=8)
    params = jittered_numpy_params(cfg, 22)
    jtr = JT.RouterTrainer(apply_fn=lambda p, x, t: JD.apply(jcfg, p, x, t),
                           num_clusters=3)
    tr = T.RouterTrainer(apply_fn=lambda p, x, t: D.apply(cfg, p, x, t),
                         num_clusters=3, device="cpu")
    lat, labels = batch["latents"], batch["cluster"]
    key = jax.random.PRNGKey(9)
    (want_loss, want_acc), want_grads = jax.value_and_grad(
        lambda p: jtr.loss(p, key, jnp.asarray(lat), jnp.asarray(labels)),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    draws = _torch_draws(_router_draws(key, lat.shape))
    (got_loss, got_acc), got_grads = T.value_and_grad(
        lambda p: tr.loss(p, draws, torch.from_numpy(lat),
                          torch.from_numpy(labels)),
        params_from_numpy(params, "cpu"), has_aux=True)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    assert got_acc.item() == float(want_acc)
    _leaves_close(got_grads, want_grads, GRAD_REL)

    jstate = jtr.init_state(jax.tree.map(jnp.asarray, params))
    state = tr.init_state(params_from_numpy(params, "cpu"))
    for i in range(2):
        k = jax.random.PRNGKey(200 + i)
        jstate, jm = jtr.train_step(jstate, k, {
            "latents": jnp.asarray(lat), "cluster": jnp.asarray(labels)})
        state, m = tr.train_step(
            state, None, {"latents": torch.from_numpy(lat),
                          "cluster": torch.from_numpy(labels)},
            draws=_torch_draws(_router_draws(k, lat.shape)))
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        assert m["acc"] == jm["acc"]
        np.testing.assert_allclose(m["lr"], jm["lr"], rtol=1e-6)
    # the router's lr is 5e-5: a hundredth of a step is below STATE_ABS
    _leaves_close(state.opt_state.mu, jstate.opt_state.mu, STATE_REL,
                  STATE_ABS)
    _leaves_close(state.params, jstate.params, STATE_REL, STATE_ABS)
    _leaves_close(state.ema, jstate.ema, STATE_REL, STATE_ABS)


def test_trainers_draw_from_a_generator_and_default_to_the_card(batch):
    """Without ``draws`` a step draws from the generator (the same seed
    gives the same step); the default device is the GPU, which raises on
    a machine without one."""
    cfg = dit_b2().reduced(latent_size=8, num_layers=1)
    params = params_from_numpy(jittered_numpy_params(cfg, 3), "cpu")
    tr = T.ExpertTrainer(apply_fn=D.make_expert_apply(cfg), objective="fm",
                         schedule_name="linear", device="cpu")
    tb = {n: torch.from_numpy(batch[n]) for n in ("latents", "text_emb")}
    runs = [tr.train_step(tr.init_state(params),
                          torch.Generator().manual_seed(1), tb)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    d = tr.draw(torch.Generator().manual_seed(1), tb["latents"])
    assert set(d) == {"t", "eps", "drop"} and d["drop"].dtype == torch.bool
    rd = T.RouterTrainer(apply_fn=None, num_clusters=2, device="cpu").draw(
        torch.Generator().manual_seed(1), tb["latents"])
    assert set(rd) == {"t", "eps", "use_cos"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.ExpertTrainer(apply_fn=None, objective="fm",
                            schedule_name="linear")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.RouterTrainer(apply_fn=None, num_clusters=2)
    # the LM step is ported: it returns a step that trains on the CPU
    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    lm = get_config("mamba2-2.7b").reduced(num_layers=1)
    step = T.make_lm_train_step(lm, Opt.AdamWConfig())
    lb = {"tokens": torch.zeros(1, 16, dtype=torch.int32),
          "labels": torch.ones(1, 16, dtype=torch.int32)}
    p = zoo.init(lm, torch.Generator().manual_seed(0), "cpu")
    _, st, loss, m = step(p, Opt.adamw_init(p), lb)
    assert int(st.step) == 1 and math.isfinite(loss.item())
    assert set(m) == {"ce", "grad_norm", "lr"}


# ---------------------------------------------------------------------------
# The training CLI
# ---------------------------------------------------------------------------


def test_train_cli_writes_a_servable_checkpoint(one_torch_thread, tmp_path,
                                                capsys):
    """``--mode expert`` at reduced size on the CPU: the EMA checkpoint
    loads with its metadata, and the serving engine serves a finite
    request from it; ``--mode lm`` trains paligemma-3b (its batches with
    the stubbed patches) and mamba2-2.7b, printing the reference's step
    lines, and raises for an unknown arch (argparse's choices)."""
    from repro_torch.launch import train
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.training.checkpoint import load_checkpoint

    out = tmp_path / "expert0.npz"
    train.main(["--mode", "expert", "--objective", "ddpm", "--cluster", "0",
                "--clusters", "2", "--corpus", "128", "--steps", "3",
                "--batch", "4", "--out", str(out), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("step      0 loss ")
    assert lines[-1] == f"saved EMA checkpoint -> {out}"
    params, meta = load_checkpoint(str(out), device="cpu")
    assert meta["objective"] == "ddpm" and meta["schedule"] == "cosine"
    assert meta["cluster_id"] == 0 and meta["step"] == 3
    assert meta["arch"] == "dit-b2"
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))
    eng = ServingEngine.from_checkpoint_dir(
        str(tmp_path), dit_cfg=dit_b2().reduced(latent_size=8),
        device="cpu")
    text = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0))
    lat = eng.generate(0, text, 2)
    assert lat.shape == (2, 8, 8, 4) and bool(torch.isfinite(lat).all())
    with pytest.raises(SystemExit):
        train.main(["--mode", "lm", "--arch", "gpt-9", "--device", "cpu"])
    capsys.readouterr()
    train.main(["--mode", "lm", "--arch", "paligemma-3b", "--steps", "2",
                "--seq-len", "16", "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:15] for ln in lines] == ["step    0 loss ", "step    1 loss "]
    assert all(math.isfinite(float(ln.split()[-1])) for ln in lines)
    train.main(["--mode", "lm", "--arch", "mamba2-2.7b", "--steps", "2",
                "--seq-len", "32", "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:15] for ln in lines] == ["step    0 loss ", "step    1 loss "]
