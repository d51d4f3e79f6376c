"""LM training of the port against the JAX package, on the CPU (mamba2;
the train step also on the dense internlm2 and the hybrid zamba2):
the SSD scan's plain backward (and its first stage, the state gradient at
each chunk's end, and the split the kernels compute it by), the token-mean
cross-entropy, the zoo
loss and its gradients, the LM train step, the in-place AdamW update,
``launch.steps``, ``lm_batch``, the ``--mode lm`` CLI and the LM example.

The same numpy inputs (or JAX parameters and batches passed through
``np.asarray``) go through both packages.  Tolerances, each relative to
the largest |value| of the output it bounds:

* ``BWD_REL = 1e-5``: ``ref_ssd_scan_bwd`` (the chunked backward written
  out) against ``jax.vjp`` of the reference's ``ssd_chunked`` and
  against autograd of the sequential recurrence — float32 sums in
  another order, decay factors from float32 cumulative log-decays
  (observed ≤ 1.4e-6);
* ``LOSS_REL = 1e-5`` for a loss, ``GRAD_REL = 1e-4`` per gradient leaf:
  two reduced float32 layers of GEMMs, RMSNorms and the scan, forward
  and backward, summed in another order by XLA and ATen (as
  ``tests/test_torch_training.py``);
* after AdamW steps the moments within ``STATE_REL · max + 1e-7``; the
  parameters within ``STATE_REL · max`` plus a hundredth of a step where
  the gradient is clear of ``GRAD_REL · max``, and within two steps
  everywhere: Adam's first step is ``lr·g/(|g| + ε)``, so an entry whose
  gradient is zero to within rounding moves by ±lr on either side.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.data.pipeline import lm_batch as j_lm_batch
from repro.launch import steps as JSteps
from repro.models import mamba2 as JM
from repro.models import transformer as JTr
from repro.models import zoo as jzoo
from repro.training import optimizer as JOpt
from repro.training import trainer as JT
from repro_torch.configs import get_config, get_shape
from repro_torch.data import lm_batch
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.models import transformer as Tr
from repro_torch.models import zoo
from repro_torch.models.config import LMConfig
from repro_torch.training import optimizer as Opt
from repro_torch.training import trainer as T
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import params_from_numpy
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

BWD_REL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4
STATE_REL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_leaves(tree):
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(
        tree)]


# ---------------------------------------------------------------------------
# The SSD scan's plain backward
# ---------------------------------------------------------------------------


def _scan_inputs(b, h, s, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2.0)).astype(
        np.float32)
    A = -np.linspace(1.0, 8.0, h).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, dy, ds


@pytest.mark.parametrize("with_dstate", [False, True], ids=["ds0", "ds"])
@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (2, 3, 64, 8, 16, 16),          # four chunks
    (1, 2, 48, 16, 8, 48),          # one chunk: chunk equal to S
    (2, 4, 32, 32, 16, 8),          # reduced head width, chunk 8
])
def test_ref_ssd_scan_bwd_matches_jax_vjp(b, h, s, p, n, chunk, with_dstate):
    """``ref_ssd_scan_bwd`` against ``jax.vjp`` of the reference's
    ``ssd_chunked`` from the zero state (cotangents dy and, or not, the
    final state's), and against autograd of the port's ``ops.ssd_scan``
    on the CPU: all five gradients within ``BWD_REL``."""
    x, dt, A, B, C, dy, ds = _scan_inputs(b, h, s, p, n, s + p)

    @jax.jit
    def vjp(args, ct):
        return jax.vjp(lambda *a: JM.ssd_chunked(*a, chunk=chunk), *args)[1](
            ct)

    want = vjp((x, dt, A, B, C), (dy, ds if with_dstate
                                  else np.zeros_like(ds)))
    got = ref.ref_ssd_scan_bwd(
        _t(x).transpose(1, 2), _t(dt).transpose(1, 2), _t(A), _t(B), _t(C),
        _t(dy).transpose(1, 2), _t(ds) if with_dstate else None, chunk=chunk)
    assert got[1].dtype == got[2].dtype == torch.float32
    leaves = [_t(a).requires_grad_(True) for a in (x, dt, A, B, C)]
    y, state = ops.ssd_scan(leaves[0].transpose(1, 2),
                            leaves[1].transpose(1, 2), leaves[2], leaves[3],
                            leaves[4], chunk=chunk)
    loss = (y * _t(dy).transpose(1, 2)).sum()
    if with_dstate:
        loss = loss + (state * _t(ds)).sum()
    auto = torch.autograd.grad(loss, leaves)
    layout = (lambda g: g.transpose(1, 2),) * 2 + (lambda g: g,) * 3
    for name, g, w, a, f in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                                auto, layout):
        assert _rel(f(g), w) <= BWD_REL, name
        assert _rel(f(g), a.numpy()) <= BWD_REL, name


def test_ref_ssd_scan_bwd_partial_last_chunk():
    """S = 40 in chunks of 16: the last chunk holds 8 positions, padded
    with dt = 0 (no decay, no input) — against autograd of the sequential
    recurrence."""
    x, dt, A, B, C, dy, ds = _scan_inputs(2, 2, 40, 8, 8, 3)
    leaves = [_t(a).requires_grad_(True) for a in (x, dt, A, B, C)]
    y, state = ref.ref_ssd_scan(*leaves)
    auto = torch.autograd.grad((y * _t(dy)).sum() + (state * _t(ds)).sum(),
                               leaves)
    got = ref.ref_ssd_scan_bwd(
        _t(x).transpose(1, 2), _t(dt).transpose(1, 2), _t(A), _t(B), _t(C),
        _t(dy).transpose(1, 2), _t(ds), chunk=16)
    got = (got[0].transpose(1, 2), got[1].transpose(1, 2)) + got[2:]
    for g, a in zip(got, auto):
        assert _rel(g, a.numpy()) <= BWD_REL


def test_ref_ssd_scan_bwd_keeps_the_input_dtypes():
    x, dt, A, B, C, dy, _ = _scan_inputs(1, 2, 32, 8, 8, 5)
    bf = torch.bfloat16
    got = ref.ref_ssd_scan_bwd(
        _t(x).transpose(1, 2).to(bf), _t(dt).transpose(1, 2), _t(A),
        _t(B).to(bf), _t(C).to(bf), _t(dy).transpose(1, 2).to(bf), chunk=16)
    assert [g.dtype for g in got] == [bf, torch.float32, torch.float32, bf,
                                      bf]


#: the backward's first stage and its decomposition: the same shapes as the
#: kernel's CPU-side checks — the reduced config's, chunk 8, a partial last
#: tile, P 36 with N 24 and a partial last tile
STATE_SHAPES = [
    (2, 3, 64, 32, 16, 16),
    (1, 2, 48, 8, 32, 8),
    (2, 2, 40, 8, 8, 16),
    (1, 3, 60, 36, 24, 16),
]


@pytest.mark.parametrize("with_dstate", [False, True], ids=["ds0", "ds"])
@pytest.mark.parametrize("b,h,s,p,n,chunk", STATE_SHAPES)
def test_ref_ssd_scan_bwd_states_matches_jax_vjp(b, h, s, p, n, chunk,
                                                 with_dstate):
    """``ref_ssd_scan_bwd_states`` (the plain version of the backward's
    first stage) against the reference: for chunk k, the gradient of the
    state at its end is ``jax.vjp`` of ``ssd_chunked`` over the positions
    after chunk k with respect to ``init_state`` — the final state of
    ``ssd_chunked`` over chunks 0..k — under the cotangents ``(dy,
    d_state)`` (for the last chunk, ``d_state`` itself).  A partial last
    chunk is padded with ``dt = 0`` and ``x = dy = 0``, as the kernel's
    plain versions pad it (the reference asserts ``S % chunk == 0``).
    Within ``BWD_REL``."""
    x, dt, A, B, C, dy, ds = _scan_inputs(b, h, s, p, n, s + n)
    nt = -(-s // chunk)

    def padded(a):
        return np.pad(a, [(0, 0), (0, nt * chunk - s)]
                      + [(0, 0)] * (a.ndim - 2))

    xp, dtp, Bp, Cp, dyp = map(padded, (x, dt, B, C, dy))
    ct = ds if with_dstate else np.zeros_like(ds)
    got = ref.ref_ssd_scan_bwd_states(
        _t(dt).transpose(1, 2), _t(A), _t(C), _t(dy).transpose(1, 2),
        _t(ds) if with_dstate else None, chunk=chunk)
    assert got.shape == (b, h, nt, p, n) and got.dtype == torch.float32
    for k in range(nt):
        e = (k + 1) * chunk
        if k == nt - 1:
            want = ct
        else:
            init = JM.ssd_chunked(xp[:, :e], dtp[:, :e], A, Bp[:, :e],
                                  Cp[:, :e], chunk=chunk)[1]
            _, vjp = jax.vjp(lambda s0, e=e: JM.ssd_chunked(
                xp[:, e:], dtp[:, e:], A, Bp[:, e:], Cp[:, e:], chunk=chunk,
                init_state=s0), init)
            (want,) = vjp((dyp[:, e:], ct))
        assert _rel(got[:, :, k], want) <= BWD_REL, k


def _kernel_decomposition(x, dt, A, B, C, dy, ds, chunk):
    """The backward as the CUDA kernels split it, in plain torch (float32,
    the kernels' layout): the end-of-tile state gradients first
    (``ref_ssd_scan_bwd_states``), then per (batch, head, tile) only
    independent terms — g's state and triangle parts, and the per-position
    R, Q', dci, s' and exp(cum_last)·⟨dS, S0⟩ — and per (batch, tile) the
    head sums; ∂/∂cum assembled from those as the sums kernel does."""
    f32 = torch.float32
    b, h, s, p = x.shape
    n = B.shape[-1]
    nt = -(-s // chunk)
    pad = nt * chunk - s

    def tiles(a, axis):
        a = a.to(f32)
        widths = [0, 0] * (a.dim() - 1 - axis) + [0, pad]
        a = torch.nn.functional.pad(a, widths)
        return a.reshape(a.shape[:axis] + (nt, chunk) + a.shape[axis + 1:])

    xf, dyf, dtf = tiles(x, 2), tiles(dy, 2), tiles(dt, 2)
    Bf, Cf = tiles(B, 1), tiles(C, 1)
    cum = torch.cumsum(dtf * A[:, None, None], -1)          # (b, h, nt, q)
    last = cum[..., -1:]
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    L = torch.exp(torch.where(lower, cum[..., :, None] - cum[..., None, :],
                              -math.inf))                   # [i][j]
    M = (Cf @ Bf.transpose(-1, -2))[:, None] * L
    ecum, dte = torch.exp(cum), torch.exp(last - cum)
    elast = torch.exp(last[..., 0])
    dS = ref.ref_ssd_scan_bwd_states(dt, A, C, dy, ds, chunk=chunk)
    S0 = torch.zeros_like(dS)                               # tile starts
    state = torch.zeros((b, h, p, n))
    for k in range(nt):
        S0[:, :, k] = state
        state = elast[:, :, k, None, None] * state + torch.einsum(
            "bhjp,bhj,bjn->bhpn", xf[:, :, k], dtf[:, :, k] * dte[:, :, k],
            Bf[:, k])
    G = torch.einsum("bhkjp,bhkip->bhkji", xf, dyf)         # x_j·dy_i
    t = G * M.transpose(-1, -2)                             # [j][i]
    R = (dtf[..., :, None] * t).sum(-2)                     # over j
    Qp = t.sum(-1)                                          # over i
    gs = dte[..., None] * torch.einsum("bkjn,bhkpn->bhkjp", Bf, dS)
    g = torch.einsum("bhkij,bhkip->bhkjp", M, dyf) + gs
    sp = (xf * gs).sum(-1)
    dCp = ecum[..., None] * torch.einsum("bhkip,bhkpn->bhkin", dyf, S0)
    dci = (dCp * Cf[:, None]).sum(-1)
    ex = elast * (dS * S0).sum((-1, -2))
    xg = Qp + sp
    dcum = R + dci - dtf * xg
    dcum[..., -1] += (dtf * sp).sum(-1) + ex
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = xg + A[:, None, None] * da
    dA = (da * dtf).sum((0, 2, 3))
    dtGL = (dtf[..., :, None] * G * L.transpose(-1, -2)).sum(1)   # [j][i]
    dBp = (dtf * dte)[..., None] * torch.einsum("bhkjp,bhkpn->bhkjn", xf, dS)
    dC = dCp.sum(1) + dtGL.transpose(-1, -2) @ Bf
    dB = dBp.sum(1) + dtGL @ Cf

    def untile(a, axis):
        a = a.reshape(a.shape[:axis] + (nt * chunk,) + a.shape[axis + 2:])
        return a.narrow(axis, 0, s)

    return (untile(dtf[..., None] * g, 2), untile(ddt, 2), dA,
            untile(dB, 1), untile(dC, 1))


@pytest.mark.parametrize("with_dstate", [False, True], ids=["ds0", "ds"])
@pytest.mark.parametrize("b,h,s,p,n,chunk", STATE_SHAPES)
def test_kernel_decomposition_matches_ref_ssd_scan_bwd(b, h, s, p, n, chunk,
                                                       with_dstate):
    """The identities the backward kernels rest on — ∂/∂cum from the row
    and column sums R, Q' of ``dt G M``, dci, s' and ⟨dS, S0⟩, ``x·g = Q' +
    s'``, the head sums taken after the per-head terms, and the state
    gradients computed before any tile — written out in plain torch and
    held against ``ref_ssd_scan_bwd``: all five gradients within
    ``BWD_REL``."""
    x, dt, A, B, C, dy, ds = _scan_inputs(b, h, s, p, n, 2 * s + p)
    args = (_t(x).transpose(1, 2), _t(dt).transpose(1, 2), _t(A), _t(B),
            _t(C), _t(dy).transpose(1, 2), _t(ds) if with_dstate else None)
    got = _kernel_decomposition(*args, chunk)
    want = ref.ref_ssd_scan_bwd(*args, chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert _rel(g, w.numpy()) <= BWD_REL, name


# ---------------------------------------------------------------------------
# Cross-entropy, the zoo loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 16, 40, 64])
def test_cross_entropy_matches_jax(chunk):
    """Token-mean CE against the reference's, chunked and not: with S 40
    and chunk 16 the two whole chunks are averaged and the last 8
    positions are left out, as the reference does."""
    rng = np.random.default_rng(chunk)
    logits = (3 * rng.standard_normal((2, 40, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (2, 40)).astype(np.int32)
    want = float(JTr.cross_entropy(logits, labels, chunk=chunk))
    got = Tr.cross_entropy(_t(logits), _t(labels), chunk=chunk).item()
    assert abs(got - want) <= LOSS_REL * abs(want)
    if chunk == 16:                 # the remainder is dropped
        head = Tr.cross_entropy(_t(logits[:, :32]), _t(labels[:, :32]))
        whole = Tr.cross_entropy(_t(logits), _t(labels))
        assert abs(got - head.item()) <= LOSS_REL * abs(want)
        assert abs(got - whole.item()) > 1e-3


def _reduced_pair(arch="mamba2-2.7b", **over):
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    return dataclasses.replace(jcfg, **over), dataclasses.replace(cfg, **over)


def _carried(jcfg, seed=0):
    jp = jzoo.init(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(vocab, b=2, s=32, seed=7):
    jb = j_lm_batch(jax.random.PRNGKey(seed), b, s, vocab)
    return jb, {k: _t(np.asarray(v)) for k, v in jb.items()}


def _grad_rel(got, want) -> float:
    return max(_rel(g, w) for g, w in zip(tree_leaves(got),
                                          _np_leaves(want)))


@pytest.mark.parametrize("chunk", [0, 16], ids=["whole", "chunked"])
def test_zoo_loss_and_gradients_match_jax(one_torch_thread, chunk):
    """``zoo.loss_fn`` of the reduced mamba2-2.7b on carried-over weights:
    the loss within ``LOSS_REL`` and every gradient leaf within
    ``GRAD_REL`` of ``jax.value_and_grad(repro.models.zoo.loss_fn)``;
    with remat on, the port's numbers are bitwise those with it off."""
    jcfg, cfg = _reduced_pair(logits_chunk=chunk)
    jp, tp = _carried(jcfg)
    jb, tb = _batch(cfg.vocab_size)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jzoo.loss_fn(jcfg, p, jb), has_aux=True))(jp)
    runs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        (loss, m), g = T.value_and_grad(lambda p: zoo.loss_fn(c, p, tb), tp,
                                        has_aux=True)
        runs.append((loss, m, g))
    (loss, m, g), (rloss, _, rg) = runs
    assert abs(loss.item() - float(jloss)) <= LOSS_REL * abs(float(jloss))
    assert abs(m["ce"].item() - float(jm["ce"])) <= LOSS_REL * float(jm["ce"])
    assert _grad_rel(g, jg) <= GRAD_REL
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g),
                                                 tree_leaves(rg)))
    # every leaf has a gradient (none stops at the scan)
    assert all(bool(a.abs().max() > 0) for a in tree_leaves(g))


# ---------------------------------------------------------------------------
# The LM train step and the in-place AdamW update
# ---------------------------------------------------------------------------


def _check_state(params, opt_state, jparams, jopt, lr, jgrad=None):
    """Moments within ``STATE_REL``; parameters within ``STATE_REL`` plus
    a hundredth of a step where the (first) gradient is clear of
    ``GRAD_REL``, within two steps everywhere."""
    for m, jm in zip(tree_leaves(opt_state.mu), _np_leaves(jopt.mu)):
        assert np.abs(m.numpy() - jm).max() <= STATE_REL * np.abs(jm).max() \
            + 1e-7
    for v, jv in zip(tree_leaves(opt_state.nu), _np_leaves(jopt.nu)):
        assert np.abs(v.numpy() - jv).max() <= STATE_REL * np.abs(jv).max() \
            + 1e-7
    grads = _np_leaves(jgrad) if jgrad is not None else None
    for i, (p, jpar) in enumerate(zip(tree_leaves(params),
                                      _np_leaves(jparams))):
        diff = np.abs(p.numpy() - jpar)
        assert diff.max() <= 2 * lr + 1e-7
        if grads is not None:
            g = grads[i]
            clear = np.abs(g) > GRAD_REL * np.abs(g).max()
            if clear.any():
                assert diff[clear].max() <= STATE_REL * np.abs(jpar).max() \
                    + lr / 100


_STEP_LR = 1e-3


#: the train step's archs: mamba2 (reduced), the dense internlm2 with 4
#: query heads over 2 kv heads (its reduction leaves it 4/4) and the
#: hybrid zamba2; each case's id, the mamba2 ones as they were
TRAIN_ARCHS = {"mamba2-2.7b": {}, "internlm2-1.8b": dict(num_kv_heads=2),
               "zamba2-2.7b": {}}
TRAIN_CASES = [(a, n) for a in TRAIN_ARCHS for n in (1, 3)]
TRAIN_IDS = [str(n) if a == "mamba2-2.7b" else f"{a}-{n}"
             for a, n in TRAIN_CASES]


@functools.cache
def _jax_trajectory(steps: int, arch: str = "mamba2-2.7b"):
    """The reference's jitted LM step on the reduced ``arch`` from carried
    weights: per step (loss, metrics, params, opt state), and the first
    step's gradients."""
    jcfg, _ = _reduced_pair(arch, **TRAIN_ARCHS[arch])
    jp, _ = _carried(jcfg, seed=1)
    jstep = JT.make_lm_train_step(jcfg, JOpt.AdamWConfig(
        learning_rate=_STEP_LR, warmup_steps=2))
    jstate, out = JOpt.adamw_init(jp), []
    jb, _ = _batch(jcfg.vocab_size, seed=20)
    _, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jzoo.loss_fn(jcfg, p, jb), has_aux=True))(jp)
    for i in range(steps):
        jb, _ = _batch(jcfg.vocab_size, seed=20 + i)
        jp, jstate, jloss, jm = jstep(jp, jstate, jb)
        out.append((jloss, jm, jp, jstate))
    return out, jgrad


@pytest.mark.parametrize("arch,nsteps", TRAIN_CASES, ids=TRAIN_IDS)
def test_lm_train_step_matches_jax(one_torch_thread, arch, nsteps):
    """``make_lm_train_step`` against the reference's jitted step on the
    reduced mamba2-2.7b, internlm2-1.8b (GQA 4/2) and zamba2-2.7b, the
    same batches: each step's loss and ``grad_norm``, then the parameters
    and both moments (tolerances in the module docstring; the first
    gradient decides which entries are clear of rounding)."""
    jcfg, cfg = _reduced_pair(arch, **TRAIN_ARCHS[arch])
    _, tp = _carried(jcfg, seed=1)
    step = T.make_lm_train_step(cfg, Opt.AdamWConfig(
        learning_rate=_STEP_LR, warmup_steps=2))
    state = Opt.adamw_init(tp)
    traj, jgrad = _jax_trajectory(3, arch)
    for i in range(nsteps):
        _, tb = _batch(cfg.vocab_size, seed=20 + i)
        jloss, jm, jp, jstate = traj[i]
        tp, state, loss, m = step(tp, state, tb)
        assert abs(loss.item() - float(jloss)) <= LOSS_REL * float(jloss)
        assert set(m) == set(jm)
        assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= \
            GRAD_REL * float(jm["grad_norm"])
        assert m["lr"].item() == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state.step) == nsteps
    _check_state(tp, state, jp, jstate, _STEP_LR,
                 jgrad if nsteps == 1 else None)


def _opt_tree(seed):
    """A tree with a stacked float32 leaf, a bf16 leaf, a wide one that
    takes several slices and a 0-d one, and its gradients."""
    g = torch.Generator().manual_seed(seed)
    params = {"blocks": {"w": torch.randn(5, 6, 7, generator=g),
                         "h": torch.randn(4, 33, generator=g).to(
                             torch.bfloat16)},
              "wide": torch.randn(300, 9, generator=g),
              "scale": torch.randn((), generator=g)}
    grads = tree_map(lambda p: (3 * torch.randn(p.shape, generator=g)).to(
        p.dtype), params)
    return params, grads


@pytest.mark.parametrize("clip,wd", [(1.0, 0.0), (0.0, 1e-2), (1e3, 0.0)])
def test_inplace_update_is_bitwise_adamw_update(monkeypatch, clip, wd):
    """``adamw_update_`` (slices of the leading axis, in place) against
    ``adamw_update`` (whole leaves, new trees) over three steps, clipping
    on and off, with weight decay: parameters, moments, step, grad norm
    and lr bitwise equal; the inputs are the tensors updated."""
    monkeypatch.setattr(Opt, "SLICE_ELEMS", 64)        # many slices
    cfg = Opt.AdamWConfig(learning_rate=1e-2, warmup_steps=2,
                          clip_norm=clip, weight_decay=wd)
    params, grads = _opt_tree(3)
    p1, s1 = params, Opt.adamw_init(params)
    p2 = tree_map(torch.clone, params)
    s2 = Opt.adamw_init(p2)
    for i in range(3):
        g = tree_map(lambda a: a * (i + 1), grads)
        p1, s1, m1 = Opt.adamw_update(cfg, g, s1, p1)
        mu, nu = s2.mu, s2.nu
        out, s2, m2 = Opt.adamw_update_(cfg, g, s2, p2)
        assert out is p2 and s2.mu is mu and s2.nu is nu
        assert torch.equal(m1["grad_norm"], m2["grad_norm"])
        assert torch.equal(m1["lr"], m2["lr"])
        assert torch.equal(s1.step, s2.step)
        for a, b in zip(tree_leaves((p1, s1.mu, s1.nu)),
                        tree_leaves((p2, s2.mu, s2.nu))):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# launch.steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_steps_make_train_step_matches_jax(one_torch_thread, microbatches):
    """``steps.make_train_step`` (gradient accumulation over leading-axis
    splits, summed then scaled) against the reference's: the loss, then
    the parameters and moments after one step."""
    jcfg, cfg = _reduced_pair()
    jp, tp = _carried(jcfg, seed=2)
    jb, tb = _batch(cfg.vocab_size, b=4, s=16, seed=9)
    jopt, opt = JOpt.AdamWConfig(), Opt.AdamWConfig()
    jstep = jax.jit(JSteps.make_train_step(jcfg, jopt,
                                           microbatches=microbatches))
    step = steps.make_train_step(cfg, opt, microbatches=microbatches)
    jp2, jstate, jloss = jstep(jp, JOpt.adamw_init(jp), jb)
    tp2, state, loss = step(tp, Opt.adamw_init(tp), tb)
    assert abs(loss.item() - float(jloss)) <= LOSS_REL * float(jloss)
    _check_state(tp2, state, jp2, jstate, opt.learning_rate)


def test_steps_prefill_and_serve_match_jax(one_torch_thread):
    """``make_prefill_step`` and ``make_serve_step`` (decode_32k) on
    carried weights: logits and caches within ``1e-5`` of the
    reference's."""
    jcfg, cfg = _reduced_pair()
    jp, tp = _carried(jcfg, seed=4)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32),
                                             dtype=np.int32)
    jl, jc = JSteps.make_prefill_step(jcfg)(jp, {"tokens": toks})
    tl, tc = steps.make_prefill_step(cfg)(tp, {"tokens": _t(toks)})
    assert _rel(tl, jl) <= 1e-5
    shape = get_shape("decode_32k")
    nxt = toks[:, :1]
    jl2, jc2 = JSteps.make_serve_step(jcfg, J_SHAPES["decode_32k"])(
        jp, jc, nxt, np.full((2,), 32, np.int32))
    tl2, tc2 = steps.make_serve_step(cfg, shape)(tp, tc, _t(nxt), None)
    assert _rel(tl2, jl2) <= 1e-5
    for k in ("conv", "ssm"):
        assert _rel(tc2[k], jc2[k]) <= 1e-5


def test_cfg_for_shape_matches_jax():
    """Every architecture id of the reference (its name, family and
    attention windows) at every input shape: the same resolved window
    and cache length, or the same ``ValueError``."""
    for arch in J_ARCH_IDS:
        jcfg = j_get_config(arch)
        cfg = LMConfig(name=jcfg.name, arch_type=jcfg.arch_type,
                       num_layers=jcfg.num_layers, d_model=jcfg.d_model,
                       vocab_size=jcfg.vocab_size,
                       sliding_window=jcfg.sliding_window,
                       decode_window=jcfg.decode_window)
        for name, jshape in J_SHAPES.items():
            try:
                jr, jlen = JSteps.cfg_for_shape(jcfg, jshape)
            except ValueError as e:
                with pytest.raises(ValueError, match="sub-quadratic"):
                    steps.cfg_for_shape(cfg, get_shape(name))
                assert "sub-quadratic" in str(e)
                continue
            r, n = steps.cfg_for_shape(cfg, get_shape(name))
            assert (r.decode_window, n) == (jr.decode_window, jlen), (arch,
                                                                      name)
    with pytest.raises(ValueError, match="unknown input shape"):
        get_shape("train_1m")


def _struct(t):
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), str(t.dtype).split(".")[-1]
    return tuple(t.shape), jnp.dtype(t.dtype).name


def test_specs_and_shapes_match_jax():
    """``input_specs`` at every shape and ``param_shapes`` /
    ``opt_shapes`` of the full mamba2-2.7b: meta tensors with the
    reference's ``ShapeDtypeStruct`` shapes and dtypes, leaf for leaf."""
    jcfg, cfg = j_get_config("mamba2-2.7b"), get_config("mamba2-2.7b")
    for name, jshape in J_SHAPES.items():
        want = JSteps.input_specs(jcfg, jshape)
        got = steps.input_specs(cfg, get_shape(name))
        assert all(t.device.type == "meta" for t in tree_leaves(got))
        assert [_struct(t) for t in tree_leaves(got)] == \
            [_struct(t) for t in jax.tree_util.tree_leaves(want)], name
    got, want = steps.param_shapes(cfg), JSteps.param_shapes(jcfg)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert [_struct(t) for t in tree_leaves(got)] == \
        [_struct(t) for t in jax.tree_util.tree_leaves(want)]
    assert sum(t.numel() for t in tree_leaves(got)) == 2_831_296_000
    ostate, jostate = steps.opt_shapes(cfg), JSteps.opt_shapes(jcfg)
    assert [_struct(t) for t in tree_leaves(ostate.mu)] == \
        [_struct(t) for t in jax.tree_util.tree_leaves(jostate.mu)]
    assert _struct(ostate.step) == _struct(jostate.step)


# ---------------------------------------------------------------------------
# lm_batch, the CLI and the example
# ---------------------------------------------------------------------------


def test_lm_batch_shapes_range_shift_and_frequencies():
    """Shapes, dtype, range and the one-position shift; the frequency of
    the lowest ranks against the truncated Zipf(1.1) mixture (0.9 of
    ``log((r + 2)/(r + 1)) / log V`` plus 0.1 / V) within five standard
    deviations, and against the reference's draws of the same size."""
    vocab, b, s = 512, 64, 1024
    out = lm_batch(torch.Generator().manual_seed(0), b, s, vocab)
    toks, labels = out["tokens"], out["labels"]
    assert toks.shape == labels.shape == (b, s)
    assert toks.dtype == labels.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < vocab
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    jtoks = np.asarray(j_lm_batch(jax.random.PRNGKey(0), b, s,
                                  vocab)["tokens"])
    counts = np.bincount(toks.reshape(-1).numpy(), minlength=vocab)
    jcounts = np.bincount(jtoks.reshape(-1), minlength=vocab)
    total = b * s
    for r in range(8):
        p = 0.9 * math.log((r + 2) / (r + 1)) / math.log(vocab) + 0.1 / vocab
        sd = math.sqrt(p * (1 - p) / total)
        assert abs(counts[r] / total - p) <= 5 * sd, r
        assert abs(jcounts[r] / total - p) <= 5 * sd, r
    again = lm_batch(torch.Generator().manual_seed(0), b, s, vocab)
    assert torch.equal(again["tokens"], toks)


def test_train_cli_lm_mode_prints_the_reference_lines(one_torch_thread,
                                                      capsys):
    """``--mode lm --arch mamba2-2.7b`` trains the reduced model on the
    CPU and prints the reference's ``step    i loss …`` lines, and so does
    ``--arch paligemma-3b`` (its batches with the stubbed patches); an
    unknown id raises (argparse's choices)."""
    from repro_torch.launch import train

    for arch in ("mamba2-2.7b", "paligemma-3b"):
        train.main(["--mode", "lm", "--arch", arch, "--steps", "2",
                    "--seq-len", "32", "--batch", "2", "--device", "cpu"])
        lines = capsys.readouterr().out.splitlines()
        assert [ln[:15] for ln in lines] == ["step    0 loss ",
                                             "step    1 loss "], arch
        assert all(math.isfinite(float(ln.split()[-1])) for ln in lines)
    with pytest.raises(SystemExit):
        train.main(["--mode", "lm", "--arch", "gpt-9", "--device", "cpu"])


def test_lm_example_trains_two_experts(one_torch_thread, capsys):
    """The LM example at 3 steps: two experts train, and each cluster's
    right expert scores below its wrong one, the routed ensemble with it."""
    from repro_torch.examples import decentralized_lm_experts as ex

    ex.main(["--arch", "mamba2-2.7b", "--steps", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("training 2 isolated mamba2-2.7b experts")
    assert lines[1].startswith("  expert 0 final loss ")
    for line in lines[3:5]:
        words = line.split()
        right, wrong, routed = (float(words[i]) for i in (4, 7, 10))
        assert right < wrong and routed == right
