"""The port's Mamba2 SSD scan, mixer and backbone against the JAX package,
on the CPU.

The same numpy inputs, drawn from a seed (or JAX parameters passed
through ``np.asarray``), go through the reference and the port.  The
port's ``ops.ssd_scan`` runs its plain version (``ssd_sequential``) on
CPU tensors; the reference's scan is held under its oracle and under the
Pallas kernel in interpret mode.  The CUDA kernel is held against the
plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances, each relative to the output's scale ``max|want|``:

* ``SEQ_REL = 1e-6``: the two sequential recurrences, the same float32
  ops in the same order (einsum sums of ≤ 128 terms may differ by ulps);
* ``GEMM_REL = 1e-5``: a float32 GEMM (the mixer's input projection)
  summed in another order by XLA and ATen;
* ``CHUNK_REL = 1e-5``: chunked against sequential, or two chunked
  algorithms whose sums run in another order — ``exp(cum_i − cum_j)``
  of float32 cumulative sums carries an ulp of ``cum`` into every decay
  factor (observed ≤ 1e-6);
* ``MODEL_REL = 1e-5``: logits, caches and mixer outputs of the reduced
  float32 backbone: GEMMs and RMSNorms on top of the scan (observed
  ≤ 1.5e-6);
* ``BF16_MODEL_REL = 2⁻⁷``: the reduced bf16 backbone against the JAX
  model run op by op without jit: both round every op to bf16, but GEMM
  and reduction sums in another order can flip the rounding of a bf16
  value — one ulp, at most 2⁻⁷ of it (observed 3.8e-3 of max|logit|).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models import mamba2 as JM
from repro.models import zoo as jzoo
from repro.training import checkpoint as jckpt
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba2 as M
from repro_torch.models import zoo
from repro_torch.training import checkpoint as ckpt
from repro_torch.tree import tree_map
from repro_torch.weights import params_from_numpy

SEQ_REL = 1e-6
GEMM_REL = 1e-5
CHUNK_REL = 1e-5
MODEL_REL = 1e-5
BF16_MODEL_REL = 2.0 ** -7

#: the reference's SSD_CASES (tests/test_kernels.py):
#: (b, h, s, p, n, chunk, head_block)
SSD_CASES = [
    (2, 8, 64, 16, 16, 16, 4),
    (1, 4, 128, 32, 8, 32, 4),
    (2, 2, 32, 8, 32, 8, 2),
]


def _draw(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ssd_inputs(b, h, s, p, n, seed=0):
    """x (b, s, h, p), dt (b, s, h) = softplus(N), A = −exp(N), B, C."""
    x = _draw((b, s, h, p), seed)
    dt = np.asarray(jax.nn.softplus(_draw((b, s, h), seed + 1)))
    A = -np.exp(_draw((h,), seed + 2))
    B = _draw((b, s, n), seed + 3)
    C = _draw((b, s, n), seed + 4)
    return x, dt, A, B, C


@pytest.mark.parametrize("jax_side", ["oracle", "pallas"])
@pytest.mark.parametrize("b,h,s,p,n,chunk,hb", SSD_CASES)
def test_ssd_scan_matches_jax(b, h, s, p, n, chunk, hb, jax_side):
    """``ref_ssd_scan`` and ``ops.ssd_scan`` (CPU) against the reference's
    oracle and its Pallas kernel in interpret mode; the port returns the
    final state on the CPU too."""
    x, dt, A, B, C = _ssd_inputs(b, h, s, p, n)
    xk, dtk = np.swapaxes(x, 1, 2), np.swapaxes(dt, 1, 2)   # kernel layout
    if jax_side == "oracle":
        jy, jstate = JR.ref_ssd_scan(x, dt, A, B, C)
        jy = np.swapaxes(np.asarray(jy), 1, 2)
        rel = SEQ_REL
    else:
        jy, jstate = j_ssd_scan(xk, dtk, A, B, C, chunk=chunk,
                                head_block=hb, interpret=True)
        rel = CHUNK_REL
    y0, s0 = ref.ref_ssd_scan(_t(x), _t(dt), _t(A), _t(B), _t(C))
    y1, s1 = ops.ssd_scan(_t(xk), _t(dtk), _t(A), _t(B), _t(C), chunk=chunk,
                          head_block=hb)
    assert s1 is not None and s1.shape == (b, h, p, n)
    assert s1.dtype == torch.float32
    torch.testing.assert_close(y1, y0.transpose(1, 2), rtol=0, atol=0)
    torch.testing.assert_close(s1, s0, rtol=0, atol=0)
    assert _rel(y1, jy) <= rel
    assert _rel(s1, jstate) <= rel


def test_reference_cpu_scan_drops_the_state():
    """The reference's ``ops.ssd_scan`` on its oracle path returns
    ``(y, None)`` (``repro/kernels/ops.py:71``); the port returns the
    state on every device (ROADMAP.md §C)."""
    x, dt, A, B, C = _ssd_inputs(1, 2, 16, 4, 8)
    xk, dtk = np.swapaxes(x, 1, 2), np.swapaxes(dt, 1, 2)
    old = os.environ.get("REPRO_FORCE_PALLAS")
    os.environ["REPRO_FORCE_PALLAS"] = "0"
    try:
        _, jstate = jops.ssd_scan(xk, dtk, A, B, C, chunk=8)
    finally:
        if old is None:
            os.environ.pop("REPRO_FORCE_PALLAS")
        else:
            os.environ["REPRO_FORCE_PALLAS"] = old
    assert jstate is None
    _, state = ops.ssd_scan(_t(xk), _t(dtk), _t(A), _t(B), _t(C), chunk=8)
    _, want = JR.ref_ssd_scan(x, dt, A, B, C)
    assert _rel(state, want) <= SEQ_REL


def _scan_as_the_kernel_walks_it(x, dt, A, B, C, chunk, group=32):
    """The CUDA kernel's decomposition (``csrc/ssd_scan.cu``) in plain
    torch, kernel layout: C·Bᵀ once per (batch, chunk), never per head;
    per chunk and head the scores ``CB_ij·exp(cum_i − cum_j)·dt_j`` of the
    in-chunk cumulative log-decay, selected to 0 above the diagonal before
    the exp; the state split into column groups of ``group`` rows p, each
    carried through the chunks on its own: ``y = exp(cum)·(C·stateᵀ) +
    S·x``, ``state ← exp(cum_last)·state + (x·w)ᵀ·B``."""
    b, h, s, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    f32 = torch.float32
    groups = [slice(g, min(g + group, p)) for g in range(0, p, group)]
    states = [torch.zeros(b, h, g.stop - g.start, n, dtype=f32)
              for g in groups]
    lower = torch.tril(torch.ones(q, q, dtype=torch.bool))
    ys = []
    for t0 in range(0, s, q):
        Bc, Cc = B[:, t0:t0 + q].to(f32), C[:, t0:t0 + q].to(f32)
        cb = Cc @ Bc.transpose(-1, -2)                 # (b, q, q), per chunk
        d = dt[:, :, t0:t0 + q].to(f32)                # (b, h, q)
        cum = torch.cumsum(d * A[:, None], dim=-1)
        seg = torch.where(lower, cum[..., :, None] - cum[..., None, :], 0.0)
        scores = torch.where(lower, cb[:, None] * torch.exp(seg)
                             * d[..., None, :], 0.0)   # (b, h, q, q)
        w = d * torch.exp(cum[..., -1:] - cum)
        decay = torch.exp(cum[..., -1])[..., None, None]
        parts = []
        for k, g in enumerate(groups):
            xg = x[:, :, t0:t0 + q, g].to(f32)         # (b, h, q, group)
            st = states[k]
            inter = torch.exp(cum)[..., None] * (Cc[:, None]
                                                 @ st.transpose(-1, -2))
            parts.append(inter + scores @ xg)
            states[k] = decay * st + (xg * w[..., None]).transpose(-1, -2) \
                @ Bc[:, None]
        ys.append(torch.cat(parts, dim=-1))
    return torch.cat(ys, dim=2).to(x.dtype), torch.cat(states, dim=2)


@pytest.mark.parametrize("b,h,s,p,n,chunk,hb", SSD_CASES + [
    (1, 2, 64, 64, 16, 16, 2),       # two column groups of 32
    (2, 2, 48, 48, 8, 16, 2),        # a group of 32 and one of 16
])
def test_kernel_decomposition_matches_jax(b, h, s, p, n, chunk, hb):
    """The algebra the CUDA kernel's split rests on: state column groups
    scanned on their own, C·Bᵀ once per (batch, chunk), chunk by chunk —
    against the JAX Pallas kernel (interpret mode), the JAX oracle and the
    port's ``ref_ssd_scan``, at ``CHUNK_REL``."""
    x, dt, A, B, C = _ssd_inputs(b, h, s, p, n)
    xk, dtk = np.swapaxes(x, 1, 2), np.swapaxes(dt, 1, 2)
    y, state = _scan_as_the_kernel_walks_it(_t(xk), _t(dtk), _t(A), _t(B),
                                            _t(C), chunk)
    assert y.shape == (b, h, s, p) and state.shape == (b, h, p, n)
    jy, jstate = j_ssd_scan(xk, dtk, A, B, C, chunk=chunk, head_block=hb,
                            interpret=True)
    assert _rel(y, jy) <= CHUNK_REL
    assert _rel(state, jstate) <= CHUNK_REL
    oy, ostate = JR.ref_ssd_scan(x, dt, A, B, C)
    assert _rel(y.transpose(1, 2), oy) <= CHUNK_REL
    assert _rel(state, ostate) <= CHUNK_REL
    ry, rstate = ref.ref_ssd_scan(_t(x), _t(dt), _t(A), _t(B), _t(C))
    assert _rel(y.transpose(1, 2), ry.numpy()) <= CHUNK_REL
    assert _rel(state, rstate.numpy()) <= CHUNK_REL


@pytest.mark.parametrize("b,s,n,tile", [(2, 64, 16, 16), (1, 128, 32, 32),
                                        (2, 100, 128, 32),   # partial tile
                                        (1, 256, 128, 128)])
def test_ssd_scan_prep_matches_jax(b, s, n, tile):
    """The plain version of the scan's prep (``ref_ssd_scan_prep``): C·Bᵀ
    of each tile as the JAX kernel forms it (``CB = C @ B.T``,
    ``repro/kernels/ssd_scan.py:51``) on its causal triangle, transposed
    and zero elsewhere, at ``GEMM_REL``; C transposed and B exactly, zero
    padded to 128."""
    B, C = _draw((b, s, n), 1), _draw((b, s, n), 2)
    got = ref.ref_ssd_scan_prep(_t(B), _t(C), tile).numpy()
    nt = -(-s // tile)
    assert got.shape == (b, nt, 3, 128, 128)
    lower = np.tril(np.ones((tile, tile), bool))
    for k in range(nt):
        t0, t1 = k * tile, min(s, (k + 1) * tile)
        q = t1 - t0
        for bi in range(b):
            cb = np.asarray(jnp.asarray(C[bi, t0:t1])
                            @ jnp.asarray(B[bi, t0:t1]).T)
            want = np.zeros((128, 128), np.float32)
            want[:q, :q] = np.where(lower[:q, :q], cb, 0.0).T
            assert _rel(got[bi, k, 0], want) <= GEMM_REL
            ct = np.zeros((128, 128), np.float32)
            ct[:n, :q] = C[bi, t0:t1].T
            bf = np.zeros((128, 128), np.float32)
            bf[:q, :n] = B[bi, t0:t1]
            np.testing.assert_array_equal(got[bi, k, 1], ct)
            np.testing.assert_array_equal(got[bi, k, 2], bf)


def test_ssd_scan_chunk_contract():
    """``S`` must be a multiple of ``min(chunk, S)``; ``S < chunk`` scans
    one chunk."""
    x, dt, A, B, C = _ssd_inputs(1, 2, 24, 4, 8)
    xk, dtk = _t(np.swapaxes(x, 1, 2)), _t(np.swapaxes(dt, 1, 2))
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd_scan(xk, dtk, _t(A), _t(B), _t(C), chunk=16)
    y, _ = ops.ssd_scan(xk, dtk, _t(A), _t(B), _t(C), chunk=128)
    jy, _ = JM.ssd_chunked(x, dt, A, B, C, chunk=128)
    assert _rel(y.transpose(1, 2), jy) <= CHUNK_REL


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_ssd_chunked_matches_jax(with_state):
    b, h, s, p, n = 2, 4, 64, 16, 8
    x, dt, A, B, C = _ssd_inputs(b, h, s, p, n, seed=10)
    init = _draw((b, h, p, n), 15) if with_state else None
    jy, js = JM.ssd_chunked(x, dt, A, B, C, chunk=16, init_state=init)
    y, st = M.ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk=16,
                          init_state=None if init is None else _t(init))
    assert _rel(y, jy) <= CHUNK_REL
    assert _rel(st, js) <= CHUNK_REL
    # and the port's own chunked and sequential forms agree
    sy, ss = M.ssd_sequential(_t(x), _t(dt), _t(A), _t(B), _t(C),
                              None if init is None else _t(init))
    assert _rel(y, sy.numpy()) <= CHUNK_REL
    assert _rel(st, ss.numpy()) <= CHUNK_REL


def test_ssd_decode_step_matches_jax():
    b, h, p, n = 3, 4, 8, 16
    state = _draw((b, h, p, n), 20)
    x = _draw((b, h, p), 21)
    dt = np.asarray(jax.nn.softplus(_draw((b, h), 22)))
    A = -np.exp(_draw((h,), 23))
    B, C = _draw((b, n), 24), _draw((b, n), 25)
    jy, js = JM.ssd_decode_step(state, x, dt, A, B, C)
    y, st = M.ssd_decode_step(_t(state), _t(x), _t(dt), _t(A), _t(B), _t(C))
    assert _rel(y, jy) <= SEQ_REL
    assert _rel(st, js) <= SEQ_REL


@pytest.mark.parametrize("with_tail", [False, True], ids=["zeros", "tail"])
def test_causal_conv_matches_jax(with_tail):
    x = _draw((2, 9, 6), 30)
    w = _draw((4, 6), 31)
    bias = _draw((6,), 32)
    init = _draw((2, 3, 6), 33) if with_tail else None
    jy, jtail = JM._causal_conv(x, w, bias, init)
    y, tail = M._causal_conv(_t(x), _t(w), _t(bias),
                             None if init is None else _t(init))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


def _reduced(dtype="f32"):
    """The reduced mamba2-2.7b config of both packages (2 layers, d 256,
    16 heads of 32, state 16, chunk 16, vocab 512)."""
    if dtype == "bf16":
        return (j_get_config("mamba2-2.7b").reduced(
                    param_dtype=jnp.bfloat16, activation_dtype=jnp.bfloat16),
                get_config("mamba2-2.7b").reduced(
                    param_dtype=torch.bfloat16,
                    activation_dtype=torch.bfloat16))
    return (j_get_config("mamba2-2.7b").reduced(),
            get_config("mamba2-2.7b").reduced())


def _params(jcfg, seed=0):
    """JAX init, carried to the port leaf by leaf through numpy."""
    jp = jzoo.init(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_mixer_apply_matches_jax(mode):
    jcfg, cfg = _reduced()
    jp, tp = _params(jcfg, seed=3)
    jmix = jax.tree.map(lambda a: a[0], jp["blocks"]["mixer"])
    mix = tree_map(lambda a: a[0], tp["blocks"]["mixer"])
    if mode == "train":
        hid = _draw((2, 32, cfg.d_model), 40)
        kw, tkw = {}, {}
        rel = MODEL_REL
    else:
        hid = _draw((2, 1, cfg.d_model), 41)
        conv = _draw((2, cfg.ssm_conv_width - 1,
                      cfg.ssm_d_inner + 2 * cfg.ssm_state), 42)
        ssm = _draw((2, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state), 43)
        kw = dict(conv_state=conv, ssm_state=ssm, mode="decode")
        tkw = dict(conv_state=_t(conv), ssm_state=_t(ssm), mode="decode")
        rel = MODEL_REL
    jout, (jconv, jssm) = JM.mixer_apply(jcfg, jmix, hid, **kw)
    out, (conv_t, ssm_t) = M.mixer_apply(cfg, mix, _t(hid), **tkw)
    assert _rel(out, jout) <= rel
    assert _rel(conv_t, jconv) <= GEMM_REL
    assert _rel(ssm_t, jssm) <= rel


def test_mixer_with_a_state_goes_through_ssd_chunked():
    """``mode="train"`` given a state takes the plain chunked algorithm
    (no kernel), as the reference's mixer does."""
    jcfg, cfg = _reduced()
    jp, tp = _params(jcfg, seed=4)
    jmix = jax.tree.map(lambda a: a[1], jp["blocks"]["mixer"])
    mix = tree_map(lambda a: a[1], tp["blocks"]["mixer"])
    hid = _draw((2, 32, cfg.d_model), 44)
    ssm = _draw((2, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state), 45)
    jout, (_, jssm) = JM.mixer_apply(jcfg, jmix, hid, ssm_state=ssm)
    out, (_, ssm_t) = M.mixer_apply(cfg, mix, _t(hid), ssm_state=_t(ssm))
    assert _rel(out, jout) <= MODEL_REL
    assert _rel(ssm_t, jssm) <= MODEL_REL


def test_forward_prefill_decode_match_jax():
    """The reduced float32 backbone on parameters carried across:
    ``forward_train`` logits, ``prefill`` logits and cache, then one
    ``decode_step`` from that cache; and the reference's invariant that
    decode from a prefill continues ``forward_train``."""
    jcfg, cfg = _reduced()
    jp, tp = _params(jcfg, seed=1)
    toks = _tokens(cfg.vocab_size, (2, 32), 50)
    jlog, _ = jzoo.forward_train(jcfg, jp, {"tokens": toks})
    log, aux = zoo.forward_train(cfg, tp, {"tokens": _t(toks)})
    assert log.shape == (2, 32, cfg.vocab_size) and float(aux) == 0.0
    assert _rel(log, jlog) <= MODEL_REL

    head = toks[:, :16]
    jl, jc = jzoo.prefill(jcfg, jp, {"tokens": head})
    pl, pc = zoo.prefill(cfg, tp, {"tokens": _t(head)})
    assert _rel(pl, jl) <= MODEL_REL
    assert _rel(pc["conv"], jc["conv"]) <= MODEL_REL
    assert _rel(pc["ssm"], jc["ssm"]) <= MODEL_REL

    pos = np.full((2,), 16, np.int32)
    jd, jc2 = jzoo.decode_step(jcfg, jp, jc, toks[:, 16:17], pos)
    dl, dc = zoo.decode_step(cfg, tp, pc, _t(toks[:, 16:17]), _t(pos))
    assert _rel(dl, jd) <= MODEL_REL
    assert _rel(dc["ssm"], jc2["ssm"]) <= MODEL_REL
    assert _rel(dl, log[:, 16].numpy()) <= MODEL_REL


def test_make_cache_matches_jax():
    jcfg, cfg = _reduced()
    jc = jzoo.make_cache(jcfg, 3, 64)
    c = zoo.make_cache(cfg, 3, 64, "cpu")
    for k in ("conv", "ssm"):
        assert tuple(c[k].shape) == jc[k].shape
        assert not c[k].any()


def test_bf16_forward_matches_unjitted_jax():
    """Reduced bf16 config against the JAX model run op by op without jit
    (under jit XLA keeps bf16 intermediates in float32)."""
    jcfg, cfg = _reduced("bf16")
    jp, tp = _params(jcfg, seed=2)
    assert tp["embed"]["emb"].dtype == torch.bfloat16
    toks = _tokens(cfg.vocab_size, (2, 32), 51)
    with jax.disable_jit():
        jlog, _ = jzoo.forward_train(jcfg, jp, {"tokens": toks})
    log, _ = zoo.forward_train(cfg, tp, {"tokens": _t(toks)})
    assert log.dtype == torch.bfloat16
    rel = _rel(log, np.asarray(jlog, np.float32))
    print(f"bf16 logits max|Δ|/max|want| = {rel:.3g}")
    assert rel <= BF16_MODEL_REL


def test_mamba2_checkpoint_from_jax_loads(tmp_path):
    """A tree written by the JAX package's ``save_checkpoint`` loads
    through the port's ``load_checkpoint`` (stacked ``blocks`` and all)
    and gives the same forward as the tree carried in memory."""
    jcfg, cfg = _reduced()
    jp, tp = _params(jcfg, seed=5)
    path = str(tmp_path / "mamba2.npz")
    jckpt.save_checkpoint(path, jp, metadata={"arch": cfg.name})
    loaded, meta = ckpt.load_checkpoint(path, device="cpu")
    assert meta == {"arch": cfg.name}
    assert loaded["blocks"]["mixer"]["in_proj"]["w"].shape == \
        (cfg.num_layers, cfg.d_model,
         2 * cfg.ssm_d_inner + 2 * cfg.ssm_state + cfg.ssm_nheads)
    toks = _t(_tokens(cfg.vocab_size, (2, 16), 52))
    got, _ = zoo.forward_train(cfg, loaded, {"tokens": toks})
    want, _ = zoo.forward_train(cfg, tp, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_only_the_ssm_family_is_served():
    """Every id of the reference is served now, the VLM paligemma-3b the
    last (``tests/test_torch_vlm.py``; the hybrid, dense, MoE and audio
    families in their own files): ``zoo.init`` of its reduced config
    draws the ``vlm`` family's tree; an unknown id or family raises.
    The mamba2 config, full and reduced, field for field."""
    vlm = get_config("paligemma-3b")
    assert (vlm.arch_type, vlm.num_layers, vlm.head_dim,
            vlm.vision_prefix_len) == ("vlm", 18, 256, 256)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-9")
    cfg = get_config("mamba2-2.7b")
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.ssm_state,
            cfg.ssm_nheads, cfg.ssm_d_inner) == (64, 2560, 50280, 128, 80,
                                                 5120)
    # every field the port keeps agrees with the reference, full and reduced
    jcfg = j_get_config("mamba2-2.7b")
    for c, jc in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        for f in dataclasses.fields(c):
            got, want = getattr(c, f.name), getattr(jc, f.name)
            if isinstance(got, torch.dtype):
                got, want = str(got).split(".")[-1], jnp.dtype(want).name
            assert got == want, f.name
        assert (c.ssm_d_inner, c.ssm_nheads) == (jc.ssm_d_inner,
                                                 jc.ssm_nheads)
    params = zoo.init(vlm.reduced(), torch.Generator().manual_seed(0), "cpu")
    assert sorted(params) == ["blocks", "embed", "ln_final", "unembed",
                              "vision_proj"]
    assert tuple(params["vision_proj"]["w"].shape) == (256, 256)
    with pytest.raises(ValueError, match="unknown arch_type"):
        zoo.init(dataclasses.replace(cfg, arch_type="vision"),
                 torch.Generator(), "cpu")
