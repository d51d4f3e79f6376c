"""The port's written-out backward formulas against JAX's autodiff of the
reference, on the CPU.

On the card the backward kernels (``adaln_fuse_bwd``,
``flash_attention_bwd``) are held against their plain versions,
``repro_torch/kernels/ref.py`` ``ref_adaln_fuse_bwd`` and
``ref_flash_attention_bwd`` (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  The port's CPU training path differentiates the
*forward* plain versions through autograd, so these tests close the chain:
the same seeded numpy inputs and output gradient go through ``jax.vjp`` of
the reference's functions and through the port's written-out formulas.

* attention: ``repro.kernels.ref.ref_flash_attention`` (with and without
  ``softmax_scale``, causal and sliding-window masks, grouped kv heads
  repeated by the reference's front end) in the kernel's ``(B, H, S, D)``
  layout, ``repro.models.layers.chunked_attention`` (the same masks,
  grouped kv heads natively) in the model's ``(B, S, H, D)`` layout, and
  autograd of the port's own CPU ``ops.flash_attention``;
* AdaLN: ``repro.models.layers.layernorm({}, x)`` then
  ``repro.models.dit._modulate`` (the block's modulate sites), the final
  layer's ``layernorm·(1 + scale) + shift``, the plain LayerNorm (the one
  before cross-attention), and a broadcast ``x`` (the ragged forward's
  replica view: the rows' gradients summed over the broadcast axis, as
  autograd sums an ``expand``).

The shapes are the GPU tests' at CPU sizes.  Tolerance: float32 on both
sides, summed in another order (XLA's dots and reductions against
ATen's): each gradient within ``1e-5`` of the largest |gradient| of its
call (attention: of the three; AdaLN: of that gradient).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import dit as JD
from repro.models import layers as JL
from repro_torch.kernels import ref
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

GRAD_REL = 1e-5


def _draw(shape, seed, scale=1.0, shift=0.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close(got, want, top):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * top, (err, top)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

#: (B, H, S, D, scale, Hkv, causal, window); the non-causal MHA cases keep
#: their ids
ATTN_CASES = [
    (2, 3, 100, 64, 0.3, 3, False, 0),    # partial tiles, a softmax scale
    (1, 2, 70, 32, None, 2, False, 0),    # narrower head
    (1, 2, 40, 128, 0.1, 2, False, 0),    # widest head the backward takes
    (3, 1, 1, 16, None, 1, False, 0),     # one position: dq = dk = 0
    (2, 4, 100, 64, None, 2, True, 0),    # causal, GQA 4/2, partial tile
    (1, 2, 70, 32, 0.3, 1, True, 0),      # causal, GQA 2/1
    (2, 4, 90, 16, None, 2, True, 20),    # causal sliding window, GQA 4/2
    (1, 2, 50, 32, None, 2, False, 12),   # a window without the causal mask
]
ATTN_IDS = ["-".join(map(str, c[:5])) for c in ATTN_CASES[:4]] + [
    "causal-gqa4_2", "causal-gqa2_1", "causal-window-gqa4_2", "window"]


def _attn_inputs(b, h, s, d, hkv):
    seed = b * h + s + d
    return [_draw((b, n, s, d), seed + i)                 # q k v dO
            for i, n in enumerate((h, hkv, hkv, h))]


def _check_grads(got, want):
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        _assert_close(g, w, top)


@pytest.mark.parametrize("b,h,s,d,scale,hkv,causal,window", ATTN_CASES,
                         ids=ATTN_IDS)
def test_flash_attention_bwd_formula_matches_jax_vjp(b, h, s, d, scale, hkv,
                                                     causal, window):
    """``ref_flash_attention_bwd`` against ``jax.vjp`` of the reference's
    kernel oracle in the ``(B, H, S, D)`` layout, with its masks; grouped
    kv heads through the reference's front end (kv heads repeated before
    the MHA oracle, so the vjp sums each group)."""
    q, k, v, do = _attn_inputs(b, h, s, d, hkv)

    def f(q, k, v):
        k, v = (jnp.repeat(a, h // hkv, axis=1) for a in (k, v))
        return jref.ref_flash_attention(q, k, v, causal=causal,
                                        window=window, softmax_scale=scale)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = ref.ref_flash_attention_bwd(_t(q), _t(k), _t(v), _t(do),
                                      causal=causal, window=window,
                                      softmax_scale=scale)
    _check_grads(got, want)


@pytest.mark.parametrize("b,h,s,d,scale,hkv,causal,window", ATTN_CASES,
                         ids=ATTN_IDS)
def test_flash_attention_bwd_formula_matches_chunked_attention(
        b, h, s, d, scale, hkv, causal, window):
    """The same formula against ``jax.vjp`` of the model's training
    attention, ``layers.chunked_attention`` (float32 softmax), which takes
    ``(B, S, H, D)`` projections with ``Hkv`` kv heads and the causal and
    window masks (chunked over queries: 2 chunks at S 100, 90 and 70)."""
    q, k, v, do = _attn_inputs(b, h, s, d, hkv)
    pos = jnp.arange(s)

    def f(q, k, v):
        return JL.chunked_attention(q, k, v, q_positions=pos,
                                    kv_positions=pos, causal=causal,
                                    window=window, chunk_size=64,
                                    softmax_scale=scale)

    def bshd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3))

    _, vjp = jax.vjp(f, bshd(q), bshd(k), bshd(v))
    want = [np.asarray(w).transpose(0, 2, 1, 3) for w in vjp(bshd(do))]
    got = ref.ref_flash_attention_bwd(_t(q), _t(k), _t(v), _t(do),
                                      causal=causal, window=window,
                                      softmax_scale=scale)
    _check_grads(got, want)


@pytest.mark.parametrize("b,h,s,d,scale,hkv,causal,window", ATTN_CASES,
                         ids=ATTN_IDS)
def test_flash_attention_bwd_formula_matches_cpu_autograd(
        b, h, s, d, scale, hkv, causal, window):
    """The same formula against autograd of the port's own
    ``ops.flash_attention`` on the CPU (the plain forward, kv heads
    repeated), which is what CPU training differentiates."""
    from repro_torch.kernels import ops

    q, k, v, do = _attn_inputs(b, h, s, d, hkv)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window,
                              softmax_scale=scale)
    want = torch.autograd.grad(out, leaves, _t(do))
    got = ref.ref_flash_attention_bwd(_t(q), _t(k), _t(v), _t(do),
                                      causal=causal, window=window,
                                      softmax_scale=scale)
    _check_grads(got, [w.numpy() for w in want])


# ---------------------------------------------------------------------------
# AdaLN
# ---------------------------------------------------------------------------

def _modulate_site(x, gamma, beta):
    """A block's modulate site: ``_modulate(layernorm(x))`` over rows
    ``(B, N, D)``."""
    return JD._modulate(JL.layernorm({}, x), gamma, beta)


def _final_layer(x, scale, shift):
    """The final layer's inline modulation (``dit.py``'s last LayerNorm)."""
    return JL.layernorm({}, x) * (1.0 + scale[:, None]) + shift[:, None]


ADALN_CASES = [
    ((3, 2, 33, 100), "modulate"),      # G 2, D off the 32-lane stride
    ((3, 2, 33, 100), "layernorm"),
    ((2, 64, 768), "modulate"),         # the DiT's width
    ((2, 64, 768), "final"),
    ((2, 64, 768), "layernorm"),        # before cross-attention
    ((3, 70, 64), "final"),
]


@pytest.mark.parametrize("shape,site", ADALN_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{k}"
                              for s, k in ADALN_CASES])
def test_adaln_fuse_bwd_formula_matches_jax_vjp(shape, site):
    """``ref_adaln_fuse_bwd``'s dx, dγ and dβ against ``jax.vjp`` of the
    reference's LayerNorm and modulation (rows of a ``(B, G, S, D)`` x
    merged to ``(B, G·S, D)`` for the reference, whose ``gamma[:, None]``
    broadcasts over one middle axis)."""
    b, d = shape[0], shape[-1]
    x = _draw(shape, sum(shape), scale=3.0, shift=1.0)
    dy = _draw(shape, sum(shape) + 1)
    mods = _draw((b, 2, d), sum(shape) + 2, scale=0.3)
    rows = jnp.asarray(x.reshape(b, -1, d))
    drows = jnp.asarray(dy.reshape(b, -1, d))
    if site == "layernorm":
        _, vjp = jax.vjp(lambda x: JL.layernorm({}, x), rows)
        want = [np.asarray(vjp(drows)[0]).reshape(shape)]
        got = ref.ref_adaln_fuse_bwd(_t(x), None, _t(dy))
        assert got[1] is None and got[2] is None
        got = got[:1]
    else:
        fn = _modulate_site if site == "modulate" else _final_layer
        _, vjp = jax.vjp(fn, rows, jnp.asarray(mods[:, 0]),
                         jnp.asarray(mods[:, 1]))
        dx, dg, db = vjp(drows)
        want = [np.asarray(dx).reshape(shape), dg, db]
        got = ref.ref_adaln_fuse_bwd(_t(x), _t(mods[:, 0]), _t(dy))
    for g, w in zip(got, want):
        _assert_close(g, w, float(np.abs(np.asarray(w)).max()))


@pytest.mark.parametrize("affine", [True, False], ids=["mod", "ln"])
def test_adaln_fuse_bwd_formula_on_a_broadcast_x(affine):
    """A broadcast ``(P, g, T, d)`` view of ``(P, T, d)`` (the ragged
    forward's replicas): the formula's per-row dx, summed over ``g`` as
    autograd sums an ``expand``, against ``jax.vjp`` with respect to the
    un-broadcast rows; dγ and dβ over every row read."""
    b, g, t, d = 3, 2, 40, 96
    base = _draw((b, t, d), 7, scale=3.0, shift=1.0)
    dy = _draw((b, g, t, d), 8)
    mods = _draw((b, 2, d), 9, scale=0.3)

    def rows(base):
        return jnp.broadcast_to(base[:, None], (b, g, t, d)).reshape(
            b, g * t, d)

    x = _t(base)[:, None].expand(b, g, t, d)
    drows = jnp.asarray(dy.reshape(b, g * t, d))
    if affine:
        _, vjp = jax.vjp(lambda x, gm, bt: _modulate_site(rows(x), gm, bt),
                         jnp.asarray(base), jnp.asarray(mods[:, 0]),
                         jnp.asarray(mods[:, 1]))
        want = vjp(drows)
        dx, dgamma, dbeta = ref.ref_adaln_fuse_bwd(x, _t(mods[:, 0]),
                                                   _t(dy))
        got = [dx.sum(dim=1), dgamma, dbeta]
    else:
        _, vjp = jax.vjp(lambda x: JL.layernorm({}, rows(x)),
                         jnp.asarray(base))
        want = vjp(drows)
        got = [ref.ref_adaln_fuse_bwd(x, None, _t(dy))[0].sum(dim=1)]
    assert len(got) == len(want)
    for gr, w in zip(got, want):
        _assert_close(gr, w, float(np.abs(np.asarray(w)).max()))
