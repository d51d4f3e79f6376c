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

* attention: ``repro.kernels.ref.ref_flash_attention`` (non-causal, with
  and without ``softmax_scale``) in the kernel's ``(B, H, S, D)`` layout,
  and ``repro.models.layers.chunked_attention`` (``causal=False``) in the
  model's ``(B, S, H, D)`` layout;
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

ATTN_CASES = [
    (2, 3, 100, 64, 0.3),         # partial tiles, a softmax scale
    (1, 2, 70, 32, None),         # narrower head
    (1, 2, 40, 128, 0.1),         # widest head the backward takes
    (3, 1, 1, 16, None),          # one position: dq = dk = 0
]


def _attn_inputs(b, h, s, d):
    seed = b * h + s + d
    return [_draw((b, h, s, d), seed + i) for i in range(4)]   # q k v dO


@pytest.mark.parametrize("b,h,s,d,scale", ATTN_CASES)
def test_flash_attention_bwd_formula_matches_jax_vjp(b, h, s, d, scale):
    """``ref_flash_attention_bwd`` against ``jax.vjp`` of the reference's
    kernel oracle, non-causal, in the ``(B, H, S, D)`` layout."""
    q, k, v, do = _attn_inputs(b, h, s, d)

    def f(q, k, v):
        return jref.ref_flash_attention(q, k, v, causal=False,
                                        softmax_scale=scale)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = ref.ref_flash_attention_bwd(_t(q), _t(k), _t(v), _t(do),
                                      softmax_scale=scale)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        _assert_close(g, w, top)


@pytest.mark.parametrize("b,h,s,d,scale", ATTN_CASES)
def test_flash_attention_bwd_formula_matches_chunked_attention(b, h, s, d,
                                                               scale):
    """The same formula against ``jax.vjp`` of the model's training
    attention, ``layers.chunked_attention(causal=False)``, which takes
    ``(B, S, H, D)`` projections (chunked over queries: 2 chunks at S 100
    and 70)."""
    q, k, v, do = _attn_inputs(b, h, s, d)
    pos = jnp.arange(s)

    def f(q, k, v):
        return JL.chunked_attention(q, k, v, q_positions=pos,
                                    kv_positions=pos, causal=False,
                                    chunk_size=64, softmax_scale=scale)

    def bshd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3))

    _, vjp = jax.vjp(f, bshd(q), bshd(k), bshd(v))
    want = [np.asarray(w).transpose(0, 2, 1, 3) for w in vjp(bshd(do))]
    got = ref.ref_flash_attention_bwd(_t(q), _t(k), _t(v), _t(do),
                                      softmax_scale=scale)
    top = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        _assert_close(g, w, top)


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
