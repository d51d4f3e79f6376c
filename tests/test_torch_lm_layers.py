"""The port's LM layers of the dense and hybrid backbones against the JAX
package's ``repro.models.layers``, on the CPU: RoPE, SwiGLU, single-token
``decode_attention`` over a KV cache, and causal attention over a
sequence — the port's ``ops.flash_attention_gqa`` (on CPU tensors its
plain version; the CUDA kernel is held to that plain version on the card,
``tests/test_torch_cuda.py``) against the reference's
``chunked_attention``, which the dense and hybrid backbones call.

The same numpy inputs, drawn from a seed, go through both packages.
Tolerances, relative to ``max|want|``:

* ``LAYER_REL = 1e-6``: RoPE, SwiGLU and ``decode_attention`` in
  float32 — the same ops in the same order; ``cos``/``sin``/``pow`` and
  the exponentials of XLA and ATen may differ by an ulp, and the
  einsums' and GEMMs' sums of ≤ 128 terms by a few;
* ``ATTN_REL = 1e-5``: attention over a sequence, float32 sums of up to
  96 × 80 terms in another order (the reference's chunked einsums against
  one ATen matmul), as ``tests/test_torch_attention.py``;
* ``BF16_REL = 2⁻⁷``: bf16 outputs rounded once from float32 on both
  sides (one bf16 ulp).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.models import layers as L

LAYER_REL = 1e-6
ATTN_REL = 1e-5
BF16_REL = 2.0 ** -7


def _draw(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("d,theta", [(64, 10000.0), (80, 10000.0),
                                     (32, 1e6)])
@pytest.mark.parametrize("batched", [False, True], ids=["pos_S", "pos_BS"])
def test_apply_rope_matches_jax(d, theta, batched):
    """Interleaved pairs, float32 angles, positions ``(S,)`` or ``(B, S)``
    (decode's ``pos[:, None]``: distinct positions per row)."""
    b, s, h = 2, 96, 3
    x = _draw((b, s, h, d), d)
    pos = (np.random.default_rng(1).integers(0, 4096, (b, s), dtype=np.int32)
           if batched else np.arange(s, dtype=np.int32))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(_t(x), _t(pos), theta)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= LAYER_REL
    np.testing.assert_array_equal(
        L.rope_frequencies(d, theta).numpy(),
        np.asarray(JL.rope_frequencies(d, theta)))


def test_apply_rope_bf16_promotes_and_casts_back():
    """A bf16 ``x`` is rotated in float32 (bf16 · float32 promotes on both
    sides) and cast back to bf16 once."""
    x = _draw((2, 40, 4, 80), 3)
    pos = np.arange(40, dtype=np.int32)
    want = JL.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    got = L.apply_rope(_t(x).to(torch.bfloat16), _t(pos))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got, np.asarray(want, np.float32)) <= BF16_REL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swiglu_matches_jax(dtype):
    d, f = 48, 96
    x = _draw((2, 7, d), 4)
    w = {k: {"w": _draw(shape, 5 + i, 1.0 / np.sqrt(shape[0]))}
         for i, (k, shape) in enumerate((("w_gate", (d, f)),
                                         ("w_up", (d, f)),
                                         ("w_down", (f, d))))}
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jw = {k: {"w": jnp.asarray(v["w"], jdt)} for k, v in w.items()}
    tw = {k: {"w": _t(v["w"]).to(tdt)} for k, v in w.items()}
    want = JL.swiglu(jw, jnp.asarray(x, jdt))
    got = L.swiglu(tw, _t(x).to(tdt))
    assert got.dtype == tdt
    rel = LAYER_REL if dtype == "f32" else BF16_REL
    assert _rel(got, np.asarray(want, np.float32)) <= rel


@pytest.mark.parametrize("case", ["prefix", "ring", "window", "gqa"])
def test_decode_attention_matches_jax(case):
    """One token against a cache: ``prefix`` — slots past the token empty
    (``pos = −1``); ``ring`` — a ring buffer whose slots hold positions out
    of order, one of them past the token; ``window`` — the ring under a
    window of 5; ``gqa`` — 4 query heads over 2 kv heads with distinct
    positions per row."""
    b, w, d = 2, 12, 16
    hq, hkv = (4, 2) if case == "gqa" else (3, 3)
    q = _draw((b, 1, hq, d), 6)
    k, v = _draw((b, w, hkv, d), 7), _draw((b, w, hkv, d), 8)
    qpos = np.array([7, 7], np.int32)
    kvpos = np.tile(np.arange(w, dtype=np.int32), (b, 1))
    if case == "prefix":
        kvpos[:, 8:] = -1
    else:                                  # ring: slot = pos % 12
        kvpos = np.stack([(np.arange(w) + 12 * (np.arange(w) <= 3)) % 24,
                          np.arange(w)]).astype(np.int32)
        qpos = np.array([15, 9], np.int32)
    window = 5 if case == "window" else 0
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_position=jnp.asarray(qpos),
                               kv_positions=jnp.asarray(kvpos), window=window)
    got = L.decode_attention(_t(q), _t(k), _t(v), q_position=_t(qpos),
                             kv_positions=_t(kvpos), window=window)
    assert _rel(got, want) <= LAYER_REL


#: (S, Hq, Hkv, D, window) of the sequence attention: S 96 and 80 are not
#: multiples of the reduced ``attn_chunk`` 64 (the reference pads)
ATTN_CASES = [
    (96, 4, 4, 64, 0),         # causal MHA
    (80, 4, 4, 80, 0),         # zamba2's head dim
    (96, 4, 4, 64, 24),        # causal + window
    (80, 4, 2, 80, 0),         # GQA 4/2
    (96, 4, 2, 64, 24),        # GQA 4/2 under a window
]


@pytest.mark.parametrize("s,hq,hkv,d,window", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_gqa_matches_chunked_attention(s, hq, hkv, d, window,
                                                       dtype):
    """``ops.flash_attention_gqa`` on ``(B, H, S, D)`` views of
    ``(B, S, H, D)`` projections, causal, against the reference's
    ``chunked_attention`` at positions ``0 .. S−1`` with chunks of 64, as
    the dense and hybrid backbones call it."""
    b = 2
    q, k, v = (_draw((b, s, h, d), seed) for h, seed in ((hq, 9), (hkv, 10),
                                                          (hkv, 11)))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    pos = jnp.arange(s)
    want = JL.chunked_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        q_positions=pos, kv_positions=pos, causal=True, window=window,
        chunk_size=64)
    tq, tk, tv = (_t(a).to(tdt).transpose(1, 2) for a in (q, k, v))
    ops.reset_launches()
    got = ops.flash_attention_gqa(tq, tk, tv, causal=True, window=window)
    assert not any(ops.LAUNCHES.values())        # the plain version
    assert got.dtype == tdt
    rel = ATTN_REL if dtype == "f32" else BF16_REL
    assert _rel(got.transpose(1, 2), np.asarray(want, np.float32)) <= rel
