"""Neural-net primitives of the DiT and the LM backbones, as plain
functions on tensors.

Parameters are dicts of tensors in the reference layout: a dense weight is
``(in, out)`` (not ``nn.Linear``'s ``(out, in)``), so checkpoints of the
JAX package load without transposes.  ``attention`` is non-causal and
unmasked, with the semantics of the reference's ``chunked_attention`` on
the DiT path: a float32 ``QKᵀ`` scaled by ``1/sqrt(head_dim)``, softmax
over keys, then ``PV``.  The DiT's LayerNorms and self-attention go
through the kernel wrappers (``kernels.ops.layernorm``,
``adaln_modulate``, ``flash_attention``); ``attention`` serves its
cross-attention, whose query and text lengths differ.  The LMs' causal
attention over a sequence goes through ``flash_attention_gqa``
(``models.transformer``); ``decode_attention``, one token against a KV
cache, is plain torch, as the reference computes it in jnp.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def embed(params: dict, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Rows ``ids`` of the table ``params["emb"]``, cast to ``dtype``
    (the reference casts the table, then takes rows: the same values)."""
    rows = params["emb"][ids]
    return rows if dtype is None else rows.to(dtype)


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis in float32, scaled, cast back to ``x``'s
    dtype (``repro.models.layers.rmsnorm``)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: ``x·(1/(1 + e^−x))``,
    each op rounded in ``x``'s dtype (bf16 paths round where the reference
    does)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)`` op by op:
    ``max(x, 0) + log1p(exp(−|x|))``, NaN where ``x`` is NaN (not
    ``F.softplus``'s thresholded form)."""
    out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    return dense(params["w2"], gelu(dense(params["w1"], x)))


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate the interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` by
    float32 angles ``pos · θ^(−2i/D)`` (the reference's convention, not the
    half-split one).  ``x``: (B, S, H, D); ``positions``: (B, S) or (S,).
    The rotation runs in float32 (a bf16 ``x`` promotes) and the result is
    cast to ``x``'s dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (D/2,)
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos[..., None] * freqs                               # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


#: the masked logit of ``decode_attention`` (the reference's ``NEG_INF``)
NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, q_position: torch.Tensor,
                     kv_positions: torch.Tensor, window: int = 0,
                     softmax_scale: float | None = None) -> torch.Tensor:
    """One token against a (possibly ring-buffer) KV cache, in float32.

    ``q``: (B, 1, Hq, D); ``k_cache``/``v_cache``: (B, Skv, Hkv, D) with
    query head ``h`` reading kv head ``h // (Hq/Hkv)``; ``q_position``:
    (B,) the token's absolute position; ``kv_positions``: (B, Skv) the
    position each slot holds.  Slots with a position < 0, past
    ``q_position`` or outside ``window`` are masked.  Returns (B, 1, Hq, D)
    in ``q``'s dtype.
    """
    b, _, hkv, d = k_cache.shape
    hq = q.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, hq // hkv, d).to(torch.float32)
    logits = torch.einsum("bhgd,bshd->bhgs", qg,
                          k_cache.to(torch.float32)) * scale
    qpos = q_position[:, None]
    valid = (kv_positions >= 0) & (kv_positions <= qpos)
    if window:
        valid = valid & (qpos - kv_positions < window)
    logits = torch.where(valid[:, None, None, :], logits,
                         logits.new_tensor(NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, hq, d).to(q.dtype)


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``w_down(silu(w_gate x) · w_up x)``, every op in ``x``'s dtype."""
    return dense(params["w_down"],
                 silu(dense(params["w_gate"], x)) * dense(params["w_up"], x))


def gqa_project(params: dict, x: torch.Tensor, num_heads: int,
                num_kv_heads: int, head_dim: int):
    b, s, _ = x.shape
    q = dense(params["wq"], x).reshape(b, s, num_heads, head_dim)
    k = dense(params["wk"], x).reshape(b, s, num_kv_heads, head_dim)
    v = dense(params["wv"], x).reshape(b, s, num_kv_heads, head_dim)
    return q, k, v


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              softmax_scale: float | None = None) -> torch.Tensor:
    """Non-causal, unmasked attention.

    ``q``: ``(B, Sq, H, D)``; ``k``/``v``: ``(B, Skv, H, D)`` (equal head
    counts — the DiT has no GQA).  Returns ``(B, Sq, H, D)`` in ``q``'s
    dtype.
    """
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qh = q.to(torch.float32).transpose(1, 2)               # (B, H, Sq, D)
    kh = k.to(torch.float32).transpose(1, 2)
    vh = v.to(torch.float32).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) * scale           # (B, H, Sq, Skv)
    p = torch.softmax(logits, dim=-1)
    out = p @ vh                                           # (B, H, Sq, D)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# Initializers (``torch.Generator``-seeded; the port's own random init)
# ---------------------------------------------------------------------------


def _normal(shape, gen: torch.Generator, device, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, *, device, dtype,
               scale: float | None = None) -> dict:
    scale = (1.0 / math.sqrt(in_dim)) if scale is None else scale
    return {"w": _normal((in_dim, out_dim), gen, device, dtype) * scale}


def dense_init_b(gen, in_dim: int, out_dim: int, *, device, dtype) -> dict:
    p = dense_init(gen, in_dim, out_dim, device=device, dtype=dtype)
    p["b"] = torch.zeros((out_dim,), device=device, dtype=dtype)
    return p


def embed_init(gen, vocab: int, dim: int, *, device, dtype) -> dict:
    return {"emb": _normal((vocab, dim), gen, device, torch.float32)
            .mul_(0.02).to(dtype)}


def rmsnorm_init(dim: int, *, device, dtype) -> dict:
    return {"scale": torch.ones((dim,), device=device, dtype=dtype)}


def gqa_init(gen, d_model: int, num_heads: int, num_kv_heads: int,
             head_dim: int, *, device, dtype) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {"wq": dense_init(gen, d_model, num_heads * head_dim, **kw),
            "wk": dense_init(gen, d_model, num_kv_heads * head_dim, **kw),
            "wv": dense_init(gen, d_model, num_kv_heads * head_dim, **kw),
            "wo": dense_init(gen, num_heads * head_dim, d_model, **kw)}


def swiglu_init(gen, d_model: int, d_ff: int, *, device, dtype) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {"w_gate": dense_init(gen, d_model, d_ff, **kw),
            "w_up": dense_init(gen, d_model, d_ff, **kw),
            "w_down": dense_init(gen, d_ff, d_model, **kw)}
