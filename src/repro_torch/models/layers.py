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
cache, is plain torch, as the reference computes it in jnp, and so is
``chunked_attention``, the reference's attention function with all its
masks (positions, window, prefix-LM, valid slots), which no model path of
the port calls.  So is the
routed expert layer ``moe_apply`` (the reference computes it in jnp:
einsums and a scatter/gather dispatch, outside any Pallas kernel); its
expert products are ATen GEMMs.  So are Whisper's affine ``layernorm``
and its GELU MLP (jnp in the reference, outside any Pallas kernel; the
AdaLN kernel computes ``LN(x)·(1 + γ) + β``, and ``1 + (scale − 1)`` is
not ``scale`` in float32, so the affine norm stays plain torch).
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


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    """LayerNorm over the last axis with float32 mean and population
    variance, ``(x − μ)·rsqrt(var + eps)``, then ``·scale + bias``
    (``layernorm_init``'s parameters) in float32, cast back to ``x``'s
    dtype (``repro.models.layers.layernorm``)."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = ((x32 - mu) * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
         + params["bias"].to(torch.float32))
    return y.to(x.dtype)


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


#: the masked logit of ``decode_attention`` and ``chunked_attention`` (the
#: reference's ``NEG_INF``)
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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      prefix_len: int = 0,
                      kv_valid: torch.Tensor | None = None,
                      chunk_size: int = 512, kv_chunk: int = 0,
                      f32_softmax: bool = True,
                      softmax_scale: float | None = None) -> torch.Tensor:
    """The reference's ``chunked_attention`` in plain torch, every argument
    with its meaning there: GQA, causality, sliding window, prefix-LM and
    a valid-slot mask over absolute positions.

    ``q``: (B, Sq, Hq, D); ``k``/``v``: (B, Skv, Hkv, D), ``Hq % Hkv ==
    0``.  ``q_positions``/``kv_positions``: (Sq,)/(Skv,) or (B, ·).
    ``causal``: ``kv_pos ≤ q_pos``; ``window`` > 0 also ``q_pos − kv_pos <
    window``; ``prefix_len``: positions below it also see each other both
    ways — under ``causal`` only, as in the reference; ``kv_valid``: an
    optional (B, Skv) bool mask of valid slots.  Queries run in chunks of
    ``chunk_size`` (the last one padded with position 0); ``kv_chunk`` >
    0 that divides ``Skv`` and is shorter than it blocks the keys too,
    with an online-softmax accumulator.  A masked logit is ``-1e30``: a row
    with every key masked averages the values uniformly, as the
    reference's does.  ``f32_softmax=False`` (the reference's bf16 chain,
    another function) raises.  Returns (B, Sq, Hq, D) in ``q``'s dtype.
    The model code attends through ``kernels.ops.flash_attention_gqa``;
    this is the reference's function for whatever calls it directly.
    """
    if not f32_softmax:
        raise NotImplementedError(
            "chunked_attention: f32_softmax=False (a bf16 softmax chain) is "
            "not ported; the port's attention computes the float32 softmax")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv "
                         f"heads")
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if q_positions.dim() == 1:
        q_positions = q_positions[None].expand(b, sq)
    if kv_positions.dim() == 1:
        kv_positions = kv_positions[None].expand(b, skv)
    n_chunks = max(1, -(-sq // chunk_size))
    pad = n_chunks * chunk_size - sq
    qf = q.to(torch.float32)
    if pad:
        qf = F.pad(qf, (0, 0, 0, 0, 0, pad))
        q_positions = F.pad(q_positions, (0, pad))
    qg = qf.reshape(b, -1, hkv, g, d).permute(0, 2, 3, 1, 4)  # B,Hkv,G,S,D
    kT = k.to(torch.float32).permute(0, 2, 3, 1)            # (B, Hkv, D, Skv)
    vv = v.to(torch.float32).permute(0, 2, 1, 3)            # (B, Hkv, Skv, D)
    unmasked = not causal and not window and kv_valid is None

    def block_mask(qp, kp):
        """(B, C) q-positions × (B, K) kv-positions -> (B, C, K) bool."""
        mask = torch.ones((qp.shape[0], qp.shape[1], kp.shape[1]),
                          dtype=torch.bool, device=qp.device)
        if causal:
            cmask = kp[:, None, :] <= qp[:, :, None]
            if prefix_len:
                cmask = cmask | ((kp[:, None, :] < prefix_len)
                                 & (qp[:, :, None] < prefix_len))
            mask = mask & cmask
        if window:
            mask = mask & (qp[:, :, None] - kp[:, None, :] < window)
        return mask

    def one_chunk(qc, qp):
        logits = torch.einsum("bhgcd,bhds->bhgcs", qc, kT) * scale
        if not unmasked:
            mask = block_mask(qp, kv_positions)
            if kv_valid is not None:
                mask = mask & kv_valid[:, None, :]
            logits = torch.where(mask[:, None, None], logits,
                                 logits.new_tensor(NEG_INF))
        m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=NEG_INF)
        p = torch.exp(logits - m)
        denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        return torch.einsum("bhgcs,bhsd->bhgcd", p, vv) / denom

    def one_chunk_online(qc, qp):
        nk = skv // kv_chunk
        m = qc.new_full(qc.shape[:-1] + (1,), NEG_INF)
        l_sum = qc.new_zeros(qc.shape[:-1] + (1,))
        acc = torch.zeros_like(qc)
        for j in range(nk):
            blk = slice(j * kv_chunk, (j + 1) * kv_chunk)
            logits = torch.einsum("bhgcd,bhdk->bhgck", qc,
                                  kT[..., blk]) * scale
            mask = block_mask(qp, kv_positions[:, blk])
            if kv_valid is not None:
                mask = mask & kv_valid[:, None, blk]
            logits = torch.where(mask[:, None, None], logits,
                                 logits.new_tensor(NEG_INF))
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l_sum = alpha * l_sum + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + torch.einsum("bhgck,bhkd->bhgcd", p,
                                             vv[:, :, blk])
            m = m_new
        return acc / torch.clamp(l_sum, min=1e-30)

    run = (one_chunk_online if kv_chunk and skv % kv_chunk == 0
           and skv > kv_chunk else one_chunk)
    outs = [run(qg[:, :, :, c * chunk_size:(c + 1) * chunk_size],
                q_positions[:, c * chunk_size:(c + 1) * chunk_size])
            for c in range(n_chunks)]
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)    # (B, S, Hkv, G, D)
    return out.reshape(b, -1, hq, d)[:, :sq].to(q.dtype)


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
# MoE (Mixtral-style top-k routing, optionally with a capacity dispatch)
# ---------------------------------------------------------------------------


def moe_route(params: dict, xf: torch.Tensor, k: int):
    """Top-k routing of the tokens ``xf`` (T, d), in float32 whatever
    ``xf``'s dtype: the router's softmax, its top ``k`` experts a token
    ``tope`` (T, k) (best first) with weights ``topw`` renormalised to sum
    to 1 (by ``max(sum, 1e-9)``), and the Switch load-balance loss
    ``E · Σ_e f_e p_e`` (``f`` the share of tokens whose top-1 expert is
    ``e``, ``p`` the mean router probability): ``(topw, tope, probs,
    aux)``."""
    probs = torch.softmax(dense(params["router"], xf.to(torch.float32)), -1)
    topw, tope = torch.topk(probs, k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    e = probs.shape[-1]
    f = F.one_hot(tope[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(f * probs.mean(0))
    return topw, tope, probs, aux


class MoERecorder:
    """While active (``with MoERecorder() as rec``), records what every
    ``moe_apply`` routes: the smallest gap between a token's k-th and
    (k+1)-th router probability (``gaps``, one a call; a near-tie there
    can send a token to another expert after a one-ulp difference
    upstream) and each capacity dispatch's kept assignments (``keeps``).
    For checks of the routing; it reads the device, so it is off (no
    recorder active) on the served and trained paths."""

    active: list = []

    def __init__(self):
        self.gaps, self.keeps = [], []

    def __enter__(self):
        MoERecorder.active.append(self)
        return self

    def __exit__(self, *exc):
        MoERecorder.active.remove(self)

    def route(self, probs: torch.Tensor, k: int) -> None:
        top = torch.topk(probs, k + 1, dim=-1).values
        gap = (top[:, k - 1] - top[:, k]).min()
        self.gaps.append(gap.item())  # lint: allow-host-sync — a check

    def dispatch(self, keep: torch.Tensor) -> None:
        self.keeps.append(keep.cpu())

    @property
    def min_gap(self):
        return min(self.gaps) if self.gaps else None

    @property
    def drops(self) -> list[int]:
        """The (token, k) assignments each capacity dispatch dropped."""
        return [int((~k).sum()) for k in self.keeps]


def moe_capacity(t: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots an expert has under the capacity dispatch of ``t`` tokens."""
    return int(max(1, math.ceil(t * k / e * capacity_factor)))


def moe_dispatch(tope: torch.Tensor, e: int, cap: int):
    """GShard slots of the (token, k) assignments ``tope`` (T, k) to ``e``
    experts, flattened token-major then k: an assignment's position in its
    expert is the count of the earlier assignments to that expert; it is
    kept when that is below ``cap``.  Returns ``(slot, keep)`` (T·k,):
    ``expert · cap + position``, and ``e · cap`` (the overflow row) for a
    dropped assignment."""
    flat_e = tope.reshape(-1)
    onehot = F.one_hot(flat_e, e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - onehot                 # exclusive
    flat_pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = flat_pos < cap
    slot = torch.where(keep, flat_e * cap + flat_pos,
                       torch.full_like(flat_e, e * cap))
    return slot, keep


def _ffn_experts(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its own rows: ``h`` (E, C, d) -> (E, C, d),
    the products batched over E in ``h``'s dtype."""
    dt = h.dtype
    g = torch.bmm(h, params["w_gate"].to(dt))
    u = torch.bmm(h, params["w_up"].to(dt))
    return torch.bmm(silu(g) * u, params["w_down"].to(dt))


def moe_apply(params: dict, x: torch.Tensor, *, num_experts_per_tok: int = 2,
              capacity_factor: float = 1.25,
              impl: str = "dropping") -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed SwiGLU experts (``repro.models.layers.moe_apply``):
    ``x`` (B, S, d) -> ``(y (B, S, d), aux)``, ``aux`` the load-balance
    loss of ``moe_route``.  Each token's output is the sum over its k
    experts of the expert's SwiGLU output times its routing weight, cast
    to the activation dtype, added in ascending k (or expert) order, so
    a run repeats bitwise.  ``impl``:

    * ``"dense"``: every expert on every token, ``(E, T, F)`` at once,
      then the weighted sum over experts;
    * ``"dense_scan"``: every expert on every token, one expert after the
      other (``e = 0 … E−1``), each adding ``yo · w_e`` into a ``(T, d)``
      accumulator in the activation dtype (the reference's ``lax.scan``
      order: the bf16 result depends on it);
    * ``"dense_fused"``: every expert on every token, the routing weights
      folded into the activations, then one contraction over experts and
      F together;
    * ``"dropping"`` — and any other string, as the reference falls
      through to it — GShard's capacity dispatch: ``moe_capacity`` slots
      an expert (``moe_dispatch``), only the kept assignments' tokens go
      through their experts, a dropped assignment contributes zero.

    Under autograd the dense scan takes the experts of the stacked
    weights with one ``unbind(0)``: a view ``w[e]`` per expert would give
    each expert's gradient a zero tensor of the whole ``(E, d, F)`` leaf.
    """
    b, s, d = x.shape
    e = params["w_gate"].shape[0]
    k = num_experts_per_tok
    xf = x.reshape(b * s, d)
    t, dt = xf.shape[0], xf.dtype
    topw, tope, probs, aux = moe_route(params, xf, k)
    for rec in MoERecorder.active:
        rec.route(probs, k)

    if impl in ("dense", "dense_scan", "dense_fused"):
        w_full = torch.zeros((t, e), dtype=dt, device=xf.device) \
            .scatter(1, tope, topw.to(dt))                     # (T, E)
        if impl == "dense":
            y_all = _ffn_experts(params, xf.expand(e, t, d))
            y = torch.einsum("etd,te->td", y_all, w_full)
        elif impl == "dense_fused":
            g = torch.einsum("td,edf->etf", xf, params["w_gate"].to(dt))
            u = torch.einsum("td,edf->etf", xf, params["w_up"].to(dt))
            z = silu(g) * u * w_full.T[:, :, None]
            y = torch.einsum("etf,efd->td", z, params["w_down"].to(dt))
        else:
            y = torch.zeros_like(xf)
            for wg, wu, wd, we in zip(params["w_gate"].unbind(0),
                                      params["w_up"].unbind(0),
                                      params["w_down"].unbind(0),
                                      w_full.unbind(1)):
                yo = (silu(xf @ wg.to(dt)) * (xf @ wu.to(dt))) @ wd.to(dt)
                y = y + yo * we[:, None]
        return y.reshape(b, s, d), aux

    cap = moe_capacity(t, k, e, capacity_factor)
    slot, keep = moe_dispatch(tope, e, cap)
    for rec in MoERecorder.active:
        rec.dispatch(keep)
    flat_t = torch.arange(t, device=xf.device).repeat_interleave(k)
    # each kept slot takes one token; the dropped ones all land on the
    # overflow row, which is cut off
    buf = xf.new_zeros((e * cap + 1, d)).index_copy(0, slot, xf[flat_t])
    y_flat = _ffn_experts(params, buf[:e * cap].reshape(e, cap, d)) \
        .reshape(e * cap, d)
    y_tok = torch.where(keep[:, None],
                        y_flat[torch.clamp(slot, max=e * cap - 1)],
                        y_flat.new_zeros(()))
    contrib = (y_tok * topw.reshape(-1, 1).to(dt)).reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y.reshape(b, s, d), aux


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


def layernorm_init(dim: int, *, device, dtype) -> dict:
    """``layernorm``'s parameters: ``scale`` 1 and ``bias`` 0."""
    return {"scale": torch.ones((dim,), device=device, dtype=dtype),
            "bias": torch.zeros((dim,), device=device, dtype=dtype)}


def gqa_init(gen, d_model: int, num_heads: int, num_kv_heads: int,
             head_dim: int, *, device, dtype, qkv_bias: bool = False) -> dict:
    """The q, k, v and output projections; ``qkv_bias`` gives q, k and v a
    zero bias each (Whisper's), the output projection none."""
    kw = dict(device=device, dtype=dtype)
    mk = dense_init_b if qkv_bias else dense_init
    return {"wq": mk(gen, d_model, num_heads * head_dim, **kw),
            "wk": mk(gen, d_model, num_kv_heads * head_dim, **kw),
            "wv": mk(gen, d_model, num_kv_heads * head_dim, **kw),
            "wo": dense_init(gen, num_heads * head_dim, d_model, **kw)}


def moe_init(gen, d_model: int, d_ff: int, num_experts: int, *, device,
             dtype) -> dict:
    """The router (float32 whatever ``dtype``: routing runs in float32)
    and the stacked experts' SwiGLU weights ``w_gate``, ``w_up`` (E, d, F)
    and ``w_down`` (E, F, d), the reference's layout and scales."""
    def stacked(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
                .mul_(1.0 / math.sqrt(fan_in)).to(dtype))

    e = num_experts
    return {"router": dense_init(gen, d_model, e, device=device,
                                 dtype=torch.float32),
            "w_gate": stacked((e, d_model, d_ff), d_model),
            "w_up": stacked((e, d_model, d_ff), d_model),
            "w_down": stacked((e, d_ff, d_model), d_ff)}


def swiglu_init(gen, d_model: int, d_ff: int, *, device, dtype) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {"w_gate": dense_init(gen, d_model, d_ff, **kw),
            "w_up": dense_init(gen, d_model, d_ff, **kw),
            "w_down": dense_init(gen, d_ff, d_model, **kw)}


def gelu_mlp_init(gen, d_model: int, d_ff: int, *, device, dtype) -> dict:
    """``gelu_mlp``'s two dense layers, each with a zero bias."""
    kw = dict(device=device, dtype=dtype)
    return {"w1": dense_init_b(gen, d_model, d_ff, **kw),
            "w2": dense_init_b(gen, d_ff, d_model, **kw)}
