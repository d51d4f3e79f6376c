"""Diffusion Transformer expert with PixArt-α AdaLN-Single (paper §2.5).

Port of ``repro.models.dit``: the parameter dict has the reference's keys
and layout (per-layer leaves stacked ``(L, ...)`` under ``blocks`` and
``cross_attn``, dense weights ``(in, out)``), so a reference checkpoint
loads as is (``repro_torch.weights.params_from_numpy``).

The per-layer modulations come from AdaLN-Single (a global MLP of the
timestep embedding τ plus per-block embeddings, Eqs. 14–16), or with
``adaln_single=False`` from the classic per-block adaLN-Zero projection
of ``silu(τ)`` (the ablation baseline, ``adaln_per_block`` leaves).

Per block (Eqs. 17–19):

    h1 = h  + α_msa ⊙ MSA(LN(h) ⊙ (1+γ_msa) + β_msa)
    h2 = h1 + CrossAttn(LN(h1), e_text)
    h' = h2 + α_mlp ⊙ FFN(LN(h2) ⊙ (1+γ_mlp) + β_mlp)

``apply`` is the dense forward (the router, and any single expert);
``make_ragged_expert_apply`` is the serving forward of the routed
experts, where every dense layer is one ragged grouped GEMM
(``kernels.ops.ragged_expert_matmul``) over all routed (sample, slot)
pairs, from any store's ``ragged_view()`` — dense leaves, or quantized
``QuantLeaf``s whose weights reach the GEMM as int8/fp8 bytes.

In both, every LayerNorm — modulated (``kernels.ops.adaln_modulate``)
or not (``kernels.ops.layernorm``, before cross-attention) — and every
self-attention (``kernels.ops.flash_attention``, non-causal) goes
through the port's kernels; cross-attention (256 queries over 77 text
tokens, unequal lengths the attention kernel does not take) stays
plain ops (``layers.attention``).

``apply`` (hence ``make_expert_apply`` and ``make_router_fn``) is
differentiable in its parameters on both devices: on the card the
kernel wrappers run their backward kernels when an input requires grad
(the training path, ``training.trainer``); without grad the forward is
the serving forward, launch for launch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.param_store import QuantLeaf, dequant_leaf
from repro_torch.core.schedules import to_ddpm_timestep
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import DiTConfig
from repro_torch.tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def sinusoidal_table(num: int, dim: int, device=None) -> torch.Tensor:
    """Frozen sinusoidal timestep features (the 'learned table' init)."""
    half = dim // 2
    ar = torch.arange(half, device=device, dtype=torch.float32)
    freqs = torch.exp(-math.log(10000.0) * ar / max(half - 1, 1))
    ang = torch.arange(num, device=device, dtype=torch.float32)[:, None] \
        * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, p*p*C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, p: int, hw: int, c: int) -> torch.Tensor:
    b = x.shape[0]
    g = hw // p
    x = x.reshape(b, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hw, hw, c)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init(cfg: DiTConfig, gen: torch.Generator) -> dict:
    """Random parameters with the reference's structure and init scheme,
    drawn from ``gen`` on ``gen.device``.

    Zero-init layers (final projection, AdaLN-Single output or the
    per-block adaLN-Zero projections, cross-attn output) are zero as in
    the reference (§2.5).
    """
    dev, dt = gen.device, cfg.param_dtype
    d = cfg.d_model
    nl = cfg.num_layers
    in_dim = cfg.patch_size ** 2 * cfg.latent_channels
    t_feat = 256

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dt)

    def dense_b(i, o):
        return L.dense_init_b(gen, i, o, device=dev, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    def stacked(i, o, bias=False):
        leaf = {"w": normal(nl, i, o) / math.sqrt(i)}
        if bias:
            leaf["b"] = zeros(nl, o)
        return leaf

    params: dict = {
        "patch_embed": dense_b(in_dim, d),
        "pos_embed": {"emb": 0.02 * normal(cfg.num_tokens, d)},
        "t_embed": {
            "table": sinusoidal_table(cfg.num_timesteps, t_feat,
                                      device=dev).to(dt),
            "mlp1": dense_b(t_feat, d),
            "mlp2": dense_b(d, d),
        },
        "blocks": {
            "attn": {name: stacked(d, d)
                     for name in ("wq", "wk", "wv", "wo")},
            "mlp": {"w1": stacked(d, cfg.d_ff, bias=True),
                    "w2": stacked(cfg.d_ff, d, bias=True)},
        },
        "final_layer": {"mod": {"w": zeros(d, 2 * d)},
                        "out": {"w": zeros(d, in_dim)}},
    }
    if cfg.adaln_single:
        params["adaln_single"] = {
            "mlp1": dense_b(d, d),
            "mlp2": {"w": zeros(d, 6 * d)},
            "block_embed": normal(nl, 6, d) / math.sqrt(d),
        }
    else:
        # classic per-block adaLN-Zero: one zero-init d -> 6d per layer
        params["adaln_per_block"] = {"w": zeros(nl, d, 6 * d)}
    if cfg.use_text:
        params["text_proj"] = dense_b(cfg.text_dim, d)
        params["cross_attn"] = {
            "wq": stacked(d, d), "wk": stacked(d, d), "wv": stacked(d, d),
            "wo": {"w": zeros(nl, d, d)},
        }
        params["null_text_embed"] = {
            "emb": 0.02 * normal(cfg.text_len, cfg.text_dim)
        }
    if cfg.num_classes:
        params["cls_head"] = dense_b(d, cfg.num_classes)
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# Dense apply
# ---------------------------------------------------------------------------


def timestep_embedding(cfg: DiTConfig, params, t: torch.Tensor):
    """τ(t) via the discrete table + MLP (Eq. 21 runtime mapping)."""
    idx = to_ddpm_timestep(t, cfg.num_timesteps)
    feat = params["t_embed"]["table"][idx]
    h = L.silu(L.dense(params["t_embed"]["mlp1"], feat))
    return L.dense(params["t_embed"]["mlp2"], h)            # (B, d)


def global_modulation(cfg: DiTConfig, params, tau: torch.Tensor):
    """Eq. 14/15: the global (6, d) modulation broadcast over the L layers
    as ``(B, L, 6, d)`` (per-layer variation comes from E_b, Eq. 16)."""
    b = tau.shape[0]
    h = L.silu(L.dense(params["adaln_single"]["mlp1"], tau))
    c = L.dense(params["adaln_single"]["mlp2"], h).reshape(b, 1, 6,
                                                            cfg.d_model)
    return c.expand(b, cfg.num_layers, 6, cfg.d_model)


def layer_modulations(cfg: DiTConfig, params, tau: torch.Tensor):
    """Every layer's ``(6, d)`` modulations, ``(L, B, 6, d)``: AdaLN-Single's
    global modulation plus the block embeddings, or one per-block
    adaLN-Zero projection of ``silu(τ)`` per layer."""
    b = tau.shape[0]
    if cfg.adaln_single:
        mods = global_modulation(cfg, params, tau)            # (B, L, 6, d)
        mods = mods + params["adaln_single"]["block_embed"][None].to(
            mods.dtype)
        return mods.movedim(1, 0)
    h = L.silu(tau)
    return torch.stack([
        L.dense({"w": w}, h).reshape(b, 6, cfg.d_model)
        for w in params["adaln_per_block"]["w"]])


def _modulate_ln(x, gamma, beta):
    """``LN(x)·(1+γ)+β`` with ``1 + γ`` in γ's dtype, as the reference DiT's
    ``layernorm({}, x) * (1.0 + γ) + β`` rounds it (bf16 modulations of a
    bf16 store)."""
    return ops.adaln_modulate(x, gamma, beta, round_scale=True)


def _attend(q, k, v):
    """Non-causal self-attention of ``(B, S, H, D)`` projections through
    the attention kernel, read and written in that layout (a transposed
    view of the kernel's ``(B, H, S, D)``); returns ``(B, S, H·D)``."""
    b, s = q.shape[0], q.shape[1]
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=False)
    return out.transpose(1, 2).reshape(b, s, -1)


def _layer(tree, layer: int):
    return tree_map(lambda a: a[layer], tree)


def _self_attn(cfg: DiTConfig, p, x):
    hd = cfg.d_model // cfg.num_heads
    q, k, v = L.gqa_project(p, x, cfg.num_heads, cfg.num_heads, hd)
    return L.dense(p["wo"], _attend(q, k, v))


def _cross_attn(cfg: DiTConfig, p, x, text):
    d = cfg.d_model
    hd = d // cfg.num_heads
    b, s, _ = x.shape
    m = text.shape[1]
    q = L.dense(p["wq"], x).reshape(b, s, cfg.num_heads, hd)
    k = L.dense(p["wk"], text).reshape(b, m, cfg.num_heads, hd)
    v = L.dense(p["wv"], text).reshape(b, m, cfg.num_heads, hd)
    return L.dense(p["wo"], L.attention(q, k, v).reshape(b, s, d))


def apply(cfg: DiTConfig, params, x_t: torch.Tensor, t: torch.Tensor, *,
          text_emb: torch.Tensor | None = None,
          drop_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Dense forward: ε/velocity ``(B, H, W, C)``, or router logits
    ``(B, num_classes)`` when ``cfg.num_classes``.

    ``text_emb`` ``(B, text_len, text_dim)``; None uses the learned null
    embedding, and ``drop_mask`` ``(B,)`` rows substitute it.
    """
    b = x_t.shape[0]
    h = L.dense(params["patch_embed"],
                patchify(x_t.to(cfg.activation_dtype), cfg.patch_size))
    h = h + params["pos_embed"]["emb"][None].to(h.dtype)
    tau = timestep_embedding(cfg, params, t)                  # (B, d)

    text = None
    if cfg.use_text:
        null = params["null_text_embed"]["emb"][None].expand(
            b, cfg.text_len, cfg.text_dim)
        if text_emb is None:
            text_emb = null
        elif drop_mask is not None:
            text_emb = torch.where(drop_mask[:, None, None], null, text_emb)
        text = L.dense(params["text_proj"],
                       text_emb.to(cfg.activation_dtype))

    mods = layer_modulations(cfg, params, tau)                # (L, B, 6, d)

    for layer in range(cfg.num_layers):
        bp = _layer(params["blocks"], layer)
        mod = mods[layer]
        g_msa, b_msa, a_msa = mod[:, 0], mod[:, 1], mod[:, 2]
        g_mlp, b_mlp, a_mlp = mod[:, 3], mod[:, 4], mod[:, 5]
        hn = _modulate_ln(h, g_msa, b_msa)                    # Eq. 17
        h = h + a_msa[:, None] * _self_attn(cfg, bp["attn"], hn)
        if text is not None:                                  # Eq. 18
            cp = _layer(params["cross_attn"], layer)
            h = h + _cross_attn(cfg, cp, ops.layernorm(h), text)
        hn = _modulate_ln(h, g_mlp, b_mlp)                    # Eq. 19
        h = h + a_mlp[:, None] * L.gelu_mlp(bp["mlp"], hn)

    if cfg.num_classes:
        return L.dense(params["cls_head"], h.mean(dim=1))     # router logits

    mod = L.dense(params["final_layer"]["mod"], L.silu(tau))
    shift, scale = torch.chunk(mod, 2, dim=-1)
    h = _modulate_ln(h, scale, shift)
    out = L.dense(params["final_layer"]["out"], h)
    return unpatchify(out, cfg.patch_size, cfg.latent_size,
                      cfg.latent_channels).to(torch.float32)


def make_expert_apply(cfg: DiTConfig):
    """Adapter matching the ``ExpertSpec.apply_fn`` signature."""

    def apply_fn(params, x_t, t, **cond):
        return apply(cfg, params, x_t, t, text_emb=cond.get("text_emb"),
                     drop_mask=cond.get("drop_mask"))

    return apply_fn


def make_router_fn(cfg: DiTConfig, params):
    """Router posterior p(k | x_t, t) (Eq. 2)."""

    def router_fn(x_t, t):
        return torch.softmax(apply(cfg, params, x_t, t), dim=-1)

    return router_fn


# ---------------------------------------------------------------------------
# Ragged pair-major apply (the routed serving forward)
# ---------------------------------------------------------------------------


def stack_expert_params(params_list):
    """Stack K same-architecture expert trees: every leaf gains a leading
    expert axis ``(K, ...)``."""
    def rec(nodes):
        first = nodes[0]
        if isinstance(first, dict):
            return {k: rec([n[k] for n in nodes]) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(rec([n[i] for n in nodes])
                               for i in range(len(first)))
        return torch.stack(nodes)

    return rec(list(params_list))


def _ragged_dense(leaf: dict, x: torch.Tensor, pe: torch.Tensor):
    """Per-pair expert dense through the ragged grouped GEMM.

    A ``QuantLeaf`` weight stays int8/fp8 into the GEMM with its ``(K,)``
    scales; the bias (tiny) expands through ``dequant_leaf``.
    """
    w = leaf["w"]
    wq, ws = (w.q, w.scale) if isinstance(w, QuantLeaf) else (w, None)
    b = leaf.get("b")
    bias = None if b is None else dequant_leaf(b)
    return ops.ragged_expert_matmul(x, wq, pe, bias=bias, w_scale=ws)


def _layer_view(tree, layer: int):
    """Slice layer ``layer`` from stacked ``(K, L, ...)`` view leaves.

    A ``QuantLeaf`` slices its bytes and keeps its ``(K,)`` scales: every
    layer of a stacked leaf shares its expert's one scale.
    """
    def f(a):
        if isinstance(a, QuantLeaf):
            return QuantLeaf(a.q[:, layer], a.scale)
        return a[:, layer]

    return tree_map(f, tree)


def make_ragged_expert_apply(cfg: DiTConfig):
    """Pair-major ragged forward, matching ``ExpertSpec.ragged_apply_fn``.

    Signature ``ragged_apply_fn(view, x_p, t_p, cond_pg, pe, g)``: ``view``
    is ``DenseStore.ragged_view()`` (leaves ``(K, ...)``); ``x_p``
    ``(P, H, W, C)`` one latent per routed (sample, slot) pair; ``t_p``
    ``(P,)``; ``cond_pg`` leaves ``(P, g, ...)``; ``pe`` ``(P,)`` expert id
    per pair.  Returns ``(P·g, H, W, C)`` float32, pair-major (the ``g``
    replicas of a pair adjacent).

    The ``g`` CFG replicas of a pair share latent, timestep and expert, so
    the conditioning-independent prefix (embeddings, timestep path,
    modulations and the layer-0 self-attention, which precedes the first
    cross-attention) runs once per pair and broadcasts to the replicas.
    """
    if cfg.num_classes:
        raise ValueError(
            "ragged apply serves expert prediction only; the router head "
            "(num_classes > 0) goes through the dense apply"
        )

    def ragged_apply(view, x_p, t_p, cond, pe, g):
        p_pairs = x_p.shape[0]
        d = cfg.d_model
        hd = d // cfg.num_heads
        ps = cfg.patch_size

        def pd(leaf, x):
            return _ragged_dense(leaf, x, pe)

        xp = patchify(x_p.to(cfg.activation_dtype), ps)
        h_r = pd(view["patch_embed"], xp)                  # (P, T, d)
        h_r = h_r + dequant_leaf(view["pos_embed"]["emb"])[pe].to(h_r.dtype)

        # Timestep path — replicas share t, so one row per pair.
        idx = to_ddpm_timestep(t_p, cfg.num_timesteps)
        feat = dequant_leaf(view["t_embed"]["table"])[pe, idx]
        ht = L.silu(pd(view["t_embed"]["mlp1"], feat))
        tau = pd(view["t_embed"]["mlp2"], ht)              # (P, d)

        if cfg.adaln_single:
            hm = L.silu(pd(view["adaln_single"]["mlp1"], tau))
            c = pd(view["adaln_single"]["mlp2"], hm).reshape(p_pairs, 1, 6,
                                                             d)
            mods = c.expand(p_pairs, cfg.num_layers, 6, d)
            mods = mods + dequant_leaf(
                view["adaln_single"]["block_embed"])[pe].to(mods.dtype)
            mods = mods.movedim(1, 0)                      # (L, P, 6, d)
        else:
            # one ragged modulation GEMM per layer
            st = L.silu(tau)
            mods = torch.stack([
                pd(_layer_view(view["adaln_per_block"], layer),
                   st).reshape(p_pairs, 6, d)
                for layer in range(cfg.num_layers)])       # (L, P, 6, d)

        def self_attn(bp, h, mod):
            # h: (P, T, d) prefix or (P, g, T, d) expanded; mod (P, 6, d)
            nb = h.dim() - 2
            ex = (slice(None),) + (None,) * (nb - 1) + (None,)
            g_msa, b_msa, a_msa = mod[:, 0], mod[:, 1], mod[:, 2]
            hn = _modulate_ln(h, g_msa, b_msa)
            t_tok = hn.shape[-2]
            q = pd(bp["attn"]["wq"], hn).reshape(-1, t_tok, cfg.num_heads,
                                                 hd)
            k = pd(bp["attn"]["wk"], hn).reshape(-1, t_tok, cfg.num_heads,
                                                 hd)
            v = pd(bp["attn"]["wv"], hn).reshape(-1, t_tok, cfg.num_heads,
                                                 hd)
            att = pd(bp["attn"]["wo"], _attend(q, k, v).reshape(h.shape))
            return h + a_msa[ex] * att

        # Prefix: layer-0 self-attention on the per-pair representative —
        # exact because cross-attention (the first conditioning-dependent
        # op) runs after self-attention within a block (Eqs. 17→18).
        h_r = self_attn(_layer_view(view["blocks"], 0), h_r, mods[0])
        # Expand to the replicas: a broadcast, no recompute.
        h = h_r[:, None].expand((p_pairs, g) + tuple(h_r.shape[1:]))

        text = None
        if cfg.use_text:
            nulle = dequant_leaf(view["null_text_embed"]["emb"])[pe]
            text_emb = cond.get("text_emb")
            if text_emb is None:
                text_emb = nulle[:, None].expand(
                    (p_pairs, g) + tuple(nulle.shape[1:]))
            else:
                drop = cond.get("drop_mask")
                if drop is not None:
                    text_emb = torch.where(drop[..., None, None],
                                           nulle[:, None], text_emb)
            text = pd(view["text_proj"], text_emb.to(cfg.activation_dtype))
            t_txt = text.shape[-2]

        for layer in range(cfg.num_layers):
            bp = _layer_view(view["blocks"], layer)
            mod = mods[layer]
            g_mlp, b_mlp, a_mlp = mod[:, 3], mod[:, 4], mod[:, 5]
            if layer > 0:
                h = self_attn(bp, h, mod)                  # Eq. 17
            if text is not None:                           # Eq. 18
                cp = _layer_view(view["cross_attn"], layer)
                t_tok = h.shape[-2]
                hn = ops.layernorm(h)
                q = pd(cp["wq"], hn).reshape(-1, t_tok, cfg.num_heads, hd)
                k = pd(cp["wk"], text).reshape(-1, t_txt, cfg.num_heads, hd)
                v = pd(cp["wv"], text).reshape(-1, t_txt, cfg.num_heads, hd)
                h = h + pd(cp["wo"], L.attention(q, k, v).reshape(h.shape))
            hn = _modulate_ln(h, g_mlp, b_mlp)             # Eq. 19
            hmid = L.gelu(pd(bp["mlp"]["w1"], hn))
            h = h + a_mlp[:, None, None] * pd(bp["mlp"]["w2"], hmid)

        mod = pd(view["final_layer"]["mod"], L.silu(tau))
        shift, scale = torch.chunk(mod, 2, dim=-1)
        h = _modulate_ln(h, scale, shift)
        out = pd(view["final_layer"]["out"], h)
        out = out.reshape((p_pairs * g,) + tuple(out.shape[2:]))
        return unpatchify(out, ps, cfg.latent_size,
                          cfg.latent_channels).to(torch.float32)

    return ragged_apply
