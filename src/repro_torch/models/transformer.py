"""Decoder-only transformer backbone, dense GQA, MoE and VLM prefix (port
of ``repro.models.transformer``): stablelm-1.6b, internlm2-1.8b,
deepseek-67b and deepseek-coder-33b (dense), mixtral-8x7b and
mixtral-8x22b (MoE, sliding-window attention), paligemma-3b (``vlm``:
the stubbed SigLIP patches, projected by ``vision_proj``, form a prefix
that attends bidirectionally).

Each block is RMSNorm, causal GQA attention with RoPE, RMSNorm, then
SwiGLU — or, when ``cfg.num_experts``, the top-k routed SwiGLU experts of
``layers.moe_apply`` with the config's ``moe_impl`` — both residual.  The
parameter dict has the reference's keys and layout: per-layer leaves
stacked ``(num_layers, ...)`` under ``blocks``, dense
weights ``(in, out)``, so a reference tree carries over leaf by leaf
(``repro_torch.weights.params_from_numpy``); layers run in a Python loop
over the stack unbound once (``tree.tree_unstack``).

Every attention over a sequence (``forward_train``, ``prefill``, and the
hybrid backbone's shared block) goes through ``kernels.ops.
flash_attention_gqa`` — the hand-written CUDA kernel on the card, its
plain version on the CPU — on ``(B, H, S, D)`` views of the projections,
causal over positions ``0 .. S−1`` (the kernel's index masks are the
reference's position masks there), with the VLM's prefix-LM mask
(``prefix_len`` P: the ``P = vision_embeds.shape[1]`` patch positions
see each other both ways).  ``decode_step`` attends one token to the KV
cache with ``layers.decode_attention`` (plain torch, as the reference's
jnp); its positions count the prefix.  The MoE layers' load-balance
losses, averaged over the layers, are ``forward_train``'s aux output and
enter ``loss_fn`` with ``aux_loss_weight``.

Also the token-mean cross-entropy that every LM backbone's ``loss_fn``
uses.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.launch.fsdp import maybe_unshard
from repro_torch.models import layers as L
from repro_torch.models.config import LMConfig
from repro_torch.tree import tree_leaves, tree_stack_layers, tree_unstack
from repro_torch.weights import resolve_device


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  chunk: int = 0) -> torch.Tensor:
    """Token-mean CE.  ``chunk`` > 0 evaluates the softmax over sequence
    chunks of ``chunk`` positions (a memory lever for large vocabularies)
    and averages the ``S // chunk`` whole chunks, as the reference does:
    a remainder of fewer than ``chunk`` positions is left out."""
    if chunk and logits.shape[1] > chunk:
        n = logits.shape[1] // chunk
        ces = [_ce(logits[:, c * chunk:(c + 1) * chunk],
                   labels[:, c * chunk:(c + 1) * chunk]) for c in range(n)]
        return torch.stack(ces).mean()
    return _ce(logits, labels)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - picked)


# ---------------------------------------------------------------------------
# Blocks: the dense layers, and the hybrid backbone's shared block
# ---------------------------------------------------------------------------


def _check_attention(cfg: LMConfig) -> None:
    if not cfg.attn_f32_softmax:
        raise NotImplementedError(
            f"{cfg.name}: attn_f32_softmax=False (a bf16 softmax chain) is "
            f"not ported; the attention kernel computes the float32 softmax")


def _attn_full(cfg: LMConfig, p: dict, h: torch.Tensor,
               positions: torch.Tensor, prefix_len: int = 0):
    """Causal self-attention of the normed hidden states ``h`` (B, S, d)
    at positions ``0 .. S−1`` (the first ``prefix_len`` of them
    bidirectional among themselves): projections, RoPE, the attention
    kernel, the output projection.  Returns ``(y (B, S, d), (k, v))`` with
    the roped keys and the values ``(B, S, Hkv, D)`` a KV cache keeps."""
    _check_attention(cfg)
    hd = cfg.resolved_head_dim
    q, k, v = L.gqa_project(p, h, cfg.num_heads, cfg.num_kv_heads, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention_gqa(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
                                  window=cfg.sliding_window,
                                  prefix_len=prefix_len)
    b, s = h.shape[:2]
    y = L.dense(p["wo"], out.transpose(1, 2).reshape(b, s, -1))
    return y, (k, v)


def block_init(cfg: LMConfig, gen, device) -> dict:
    """One block's parameters: RMSNorm, GQA projections, RMSNorm, SwiGLU
    — or the MoE's router and experts under ``moe`` when
    ``cfg.num_experts`` (also the hybrid's shared block)."""
    pd = cfg.param_dtype
    p = {
        "ln_attn": L.rmsnorm_init(cfg.d_model, device=device, dtype=pd),
        "attn": L.gqa_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim, device=device, dtype=pd),
        "ln_ffn": L.rmsnorm_init(cfg.d_model, device=device, dtype=pd),
    }
    if cfg.num_experts:
        p["moe"] = L.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.num_experts,
                              device=device, dtype=pd)
    else:
        p["ffn"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, device=device,
                                 dtype=pd)
    return p


def _ffn(cfg: LMConfig, p: dict, h):
    """The block's feed-forward of the normed ``h``: ``(f, aux)``, the
    MoE's load-balance loss (``None`` without experts)."""
    hn = L.rmsnorm(p["ln_ffn"], h, cfg.norm_eps)
    if cfg.num_experts:
        return L.moe_apply(p["moe"], hn,
                           num_experts_per_tok=cfg.num_experts_per_tok,
                           capacity_factor=cfg.moe_capacity_factor,
                           impl=cfg.moe_impl)
    return L.swiglu(p["ffn"], hn), None


def block_apply(cfg: LMConfig, p: dict, h, positions, prefix_len: int = 0):
    """A block over a sequence: ``(h, (k, v), aux)`` (``aux`` the MoE's
    load-balance loss, ``None`` without experts)."""
    hn = L.rmsnorm(p["ln_attn"], h, cfg.norm_eps)
    a, kv = _attn_full(cfg, p["attn"], hn, positions, prefix_len)
    h = h + a
    f, aux = _ffn(cfg, p, h)
    return h + f, kv, aux


def decode_slots(cache: dict, pos: torch.Tensor, ring: bool):
    """The cache slot each row's new token takes — ``pos % w`` on a ring
    buffer, else ``min(pos, w − 1)`` — and the cache's positions with it
    written: ``(slot, new_pos)``."""
    w = cache["pos"].shape[1]
    slot = pos % w if ring else torch.clamp(pos, max=w - 1)
    new_pos = cache["pos"].clone()
    new_pos[torch.arange(pos.shape[0], device=pos.device), slot] = \
        pos.to(new_pos.dtype)
    return slot, new_pos


def block_decode(cfg: LMConfig, p: dict, h: torch.Tensor, pos, k_c, v_c,
                 slot, new_pos, window: int) -> torch.Tensor:
    """One token (B, 1, d) through a block: its key and value, roped at
    ``pos``, written into ``k_c``/``v_c`` (B, W, Hkv, D) at ``slot`` in
    place, attention over the cache, then SwiGLU or the MoE (over the B
    tokens, with the config's ``moe_impl``: under ``"dropping"`` their
    capacity is ``ceil(B·k/E·capacity_factor)``), both residual."""
    hd = cfg.resolved_head_dim
    b = h.shape[0]
    hn = L.rmsnorm(p["ln_attn"], h, cfg.norm_eps)
    q, k, v = L.gqa_project(p["attn"], hn, cfg.num_heads, cfg.num_kv_heads,
                            hd)
    q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
    bidx = torch.arange(b, device=h.device)
    k_c[bidx, slot] = k[:, 0].to(k_c.dtype)
    v_c[bidx, slot] = v[:, 0].to(v_c.dtype)
    out = L.decode_attention(q, k_c, v_c, q_position=pos,
                             kv_positions=new_pos, window=window)
    h = h + L.dense(p["attn"]["wo"], out.reshape(b, 1, cfg.num_heads * hd))
    return h + _ffn(cfg, p, h)[0]


# ---------------------------------------------------------------------------
# The dense, MoE and VLM backbone
# ---------------------------------------------------------------------------


def _check_family(cfg: LMConfig) -> None:
    if cfg.arch_type not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}): the transformer is "
            f"the dense, MoE and VLM-prefix backbone")


def init(cfg: LMConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's structure and init scheme,
    drawn from ``gen`` on ``device`` (``None`` → ``"cuda"``); with
    ``cfg.vision_prefix_len`` also ``vision_proj``, the (d, d) projector
    of the stubbed patch embeddings."""
    _check_family(cfg)
    dev = resolve_device(device)
    pd = cfg.param_dtype
    blocks = tree_stack_layers(lambda: block_init(cfg, gen, dev),
                               cfg.num_layers)
    params = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev,
                              dtype=pd),
        "blocks": blocks,
        "ln_final": L.rmsnorm_init(cfg.d_model, device=dev, dtype=pd),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                device=dev, dtype=pd),
    }
    if cfg.vision_prefix_len:
        params["vision_proj"] = L.dense_init(gen, cfg.d_model, cfg.d_model,
                                             device=dev, dtype=pd)
    return params


def _embed_inputs(cfg: LMConfig, params, tokens, vision_embeds):
    """The token embeddings, after the projected patch embeddings when the
    config has a vision prefix and ``vision_embeds`` (B, P, d) are given:
    ``(h (B, P + S, d), P)`` (``P`` 0 without them)."""
    h = L.embed(params["embed"], tokens, cfg.activation_dtype)
    if not (cfg.vision_prefix_len and vision_embeds is not None):
        return h, 0
    vis = L.dense(params["vision_proj"],
                  vision_embeds.to(cfg.activation_dtype))
    return torch.cat([vis, h], dim=1), vision_embeds.shape[1]


def _residual(cfg: LMConfig, p: dict, h, positions, prefix_len: int):
    # the FSDP gather inside the checkpointed function: the backward
    # gathers the layer again, none is kept across the step
    p = maybe_unshard(p)
    h, _, aux = block_apply(cfg, p, h, positions, prefix_len)
    return h, aux


def forward_train(cfg: LMConfig, params, tokens, *, vision_embeds=None):
    """(B, S) tokens (after the VLM's ``vision_embeds`` prefix, when given)
    -> ((B, S, V) logits of the token positions, the MoE aux loss summed
    over the layers in order and divided by their number: float32, zero
    for a dense model).  With ``cfg.remat``, when gradients are taken,
    each layer keeps only its input and runs its forward again in the
    backward (its aux comes out of the checkpoint with its output)."""
    remat = cfg.remat and torch.is_grad_enabled() and any(
        a.requires_grad for a in tree_leaves(params))
    h, prefix = _embed_inputs(cfg, params, tokens, vision_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for bp in tree_unstack(params["blocks"]):
        if remat:
            h, a = checkpoint(_residual, cfg, bp, h, positions, prefix,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            h, a = _residual(cfg, bp, h, positions, prefix)
        if a is not None:
            aux = aux + a
    h = L.rmsnorm(params["ln_final"], h, cfg.norm_eps)
    if prefix:
        h = h[:, prefix:]
    logits = L.dense(params["unembed"], h)
    return logits, aux / max(cfg.num_layers, 1)


def loss_fn(cfg: LMConfig, params, tokens, labels, *, vision_embeds=None):
    """``(ce + aux_loss_weight · aux, {"ce": ce, "moe_aux": aux})`` (a
    dense model's aux is zero; the CE over the token positions)."""
    logits, aux = forward_train(cfg, params, tokens,
                                vision_embeds=vision_embeds)
    ce = cross_entropy(logits, labels, chunk=cfg.logits_chunk)
    return ce + cfg.aux_loss_weight * aux, {"ce": ce, "moe_aux": aux}


def make_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> dict:
    """KV cache: roped keys and values per layer ``(L, B, max_len, Hkv,
    D)`` and each slot's position ``(B, max_len)`` (−1: empty).
    ``max_len`` is the ring's size under a decode window."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=dev),
    }


def prefill(cfg: LMConfig, params, tokens, *, vision_embeds=None):
    """(B, S) tokens (after the VLM's ``vision_embeds`` prefix of P
    positions, when given) -> ((B, V) last-position logits, a KV cache of
    the prompt's length, P + S)."""
    h, prefix = _embed_inputs(cfg, params, tokens, vision_embeds)
    b, s = h.shape[:2]
    positions = torch.arange(s, device=h.device)
    ks, vs = [], []
    for bp in tree_unstack(params["blocks"]):
        h, (k, v), _ = block_apply(cfg, maybe_unshard(bp), h, positions,
                                   prefix)
        ks.append(k)
        vs.append(v)
    hl = L.rmsnorm(params["ln_final"], h[:, -1:], cfg.norm_eps)
    logits = L.dense(params["unembed"], hl)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "pos": positions.to(torch.int32)[None].repeat(b, 1)}


def decode_step(cfg: LMConfig, params, cache: dict, token, pos):
    """One token (B, 1) at positions ``pos`` (B,) through every layer,
    its keys and values written at slot ``pos % W`` under a decode window
    (a ring buffer), else ``min(pos, W − 1)``.  Returns ((B, V) logits,
    the new cache; the given one is not modified)."""
    h = L.embed(params["embed"], token, cfg.activation_dtype)
    slot, new_pos = decode_slots(cache, pos, bool(cfg.decode_window))
    window = cfg.decode_window or cfg.sliding_window
    ks, vs = cache["k"].clone(), cache["v"].clone()
    for i, bp in enumerate(tree_unstack(params["blocks"])):
        h = block_decode(cfg, maybe_unshard(bp), h, pos, ks[i], vs[i], slot,
                         new_pos, window)
    h = L.rmsnorm(params["ln_final"], h, cfg.norm_eps)
    logits = L.dense(params["unembed"], h)[:, 0]
    return logits, {"k": ks, "v": vs, "pos": new_pos}
