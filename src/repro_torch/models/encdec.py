"""Whisper-style encoder-decoder backbone [arXiv:2212.04356] (port of
``repro.models.encdec``): whisper-large-v3.

The audio frontend (mel spectrogram + conv feature extractor) is a stub
(``models/frontend_stubs.py``): the encoder takes precomputed frame
embeddings ``(B, n_frames, d_model)``.  A bidirectional encoder over the
frames and a causal decoder with cross-attention, learned positional
embeddings, pre-LN blocks with GELU MLPs and Whisper's LayerNorm with
bias (``layers.layernorm``), q, k and v projections with biases.

The parameter dict has the reference's keys and layout (per-layer leaves
stacked ``(layers, ...)`` under ``enc_blocks`` and ``dec_blocks``, dense
weights ``(in, out)``), so a reference tree carries over leaf by leaf
(``repro_torch.weights.params_from_numpy``); layers run in a Python loop
over the stacks unbound once (``tree.tree_unstack``), each under
``torch.utils.checkpoint`` when ``cfg.remat`` and gradients are taken.

Every attention over a sequence goes through ``kernels.ops.
flash_attention_gqa`` — the hand-written CUDA kernel on the card, its
plain version on the CPU — on ``(B, H, S, D)`` views of the projections:
the encoder's self-attention non-causal, the decoder's causal (with
``cfg.sliding_window``), and the decoder's cross-attention non-causal,
``S`` decoder rows over the ``m`` encoder frames (the kernel's own kv
length).  ``decode_step`` attends one token to the caches with
``layers.decode_attention`` (plain torch, as the reference's jnp).

The cache is the reference's: ``prefill`` returns a self-attention cache
as long as the prompt and every layer's cross-attention keys and values
of the encoder output; under ``decode_window`` ``decode_step`` writes
slot ``pos % W`` of that cache, so decoding past the prompt attends a
ring of the prompt's length (ROADMAP.md, C).  The reference's
``maybe_unshard`` (an FSDP gather) is the identity on one device and is
left out.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import LMConfig
from repro_torch.models.transformer import (_check_attention, cross_entropy,
                                            decode_slots)
from repro_torch.tree import tree_leaves, tree_stack_layers, tree_unstack
from repro_torch.weights import resolve_device

#: rows of the decoder's learned position table (the reference's)
DEC_POSITIONS = 8192


def _check_family(cfg: LMConfig) -> None:
    if cfg.arch_type != "audio":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}): models.encdec is the "
            f"audio (encoder-decoder) backbone")


def _enc_block_init(cfg: LMConfig, gen, dev) -> dict:
    pd, hd = cfg.param_dtype, cfg.resolved_head_dim
    return {
        "ln_attn": L.layernorm_init(cfg.d_model, device=dev, dtype=pd),
        "attn": L.gqa_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           hd, device=dev, dtype=pd, qkv_bias=True),
        "ln_ffn": L.layernorm_init(cfg.d_model, device=dev, dtype=pd),
        "ffn": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, device=dev,
                               dtype=pd),
    }


def _dec_block_init(cfg: LMConfig, gen, dev) -> dict:
    pd, hd = cfg.param_dtype, cfg.resolved_head_dim
    return {
        "ln_self": L.layernorm_init(cfg.d_model, device=dev, dtype=pd),
        "self_attn": L.gqa_init(gen, cfg.d_model, cfg.num_heads,
                                cfg.num_kv_heads, hd, device=dev, dtype=pd,
                                qkv_bias=True),
        "ln_cross": L.layernorm_init(cfg.d_model, device=dev, dtype=pd),
        "cross_attn": L.gqa_init(gen, cfg.d_model, cfg.num_heads,
                                 cfg.num_heads, hd, device=dev, dtype=pd,
                                 qkv_bias=True),
        "ln_ffn": L.layernorm_init(cfg.d_model, device=dev, dtype=pd),
        "ffn": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, device=dev,
                               dtype=pd),
    }


def init(cfg: LMConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's structure and init scheme,
    drawn from ``gen`` on ``device`` (``None`` → ``"cuda"``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def table(rows):
        return (L._normal((rows, cfg.d_model), gen, dev, torch.float32)
                * 0.01).to(pd)

    n_enc = cfg.num_encoder_layers or cfg.num_layers
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev,
                              dtype=pd),
        "enc_pos": table(cfg.encoder_seq_len),
        "dec_pos_table": table(DEC_POSITIONS),
        "enc_blocks": tree_stack_layers(
            lambda: _enc_block_init(cfg, gen, dev), n_enc),
        "dec_blocks": tree_stack_layers(
            lambda: _dec_block_init(cfg, gen, dev), cfg.num_layers),
        "ln_enc_final": L.layernorm_init(cfg.d_model, device=dev, dtype=pd),
        "ln_dec_final": L.layernorm_init(cfg.d_model, device=dev, dtype=pd),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                device=dev, dtype=pd),
    }


def _attend(q, k, v, **mask) -> torch.Tensor:
    """(B, Sq, H, D) queries over (B, Skv, Hkv, D) keys and values through
    the attention kernel on their (B, H, S, D) views; the output as
    (B, Sq, H, D), laid out as ``q``."""
    out = ops.flash_attention_gqa(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), **mask)
    return out.transpose(1, 2)


def _dec_positions(params: dict, positions: torch.Tensor) -> torch.Tensor:
    tbl = params["dec_pos_table"]
    return tbl[torch.clamp(positions.long(), 0, tbl.shape[0] - 1)]


def _enc_block(cfg: LMConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    b, s = h.shape[:2]
    hn = L.layernorm(p["ln_attn"], h, cfg.norm_eps)
    q, k, v = L.gqa_project(p["attn"], hn, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim)
    out = _attend(q, k, v, causal=False)
    h = h + L.dense(p["attn"]["wo"], out.reshape(b, s, -1))
    return h + L.gelu_mlp(p["ffn"], L.layernorm(p["ln_ffn"], h,
                                                cfg.norm_eps))


def _remat(cfg: LMConfig, params) -> bool:
    return cfg.remat and torch.is_grad_enabled() and any(
        a.requires_grad for a in tree_leaves(params))


def _encode(cfg: LMConfig, params, frames, remat: bool) -> torch.Tensor:
    _check_attention(cfg)
    h = frames.to(cfg.activation_dtype)
    h = h + params["enc_pos"][None, :h.shape[1]].to(h.dtype)
    for p in tree_unstack(params["enc_blocks"]):
        if remat:
            h = checkpoint(_enc_block, cfg, p, h, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _enc_block(cfg, p, h)
    return L.layernorm(params["ln_enc_final"], h, cfg.norm_eps)


def encode(cfg: LMConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, n_frames, d_model) stubbed conv-frontend output ->
    the encoder's (B, n_frames, d_model) memory."""
    return _encode(cfg, params, frames, _remat(cfg, params))


def _cross_kv(cfg: LMConfig, p: dict, memory: torch.Tensor):
    """The cross-attention's keys and values of ``memory``: (B, m, H, D)
    each."""
    b, m, _ = memory.shape
    hd = cfg.resolved_head_dim
    k = L.dense(p["cross_attn"]["wk"], memory).reshape(b, m, cfg.num_heads,
                                                       hd)
    v = L.dense(p["cross_attn"]["wv"], memory).reshape(b, m, cfg.num_heads,
                                                       hd)
    return k, v


def _dec_block(cfg: LMConfig, p: dict, h: torch.Tensor,
               memory: torch.Tensor):
    """A decoder block over positions ``0 .. S−1``: causal self-attention,
    cross-attention over ``memory``, the GELU MLP, each residual.
    Returns ``(h, (k, v), (kc, vc))``: the self-attention's keys and
    values (B, S, Hkv, D) and the cross-attention's (B, m, H, D)."""
    b, s = h.shape[:2]
    hd = cfg.resolved_head_dim
    hn = L.layernorm(p["ln_self"], h, cfg.norm_eps)
    q, k, v = L.gqa_project(p["self_attn"], hn, cfg.num_heads,
                            cfg.num_kv_heads, hd)
    out = _attend(q, k, v, causal=True, window=cfg.sliding_window)
    h = h + L.dense(p["self_attn"]["wo"], out.reshape(b, s, -1))
    hn = L.layernorm(p["ln_cross"], h, cfg.norm_eps)
    qc = L.dense(p["cross_attn"]["wq"], hn).reshape(b, s, cfg.num_heads, hd)
    kc, vc = _cross_kv(cfg, p, memory)
    out = _attend(qc, kc, vc, causal=False)
    h = h + L.dense(p["cross_attn"]["wo"], out.reshape(b, s, -1))
    h = h + L.gelu_mlp(p["ffn"], L.layernorm(p["ln_ffn"], h, cfg.norm_eps))
    return h, (k, v), (kc, vc)


def _dec_residual(cfg: LMConfig, p: dict, h, memory):
    return _dec_block(cfg, p, h, memory)[0]


def _embed_tokens(cfg: LMConfig, params, tokens) -> torch.Tensor:
    h = L.embed(params["embed"], tokens, cfg.activation_dtype)
    positions = torch.arange(tokens.shape[1], device=h.device)
    return h + _dec_positions(params, positions)[None].to(h.dtype)


def forward_train(cfg: LMConfig, params, tokens, *, audio_embeds):
    """Teacher-forced decoder over the encoded audio: (B, S) tokens and
    (B, m, d) frames -> ((B, S, V) logits, a float32 zero aux loss).
    With ``cfg.remat``, when gradients are taken, each encoder and decoder
    layer keeps only its inputs and runs its forward again in the
    backward."""
    remat = _remat(cfg, params)
    memory = _encode(cfg, params, audio_embeds, remat)
    h = _embed_tokens(cfg, params, tokens)
    for p in tree_unstack(params["dec_blocks"]):
        if remat:
            h = checkpoint(_dec_residual, cfg, p, h, memory,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = _dec_residual(cfg, p, h, memory)
    h = L.layernorm(params["ln_dec_final"], h, cfg.norm_eps)
    logits = L.dense(params["unembed"], h)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg: LMConfig, params, tokens, labels, *, audio_embeds):
    """``(ce, {"ce": ce})``: the token-mean cross-entropy of
    ``forward_train``'s logits (in ``logits_chunk`` chunks)."""
    logits, _ = forward_train(cfg, params, tokens, audio_embeds=audio_embeds)
    ce = cross_entropy(logits, labels, chunk=cfg.logits_chunk)
    return ce, {"ce": ce}


def make_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> dict:
    """Decode cache: the self-attention's keys and values per layer
    ``(L, B, max_len, Hkv, D)``, each slot's position ``(B, max_len)``
    (−1: empty), and the cross-attention's keys and values of the
    encoder's ``encoder_seq_len`` frames ``(L, B, m, H, D)``."""
    _check_family(cfg)
    dev = resolve_device(device)
    hd, lyr, act = cfg.resolved_head_dim, cfg.num_layers, cfg.activation_dtype
    self_shape = (lyr, batch, max_len, cfg.num_kv_heads, hd)
    cross_shape = (lyr, batch, cfg.encoder_seq_len, cfg.num_heads, hd)
    return {
        "k": torch.zeros(self_shape, dtype=act, device=dev),
        "v": torch.zeros(self_shape, dtype=act, device=dev),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=dev),
        "cross_k": torch.zeros(cross_shape, dtype=act, device=dev),
        "cross_v": torch.zeros(cross_shape, dtype=act, device=dev),
    }


def prefill(cfg: LMConfig, params, tokens, *, audio_embeds):
    """(B, S) tokens over (B, m, d) frames -> ((B, V) last-position
    logits, a cache whose self-attention part has the prompt's length)."""
    memory = encode(cfg, params, audio_embeds)
    b, s = tokens.shape
    h = _embed_tokens(cfg, params, tokens)
    ks, vs, kcs, vcs = [], [], [], []
    for p in tree_unstack(params["dec_blocks"]):
        h, (k, v), (kc, vc) = _dec_block(cfg, p, h, memory)
        ks.append(k)
        vs.append(v)
        kcs.append(kc)
        vcs.append(vc)
    hl = L.layernorm(params["ln_dec_final"], h[:, -1:], cfg.norm_eps)
    logits = L.dense(params["unembed"], hl)[:, 0]
    pos = torch.arange(s, device=h.device, dtype=torch.int32)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "pos": pos[None].repeat(b, 1),
                    "cross_k": torch.stack(kcs), "cross_v": torch.stack(vcs)}


def decode_step(cfg: LMConfig, params, cache: dict, token, pos):
    """One token (B, 1) at positions ``pos`` (B,) through every decoder
    layer: its self-attention key and value written at slot ``pos % W``
    under a decode window (a ring buffer), else ``min(pos, W − 1)``, then
    attention over the self cache and over the cached cross keys and
    values.  Returns ((B, V) logits, the new cache; the given one is not
    modified)."""
    hd = cfg.resolved_head_dim
    b = token.shape[0]
    h = L.embed(params["embed"], token, cfg.activation_dtype)
    h = h + _dec_positions(params, pos[:, None]).to(h.dtype)
    slot, new_pos = decode_slots(cache, pos, bool(cfg.decode_window))
    window = cfg.decode_window or cfg.sliding_window
    m = cache["cross_k"].shape[2]
    q_cross = torch.full((b,), m, dtype=torch.int32, device=h.device)
    kv_cross = torch.arange(m, device=h.device, dtype=torch.int32)[None] \
        .expand(b, m)
    bidx = torch.arange(b, device=h.device)
    ks, vs = cache["k"].clone(), cache["v"].clone()
    for i, p in enumerate(tree_unstack(params["dec_blocks"])):
        hn = L.layernorm(p["ln_self"], h, cfg.norm_eps)
        q, k, v = L.gqa_project(p["self_attn"], hn, cfg.num_heads,
                                cfg.num_kv_heads, hd)
        ks[i][bidx, slot] = k[:, 0].to(ks.dtype)
        vs[i][bidx, slot] = v[:, 0].to(vs.dtype)
        out = L.decode_attention(q, ks[i], vs[i], q_position=pos,
                                 kv_positions=new_pos, window=window)
        h = h + L.dense(p["self_attn"]["wo"], out.reshape(b, 1, -1))
        hn = L.layernorm(p["ln_cross"], h, cfg.norm_eps)
        qc = L.dense(p["cross_attn"]["wq"], hn).reshape(b, 1, cfg.num_heads,
                                                        hd)
        out = L.decode_attention(qc, cache["cross_k"][i],
                                 cache["cross_v"][i], q_position=q_cross,
                                 kv_positions=kv_cross)
        h = h + L.dense(p["cross_attn"]["wo"], out.reshape(b, 1, -1))
        h = h + L.gelu_mlp(p["ffn"], L.layernorm(p["ln_ffn"], h,
                                                 cfg.norm_eps))
    h = L.layernorm(params["ln_dec_final"], h, cfg.norm_eps)
    logits = L.dense(params["unembed"], h)[:, 0]
    return logits, {"k": ks, "v": vs, "pos": new_pos,
                    "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}
