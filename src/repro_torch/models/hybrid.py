"""Zamba2-style hybrid backbone [arXiv:2411.15242] (port of
``repro.models.hybrid``).

A Mamba2 trunk with one *shared* attention block (one parameter set, a
dense transformer block: RMSNorm, causal GQA with RoPE, RMSNorm, SwiGLU;
``transformer.block_init`` / ``block_apply`` / ``block_decode``) applied
after every ``attn_every`` mamba layers.  Each application sees another
input, so decode keeps one KV cache per application.  zamba2-2.7b: 54 mamba layers,
the shared block after every 6 (9 applications).

The parameter dict has the reference's layout: mamba blocks stacked
``(groups, per_group, ...)`` and one ``shared_attn``, so a reference tree
carries over leaf by leaf.  Every mixer of ``forward_train`` and
``prefill`` starts from the zero state and runs the ``ssd_scan`` kernel
(``mamba2.mixer_apply``); every application of the shared block attends
through the ``flash_attention`` kernel.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models.config import LMConfig
from repro_torch.tree import (tree_leaves, tree_map, tree_stack_layers,
                              tree_unstack)
from repro_torch.weights import resolve_device


def num_groups(cfg: LMConfig) -> int:
    if not cfg.attn_every or cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into groups of attn_every={cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def init(cfg: LMConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's structure and init scheme,
    drawn from ``gen`` on ``device`` (``None`` → ``"cuda"``)."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    g, per = num_groups(cfg), cfg.attn_every
    blocks = tree_map(lambda a: a.reshape((g, per) + a.shape[1:]),
                      tree_stack_layers(lambda: M.block_init(cfg, gen, dev),
                                        cfg.num_layers))
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev,
                              dtype=pd),
        "blocks": blocks,
        "shared_attn": T.block_init(cfg, gen, dev),
        "ln_final": L.rmsnorm_init(cfg.d_model, device=dev, dtype=pd),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                device=dev, dtype=pd),
    }


def _groups(cfg: LMConfig, params) -> list[list[dict]]:
    """Every group's mamba blocks as views of the stack, each leaf unbound
    once."""
    per = cfg.attn_every
    layers = tree_unstack(tree_map(lambda a: a.flatten(0, 1),
                                   params["blocks"]))
    return [layers[i:i + per] for i in range(0, len(layers), per)]


def _group(cfg: LMConfig, group: list[dict], shared: dict, h, positions):
    """One group's mamba blocks from the zero state, then the shared
    block (the reference's scan body ``outer``)."""
    for bp in group:
        h = M.residual(cfg, bp, h)
    return T.block_apply(cfg, shared, h, positions)[0]


def forward_train(cfg: LMConfig, params, tokens):
    """(B, S) tokens -> ((B, S, V) logits, zero aux loss).  With
    ``cfg.remat``, when gradients are taken, each group keeps only its
    input and runs its forward again in the backward."""
    remat = cfg.remat and torch.is_grad_enabled() and any(
        a.requires_grad for a in tree_leaves(params))
    h = L.embed(params["embed"], tokens, cfg.activation_dtype)
    positions = torch.arange(tokens.shape[1], device=h.device)
    for group in _groups(cfg, params):
        if remat:
            h = checkpoint(_group, cfg, group, params["shared_attn"], h,
                           positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _group(cfg, group, params["shared_attn"], h, positions)
    h = L.rmsnorm(params["ln_final"], h, cfg.norm_eps)
    logits = L.dense(params["unembed"], h)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg: LMConfig, params, tokens, labels):
    logits, _ = forward_train(cfg, params, tokens)
    ce = T.cross_entropy(logits, labels, chunk=cfg.logits_chunk)
    return ce, {"ce": ce}


def make_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> dict:
    """Hybrid cache: per-layer conv tails and SSM states, and one KV cache
    per application of the shared block ``(groups, B, max_len, Hkv, D)``
    with each slot's position ``(B, max_len)`` (−1: empty)."""
    dev = resolve_device(device)
    cache = M.make_cache(cfg, batch, device=dev)
    shape = (num_groups(cfg), batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    cache["k"] = torch.zeros(shape, dtype=cfg.activation_dtype, device=dev)
    cache["v"] = torch.zeros(shape, dtype=cfg.activation_dtype, device=dev)
    cache["pos"] = torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=dev)
    return cache


def prefill(cfg: LMConfig, params, tokens):
    """(B, S) tokens -> ((B, V) last-position logits, the decode cache,
    its KV caches of the prompt's length)."""
    h = L.embed(params["embed"], tokens, cfg.activation_dtype)
    b, s = tokens.shape
    positions = torch.arange(s, device=h.device)
    convs, states, ks, vs = [], [], [], []
    for group in _groups(cfg, params):
        for bp in group:
            h, (conv, state) = M.block_apply(cfg, bp, h)
            convs.append(conv)
            states.append(state)
        h, (k, v), _ = T.block_apply(cfg, params["shared_attn"], h,
                                     positions)
        ks.append(k)
        vs.append(v)
    hl = L.rmsnorm(params["ln_final"], h[:, -1:], cfg.norm_eps)
    logits = L.dense(params["unembed"], hl)[:, 0]
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(states),
                    "k": torch.stack(ks), "v": torch.stack(vs),
                    "pos": positions.to(torch.int32)[None].repeat(b, 1)}


def decode_step(cfg: LMConfig, params, cache: dict, token, pos):
    """One token (B, 1) at positions ``pos`` (B,): every mixer's decode
    update, and every application of the shared block attending over its
    own KV cache, the new key and value at slot ``pos % W`` under a window
    (a ring buffer), else ``min(pos, W − 1)``.  Returns ((B, V) logits, the
    new cache; the given one is not modified)."""
    h = L.embed(params["embed"], token, cfg.activation_dtype)
    window = cfg.decode_window or cfg.sliding_window
    slot, new_pos = T.decode_slots(cache, pos, bool(window))
    ks, vs = cache["k"].clone(), cache["v"].clone()
    convs, states = [], []
    i = 0
    for g, group in enumerate(_groups(cfg, params)):
        for bp in group:
            y, (conv, state) = M.mixer_apply(
                cfg, bp["mixer"], L.rmsnorm(bp["ln"], h, cfg.norm_eps),
                conv_state=cache["conv"][i], ssm_state=cache["ssm"][i],
                mode="decode")
            h = h + y
            convs.append(conv)
            states.append(state)
            i += 1
        h = T.block_decode(cfg, params["shared_attn"], h, pos, ks[g], vs[g],
                           slot, new_pos, window)
    h = L.rmsnorm(params["ln_final"], h, cfg.norm_eps)
    logits = L.dense(params["unembed"], h)[:, 0]
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(states),
                    "k": ks, "v": vs, "pos": new_pos}
