"""Step functions and input specs for launch: train, prefill, decode
(port of ``repro.launch.steps``).

``input_specs``, ``param_shapes`` and ``opt_shapes`` return trees of
tensors on the ``meta`` device, the port's stand-in for the reference's
``ShapeDtypeStruct``s: shapes and dtypes, no storage, so a 2.7B-parameter
tree comes back without touching the card.  The step builders close over
configs only.  The port runs every family of the reference (a decode
step's inputs hold their caches: SSM states, KV caches, slot positions
and the encoder-decoder's cross-attention keys and values; a training or
prefill batch of the audio family its stubbed frame embeddings, of the
VLM family its stubbed patch embeddings).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.launch import fsdp
from repro_torch.models import zoo
from repro_torch.models.config import LMConfig
from repro_torch.models.frontend_stubs import audio_spec, vision_spec
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update_)
from repro_torch.training.trainer import value_and_grad
from repro_torch.tree import tree_map

META = torch.device("meta")


def cfg_for_shape(cfg: LMConfig, shape: InputShape) -> tuple[LMConfig, int]:
    """Resolve the (config variant, cache length) for an input shape.

    decode_32k keeps the full seq_len cache (ring-buffering disabled);
    long_500k uses the sub-quadratic variant: ring-buffer window for
    attention archs (cfg.decode_window / native sliding_window), O(1)
    state for SSM.
    """
    if shape.kind != "decode":
        return cfg, shape.seq_len
    if cfg.arch_type == "ssm":
        return cfg, 0
    window = cfg.decode_window or cfg.sliding_window
    if shape.seq_len > 100_000:
        if not window:
            raise ValueError(
                f"{cfg.name} has no sub-quadratic variant for {shape.name}"
            )
        return dataclasses.replace(cfg, decode_window=window), window
    # 32k decode: full cache, exact attention (window masking still applies
    # for natively-SWA archs through cfg.sliding_window).
    return dataclasses.replace(cfg, decode_window=0), shape.seq_len


def input_specs(cfg: LMConfig, shape: InputShape) -> dict:
    """Meta-device stand-ins for every model input of this shape."""
    b, s = shape.global_batch, shape.seq_len
    tok = torch.empty((b, s), dtype=torch.int32, device=META)
    if shape.kind in ("train", "prefill"):
        batch = ({"tokens": tok, "labels": tok} if shape.kind == "train"
                 else {"tokens": tok})
        if cfg.arch_type == "audio":
            batch["audio_embeds"] = audio_spec(cfg, b)
        if cfg.arch_type == "vlm":
            batch["vision_embeds"] = vision_spec(cfg, b)
        return {"batch": batch}
    # decode: ONE new token against a seq_len cache.
    rcfg, cache_len = cfg_for_shape(cfg, shape)
    return {
        "cache": zoo.make_cache(rcfg, b, max(cache_len, 1), device=META),
        "token": torch.empty((b, 1), dtype=torch.int32, device=META),
        "pos": torch.empty((b,), dtype=torch.int32, device=META),
    }


def param_shapes(cfg: LMConfig) -> Any:
    return zoo.init(cfg, None, META)


def opt_shapes(cfg: LMConfig) -> Any:
    return adamw_init(param_shapes(cfg))


def make_grad_step(cfg: LMConfig, *, microbatches: int = 1):
    """The loss and gradients of a batch: ``grad_step(params, batch) ->
    (loss, grads)`` (``make_train_step``'s first half).

    ``microbatches > 1`` runs gradient accumulation: the batch is split
    along its leading axis and the microbatches run one after another,
    their float32 gradients and losses summed, then scaled by
    ``1/microbatches``; peak activation memory scales with the microbatch.
    Under an installed FSDP policy (``launch.fsdp``) ``params`` and
    ``batch`` are this rank's cuts and block, and the loss and gradients
    come back as the global batch's (``fsdp.mean_loss``,
    ``fsdp.sync_gradients``; each rank's cut of the cut leaves).
    """
    def grad_fn(params, batch):
        return value_and_grad(lambda p: zoo.loss_fn(cfg, p, batch), params,
                              has_aux=True)

    def grad_step(params, batch):
        if microbatches == 1:
            (loss, _), grads = grad_fn(params, batch)
        else:
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                (li, _), g = grad_fn(params, {k: v[i] for k, v in mb.items()})
                grads = tree_map(torch.add, grads, g)
                loss = loss + li
            inv = 1.0 / microbatches
            grads = tree_map(lambda g: g * inv, grads)
            loss = loss * inv
        return fsdp.mean_loss(loss), fsdp.sync_gradients(grads)

    return grad_step


def apply_update(opt: AdamWConfig, grads, opt_state, params):
    """AdamW in place (``adamw_update_``; ``make_train_step``'s second
    half), its global norm over every rank's cut under an FSDP policy.
    Returns ``(params, opt_state, metrics)`` (``grad_norm``, ``lr``)."""
    return adamw_update_(opt, grads, opt_state, params)


def make_train_step(cfg: LMConfig, opt: AdamWConfig | None = None,
                    *, microbatches: int = 1):
    """Full optimizer step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)``: ``make_grad_step``, then
    ``apply_update``.  The AdamW update runs in place: the step consumes
    ``params`` and ``opt_state``, as the trainer's LM step does.  Under
    an FSDP policy a rank passes its cuts (``fsdp.shard_params`` of the
    parameters and of ``adamw_init``'s moments) and its batch block, and
    gets the global batch's loss.
    """
    opt = opt or AdamWConfig()
    grad_step = make_grad_step(cfg, microbatches=microbatches)

    def train_step(params, opt_state, batch):
        loss, grads = grad_step(params, batch)
        params, opt_state, _ = apply_update(opt, grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def make_prefill_step(cfg: LMConfig):
    def prefill_step(params, batch):
        return zoo.prefill(cfg, params, batch)

    return prefill_step


def make_serve_step(cfg: LMConfig, shape: InputShape):
    rcfg, _ = cfg_for_shape(cfg, shape)

    def serve_step(params, cache, token, pos):
        return zoo.decode_step(rcfg, params, cache, token, pos)

    return serve_step
