"""Unified model-zoo dispatch (port of ``repro.models.zoo``).

One interface over the backbone modules:

    init(cfg, gen, device) -> params
    loss_fn(cfg, params, batch) -> (loss, metrics)
    forward_train(cfg, params, batch) -> (logits, aux)
    prefill(cfg, params, batch) -> (logits, cache)
    make_cache(cfg, batch_size, max_len, device) -> cache
    decode_step(cfg, params, cache, token, pos) -> (logits, cache)

``batch`` is a dict holding ``tokens`` (and ``labels`` for the loss;
``audio_embeds`` or ``vision_embeds`` for the stubbed-frontend families,
as in the reference).  The port serves and trains all of the reference's
families: ``ssm`` (``models.mamba2``), ``hybrid`` (``models.hybrid``),
``dense``, ``moe`` and ``vlm`` (``models.transformer``; the VLM takes the
batch's ``vision_embeds`` as its bidirectional prefix) and ``audio``
(``models.encdec``, which takes the batch's ``audio_embeds``).  ``init``
takes a ``torch.Generator`` where the reference takes a PRNG key.
"""

from __future__ import annotations

from repro_torch.models import encdec, hybrid, mamba2, transformer
from repro_torch.models.config import LMConfig

_FAMILY = {"ssm": mamba2, "hybrid": hybrid, "dense": transformer,
           "moe": transformer, "vlm": transformer, "audio": encdec}


def backbone(cfg: LMConfig):
    if cfg.arch_type not in _FAMILY:
        raise ValueError(
            f"unknown arch_type {cfg.arch_type!r} ({cfg.name}); the zoo's "
            f"families: {', '.join(map(repr, _FAMILY))}")
    return _FAMILY[cfg.arch_type]


def init(cfg: LMConfig, gen, device=None):
    return backbone(cfg).init(cfg, gen, device)


def _extra_kwargs(cfg: LMConfig, batch: dict) -> dict:
    if cfg.arch_type == "audio":
        return {"audio_embeds": batch["audio_embeds"]}
    if cfg.arch_type == "vlm":
        return {"vision_embeds": batch["vision_embeds"]}
    return {}


def loss_fn(cfg: LMConfig, params, batch: dict):
    m = backbone(cfg)
    return m.loss_fn(cfg, params, batch["tokens"], batch["labels"],
                     **_extra_kwargs(cfg, batch))


def forward_train(cfg: LMConfig, params, batch: dict):
    return backbone(cfg).forward_train(cfg, params, batch["tokens"],
                                       **_extra_kwargs(cfg, batch))


def prefill(cfg: LMConfig, params, batch: dict):
    return backbone(cfg).prefill(cfg, params, batch["tokens"],
                                 **_extra_kwargs(cfg, batch))


def make_cache(cfg: LMConfig, batch_size: int, max_len: int, device=None):
    return backbone(cfg).make_cache(cfg, batch_size, max_len, device)


def decode_step(cfg: LMConfig, params, cache, token, pos):
    return backbone(cfg).decode_step(cfg, params, cache, token, pos)


def supports_long_context(cfg: LMConfig) -> bool:
    """True when 500k-token decode is sub-quadratic or O(1)-state: the SSM
    natively, every other family only under a sliding or decode window (a
    ring-buffer cache), as the reference decides."""
    if cfg.arch_type == "ssm":
        return True
    return bool(cfg.decode_window or cfg.sliding_window)
