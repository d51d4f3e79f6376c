"""Unified model-zoo dispatch (port of ``repro.models.zoo``).

One interface over the backbone modules:

    init(cfg, gen, device) -> params
    forward_train(cfg, params, batch) -> (logits, aux)
    prefill(cfg, params, batch) -> (logits, cache)
    make_cache(cfg, batch_size, max_len, device) -> cache
    decode_step(cfg, params, cache, token, pos) -> (logits, cache)

``batch`` is a dict holding ``tokens``.  The port serves the ``ssm``
family (``models.mamba2``); the other families raise
``NotImplementedError`` (ROADMAP.md, module queue A.10).  ``init`` takes
a ``torch.Generator`` where the reference takes a PRNG key.
"""

from __future__ import annotations

from repro_torch.models import mamba2
from repro_torch.models.config import LMConfig

_FAMILY = {"ssm": mamba2}


def backbone(cfg: LMConfig):
    if cfg.arch_type not in _FAMILY:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}) is not ported yet: "
            f"the port serves 'ssm' (ROADMAP.md, module queue A.10)")
    return _FAMILY[cfg.arch_type]


def init(cfg: LMConfig, gen, device=None):
    return backbone(cfg).init(cfg, gen, device)


def forward_train(cfg: LMConfig, params, batch: dict):
    return backbone(cfg).forward_train(cfg, params, batch["tokens"])


def prefill(cfg: LMConfig, params, batch: dict):
    return backbone(cfg).prefill(cfg, params, batch["tokens"])


def make_cache(cfg: LMConfig, batch_size: int, max_len: int, device=None):
    return backbone(cfg).make_cache(cfg, batch_size, max_len, device)


def decode_step(cfg: LMConfig, params, cache, token, pos):
    return backbone(cfg).decode_step(cfg, params, cache, token, pos)
