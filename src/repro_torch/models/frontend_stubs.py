"""Modality frontend stubs (port of ``repro.models.frontend_stubs``).

Audio (whisper): the mel-spectrogram + conv feature extractor is stubbed
— the encoder takes precomputed frame embeddings ``(B, n_frames,
d_model)``.  Vision (paligemma): the SigLIP ViT encoder + projector is
stubbed — patch embeddings ``(B, vision_prefix_len, d_model)``.

Both stubs are deterministic functions of a seed, drawn from a
``torch.Generator`` seeded with it on ``device`` (``None`` → the card):
the reference's distribution (standard normal), shape and dtype, other
numbers, as ``data.pipeline.lm_batch`` draws its tokens.  The specs are
``meta``-device tensors, the port's stand-in for the reference's
``ShapeDtypeStruct``s (``launch.steps``).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import LMConfig
from repro_torch.weights import resolve_device

META = torch.device("meta")


def _normal(shape, seed: int, dtype, device) -> torch.Tensor:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)


def audio_frame_embeddings(cfg: LMConfig, batch: int, seed: int = 0,
                           device=None) -> torch.Tensor:
    """Stand-in for the log-mel + conv1d×2 frontend's output:
    ``(batch, encoder_seq_len, d_model)`` in the activation dtype."""
    return _normal((batch, cfg.encoder_seq_len, cfg.d_model), seed,
                   cfg.activation_dtype, device)


def vision_patch_embeddings(cfg: LMConfig, batch: int, seed: int = 0,
                            device=None) -> torch.Tensor:
    """Stand-in for SigLIP-So400m patch embeddings (already projected):
    ``(batch, vision_prefix_len, d_model)`` in the activation dtype."""
    return _normal((batch, cfg.vision_prefix_len, cfg.d_model), seed,
                   cfg.activation_dtype, device)


def audio_spec(cfg: LMConfig, batch: int) -> torch.Tensor:
    return torch.empty((batch, cfg.encoder_seq_len, cfg.d_model),
                       dtype=cfg.activation_dtype, device=META)


def vision_spec(cfg: LMConfig, batch: int) -> torch.Tensor:
    return torch.empty((batch, cfg.vision_prefix_len, cfg.d_model),
                       dtype=cfg.activation_dtype, device=META)
