"""Stub DINOv2 feature extractor (modality-frontend carve-out).

Port of ``repro.data.features``: a frozen, deterministic random-projection
network over latents standing in for the paper's 1024-d DINOv2-ViT-L/14
[CLS] features.  Two frozen branches are combined:

* a 2-layer random projection of the full latent (fine-grained, low SNR);
* spatially pooled per-channel statistics projected to the same space,
  weighted up (pooling averages the per-pixel noise down, so this branch
  carries most of the class-discriminative signal).

The frozen weights are standard normal draws from a ``torch.Generator``
seeded with ``seed`` (the reference draws them with JAX's threefry: the
same distribution, other numbers), or handed in as ``weights``.
"""

from __future__ import annotations

import functools
import math

import torch

FEATURE_DIM = 1024

#: relative weight of the pooled (high-SNR) branch in the unit-norm output.
POOLED_GAIN = 3.0

_HIDDEN = 512


@functools.lru_cache(maxsize=8)
def _frozen_weights(in_dim: int, pooled_dim: int, seed: int = 7,
                    device: str = "cpu"):
    """``(w1 (in, 512), w2 (512, 1024), w3 (pooled, 1024))``, each
    N(0, 1/fan_in), drawn on the CPU and kept on ``device``."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen)
                / math.sqrt(max(fan_in, 1))).to(device)

    return (normal((in_dim, _HIDDEN), in_dim),
            normal((_HIDDEN, FEATURE_DIM), _HIDDEN),
            normal((pooled_dim, FEATURE_DIM), pooled_dim))


def _unit(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=eps)


@torch.no_grad()
def extract_features(latents: torch.Tensor, *, seed: int = 7,
                     weights=None) -> torch.Tensor:
    """(B, H, W, C) latents -> (B, 1024) unit-norm 'DINOv2' features, on
    the latents' device.  ``weights`` ``(w1, w2, w3)`` replaces the frozen
    draws of ``seed``."""
    b, c = latents.shape[0], latents.shape[-1]
    x = latents.reshape(b, -1).to(torch.float32)
    pooled = latents.to(torch.float32).mean(dim=(1, 2))        # (B, C)
    if weights is None:
        weights = _frozen_weights(x.shape[1], c, seed, str(latents.device))
    w1, w2, w3 = (torch.as_tensor(w, dtype=torch.float32,
                                  device=latents.device) for w in weights)
    h = torch.tanh(x @ w1)
    fine = _unit(h @ w2)
    coarse = _unit(pooled @ w3)
    return _unit(fine + POOLED_GAIN * coarse)
