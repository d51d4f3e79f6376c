"""DiT expert and router configuration (copy of ``repro.models.config``'s
DiT part, with ``torch.dtype`` fields).

The reference module imports ``jax.numpy`` for its dtype defaults, so the
port keeps its own copy of the dataclass and the canonical paper
architectures.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Diffusion Transformer expert (paper §2.5 / §6.2)."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    patch_size: int = 2
    latent_size: int = 32                # 32x32x4 VAE latents
    latent_channels: int = 4
    mlp_ratio: float = 4.0
    text_dim: int = 768                  # frozen CLIP ViT-L/14
    text_len: int = 77
    use_text: bool = True                # router variant sets False
    num_classes: int = 0                 # router classifier head size
    adaln_single: bool = True            # PixArt-α AdaLN-Single (Eq. 14-16)
    param_dtype: Any = torch.float32
    activation_dtype: Any = torch.float32
    num_timesteps: int = 1000            # discrete embedding table (Eq. 21)
    attn_chunk: int = 256

    @property
    def num_tokens(self) -> int:
        return (self.latent_size // self.patch_size) ** 2

    @property
    def d_ff(self) -> int:
        return int(self.d_model * self.mlp_ratio)

    def reduced(self, **overrides) -> "DiTConfig":
        upd = dict(
            num_layers=2,
            d_model=128,
            num_heads=4,
            latent_size=8,
            text_dim=32,
            text_len=8,
            attn_chunk=32,
        )
        upd.update(overrides)
        return dataclasses.replace(self, **upd)


# Canonical paper architectures (§6.2, §6.3).
def dit_xl2(**kw) -> DiTConfig:
    return DiTConfig(
        name="dit-xl2", num_layers=28, d_model=1152, num_heads=16, **kw
    )


def dit_b2(**kw) -> DiTConfig:
    return DiTConfig(
        name="dit-b2", num_layers=12, d_model=768, num_heads=12, **kw
    )


def router_b2(num_clusters: int = 8, **kw) -> DiTConfig:
    """Router: DiT-B/2 without text conditioning, classifier head (§6.3)."""
    return DiTConfig(
        name="router-b2", num_layers=12, d_model=768, num_heads=12,
        use_text=False, num_classes=num_clusters, **kw
    )
