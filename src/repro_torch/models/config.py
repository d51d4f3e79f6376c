"""Architecture configuration dataclasses (copy of
``repro.models.config``, with ``torch.dtype`` fields).

The reference module imports ``jax.numpy`` for its dtype defaults, so the
port keeps its own copy of the dataclasses: ``LMConfig`` (the sequence
backbones of the LM-expert ensemble; the port serves all of the
reference's families) and ``DiTConfig``
with the canonical paper architectures.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Sequence-model backbone config of the LM-expert ensemble.

    The port serves and trains ``arch_type`` ``"ssm"`` (Mamba2),
    ``"hybrid"`` (Zamba2), ``"dense"`` (GQA transformers), ``"moe"``
    (the GQA transformer with a top-k routed SwiGLU expert layer in place
    of its FFN: Mixtral), ``"audio"`` (Whisper's encoder-decoder over
    stubbed frame embeddings) and ``"vlm"`` (PaliGemma: the GQA
    transformer after a bidirectional prefix of stubbed patch
    embeddings), and keeps the fields those backbones, the
    frontend stubs and ``launch.steps`` read; a later backbone adds the
    fields it needs.  Attention of every backbone runs
    through the flash attention kernel, which computes the reference's
    float32-softmax attention whatever ``attn_chunk`` and
    ``attn_kv_chunk`` (the reference's XLA blockings of the same
    function) say; ``attn_f32_softmax=False`` (the reference's bf16
    softmax chain, another function) is not ported.
    """

    name: str
    arch_type: str
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0                    # 0 = attention-free
    num_kv_heads: int = 0
    d_ff: int = 0                         # SwiGLU width
    head_dim: int = 0                     # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    moe_impl: str = "dropping"            # see ``layers.moe_apply``
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # --- hybrid (zamba2-style shared attention) ---
    attn_every: int = 0                   # shared attn block period; 0 = none
    # --- attention variant ---
    sliding_window: int = 0               # native SWA width, 0 = full
    decode_window: int = 0                # ring-buffer decode window
    rope_theta: float = 10000.0
    # --- enc-dec (whisper backbone) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0           # 0 -> num_layers
    encoder_seq_len: int = 1500           # mel-frame embeddings (stub)
    # --- VLM (paligemma backbone) ---
    vision_prefix_len: int = 0            # SigLIP patch embeddings (stub)
    # --- numerics ---
    norm_eps: float = 1e-5
    attn_chunk: int = 512
    attn_kv_chunk: int = 0
    attn_f32_softmax: bool = True
    logits_chunk: int = 0                 # 0 = unchunked loss
    param_dtype: Any = torch.float32
    activation_dtype: Any = torch.float32
    remat: bool = False                   # recompute each layer's forward
    aux_loss_weight: float = 0.01         # the MoE load-balance loss weight
    source: str = ""                      # citation for the config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def reduced(self, **overrides) -> "LMConfig":
        """Smoke-test variant, by the reference's rules: 2 layers,
        d_model<=256, at most 4 heads (kv heads at most the heads,
        ``head_dim = d_model // heads``), d_ff<=512, vocab<=512, at most 4
        experts, attention chunks of 64, a shared attention block after
        every layer, 2 encoder layers over at most 16 frames, at most 8
        vision patches."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        upd: dict[str, Any] = dict(
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=min(self.num_kv_heads, heads),
            head_dim=(d // heads) if heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            decode_window=min(self.decode_window, 64)
            if self.decode_window else 0,
            encoder_seq_len=min(self.encoder_seq_len, 16),
            vision_prefix_len=min(self.vision_prefix_len, 8),
            attn_chunk=64,
            param_dtype=torch.float32,
            activation_dtype=torch.float32,
            remat=False,
        )
        if self.num_experts:
            upd["num_experts"] = min(self.num_experts, 4)
        if self.num_encoder_layers:
            upd["num_encoder_layers"] = 2
        if self.ssm_state:
            upd["ssm_state"] = min(self.ssm_state, 16)
            upd["ssm_headdim"] = 32
            upd["ssm_chunk"] = 16
        if self.attn_every:
            upd["attn_every"] = 1
        upd.update(overrides)
        return dataclasses.replace(self, **upd)


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
