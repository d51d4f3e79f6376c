"""mixtral-8x22b — MoE 8 experts top-2, SWA [arXiv:2401.04088]."""

import torch

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    num_experts_per_tok=2,
    moe_capacity_factor=1.25,
    moe_impl="dense_scan",     # every expert on every token (E/k × FLOPs)
    sliding_window=4096,
    param_dtype=torch.bfloat16,
    activation_dtype=torch.bfloat16,
    remat=True,
    logits_chunk=512,
    source="arXiv:2401.04088",
)
