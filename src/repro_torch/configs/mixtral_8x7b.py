"""mixtral-8x7b — MoE 8 experts top-2, SWA [arXiv:2401.04088]."""

import torch

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
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
