"""zamba2-2.7b — hybrid: Mamba2 trunk + shared attention blocks
[arXiv:2411.15242]."""

import torch

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,                # shared attention block's MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=128,
    attn_every=6,              # 9 applications of the shared block
    decode_window=8192,        # shared attn uses SWA for long_500k
    param_dtype=torch.bfloat16,
    activation_dtype=torch.bfloat16,
    remat=True,
    logits_chunk=512,
    source="arXiv:2411.15242",
)
