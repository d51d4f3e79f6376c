"""mamba2-2.7b — attention-free SSM, SSD (state-space duality)
[arXiv:2405.21060]."""

import torch

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,            # d_inner 5120 -> 80 SSD heads
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=128,
    param_dtype=torch.bfloat16,
    activation_dtype=torch.bfloat16,
    remat=True,
    logits_chunk=512,
    source="arXiv:2405.21060",
)
