"""internlm2-1.8b — dense, GQA [arXiv:2403.17297]."""

import torch

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    decode_window=8192,        # long_500k SWA decode variant only
    remat=True,
    param_dtype=torch.bfloat16,
    activation_dtype=torch.bfloat16,
    logits_chunk=512,
    source="arXiv:2403.17297",
)
