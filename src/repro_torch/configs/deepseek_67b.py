"""deepseek-67b — dense llama-arch, GQA [arXiv:2401.02954]."""

import torch

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="deepseek-67b",
    arch_type="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    decode_window=8192,        # long_500k SWA decode variant only
    param_dtype=torch.bfloat16,
    activation_dtype=torch.bfloat16,
    remat=True,
    fsdp_params=True,
    logits_chunk=512,
    source="arXiv:2401.02954",
)
