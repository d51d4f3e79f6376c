"""deepseek-coder-33b — dense llama-arch, GQA [arXiv:2401.14196]."""

import torch

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100000.0,
    decode_window=8192,        # long_500k SWA decode variant only
    param_dtype=torch.bfloat16,
    activation_dtype=torch.bfloat16,
    remat=True,
    logits_chunk=512,
    source="arXiv:2401.14196",
)
