"""stablelm-1.6b — dense, MHA (kv=heads) [hf:stabilityai/stablelm-2-1_6b]."""

import torch

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    decode_window=8192,        # long_500k SWA decode variant only
    remat=True,
    param_dtype=torch.bfloat16,
    activation_dtype=torch.bfloat16,
    logits_chunk=512,
    source="hf:stabilityai/stablelm-2-1_6b",
)
