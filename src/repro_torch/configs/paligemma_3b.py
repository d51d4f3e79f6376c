"""paligemma-3b — VLM: SigLIP prefix + gemma decoder [arXiv:2407.07726].

The SigLIP vision tower is a stub: precomputed patch embeddings
(B, 256, 2048) form the bidirectional prefix (``models/frontend_stubs.py``).
"""

import torch

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="paligemma-3b",
    arch_type="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,            # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    vision_prefix_len=256,
    decode_window=8192,        # long_500k SWA decode variant only
    remat=True,
    param_dtype=torch.bfloat16,
    activation_dtype=torch.bfloat16,
    logits_chunk=256,          # 257k vocab -> chunked CE
    source="arXiv:2407.07726",
)
