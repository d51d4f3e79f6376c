"""whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356].

The mel+conv frontend is a stub: precomputed frame embeddings
(B, 1500, 1280) feed the encoder (``models/frontend_stubs.py``).
"""

import torch

from repro_torch.models.config import LMConfig

CONFIG = LMConfig(
    name="whisper-large-v3",
    arch_type="audio",
    num_layers=32,             # decoder layers
    num_encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    encoder_seq_len=1500,
    decode_window=8192,        # long_500k SWA decoder variant only
    remat=True,
    param_dtype=torch.bfloat16,
    activation_dtype=torch.bfloat16,
    logits_chunk=512,
    source="arXiv:2212.04356",
)
