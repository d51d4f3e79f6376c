"""Architecture config registry of the port (``repro.configs``' ids).

``get_config`` returns each of the reference's 10 architecture ids
(``ARCH_IDS``): ``"mamba2-2.7b"`` (``ssm``), ``"zamba2-2.7b"``
(``hybrid``), ``"internlm2-1.8b"``, ``"stablelm-1.6b"``,
``"deepseek-67b"``, ``"deepseek-coder-33b"`` (``dense``),
``"mixtral-8x7b"``, ``"mixtral-8x22b"`` (``moe``), ``"whisper-large-v3"``
(``audio``) and ``"paligemma-3b"`` (``vlm``); an unknown id raises the
reference's ``ValueError``.  The paper's own DiT experts come from
``get_dit_config``.
"""

from __future__ import annotations

from repro_torch.configs import (deepseek_67b, deepseek_coder_33b,
                                 internlm2_1p8b, mamba2_2p7b, mixtral_8x7b,
                                 mixtral_8x22b, paligemma_3b, stablelm_1p6b,
                                 whisper_large_v3, zamba2_2p7b)
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape
from repro_torch.models.config import (DiTConfig, LMConfig, dit_b2,
                                       dit_xl2, router_b2)

#: the reference's architecture ids (``repro/configs/__init__.py``)
ARCH_IDS: tuple[str, ...] = (
    "deepseek-coder-33b", "mamba2-2.7b", "stablelm-1.6b", "zamba2-2.7b",
    "whisper-large-v3", "paligemma-3b", "deepseek-67b", "mixtral-8x22b",
    "mixtral-8x7b", "internlm2-1.8b",
)

_CONFIGS = {c.name: c for c in (
    mamba2_2p7b.CONFIG, zamba2_2p7b.CONFIG, internlm2_1p8b.CONFIG,
    stablelm_1p6b.CONFIG, deepseek_67b.CONFIG, deepseek_coder_33b.CONFIG,
    mixtral_8x7b.CONFIG, mixtral_8x22b.CONFIG, whisper_large_v3.CONFIG,
    paligemma_3b.CONFIG)}

#: the paper's own diffusion-expert architectures
DIT_CONFIGS = {"dit-xl2": dit_xl2, "dit-b2": dit_b2, "router-b2": router_b2}


def get_config(arch: str) -> LMConfig:
    if arch not in _CONFIGS:
        raise ValueError(
            f"unknown arch {arch!r}; available: {sorted(ARCH_IDS)}")
    return _CONFIGS[arch]


def get_dit_config(name: str, **kw) -> DiTConfig:
    return DIT_CONFIGS[name](**kw)


__all__ = ["ARCH_IDS", "DIT_CONFIGS", "SHAPES", "InputShape", "get_config",
           "get_dit_config", "get_shape"]
