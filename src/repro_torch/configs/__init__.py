"""Architecture config registry of the port (``repro.configs``' ids).

The port serves the ``ssm`` family: ``get_config("mamba2-2.7b")``.  The
reference's other architecture ids raise ``NotImplementedError`` until
their backbones are ported (ROADMAP.md, module queue A.10).
"""

from __future__ import annotations

from repro_torch.configs import mamba2_2p7b
from repro_torch.models.config import LMConfig

#: the reference's architecture ids (``repro/configs/__init__.py``)
ARCH_IDS: tuple[str, ...] = (
    "deepseek-coder-33b", "mamba2-2.7b", "stablelm-1.6b", "zamba2-2.7b",
    "whisper-large-v3", "paligemma-3b", "deepseek-67b", "mixtral-8x22b",
    "mixtral-8x7b", "internlm2-1.8b",
)

_PORTED = {"mamba2-2.7b": mamba2_2p7b.CONFIG}


def get_config(arch: str) -> LMConfig:
    if arch in _PORTED:
        return _PORTED[arch]
    if arch in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: the port serves mamba2-2.7b "
            f"(ROADMAP.md, module queue A.10)")
    raise ValueError(f"unknown arch {arch!r}; available: {sorted(ARCH_IDS)}")


__all__ = ["ARCH_IDS", "get_config"]
