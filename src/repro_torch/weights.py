"""Carry the reference's parameter trees across to the port.

The JAX package's parameters are nested dicts (and lists) of arrays.  As
numpy — what ``np.load`` of a ``save_checkpoint`` artifact or
``jax.tree.map(np.asarray, params)`` gives — they convert leaf by leaf to
tensors with the same nested keys and list structure, no transposes (the
port keeps the reference's ``(in, out)`` dense layout); JAX's bf16 leaves
(``ml_dtypes.bfloat16`` arrays) become ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one this raises — nothing of the port
    moves to the CPU unless asked with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    return dev


def params_from_numpy(tree, device=None):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors on
    ``device`` (``None`` → ``"cuda"``; dtypes kept; scalars become 0-d
    tensors)."""
    return _to_tensors(tree, resolve_device(device))


def _to_tensors(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v, device) for v in tree)
    arr = np.asarray(tree)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()             # e.g. read-only views of JAX arrays
    if arr.dtype.name == "bfloat16":     # ml_dtypes' numpy bf16 (JAX's)
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)
