"""Launcher of the CUDA step-fused kernel (``csrc/hetero_fuse.cu``).

Replaces the TPU kernel ``repro/kernels/hetero_fuse.py:161``
(``hetero_fuse_step``): per latent element, ε→v conversion of every
routed slot's prediction, router fusion, the CFG combine and the Euler
update, in one launch.  Its plain version is
``kernels.ref.ref_hetero_fuse_step``; the sampler reaches both through
``kernels.ops.fused_step``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _fn():
    """The C entry point, built and loaded on first use (argtypes set
    once, so a launch costs one ctypes call)."""
    lib = _build.load_library("hetero_fuse")
    fn = lib.hetero_fuse_step_f32
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, f, f, p]
    fn.restype = ctypes.c_int
    return fn


def hetero_fuse_step(
    preds: torch.Tensor,      # (K, G, B, T) per-branch routed predictions
    x_t: torch.Tensor,        # (B, T) current latent
    weights: torch.Tensor,    # (G, B, K) fusion weights per branch
    coef: torch.Tensor,       # (5, K, G, B) unified coefficient stack
    dt: torch.Tensor,         # (1,) shared or (B,) per-row Euler step
    *,
    cfg_scale: float = 1.0,
    clamp: float = 20.0,
    alpha_min: float = 0.01,
) -> torch.Tensor:
    """Launch the kernel on CUDA float32 tensors; returns ``(B, T)``."""
    ops_in = (preds, x_t, weights, coef, dt)
    if not all(a.is_cuda for a in ops_in):
        raise ValueError("hetero_fuse_step launches on CUDA tensors only")
    if any(a.device != x_t.device for a in ops_in):
        raise ValueError("hetero_fuse_step operands must share one device")
    if any(a.dtype != torch.float32 for a in ops_in):
        raise TypeError("hetero_fuse_step takes float32 operands")
    if not all(a.is_contiguous() for a in ops_in):
        raise ValueError("hetero_fuse_step operands must be contiguous")
    k, g, b, t = preds.shape
    if g not in (1, 2):
        raise ValueError(f"G must be 1 (no CFG) or 2 (cond, uncond); got {g}")
    if tuple(x_t.shape) != (b, t) or tuple(weights.shape) != (g, b, k) \
            or tuple(coef.shape) != (5, k, g, b):
        raise ValueError(
            f"shape mismatch: preds {tuple(preds.shape)}, x_t "
            f"{tuple(x_t.shape)}, weights {tuple(weights.shape)}, coef "
            f"{tuple(coef.shape)}")
    if dt.dim() != 1 or dt.shape[0] not in (1, b):
        raise ValueError(f"dt must be (1,) or ({b},), got {tuple(dt.shape)}")
    out = torch.empty_like(x_t)
    stream = torch.cuda.current_stream(x_t.device).cuda_stream
    rc = _fn()(preds.data_ptr(), x_t.data_ptr(), weights.data_ptr(),
               coef.data_ptr(), dt.data_ptr(), out.data_ptr(), k, g, b, t,
               int(dt.shape[0] == b and b > 1), cfg_scale, clamp, alpha_min,
               stream)
    if rc != 0:
        raise RuntimeError(f"hetero_fuse_step launch failed: CUDA error {rc}")
    return out
