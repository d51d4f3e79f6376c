"""Launcher of the CUDA ragged grouped expert GEMM (``csrc/ragged_gemm.cu``).

Replaces the TPU kernel ``repro/kernels/ragged_gemm.py:73``
(``ragged_gemm``, dense float32 body): ``y[p·m + r] = x[p·m + r] @
w[pe[p]]`` for ``P`` row groups of ``m`` rows, every group contracting
against its own expert's weight.  Any ``m`` works (ragged edges are
masked in the kernel), so unlike the TPU wrapper there is no dense
fallback for narrow groups.  Its plain version is
``kernels.ref.ref_ragged_gemm``; the model code reaches both through
``kernels.ops.ragged_expert_matmul``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_MAX_GROUPS = 65535            # CUDA grid z limit


@functools.cache
def _fn():
    """The C entry point, built and loaded on first use (argtypes set
    once, so a launch costs one ctypes call)."""
    lib = _build.load_library("ragged_gemm")
    fn = lib.ragged_gemm_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int
    return fn


def ragged_gemm(x: torch.Tensor, w: torch.Tensor, group_experts: torch.Tensor,
                m: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors.

    Args:
      x: ``(P·m, D)`` float32, contiguous rows, group-major.
      w: ``(K, D, F)`` float32; each expert's ``(D, F)`` matrix contiguous
        (the expert axis may be strided, e.g. one layer of ``(K, L, D, F)``).
      group_experts: ``(P,)`` int32 expert id per row group.
      m: rows per group.

    Returns ``(P·m, F)`` float32.  Raises on anything the kernel does not
    take, and if the launch fails.
    """
    if not (x.is_cuda and w.is_cuda and group_experts.is_cuda):
        raise ValueError("ragged_gemm launches on CUDA tensors only")
    if not (x.device == w.device == group_experts.device):
        raise ValueError("ragged_gemm operands must share one device")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"ragged_gemm takes float32, got x={x.dtype} "
                        f"w={w.dtype}")
    if group_experts.dtype != torch.int32:
        raise TypeError("group_experts must be int32")
    if x.dim() != 2 or w.dim() != 3 or group_experts.dim() != 1:
        raise ValueError(f"bad ranks: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, ids {tuple(group_experts.shape)}")
    rows, d = x.shape
    k, dw, f = w.shape
    p = group_experts.shape[0]
    if dw != d:
        raise ValueError(f"contraction mismatch: x depth {d}, w depth {dw}")
    if p * m != rows:
        raise ValueError(f"x has {rows} rows, expected P·m = {p}·{m}")
    if p > _MAX_GROUPS:
        raise ValueError(f"{p} row groups exceed the grid limit "
                         f"{_MAX_GROUPS}")
    if not x.is_contiguous() or not group_experts.is_contiguous():
        raise ValueError("x and group_experts must be contiguous")
    if w.stride(2) != 1 or w.stride(1) != f:
        raise ValueError("each expert's (D, F) weight must be contiguous")
    y = torch.empty((rows, f), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn()(x.data_ptr(), w.data_ptr(), group_experts.data_ptr(),
               y.data_ptr(), p, m, d, f, k, w.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"ragged_gemm launch failed: CUDA error {rc}")
    return y
