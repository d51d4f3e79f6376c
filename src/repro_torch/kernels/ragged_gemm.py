"""Launcher of the CUDA ragged grouped expert GEMM (``csrc/ragged_gemm.cu``).

Replaces the TPU kernel ``repro/kernels/ragged_gemm.py:73``
(``ragged_gemm``): ``y[p·m + r] = x[p·m + r] @ w[pe[p]]`` for ``P`` row
groups of ``m`` rows, every group contracting against its own expert's
weight.  Bodies by weight dtype: float32 and bf16 (float32 activations
and accumulation), and the quantized int8 (exact int32 sums) and fp8
e4m3 (float32 sums) bodies on the tensor cores, with the dequant epilogue
``(acc·x_scale[row])·w_scale[pe[p]]``.  Any ``m`` works (ragged edges are
masked in the kernel).  Its plain version is ``kernels.ref.ref_ragged_gemm``;
the model code reaches both through ``kernels.ops.ragged_expert_matmul``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_MAX_GROUPS = 65535            # CUDA grid z limit

#: weight dtype -> (C entry point, activation dtype, quantized body)
BODIES = {
    torch.float32: ("ragged_gemm_f32", torch.float32, False),
    torch.bfloat16: ("ragged_gemm_bf16", torch.float32, False),
    torch.int8: ("ragged_gemm_int8", torch.int8, True),
    torch.float8_e4m3fn: ("ragged_gemm_fp8", torch.float8_e4m3fn, True),
}


#: the e4m3 body's contractions, by the index ``ragged_gemm_fp8_variant``
#: takes; the last (bf16) is the one ``ragged_gemm`` serves
FP8_VARIANTS = ("e4m3", "e4m3_promote128", "e4m3_promote32", "bf16")


@functools.cache
def _fn(name: str, quantized: bool):
    """A C entry point, built and loaded on first use (argtypes set once,
    so a launch costs one ctypes call)."""
    fn = getattr(_build.load_library("ragged_gemm"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    scales = [p, p] if quantized else []
    variant = [i] if name == "ragged_gemm_fp8_variant" else []
    fn.argtypes = [p, p, p, *scales, p, i, i, i, i, i, ctypes.c_longlong, p,
                   *variant]
    fn.restype = ctypes.c_int
    return fn


def ragged_gemm_fp8_variant(x: torch.Tensor, w: torch.Tensor,
                            group_experts: torch.Tensor, m: int,
                            x_scale: torch.Tensor, w_scale: torch.Tensor,
                            variant: int) -> torch.Tensor:
    """The e4m3 body through contraction ``FP8_VARIANTS[variant]``, to
    measure the variants side by side (the served path runs
    ``ragged_gemm``).  Takes what ``ragged_gemm`` takes, with D a multiple
    of 16, F of 4 and x 16-byte aligned."""
    if w.dtype != torch.float8_e4m3fn:
        raise TypeError("the variants are the e4m3 body's")
    if not 0 <= variant < len(FP8_VARIANTS):
        raise ValueError(f"variant {variant} not in "
                         f"0..{len(FP8_VARIANTS) - 1}")
    return _launch(x, w, group_experts, m, x_scale, w_scale, variant)


def ragged_gemm(x: torch.Tensor, w: torch.Tensor, group_experts: torch.Tensor,
                m: int, x_scale: torch.Tensor | None = None,
                w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors.

    Args:
      x: ``(P·m, D)`` contiguous rows, group-major: float32 for float32/
        bf16 weights, else the weights' int8/e4m3 dtype.
      w: ``(K, D, F)`` float32, bf16, int8 or e4m3; each expert's
        ``(D, F)`` matrix contiguous (the expert axis may be strided, e.g.
        one layer of ``(K, L, D, F)``).
      group_experts: ``(P,)`` int32 expert id per row group.
      m: rows per group.
      x_scale, w_scale: ``(P·m,)`` and ``(K,)`` float32 scales, for int8
        and e4m3 weights only.

    Returns ``(P·m, F)`` float32.  Raises on anything the kernel does not
    take, and if the launch fails.
    """
    return _launch(x, w, group_experts, m, x_scale, w_scale, None)


def _launch(x, w, group_experts, m, x_scale, w_scale,
            variant: int | None) -> torch.Tensor:
    if w.dtype not in BODIES:
        raise TypeError(f"ragged_gemm has no body for {w.dtype} weights")
    name, x_dtype, quantized = BODIES[w.dtype]
    operands = (x, w, group_experts) + ((x_scale, w_scale) if quantized
                                        else ())
    if any(a is None for a in operands):
        raise ValueError(f"{w.dtype} weights need x_scale and w_scale")
    if not quantized and (x_scale is not None or w_scale is not None):
        raise ValueError(f"{w.dtype} weights take no scales")
    if not all(a.is_cuda for a in operands):
        raise ValueError("ragged_gemm launches on CUDA tensors only")
    if any(a.device != x.device for a in operands):
        raise ValueError("ragged_gemm operands must share one device")
    if x.dtype != x_dtype:
        raise TypeError(f"{w.dtype} weights take {x_dtype} activations, "
                        f"got {x.dtype}")
    if quantized and (x_scale.dtype != torch.float32
                      or w_scale.dtype != torch.float32):
        raise TypeError("scales must be float32")
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
    if quantized and (tuple(x_scale.shape) != (rows,)
                      or tuple(w_scale.shape) != (k,)
                      or not x_scale.is_contiguous()
                      or not w_scale.is_contiguous()):
        raise ValueError(f"scales must be contiguous ({rows},) and ({k},), "
                         f"got {tuple(x_scale.shape)}, "
                         f"{tuple(w_scale.shape)}")
    y = torch.empty((rows, f), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scales = (x_scale.data_ptr(), w_scale.data_ptr()) if quantized else ()
    extra = ()
    if variant is not None:
        name, extra = "ragged_gemm_fp8_variant", (variant,)
    rc = _fn(name, quantized)(x.data_ptr(), w.data_ptr(),
                              group_experts.data_ptr(), *scales,
                              y.data_ptr(), p, m, d, f, k, w.stride(0),
                              stream, *extra)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return y
