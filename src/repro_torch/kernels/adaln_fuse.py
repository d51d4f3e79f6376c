"""Launcher of the CUDA AdaLN modulation kernel (``csrc/adaln_fuse.cu``).

Replaces the TPU kernel ``repro/kernels/adaln_fuse.py:34``
(``adaln_fuse``): ``LN(x)·(1+γ)+β`` with a LayerNorm without affine
(population variance, float32 statistics), ``γ``/``β`` per batch row, the
output in ``x``'s dtype.  Without ``γ``/``β`` it is the plain LayerNorm.
Its plain version is ``kernels.ref.ref_adaln_fuse``; the model code
reaches both through ``kernels.ops.adaln_modulate`` and
``kernels.ops.layernorm``.

``adaln_fuse_bwd`` launches the backward (float32): ``dx`` and, with
``γ``, the deterministic per-batch-row sums ``dγ`` and ``dβ`` (rows held
in registers where ``D % 4 == 0``, the rows are aligned and
``D ≤ 1024``; else cached in shared memory).  The TPU
kernel has no backward; this one replaces XLA's autodiff of the
reference's training forward (``repro/models/dit.py:295-314``).  Its
plain version is ``kernels.ref.ref_adaln_fuse_bwd``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: rows of float32 that eight warps keep in 227 KB of shared memory.
MAX_D = 7264
#: rows (and column partials) of float32 that four warps keep in 227 KB
BWD_MAX_D = 3584

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    fn = _build.load_library("adaln_fuse").adaln_fuse
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, p, i, p, i, i, i, i, ll, ll, ll, ll, ll,
                   ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.load_library("adaln_fuse").adaln_fuse_bwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 7 + [i] * 4 + [ll] * 4 + [ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_chunks_fn():
    fn = _build.load_library("adaln_fuse").adaln_fuse_bwd_chunks
    fn.argtypes = [ctypes.c_longlong]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor, strides) -> bool:
    """Every row start 4-element aligned (16-byte float32, 8-byte bf16)."""
    return (t.data_ptr() % (4 * t.element_size()) == 0
            and all(s % 4 == 0 for s in strides))


def adaln_fuse(
    x: torch.Tensor,                  # (B, S, D) or (B, G, S, D)
    gamma: torch.Tensor | None,       # (B, D)
    beta: torch.Tensor | None,        # (B, D)
    *,
    eps: float = 1e-6,
    round_scale: bool = False,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns a contiguous tensor of
    ``x``'s shape and dtype.

    ``x`` may be any strided view whose last axis is contiguous — the
    ragged forward's ``(P, g, T, d)`` broadcast of ``(P, T, d)`` is read
    without a copy.  ``gamma``/``beta`` rows may be strided (a slice of the
    modulation stack); ``None`` for both is the plain LayerNorm.
    ``round_scale`` rounds ``1 + γ`` to bf16 before the multiply (bf16
    ``γ`` only, as the DiT's ``1.0 + γ`` does).  Raises on anything the
    kernel does not take, and if the launch fails.
    """
    if x.dtype not in _DTYPES:
        raise TypeError(f"adaln_fuse takes float32 or bf16 x, got {x.dtype}")
    if (gamma is None) != (beta is None):
        raise ValueError("adaln_fuse takes both gamma and beta, or neither")
    operands = (x,) if gamma is None else (x, gamma, beta)
    if not all(a.is_cuda for a in operands):
        raise ValueError("adaln_fuse launches on CUDA tensors only")
    if any(a.device != x.device for a in operands):
        raise ValueError("adaln_fuse operands must share one device")
    if x.dim() == 3:
        b, s, d = x.shape
        g, sxb, sxg, sxs = 1, x.stride(0), 0, x.stride(1)
    elif x.dim() == 4:
        b, g, s, d = x.shape
        sxb, sxg, sxs = x.stride(0), x.stride(1), x.stride(2)
    else:
        raise ValueError(f"adaln_fuse takes (B, S, D) or (B, G, S, D) x, "
                         f"got {tuple(x.shape)}")
    if d > MAX_D:
        raise ValueError(f"adaln_fuse rows hold at most {MAX_D} features, "
                         f"got {d}")
    if x.stride(-1) != 1 and d > 1:
        raise ValueError("x's last axis must be contiguous")
    if gamma is not None:
        if gamma.dtype != beta.dtype or gamma.dtype not in _DTYPES:
            raise TypeError(f"gamma and beta must share a float32 or bf16 "
                            f"dtype, got {gamma.dtype}, {beta.dtype}")
        if tuple(gamma.shape) != (b, d) or tuple(beta.shape) != (b, d):
            raise ValueError(f"gamma and beta must be ({b}, {d}), got "
                             f"{tuple(gamma.shape)}, {tuple(beta.shape)}")
        if (gamma.stride(-1) != 1 or beta.stride(-1) != 1) and d > 1:
            raise ValueError("gamma's and beta's last axis must be "
                             "contiguous")
    out = torch.empty((b, g, s, d), dtype=x.dtype, device=x.device)
    sgb = gamma.stride(0) if gamma is not None else 0
    sbb = beta.stride(0) if beta is not None else 0
    vec = (d % 4 == 0 and _aligned(x, (sxb, sxg, sxs))
           and (gamma is None or (_aligned(gamma, (sgb,))
                                  and _aligned(beta, (sbb,)))))
    g_bf16 = int(gamma is not None and gamma.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn()(x.data_ptr(), _DTYPES[x.dtype],
               None if gamma is None else gamma.data_ptr(),
               None if beta is None else beta.data_ptr(), g_bf16,
               out.data_ptr(), b, g, s, d, sxb, sxg, sxs, sgb, sbb, eps,
               int(round_scale and g_bf16), int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"adaln_fuse launch failed: CUDA error {rc}")
    return out.reshape(x.shape)


def adaln_fuse_bwd(
    x: torch.Tensor,                  # (B, S, D) or (B, G, S, D)
    gamma: torch.Tensor | None,       # (B, D)
    d_out: torch.Tensor,              # x's shape
    *,
    eps: float = 1e-6,
):
    """Launch the backward on float32 CUDA tensors: ``(dx, dγ, dβ)`` of
    ``LN(x)·(1+γ)+β``, ``dx`` contiguous in ``x``'s shape, ``dγ``/``dβ``
    contiguous ``(B, D)`` summed over the ``G·S`` rows of each batch entry
    (``None`` both, and skipped, when ``gamma`` is ``None``: the plain
    LayerNorm).  ``x`` and ``gamma`` may be strided as the forward takes
    them; ``d_out`` is made contiguous.  Raises on anything the kernel
    does not take, and if the launch fails."""
    operands = (x, d_out) if gamma is None else (x, gamma, d_out)
    if any(a.dtype != torch.float32 for a in operands):
        raise TypeError("adaln_fuse_bwd takes float32 operands, got "
                        f"{[a.dtype for a in operands]}")
    if not all(a.is_cuda and a.device == x.device for a in operands):
        raise ValueError("adaln_fuse_bwd launches on CUDA tensors of one "
                         "device only")
    if d_out.shape != x.shape:
        raise ValueError(f"d_out {tuple(d_out.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    if x.dim() == 3:
        b, s, d = x.shape
        g, sxb, sxg, sxs = 1, x.stride(0), 0, x.stride(1)
    elif x.dim() == 4:
        b, g, s, d = x.shape
        sxb, sxg, sxs = x.stride(0), x.stride(1), x.stride(2)
    else:
        raise ValueError(f"adaln_fuse_bwd takes (B, S, D) or (B, G, S, D) "
                         f"x, got {tuple(x.shape)}")
    if d > BWD_MAX_D:
        raise ValueError(f"adaln_fuse_bwd rows hold at most {BWD_MAX_D} "
                         f"features, got {d}")
    if x.stride(-1) != 1 and d > 1:
        raise ValueError("x's last axis must be contiguous")
    if gamma is not None:
        if tuple(gamma.shape) != (b, d):
            raise ValueError(f"gamma must be ({b}, {d}), got "
                             f"{tuple(gamma.shape)}")
        if gamma.stride(-1) != 1 and d > 1:
            raise ValueError("gamma's last axis must be contiguous")
    dy = d_out.contiguous()
    dx = torch.empty((b, g, s, d), dtype=torch.float32, device=x.device)
    dgamma = dbeta = part = None
    if gamma is not None:
        # the kernel's own chunk count of the G·S rows of a batch entry
        chunks = _bwd_chunks_fn()(g * s)
        part = torch.empty((b, chunks, 2, d), dtype=torch.float32,
                           device=x.device)
        dgamma = torch.empty((b, d), dtype=torch.float32, device=x.device)
        dbeta = torch.empty((b, d), dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    sgb = 0 if gamma is None else gamma.stride(0)
    vec = (d % 4 == 0 and _aligned(x, (sxb, sxg, sxs))
           and _aligned(dy, (d,))
           and (gamma is None or _aligned(gamma, (sgb,))))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _bwd_fn()(x.data_ptr(), ptr(gamma), dy.data_ptr(), dx.data_ptr(),
                   ptr(part), ptr(dgamma), ptr(dbeta), b, g, s, d, sxb, sxg,
                   sxs, sgb, eps, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"adaln_fuse_bwd launch failed: CUDA error {rc}")
    return dx.reshape(x.shape), dgamma, dbeta
