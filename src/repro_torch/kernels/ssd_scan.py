"""Launcher of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``repro/kernels/ssd_scan.py:86`` (``ssd_scan``):
the Mamba2 SSD chunked scan from a zero state, over x ``(B, H, S, P)``,
dt ``(B, H, S)``, A ``(H,)`` and B, C ``(B, S, N)``, returning y in x's
dtype and the final state ``(B, H, P, N)`` in float32.  One block per
(batch, head) walks the chunks in order, the state in registers.  Its
plain version is ``kernels.ref.ref_ssd_scan``; the model code reaches
both through ``kernels.ops.ssd_scan``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_P = 64
MAX_N = 128
MAX_TILE = 128                 # positions per tile of the kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    fn = _build.load_library("ssd_scan").ssd_scan
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 7 + [i] * 7 + [ll] * 13 + [p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(
    x: torch.Tensor,          # (B, H, S, P)
    dt: torch.Tensor,         # (B, H, S) float32
    A: torch.Tensor,          # (H,) float32
    B: torch.Tensor,          # (B, S, N)
    C: torch.Tensor,          # (B, S, N)
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors with chunks of ``chunk``
    positions (``1 ≤ chunk ≤ 128``; a last partial chunk is masked —
    ``kernels.ops.ssd_scan`` enforces the reference's ``S % chunk == 0``).

    x, B and C may be any strided views whose last axis is contiguous (the
    mixer's slices of its projection), dt any view.  Returns y
    ``(B, H, S, P)`` in x's dtype, allocated ``(B, S, H, P)`` in memory
    (so the mixer's reshape back is free), and the final state.  Raises on
    anything the kernel does not take, and if the launch fails.
    """
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes float32 or bf16 x, B, C of one "
                        f"dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes float32 dt and A, got {dt.dtype}, "
                        f"{A.dtype}")
    tensors = (x, dt, A, B, C)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("ssd_scan launches on CUDA tensors only")
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan operands must share one device")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, S, P), got {tuple(x.shape)}")
    b, h, s, p = x.shape
    n = B.shape[-1]
    if (tuple(dt.shape) != (b, h, s) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (b, s, n) or C.shape != B.shape):
        raise ValueError(f"shapes do not match x {tuple(x.shape)}: dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"head dim {p} and state dim {n} must be at most "
                         f"{MAX_P} and {MAX_N}")
    if not 1 <= chunk <= MAX_TILE:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_TILE}]")
    if s == 0:
        raise ValueError("ssd_scan needs at least one position")
    if (p > 1 and x.stride(-1) != 1) or (n > 1 and (B.stride(-1) != 1
                                                    or C.stride(-1) != 1)):
        raise ValueError("x, B and C must have a contiguous last axis")
    A = A.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    strides = ([x.stride(i) for i in range(3)]
               + [dt.stride(i) for i in range(3)]
               + [B.stride(0), B.stride(1), C.stride(0), C.stride(1)]
               + [y.stride(i) for i in range(3)])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):    # the launcher asks for the device
        rc = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                   C.data_ptr(), y.data_ptr(), state.data_ptr(),
                   _DTYPES[x.dtype], b, h, s, p, n, chunk, *strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    return y, state
