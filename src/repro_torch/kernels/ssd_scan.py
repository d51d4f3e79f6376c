"""Launcher of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``repro/kernels/ssd_scan.py:86`` (``ssd_scan``):
the Mamba2 SSD chunked scan from a zero state, over x ``(B, H, S, P)``,
dt ``(B, H, S)``, A ``(H,)`` and B, C ``(B, S, N)``, returning y in x's
dtype and the final state ``(B, H, P, N)`` in float32.  A prep kernel
computes C·Bᵀ once per (batch, tile) into a float32 scratch that the
wrapper allocates; then one block per (batch, head) walks the tiles in
order, the state in shared memory.  On request the scan also writes the
state at each tile's start, which ``ssd_scan_bwd`` — the backward of the
same function, a kernel the TPU side does not have — reads instead of
scanning again.  The backward first computes the gradient of the state at
each tile's end (``ssd_scan_bwd_states``), after which every (batch, tile,
head) is independent.  The plain versions are ``kernels.ref.ref_ssd_scan``,
``ref_ssd_scan_prep``, ``ref_ssd_scan_bwd`` and
``ref_ssd_scan_bwd_states``; the model code reaches the scan through
``kernels.ops.ssd_scan``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_P = 64
MAX_N = 128
MAX_TILE = 128                 # positions per tile of the kernel
GROUP_HEADS = 16               # heads whose sums one backward block adds

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    fn = _build.load_library("ssd_scan").ssd_scan
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 9 + [i] * 7 + [ll] * 13 + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.load_library("ssd_scan").ssd_scan_bwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 19 + [i] * 7 + [ll] * 19 + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _states_fn():
    fn = _build.load_library("ssd_scan").ssd_scan_bwd_states
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 9 + [i] * 7 + [ll] * 10 + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _prep_fn():
    fn = _build.load_library("ssd_scan").ssd_scan_prep
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 3 + [i] * 5 + [ll] * 4 + [p]
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(dtype) -> int:
    """Blocks of the scan kernel an SM of the current device holds at once
    for float32 or bf16 inputs (CUDA's occupancy query)."""
    fn = _build.load_library("ssd_scan").ssd_scan_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(_DTYPES[dtype])


def bwd_blocks_per_sm(dtype) -> int:
    """Blocks of the backward's main kernel an SM of the current device
    holds at once for float32 or bf16 inputs."""
    fn = _build.load_library("ssd_scan").ssd_scan_bwd_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(_DTYPES[dtype])


def _scratch(b: int, s: int, tile: int, device) -> torch.Tensor:
    """The kernel's scratch for ``b`` sequences of ``s`` positions in tiles
    of ``tile``: per (batch, tile) C·Bᵀ transposed, C transposed and B,
    float32, each MAX_TILE × MAX_N."""
    return torch.empty((b, -(-s // tile), 3, MAX_TILE, MAX_N),
                       dtype=torch.float32, device=device)


def ssd_scan_prep(B: torch.Tensor, C: torch.Tensor, *,
                  tile: int) -> torch.Tensor:
    """The prep kernel alone, for its check against
    ``ref.ref_ssd_scan_prep``: B, C ``(B, S, N)`` CUDA tensors (float32 or
    bf16, contiguous last axis) → the scratch ``ssd_scan`` builds before
    its scan, ``(B, ceil(S / tile), 3, 128, 128)`` float32: C·Bᵀ
    transposed, C transposed, B."""
    if B.dtype not in _DTYPES or C.dtype != B.dtype:
        raise TypeError(f"ssd_scan_prep takes float32 or bf16 B, C of one "
                        f"dtype, got {B.dtype}, {C.dtype}")
    if not (B.is_cuda and C.device == B.device):
        raise ValueError("ssd_scan_prep launches on CUDA tensors only")
    b, s, n = B.shape
    if C.shape != B.shape or not 1 <= n <= MAX_N or s == 0:
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must "
                         f"match, with 1 ≤ N ≤ {MAX_N} and S ≥ 1")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile {tile} must be in [1, {MAX_TILE}]")
    if n > 1 and (B.stride(-1) != 1 or C.stride(-1) != 1):
        raise ValueError("B and C must have a contiguous last axis")
    scratch = _scratch(b, s, tile, B.device)
    stream = torch.cuda.current_stream(B.device).cuda_stream
    with torch.cuda.device(B.device):
        rc = _prep_fn()(B.data_ptr(), C.data_ptr(), scratch.data_ptr(),
                        _DTYPES[B.dtype], b, s, n, tile, B.stride(0),
                        B.stride(1), C.stride(0), C.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_prep launch failed: CUDA error {rc}")
    return scratch


def _check(x, dt, A, B, C, chunk: int) -> tuple[int, int, int, int, int]:
    """What the kernels take: float32 or bf16 x, B, C of one dtype,
    float32 dt and A, all CUDA tensors on one device, shapes that match,
    P ≤ 64, N ≤ 128, 1 ≤ chunk ≤ 128, a contiguous last axis on x, B, C.
    Returns ``(b, h, s, p, n)``."""
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
    return b, h, s, p, n


def ssd_scan(
    x: torch.Tensor,          # (B, H, S, P)
    dt: torch.Tensor,         # (B, H, S) float32
    A: torch.Tensor,          # (H,) float32
    B: torch.Tensor,          # (B, S, N)
    C: torch.Tensor,          # (B, S, N)
    *,
    chunk: int,
    with_starts: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Launch the kernel on CUDA tensors with chunks of ``chunk``
    positions (``1 ≤ chunk ≤ 128``; a last partial chunk is masked —
    ``kernels.ops.ssd_scan`` enforces the reference's ``S % chunk == 0``).

    x, B and C may be any strided views whose last axis is contiguous (the
    mixer's slices of its projection), dt any view.  Returns y
    ``(B, H, S, P)`` in x's dtype, allocated ``(B, S, H, P)`` in memory
    (so the mixer's reshape back is free), and the final state; with
    ``with_starts`` also the float32 state at the start of each chunk,
    ``(B, H, ceil(S / chunk), P, N)``, which ``ssd_scan_bwd`` reads.
    Raises on anything the kernel does not take, and if the launch fails.
    """
    b, h, s, p, n = _check(x, dt, A, B, C, chunk)
    A = A.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    starts = (torch.empty((b, h, -(-s // chunk), p, n), dtype=torch.float32,
                          device=x.device) if with_starts else None)
    scratch = _scratch(b, s, chunk, x.device)
    strides = ([x.stride(i) for i in range(3)]
               + [dt.stride(i) for i in range(3)]
               + [B.stride(0), B.stride(1), C.stride(0), C.stride(1)]
               + [y.stride(i) for i in range(3)])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):    # the launcher asks for the device
        rc = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                   C.data_ptr(), y.data_ptr(), state.data_ptr(),
                   None if starts is None else starts.data_ptr(),
                   scratch.data_ptr(), _DTYPES[x.dtype], b, h, s, p, n,
                   chunk, *strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    return (y, state) if starts is None else (y, state, starts)


def _check_bwd(x, dy, d_state, b, h, s, p, n) -> torch.Tensor | None:
    """dy and d_state as the backward takes them; d_state contiguous."""
    if dy.dtype != x.dtype or tuple(dy.shape) != (b, h, s, p) \
            or not dy.is_cuda or dy.device != x.device:
        raise ValueError(f"dy must be (B, H, S, P) {x.dtype} on x's device, "
                         f"got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if p > 1 and dy.stride(-1) != 1:
        raise ValueError("dy must have a contiguous last axis")
    if d_state is not None and (
            d_state.dtype != torch.float32
            or tuple(d_state.shape) != (b, h, p, n)
            or d_state.device != x.device):
        raise ValueError(f"d_state must be float32 {(b, h, p, n)}, got "
                         f"{tuple(d_state.shape)} {d_state.dtype}")
    return None if d_state is None else d_state.contiguous()


def ssd_scan_bwd_states(
    x: torch.Tensor,          # (B, H, S, P): the dtype and shape only
    dt: torch.Tensor,         # (B, H, S) float32
    A: torch.Tensor,          # (H,) float32
    B: torch.Tensor,          # (B, S, N)
    C: torch.Tensor,          # (B, S, N)
    dy: torch.Tensor,         # (B, H, S, P) in x's dtype
    d_state: torch.Tensor | None = None,   # (B, H, P, N) float32
    *,
    chunk: int,
) -> torch.Tensor:
    """The backward's first stage alone, for its check against
    ``ref.ref_ssd_scan_bwd_states``: the gradient of the state at the end
    of each chunk, ``(B, H, ceil(S / chunk), P, N)`` float32 (the last
    chunk's is ``d_state``, or zero).  Launches the prep, the chunks'
    local sums and their carry."""
    b, h, s, p, n = _check(x, dt, A, B, C, chunk)
    d_state = _check_bwd(x, dy, d_state, b, h, s, p, n)
    nt = -(-s // chunk)
    A = A.contiguous()
    dev, f32 = x.device, torch.float32
    dsend = torch.empty((b, h, nt, p, n), dtype=f32, device=dev)
    decay = torch.empty((b, h, nt), dtype=f32, device=dev)
    scratch = _scratch(b, s, chunk, dev)
    strides = ([dt.stride(i) for i in range(3)]
               + [B.stride(0), B.stride(1), C.stride(0), C.stride(1)]
               + [dy.stride(i) for i in range(3)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _states_fn()(
            dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(),
            None if d_state is None else d_state.data_ptr(),
            dsend.data_ptr(), decay.data_ptr(), scratch.data_ptr(),
            _DTYPES[x.dtype], b, h, s, p, n, chunk, *strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd_states launch failed: CUDA error "
                           f"{rc}")
    return dsend


def ssd_scan_bwd(
    x: torch.Tensor,          # (B, H, S, P), as the forward took it
    dt: torch.Tensor,         # (B, H, S) float32
    A: torch.Tensor,          # (H,) float32
    B: torch.Tensor,          # (B, S, N)
    C: torch.Tensor,          # (B, S, N)
    starts: torch.Tensor,     # (B, H, ceil(S / chunk), P, N) float32
    dy: torch.Tensor,         # (B, H, S, P) in x's dtype
    d_state: torch.Tensor | None = None,   # (B, H, P, N) float32
    *,
    chunk: int,
) -> tuple[torch.Tensor, ...]:
    """The backward kernels: from ``dy`` (and ``d_state``, the gradient of
    the final state; ``None`` for zero) and the forward's tile-start
    states, the gradients ``(dx, ddt, dA, dB, dC)`` of ``ssd_scan`` at
    the same inputs and ``chunk``.  dx ``(B, H, S, P)`` in x's dtype (laid
    out ``(B, S, H, P)``, as y), ddt ``(B, H, S)`` float32 (laid out
    ``(B, S, H)``), dA ``(H,)`` float32, dB and dC ``(B, S, N)`` in x's
    dtype.  Five launches: the forward's prep (C·Bᵀ per tile), the
    gradient of the state at each tile's end (the tiles' local sums, then
    their carry), one kernel over every (batch, tile, head) and (batch,
    tile, group of 16 heads), and the sums over groups, tiles and batches,
    in a fixed order (no atomics: two calls give the same bits).  Raises on
    anything the kernels do not take, and if a launch fails."""
    b, h, s, p, n = _check(x, dt, A, B, C, chunk)
    d_state = _check_bwd(x, dy, d_state, b, h, s, p, n)
    nt = -(-s // chunk)
    if (starts.dtype != torch.float32 or tuple(starts.shape) != (
            b, h, nt, p, n) or not starts.is_contiguous()
            or starts.device != x.device):
        raise ValueError(f"starts must be the forward's contiguous float32 "
                         f"{(b, h, nt, p, n)} tile states, got "
                         f"{tuple(starts.shape)} {starts.dtype}")
    A = A.contiguous()
    dev, f32 = x.device, torch.float32
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev).transpose(1, 2)
    ddt = torch.empty((b, s, h), dtype=f32, device=dev).transpose(1, 2)
    dA = torch.empty((h,), dtype=f32, device=dev)
    dB = torch.empty((b, s, n), dtype=x.dtype, device=dev)
    dC = torch.empty((b, s, n), dtype=x.dtype, device=dev)
    scratch = _scratch(b, s, chunk, dev)
    dsend = torch.empty((b, h, nt, p, n), dtype=f32, device=dev)
    decay = torch.empty((b, h, nt), dtype=f32, device=dev)
    part = torch.empty((b, nt, -(-h // GROUP_HEADS), 3, MAX_TILE, MAX_TILE),
                       dtype=f32, device=dev)
    vec = torch.empty((b, h, nt, 4, MAX_TILE), dtype=f32, device=dev)
    ex = torch.empty((b, h, nt), dtype=f32, device=dev)
    strides = ([x.stride(i) for i in range(3)]
               + [dt.stride(i) for i in range(3)]
               + [B.stride(0), B.stride(1), C.stride(0), C.stride(1)]
               + [dy.stride(i) for i in range(3)]
               + [dx.stride(i) for i in range(3)]
               + [ddt.stride(i) for i in range(3)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _bwd_fn()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(),
            None if d_state is None else d_state.data_ptr(),
            starts.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), scratch.data_ptr(),
            dsend.data_ptr(), decay.data_ptr(), part.data_ptr(),
            vec.data_ptr(), ex.data_ptr(), _DTYPES[x.dtype], b, h, s, p, n,
            chunk, *strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {rc}")
    return dx, ddt, dA, dB, dC
