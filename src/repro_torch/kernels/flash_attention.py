"""Launcher of the CUDA flash attention kernel (``csrc/flash_attention.cu``)
and its backward (``csrc/flash_attention_bwd.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention.py:82``
(``flash_attention``): online-softmax attention with float32
accumulation, optional causal, prefix-LM and sliding-window masks and
a softmax scale (default ``1/sqrt(D)``), in the reference's ``(B, H, S,
D)`` layout.  k and v may carry fewer heads than q (grouped query
attention: query head ``h`` reads kv head ``h // (Hq / Hkv)``), and a
length of their own: ``Sq`` query rows over ``Skv`` keys, the
cross-attention of an encoder-decoder (the TPU kernel takes one ``S``);
a causal or windowed call takes ``Sq == Skv`` (its masks compare
positions of one sequence).
``prefix_len`` P > 0 (causal calls only) is the reference's prefix-LM
mask, PaliGemma's: positions below P see each other both ways, so a key
is open to a query where ``kpos ≤ max(qpos, P − 1)`` (the TPU kernel has
no prefix; the reference computes that attention in jnp,
``repro/models/layers.py:137``).
Any lengths work (partial tiles are masked).  Its plain version is
``kernels.ref.ref_flash_attention``; the model code reaches both through
``kernels.ops.flash_attention`` and ``kernels.ops.flash_attention_gqa``.

One launch runs one of two forward kernels of the source, by shape
(``design`` mirrors the rule): bf16 with ``D`` a multiple of 16 up to 128,
16-byte staging and no prefix goes to the tensor-core kernel (``wgmma``
for q·kᵀ, p split in two bf16 terms for p·v), everything else — float32,
the DiT path, any prefix call — to the FFMA template.

``flash_attention_bwd`` launches the backward (three kernels of
``csrc/flash_attention_bwd.cu``): causal, prefix-LM, sliding-window and
grouped-query attention in float32 or bf16 with ``D ≤ 256``, from the
forward's row log-sum-exp (``flash_attention(..., with_lse=True)``); dq,
dk and dv rounded once to their input's dtype.  Two routes by shape
(``bwd_design`` mirrors the rule): bf16 with ``D`` a multiple of 16 up to
128, 16-byte staging and no prefix goes to the tensor-core kernels (Δ,
then a dK/dV kernel and a dQ kernel on ``wgmma``, P and dS split in two
bf16 terms; the only scratch is Δ), everything else — float32, the DiT
path, any prefix call, ``D > 128`` — to the FFMA route (Δ, then dK, dV
and each key tile's float32 share of dQ, then the shares added; every
product an IEEE float32 FFMA; key tiles of 64, of 32 at ``D > 128``).
The TPU kernel has no backward; this one replaces XLA's autodiff of the
reference's training attention (``repro/models/layers.py:137``).  Its plain version
is ``kernels.ref.ref_flash_attention_bwd``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

MAX_D = 256
#: largest head dim of the backward (``D > 128`` on the FFMA route only)
BWD_MAX_D = 256
_MAX_HEADS = 65535             # CUDA grid y limit on B·H
#: the tensor-core kernel's widest head dim, its query tile and its grid
#: y limit on query tiles
TC_MAX_D = 128
_TC_BQ, _TC_MAX_TILES = 128, 65535

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def staging_is_vec(q, k, v) -> bool:
    """The launcher's 16-byte staging rule: D and every batch, head and
    row stride of q, k, v and the output (``empty_like(q)``) whole 16-byte
    chunks of elements, every base 16-byte aligned (the stride of an axis
    of length 1 is never used)."""
    ev = 16 // q.element_size()
    out = torch.empty_like(q, device="meta")

    def rows_ok(t):
        return ((t.shape[0] == 1 or t.stride(0) % ev == 0)
                and (t.shape[1] == 1 or t.stride(1) % ev == 0)
                and t.stride(2) % ev == 0)
    return (q.shape[-1] % ev == 0 and rows_ok(out)
            and all(rows_ok(t) and t.data_ptr() % 16 == 0 for t in (q, k, v)))


def bwd_max_s(d: int) -> int:
    """The backward's longest kv length at head dim ``d`` (grid y: 65,535
    key tiles of 64, of 32 at ``D > 128``)."""
    return 65535 * (32 if d > 128 else 64)


def design(q, k, v, prefix_len: int = 0) -> str:
    """Which forward kernel one launch on these operands runs (the rule of
    ``flash_attention`` in ``csrc/flash_attention.cu``): ``"wgmma bf16"``
    for bf16 with ``D % 16 == 0``, ``D ≤ 128``, 16-byte staging, at most
    65,535 query tiles of 128 and no prefix, else ``"FFMA"``."""
    s, d = q.shape[2], q.shape[3]
    if (q.dtype == torch.bfloat16 and d % 16 == 0 and d <= TC_MAX_D
            and not prefix_len and -(-s // _TC_BQ) <= _TC_MAX_TILES
            and staging_is_vec(q, k, v)):
        return "wgmma bf16"
    return "FFMA"


def bwd_design(q, k, v, d_out, prefix_len: int = 0) -> str:
    """Which route one backward launch on these operands runs (the rule of
    ``flash_attention_bwd`` in ``csrc/flash_attention_bwd.cu``):
    ``"wgmma bf16"`` for bf16 with ``D % 16 == 0``, ``D ≤ 128``, no prefix
    and 16-byte staging (``staging_is_vec``) of q, k, v, d_out and of the
    gradients (``empty_like`` of q, k, v: their rows follow from the
    operands'), else ``"FFMA"``."""
    d = q.shape[-1]
    if (q.dtype == torch.bfloat16 and d % 16 == 0 and d <= TC_MAX_D
            and not prefix_len and staging_is_vec(q, k, v)
            and staging_is_vec(d_out, k, v)):
        return "wgmma bf16"
    return "FFMA"


@functools.cache
def _fn():
    fn = _build.load_library("flash_attention").flash_attention
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i] + [ll] * 12 \
        + [i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.load_library("flash_attention_bwd").flash_attention_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 10 + [i] * 7 + [ctypes.POINTER(ctypes.c_longlong),
                                        i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_scratch_fn():
    fn = _build.load_library(
        "flash_attention_bwd").flash_attention_bwd_scratch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * 7 + [ctypes.POINTER(ctypes.c_longlong),
                                       i, i, i]
    fn.restype = ctypes.c_longlong
    return fn


def _bwd_operands(q, k, v, out, d_out, grads):
    """Pointers and the 24 (batch, head, position) strides of q, k, v,
    out, d_out, dq, dk, dv: the launcher's order."""
    order = (q, k, v, out, d_out) + tuple(grads)
    return ([t.data_ptr() for t in order],
            (ctypes.c_longlong * 24)(*[t.stride(i) for t in order
                                       for i in range(3)]))


def bwd_scratch_floats(q, k, v, out, d_out, *, causal: bool = False,
                       window: int = 0, prefix_len: int = 0) -> int:
    """The float32 scratch ``flash_attention_bwd`` allocates for these
    CUDA operands, as its route sizes it: ``B·H·Sq`` (Δ alone) on the
    tensor-core route; the open tile pairs' dQ shares and Δ on the FFMA
    route."""
    grads = [torch.empty_like(t, device="meta") for t in (q, k, v)]
    ptrs, strides = _bwd_operands(q, k, v, out, d_out, grads)
    b, h, sq, d = q.shape
    return _bwd_scratch_fn()(*ptrs, _DTYPES[q.dtype], b, h, k.shape[1], sq,
                             k.shape[2], d, strides, int(causal),
                             int(window), int(prefix_len))


#: the tensor-core backward's kernels, by ``which`` of
#: ``flash_attention_bwd_tc_attrs``: the dK/dV kernel, and the dQ kernel's
#: instance for equal q and kv lengths and its instance for ``Sq ≠ Skv``
BWD_TC_KERNELS = ("flash_attention_bwd_dkdv_wgmma",
                  "flash_attention_bwd_dq_wgmma",
                  "flash_attention_bwd_dq_wgmma (Sq ≠ Skv)")


@functools.cache
def _bwd_attrs_fn():
    fn = _build.load_library(
        "flash_attention_bwd").flash_attention_bwd_tc_attrs
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def bwd_tc_attrs(d: int) -> dict:
    """The tensor-core backward's kernels at head dim ``d`` as built:
    ``{name: {"registers": ..., "spill_bytes": ..., "smem_bytes": ...}}``
    (``cudaFuncGetAttributes``' ``numRegs`` and ``localSizeBytes``, and the
    launch's dynamic shared bytes)."""
    attrs = {}
    for which, name in enumerate(BWD_TC_KERNELS):
        out = (ctypes.c_int * 3)()
        rc = _bwd_attrs_fn()(d, which, out)
        if rc != 0:
            raise RuntimeError(f"{name} attributes at D {d}: CUDA error {rc}")
        attrs[name] = dict(registers=out[0], spill_bytes=out[1],
                           smem_bytes=out[2])
    return attrs


@functools.cache
def _tile_attrs_fn():
    fn = _build.load_library(
        "flash_attention_bwd").flash_attention_bwd_tile_attrs
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def bwd_tile_attrs(d: int, dtype: torch.dtype) -> dict:
    """The FFMA route's tile kernel at head dim ``d`` in ``dtype`` as
    built (its 16-byte-staging instance): ``{"registers", "spill_bytes",
    "smem_bytes"}``."""
    out = (ctypes.c_int * 3)()
    rc = _tile_attrs_fn()(d, _DTYPES[dtype], out)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_tile attributes at D {d}: "
                           f"CUDA error {rc}")
    return dict(registers=out[0], spill_bytes=out[1], smem_bytes=out[2])


def check_lengths(q, k, *, causal: bool, window: int,
                  prefix_len: int = 0) -> None:
    """Refuse what no kernel computes: a causal, windowed or prefix call
    over ``Sq ≠ Skv`` (its masks compare positions of one sequence), a
    prefix without ``causal`` (it opens the causal mask's future below
    P; the reference's ``chunked_attention`` ignores it without), and
    keys of length 0 under queries."""
    if prefix_len < 0 or (prefix_len and not causal):
        raise ValueError(f"a prefix-LM mask takes causal attention and "
                         f"prefix_len ≥ 0, got causal {causal}, prefix_len "
                         f"{prefix_len}")
    sq, skv = q.shape[2], k.shape[2]
    if (causal or window) and sq != skv:
        raise ValueError(f"causal or windowed attention takes equal q and "
                         f"kv lengths, got Sq {sq} and Skv {skv}")
    if skv == 0 and sq > 0:
        raise ValueError(f"{sq} query rows over no keys")


def flash_attention(
    q: torch.Tensor,          # (B, H, Sq, D)
    k: torch.Tensor,          # (B, Hkv, Skv, D)
    v: torch.Tensor,          # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    window: int = 0,
    softmax_scale: float | None = None,
    with_lse: bool = False,
    prefix_len: int = 0,
):
    """Launch the kernel on CUDA tensors; returns ``(B, H, Sq, D)`` in
    ``q``'s dtype, laid out in memory as ``q`` is (a transposed
    ``(B, S, H, D)`` view of the DiT's projections gives a transposed
    output, which reshapes back without a copy).  ``with_lse`` also
    returns each query row's log-sum-exp of its scaled logits, float32
    ``(B, H, Sq)``, which the backward needs (``(out, lse)``).

    q, k and v may be any strided views whose last axis is contiguous.
    Raises on anything the kernel does not take, and if the launch fails.
    """
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bf16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention launches on CUDA tensors only")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention operands must share one device")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, D) and k, v (B, Hkv, Skv, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, d):
        raise ValueError(f"q and kv batch and head dim must be equal: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    check_lengths(q, k, causal=causal, window=window, prefix_len=prefix_len)
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    if d > MAX_D:
        raise ValueError(f"head dim {d} exceeds the kernel's {MAX_D}")
    if b * h > _MAX_HEADS:
        raise ValueError(f"B·H = {b * h} exceeds the grid limit "
                         f"{_MAX_HEADS}")
    if d > 1 and any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must have a contiguous last axis")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if out.stride(-1) != 1 and d > 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               None if lse is None else lse.data_ptr(),
               _DTYPES[q.dtype], b, h, hkv, s, skv, d, *strides, int(causal),
               int(window), int(prefix_len), scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, out, lse, d_out, *, causal: bool = False,
                        window: int = 0,
                        softmax_scale: float | None = None,
                        prefix_len: int = 0):
    """Launch the backward on CUDA tensors: ``(dq, dk, dv)`` of attention
    with the forward's mask (``causal``, ``window``, ``prefix_len``;
    non-causal by default), each in its input's dtype and laid out as it
    is.  q, out, d_out ``(B, H, Sq, D)``; k, v ``(B, Hkv, Skv, D)`` with
    ``H % Hkv == 0`` (query head ``h`` reads kv head ``h // (H / Hkv)``;
    dk and dv sum over the query heads of a group).  All float32 or all bf16.  ``out`` and
    ``lse`` are the forward's (``with_lse=True``); ``d_out`` the gradient
    of ``out``.  Every operand may be a strided view with a contiguous
    last axis.  Raises on anything the kernel does not take, and if the
    launch fails."""
    ts = (q, k, v, out, d_out)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention_bwd takes float32 or bf16 q, k, v, "
                        f"out, d_out of one dtype, got "
                        f"{[t.dtype for t in ts]}")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    if not all(t.is_cuda and t.device == q.device for t in ts + (lse,)):
        raise ValueError("flash_attention_bwd launches on CUDA tensors of "
                         "one device only")
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or out.shape != q.shape or d_out.shape != q.shape):
        raise ValueError(f"flash_attention_bwd takes q, out, d_out of one "
                         f"(B, H, Sq, D) shape and k, v (B, Hkv, Skv, D), "
                         f"got {[tuple(t.shape) for t in ts]}")
    b, h, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, d):
        raise ValueError(f"q and kv batch and head dim must be equal: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    check_lengths(q, k, causal=causal, window=window, prefix_len=prefix_len)
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    if tuple(lse.shape) != (b, h, s) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous ({b}, {h}, {s})")
    if d > BWD_MAX_D:
        raise ValueError(f"head dim {d} exceeds the backward's {BWD_MAX_D}")
    if skv > bwd_max_s(d):
        raise ValueError(f"Skv {skv} exceeds the backward's {bwd_max_s(d)} "
                         f"at D {d}")
    if d > 1 and any(t.stride(-1) != 1 for t in ts):
        raise ValueError("q, k, v, out and d_out must have a contiguous "
                         "last axis")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    grads = [torch.empty_like(t) for t in (q, k, v)]   # unit last stride
    ptrs, strides = _bwd_operands(q, k, v, out, d_out, grads)
    shape = (_DTYPES[q.dtype], b, h, hkv, s, skv, d)
    mask = (int(causal), int(window), int(prefix_len))
    # the route's own float32 scratch: Δ on the tensor-core route, the open
    # tile pairs' dQ shares and Δ on the FFMA route
    scratch = torch.empty(_bwd_scratch_fn()(*ptrs, *shape, strides, *mask),
                          dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bwd_fn()(*ptrs[:5], lse.data_ptr(), scratch.data_ptr(), *ptrs[5:],
                   *shape, strides, *mask, scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{rc}")
    return tuple(grads)
