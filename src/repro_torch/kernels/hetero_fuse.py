"""Launchers of the CUDA fuse and dequant kernels (``csrc/hetero_fuse.cu``).

* ``hetero_fuse_step`` replaces the TPU kernel
  ``repro/kernels/hetero_fuse.py:161``: per latent element, ε→v
  conversion of every routed slot's prediction, router fusion, the CFG
  combine and the Euler update, in one launch (``ops.fused_step``);
* ``hetero_fuse_coeffs`` replaces ``repro/kernels/hetero_fuse.py:95``:
  the conversion and fusion alone, writing the fused velocity — the
  unfused step path (``ops.fused_velocity``);
* ``hetero_fuse`` replaces ``repro/kernels/hetero_fuse.py:266``: the flag
  form of the conversion and fusion, with per-expert ``is_ddpm`` flags
  and raw ``(K, B)`` schedule coefficients (``ops.fused_convert_and_fuse``);
* ``hetero_fuse_dequant`` replaces ``repro/kernels/hetero_fuse.py:231``:
  ``float(q)·scale[r]`` over int8/e4m3 rows, cast to float32 or bf16 —
  every expansion of a quantized expert leaf (``ops.dequant_params``).

Their plain versions are the ``ref_*`` functions of the same names in
``kernels.ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point -> argtypes (set once, so a launch costs one ctypes call)
_ARGTYPES = {
    "hetero_fuse_step_f32": [_P] * 6 + [_I] * 5 + [_F] * 3 + [_P],
    "hetero_fuse_coeffs_f32": [_P] * 5 + [_I] * 3 + [_F] * 2 + [_P],
    "hetero_fuse_flags_f32": [_P] * 6 + [_I] * 3 + [_F] * 2 + [_P],
    "hetero_fuse_dequant": [_P, _I, _P, _P, _I, ctypes.c_longlong,
                            ctypes.c_longlong, _I, _P],
}


@functools.cache
def _fn(name: str):
    """A C entry point, built and loaded on first use."""
    fn = getattr(_build.load_library("hetero_fuse"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _stream(device_index: int) -> int:
    """The device's current CUDA stream as a raw handle (without building
    the ``torch.cuda.Stream`` object that ``current_stream`` returns)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _check_f32(name: str, ops_in) -> int:
    """Raise unless every operand is a contiguous float32 tensor on one
    CUDA device; returns the device's index.  One pass when they are."""
    dev = ops_in[0].get_device()
    if dev >= 0 and all(a.get_device() == dev and a.dtype == torch.float32
                        and a.is_contiguous() for a in ops_in):
        return dev
    if not all(a.is_cuda for a in ops_in):
        raise ValueError(f"{name} launches on CUDA tensors only")
    if any(a.device != ops_in[0].device for a in ops_in):
        raise ValueError(f"{name} operands must share one device")
    if any(a.dtype != torch.float32 for a in ops_in):
        raise TypeError(f"{name} takes float32 operands")
    if not all(a.is_contiguous() for a in ops_in):
        raise ValueError(f"{name} operands must be contiguous")
    return dev


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _shape_mismatch(**shapes) -> ValueError:
    return ValueError("shape mismatch: " + ", ".join(
        f"{n} {tuple(s.shape)}" for n, s in shapes.items()))


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
    """Launch the step kernel on CUDA float32 tensors; returns ``(B, T)``."""
    dev = _check_f32("hetero_fuse_step", (preds, x_t, weights, coef, dt))
    k, g, b, t = preds.shape
    if g not in (1, 2):
        raise ValueError(f"G must be 1 (no CFG) or 2 (cond, uncond); got {g}")
    if x_t.shape != (b, t) or weights.shape != (g, b, k) \
            or coef.shape != (5, k, g, b):
        raise _shape_mismatch(preds=preds, x_t=x_t, weights=weights,
                              coef=coef)
    if dt.dim() != 1 or dt.shape[0] not in (1, b):
        raise ValueError(f"dt must be (1,) or ({b},), got {tuple(dt.shape)}")
    out = torch.empty_like(x_t)
    _launched("hetero_fuse_step", _fn("hetero_fuse_step_f32")(
        preds.data_ptr(), x_t.data_ptr(), weights.data_ptr(),
        coef.data_ptr(), dt.data_ptr(), out.data_ptr(), k, g, b, t,
        int(dt.shape[0] == b and b > 1), cfg_scale, clamp, alpha_min,
        _stream(dev)))
    return out


def hetero_fuse_coeffs(
    preds: torch.Tensor,      # (K, B, T) routed-slot predictions
    x_t: torch.Tensor,        # (B, T)
    weights: torch.Tensor,    # (B, K) fusion weights
    coef: torch.Tensor,       # (5, K, B) unified coefficient stack
    *,
    clamp: float = 20.0,
    alpha_min: float = 0.01,
) -> torch.Tensor:
    """Launch the velocity kernel on CUDA float32 tensors; returns the
    fused velocity ``(B, T)``."""
    dev = _check_f32("hetero_fuse_coeffs", (preds, x_t, weights, coef))
    k, b, t = preds.shape
    if x_t.shape != (b, t) or weights.shape != (b, k) \
            or coef.shape != (5, k, b):
        raise _shape_mismatch(preds=preds, x_t=x_t, weights=weights,
                              coef=coef)
    out = torch.empty_like(x_t)
    _launched("hetero_fuse_coeffs", _fn("hetero_fuse_coeffs_f32")(
        preds.data_ptr(), x_t.data_ptr(), weights.data_ptr(),
        coef.data_ptr(), out.data_ptr(), k, b, t, clamp, alpha_min,
        _stream(dev)))
    return out


def hetero_fuse(
    preds: torch.Tensor,      # (K, B, T) native expert predictions
    x_t: torch.Tensor,        # (B, T)
    weights: torch.Tensor,    # (B, K) router weights
    is_ddpm: torch.Tensor,    # (K,) bool
    coef: torch.Tensor,       # (5, K, B) raw α, σ, α′, σ′, vscale
    *,
    clamp: float = 20.0,
    alpha_min: float = 0.01,
) -> torch.Tensor:
    """Launch the flag-form kernel on CUDA float32 tensors (``is_ddpm``
    bool; the reference kernel's five ``(K, B)`` coefficient operands
    stacked as it stacks them); returns the fused velocity ``(B, T)``."""
    dev = _check_f32("hetero_fuse", (preds, x_t, weights, coef))
    if is_ddpm.dtype != torch.bool or not is_ddpm.is_cuda \
            or is_ddpm.device != preds.device:
        raise TypeError("is_ddpm must be a bool tensor on the operands' "
                        "device")
    k, b, t = preds.shape
    if tuple(x_t.shape) != (b, t) or tuple(weights.shape) != (b, k) \
            or tuple(coef.shape) != (5, k, b) or tuple(is_ddpm.shape) != (k,):
        raise _shape_mismatch(preds=preds, x_t=x_t, weights=weights,
                              coef=coef, is_ddpm=is_ddpm)
    out = torch.empty_like(x_t)
    _launched("hetero_fuse", _fn("hetero_fuse_flags_f32")(
        preds.data_ptr(), x_t.data_ptr(), weights.data_ptr(),
        is_ddpm.contiguous().data_ptr(), coef.data_ptr(), out.data_ptr(),
        k, b, t, clamp, alpha_min, _stream(dev)))
    return out


_Q_KIND = {torch.int8: 0, torch.float8_e4m3fn: 1}
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}


def hetero_fuse_dequant(q: torch.Tensor, scale: torch.Tensor, *,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Launch the dequant kernel: ``q`` ``(R, T)`` contiguous int8/e4m3,
    ``scale`` ``(R,)`` float32 → ``(R, T)`` in ``out_dtype`` (float32 or
    bf16)."""
    if q.dtype not in _Q_KIND:
        raise TypeError(f"hetero_fuse_dequant takes int8 or float8_e4m3fn "
                        f"values, got {q.dtype}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"hetero_fuse_dequant writes float32 or bf16, "
                        f"got {out_dtype}")
    if not (q.is_cuda and scale.is_cuda) or q.device != scale.device:
        raise ValueError("hetero_fuse_dequant launches on CUDA tensors of "
                         "one device")
    if scale.dtype != torch.float32:
        raise TypeError("scale must be float32")
    if q.dim() != 2 or tuple(scale.shape) != (q.shape[0],):
        raise ValueError(f"q must be (R, T) and scale (R,), got "
                         f"{tuple(q.shape)}, {tuple(scale.shape)}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("q and scale must be contiguous")
    r, t = q.shape
    out = torch.empty((r, t), dtype=out_dtype, device=q.device)
    align = 16 if out_dtype == torch.float32 else 8
    vec4 = int(t % 4 == 0 and out.data_ptr() % align == 0)
    _launched("hetero_fuse_dequant", _fn("hetero_fuse_dequant")(
        q.data_ptr(), _Q_KIND[q.dtype], scale.data_ptr(), out.data_ptr(),
        _OUT_KIND[out_dtype], r, t, vec4, _stream(q.get_device())))
    return out
