"""Wrappers the model code calls around the port's kernels.

Each wrapper dispatches on where its tensors lie: on a CUDA device it
launches the hand-written kernel (or raises — there is no fallback and no
switch to turn the kernel off); on the CPU it runs the kernel's plain
PyTorch version from ``kernels.ref``.  Every CUDA launch adds one to the
wrapper's count in ``LAUNCHES``, so a run can show that it went through
the kernels.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import hetero_fuse as _fuse
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ragged_gemm import ragged_gemm as _ragged_gemm

#: CUDA launches per kernel since the last ``reset_launches()``.
#: ``ragged_gemm`` counts the dense (float32/bf16 weight) body.
LAUNCHES = {"ragged_gemm": 0, "ragged_gemm_int8": 0, "ragged_gemm_fp8": 0,
            "hetero_fuse_step": 0, "hetero_fuse_coeffs": 0,
            "hetero_fuse_dequant": 0}

_QUANT_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, on every device.  PyTorch's CUDA division by
    a Python scalar multiplies by the rounded reciprocal, which differs
    from the reference's division in the last bit for most ``b``; dividing
    by a tensor keeps the IEEE quotient."""
    return a / a.new_tensor(b)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fused_step(
    preds: torch.Tensor,      # (K, G·B, *latent) per-branch slot predictions
    x_t: torch.Tensor,        # (B, *latent) current latent
    weights: torch.Tensor,    # (G·B, K) fusion weights
    coef: torch.Tensor,       # (5, K, G·B) unified coefficient stack
    dt: torch.Tensor,         # scalar, (1,) or (B,) Euler step size
    *,
    g: int,
    cfg_scale: float = 1.0,
    clamp: float = 20.0,
    alpha_min: float = 0.01,
) -> torch.Tensor:
    """Step-fused hot path: convert + fuse + CFG + Euler in one kernel.

    Takes the per-slot native predictions over the branch-major ``G·B``
    guidance batch (branch 0 = cond, branch 1 = uncond), the fusion
    weights, the per-step ``(5, K, G·B)`` coefficient slice and ``dt``,
    and returns the updated latent ``x − u·dt`` with ``u`` the
    CFG-combined fused velocity.
    """
    k = preds.shape[0]
    b = x_t.shape[0]
    latent_shape = tuple(x_t.shape[1:])
    t = math.prod(latent_shape)
    pf = preds.reshape(k, g, b, t)
    xf = x_t.reshape(b, t)
    wf = weights.reshape(g, b, k)
    cf = coef.reshape(5, k, g, b).to(torch.float32)
    dt = torch.as_tensor(dt, dtype=torch.float32,
                         device=x_t.device).reshape(-1)
    if dt.shape[0] not in (1, b):
        raise ValueError(f"dt must be a scalar or ({b},), got {dt.shape}")
    if x_t.is_cuda:
        out = _fuse.hetero_fuse_step(pf.contiguous(), xf.contiguous(),
                                     wf.contiguous(), cf.contiguous(),
                                     dt.contiguous(), cfg_scale=cfg_scale,
                                     clamp=clamp, alpha_min=alpha_min)
        LAUNCHES["hetero_fuse_step"] += 1
    else:
        out = _ref.ref_hetero_fuse_step(pf, xf, wf, cf, dt,
                                        cfg_scale=cfg_scale, clamp=clamp,
                                        alpha_min=alpha_min)
    return out.reshape((b,) + latent_shape)


def fused_velocity(
    preds: torch.Tensor,      # (K, B, *latent) routed-slot predictions
    x_t: torch.Tensor,        # (B, *latent)
    weights: torch.Tensor,    # (B, K) fusion weights
    coef: torch.Tensor,       # (5, K, B) unified coefficient stack
    *,
    clamp: float = 20.0,
    alpha_min: float = 0.01,
) -> torch.Tensor:
    """Convert-and-fuse of the unfused step path: the per-slot ε→v
    conversion and the router-weighted sum, returning the fused velocity
    ``(B, *latent)`` (the CFG combine and the Euler update follow as
    separate ops)."""
    k, b = preds.shape[0], preds.shape[1]
    latent_shape = tuple(preds.shape[2:])
    t = math.prod(latent_shape)
    pf = preds.reshape(k, b, t)
    xf = x_t.reshape(b, t)
    cf = coef.to(torch.float32)
    if x_t.is_cuda:
        out = _fuse.hetero_fuse_coeffs(pf.contiguous(), xf.contiguous(),
                                       weights.contiguous(), cf.contiguous(),
                                       clamp=clamp, alpha_min=alpha_min)
        LAUNCHES["hetero_fuse_coeffs"] += 1
    else:
        out = _ref.ref_hetero_fuse_coeffs(pf, xf, weights, cf, clamp=clamp,
                                          alpha_min=alpha_min)
    return out.reshape((b,) + latent_shape)


def dequant_params(
    q: torch.Tensor,          # (R, ...) quantized leaf view (int8 / fp8)
    scale: torch.Tensor,      # (R,) symmetric per-row scales
    *,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """``scale·q`` expansion of a gathered, sliced or whole quantized
    leaf: trailing dims flatten into one row per leading index."""
    rows = q.shape[0]
    trailing = tuple(q.shape[1:])
    qf = q.reshape(rows, -1) if trailing else q.reshape(rows, 1)
    if q.is_cuda:
        out = _fuse.hetero_fuse_dequant(qf.contiguous(),
                                        scale.to(torch.float32).contiguous(),
                                        out_dtype=out_dtype)
        LAUNCHES["hetero_fuse_dequant"] += 1
    else:
        out = _ref.ref_hetero_fuse_dequant(qf, scale, out_dtype=out_dtype)
    return out.reshape((rows,) + trailing)


#: max rows per ragged-GEMM row tile of the reference (``ops.py:247``).
_RAGGED_BLOCK_M = 256


def ragged_block_m(m: int) -> int | None:
    """The reference's row-tile rule (``repro/kernels/ops.py:250``): the
    tile must divide the group width ``m``, be a multiple of 8 rows and
    halve down to at most 256; ``None`` when no such tile exists.

    The port's kernel takes any width, but the reference computes another
    function for quantized weights on widths without a tile (dequantized
    weights against unquantized activations), so the port follows it.
    """
    if m <= 0 or m % 8:
        return None
    bm = m
    while bm > _RAGGED_BLOCK_M:
        if bm % 2:
            return None
        bm //= 2
    return bm


def quantize_rows(x: torch.Tensor, qdtype: torch.dtype):
    """Symmetric per-row activation quantization, as the reference does
    outside its kernel: ``xs = max(absmax, 1e-12) / qmax``, int8 rounds
    half to even and clips to ±127, fp8 casts."""
    x32 = x.to(torch.float32)
    absmax = torch.clamp(x32.abs().amax(dim=1), min=1e-12)
    xs = true_div(absmax, _QUANT_QMAX[qdtype])
    xq = x32 / xs[:, None]
    if qdtype == torch.int8:
        xq = torch.clamp(torch.round(xq), -127, 127)
    return xq.to(qdtype), xs


_GEMM_COUNTER = {torch.int8: "ragged_gemm_int8",
                 torch.float8_e4m3fn: "ragged_gemm_fp8"}


def _gemm(xf, w, ids, m, x_scale=None, w_scale=None) -> torch.Tensor:
    """One ragged GEMM over ``(P·m, D)`` rows: the kernel on the card, the
    plain version on the CPU."""
    if not xf.is_cuda:
        return _ref.ref_ragged_gemm(xf, w, ids, x_scale, w_scale)
    y = _ragged_gemm(xf.contiguous(), w, ids.to(torch.int32).contiguous(), m,
                     x_scale, w_scale)
    LAUNCHES[_GEMM_COUNTER.get(w.dtype, "ragged_gemm")] += 1
    return y


def ragged_expert_matmul(
    x: torch.Tensor,          # (P, ..., D) per-group activations
    w: torch.Tensor,          # (K, D, F) stacked expert weights (or quant)
    expert_ids: torch.Tensor,  # (P,) expert per row group
    *,
    bias: torch.Tensor | None = None,     # (K, F) stacked bias, optional
    w_scale: torch.Tensor | None = None,  # (K,) quantized stores only
) -> torch.Tensor:
    """Grouped expert dense: ``y[p] = x[p] @ w[expert_ids[p]] (+ bias)``.

    ``x`` carries ``P`` row groups (one per routed pair), each
    ``m = prod(middle dims)`` rows wide; they flatten to ``(P·m, D)`` rows
    for one ragged GEMM launch.  float32 and bf16 weights contract in
    float32.  int8/fp8 weights (with ``w_scale``) follow the reference:
    on a width with a row tile (``ragged_block_m``) the activations are
    quantized per row to the weights' dtype and contract in the int8/fp8
    kernel; on any other width the weights are dequantized
    (``dequant_params``) and contract in float32 against the unquantized
    activations.  The per-expert bias is added after the GEMM.  The
    output is float32, except at untiled widths where the reference's
    dtype promotion (bf16 activations against bf16 weights) gives bf16.
    """
    quantized = w.dtype in _QUANT_QMAX
    if quantized and w_scale is None:
        raise ValueError("quantized ragged_expert_matmul needs w_scale")
    if not quantized and w.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"{w.dtype} expert weights are not served: stores hold float32, "
            f"bf16, int8 or float8_e4m3fn leaves")
    p = x.shape[0]
    d = x.shape[-1]
    mids = tuple(x.shape[1:-1])
    m = math.prod(mids)
    f = w.shape[-1]
    xf = x.reshape(p * m, d)
    tiled = ragged_block_m(m) is not None
    if quantized and tiled:
        xq, xs = quantize_rows(xf, w.dtype)
        y = _gemm(xq, w, expert_ids, m, xs,
                  w_scale.to(torch.float32).contiguous())
    else:
        if quantized:
            w = dequant_params(w, w_scale)
        y = _gemm(xf.to(torch.float32), w, expert_ids, m)
        if not tiled:
            y = y.to(torch.promote_types(x.dtype, w.dtype))
    y = y.reshape((p,) + mids + (f,))
    if bias is not None:
        y = y + bias[expert_ids].reshape((p,) + (1,) * len(mids) + (f,))
    return y
