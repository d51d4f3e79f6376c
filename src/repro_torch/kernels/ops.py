"""Wrappers the model code calls around the port's kernels.

Each wrapper dispatches on where its tensors lie: on a CUDA device it
launches the hand-written kernel (or raises — there is no fallback and no
switch to turn the kernel off); on the CPU it runs the kernel's plain
PyTorch version from ``kernels.ref``.  Every CUDA launch adds one to the
wrapper's count in ``LAUNCHES``, so a run can show that it went through
the kernels.

``adaln_modulate``, ``layernorm``, ``flash_attention`` and ``ssd_scan``
are differentiable on both devices: on the CPU through autograd of the
plain versions; on the card, when an input requires grad, through a
``torch.autograd.Function`` whose backward is a hand-written kernel
(``adaln_fuse_bwd``, ``flash_attention_bwd``, ``ssd_scan_bwd``).  A call
the backward does not take (AdaLN operands not float32; attention with
``D > 256``, past the backward's grid or of another dtype than float32 or
bf16; a scan of another dtype than float32 or bf16, P > 64 or N > 128)
raises ``NotImplementedError`` rather than return a tensor without a
gradient.  The attention backward takes the forward's causal, prefix-LM
and window masks and grouped kv heads.  Without grad the forward
is the plain launch: nothing is saved, no log-sum-exp and no tile-start
state is written.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.conversion import (ConversionConfig, ddpm_flags,
                                         velocity_scale)
from repro_torch.core.schedules import Schedule
from repro_torch.kernels import hetero_fuse as _fuse
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.adaln_fuse import adaln_fuse as _adaln_fuse
from repro_torch.kernels.adaln_fuse import adaln_fuse_bwd as _adaln_fuse_bwd
from repro_torch.kernels.flash_attention import BWD_MAX_D as _FLASH_BWD_MAX_D
from repro_torch.kernels.flash_attention import bwd_max_s as _flash_bwd_max_s
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd as _flash_bwd
from repro_torch.kernels.ragged_gemm import ragged_gemm as _ragged_gemm
from repro_torch.kernels.ssd_scan import MAX_N as _SSD_MAX_N
from repro_torch.kernels.ssd_scan import MAX_P as _SSD_MAX_P
from repro_torch.kernels.ssd_scan import MAX_TILE as _SSD_MAX_TILE
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_scan
from repro_torch.kernels.ssd_scan import ssd_scan_bwd as _ssd_scan_bwd

#: CUDA launches per kernel since the last ``reset_launches()``.
#: ``ragged_gemm`` counts the dense (float32/bf16 weight) body;
#: ``adaln_fuse`` counts ``adaln_modulate`` and ``layernorm``;
#: ``adaln_fuse_bwd``, ``flash_attention_bwd`` and ``ssd_scan_bwd`` one
#: backward call each (each launches two or three kernels of its source).
LAUNCHES = {"ragged_gemm": 0, "ragged_gemm_int8": 0, "ragged_gemm_fp8": 0,
            "hetero_fuse_step": 0, "hetero_fuse_coeffs": 0,
            "hetero_fuse_dequant": 0, "hetero_fuse": 0, "adaln_fuse": 0,
            "flash_attention": 0, "ssd_scan": 0, "adaln_fuse_bwd": 0,
            "flash_attention_bwd": 0, "ssd_scan_bwd": 0}

#: the dry-run's op counter while one counts (``launch.op_cost.counting``):
#: given fake tensors (``FakeTensorMode``'s, which hold no values) the
#: attention and SSD scan wrappers then report their kernel — forward, and
#: backward where gradients flow — as one operation of its own cost
#: (``OpCost.kernel``) and return tensors of the kernel's shapes without
#: computing them; given real CPU tensors they compute as without it
COUNTER = None


def _counted(t: torch.Tensor) -> bool:
    """Whether ``COUNTER`` takes this call: one counts and ``t`` is
    fake."""
    if COUNTER is None:
        return False
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)

#: routed (sample, slot) pairs the ragged GEMM launches have run since the
#: last ``reset_launches()``, per body: the rows of each launch over
#: ``m`` (an expert-sharded rank counts only its resident experts' pairs).
RAGGED_PAIRS = {"ragged_gemm": 0, "ragged_gemm_int8": 0,
                "ragged_gemm_fp8": 0}

_QUANT_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, on every device.  PyTorch's CUDA division by
    a Python scalar multiplies by the rounded reciprocal, which differs
    from the reference's division in the last bit for most ``b``; dividing
    by a tensor keeps the IEEE quotient."""
    return a / a.new_tensor(b)


def _f32(a: torch.Tensor) -> torch.Tensor:
    """``a`` as float32, without a call when it already is."""
    return a if a.dtype == torch.float32 else a.to(torch.float32)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in RAGGED_PAIRS:
        RAGGED_PAIRS[name] = 0


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
    cf = _f32(coef).reshape(5, k, g, b)
    if not (isinstance(dt, torch.Tensor) and dt.dtype == torch.float32
            and dt.device == x_t.device):
        dt = torch.as_tensor(dt, dtype=torch.float32, device=x_t.device)
    if dt.dim() != 1:
        dt = dt.reshape(-1)
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
    return out.reshape(x_t.shape)


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
    t = math.prod(preds.shape[2:])
    pf = preds.reshape(k, b, t)
    xf = x_t.reshape(b, t)
    cf = _f32(coef)
    if x_t.is_cuda:
        out = _fuse.hetero_fuse_coeffs(pf.contiguous(), xf.contiguous(),
                                       weights.contiguous(), cf.contiguous(),
                                       clamp=clamp, alpha_min=alpha_min)
        LAUNCHES["hetero_fuse_coeffs"] += 1
    else:
        out = _ref.ref_hetero_fuse_coeffs(pf, xf, weights, cf, clamp=clamp,
                                          alpha_min=alpha_min)
    return out.reshape(preds.shape[1:])


def fused_convert_and_fuse(
    preds: torch.Tensor,          # (K, B, *latent) native predictions
    x_t: torch.Tensor,            # (B, *latent)
    weights: torch.Tensor,        # (B, K) router weights
    objectives: list[str],        # per-expert 'ddpm' | 'fm'
    schedules: list[Schedule],
    t: torch.Tensor,              # (B,) native time
    conv: ConversionConfig = ConversionConfig(),
) -> torch.Tensor:
    """The per-step fusion op of Fig. 2 from objectives and schedules:
    per expert and sample the schedule's α, σ and their derivatives
    (analytic or §8.3.3 finite differences) and the Eq. 31 dampening for
    DDPM experts, then the flag-form convert-and-fuse kernel over the
    flattened latents.  Returns the fused velocity ``(B, *latent)``."""
    is_ddpm = ddpm_flags(tuple(objectives), preds.device)
    k, b = preds.shape[0], preds.shape[1]
    latent_shape = tuple(preds.shape[2:])
    t = torch.as_tensor(t, device=preds.device)
    alpha = torch.stack([s.alpha(t) for s in schedules])          # (K, B)
    sigma = torch.stack([s.sigma(t) for s in schedules])
    if conv.derivative_mode == "fd":
        d = [s.fd_derivs(t) for s in schedules]
    else:
        d = [s.derivs(t) for s in schedules]
    dalpha = torch.stack([x[0] for x in d])
    dsigma = torch.stack([x[1] for x in d])
    vs = velocity_scale(t, conv.velocity_scaling)                 # (B,)
    vscale = torch.where(is_ddpm[:, None], vs[None], 1.0)
    pf = preds.reshape(k, b, -1)
    xf = x_t.reshape(b, -1)
    kw = dict(clamp=conv.clamp, alpha_min=conv.alpha_min)
    if preds.is_cuda:
        coef = torch.stack([alpha, sigma, dalpha, dsigma, vscale]).to(
            torch.float32)                                        # (5, K, B)
        out = _fuse.hetero_fuse(pf.contiguous(), xf.contiguous(),
                                weights.contiguous(), is_ddpm, coef, **kw)
        LAUNCHES["hetero_fuse"] += 1
    else:
        out = _ref.ref_hetero_fuse(pf, xf, weights, is_ddpm, alpha, sigma,
                                   dalpha, dsigma, vscale, **kw)
    return out.reshape((b,) + latent_shape)


def adaln_modulate(
    x: torch.Tensor,          # (B, ..., D)
    gamma: torch.Tensor,      # (B, D)
    beta: torch.Tensor,       # (B, D)
    *,
    eps: float = 1e-6,
    round_scale: bool = False,
) -> torch.Tensor:
    """AdaLN modulation ``LN(x)·(1+γ)+β`` (paper Eqs. 17/19): LayerNorm
    without affine in float32, ``γ``/``β`` per leading index, the output
    in ``x``'s dtype.  ``round_scale`` computes ``1 + γ`` in ``γ``'s dtype,
    as the DiT's ``1.0 + γ`` does for bf16 modulations (the reference's
    ``ops.adaln_modulate`` computes it in float32).  ``x`` may be a
    broadcast view; on the card it is read without a copy."""
    if not x.is_cuda:
        return _ref.ref_adaln_fuse(x, gamma, beta, eps,
                                   round_scale=round_scale)
    if _wants_grad(x, gamma, beta):
        _adaln_grad_supported(x, gamma, beta)
        return _AdaLN.apply(_rows_view(x), gamma, beta, eps).reshape(x.shape)
    out = _adaln_fuse(_rows_view(x), gamma, beta, eps=eps,
                      round_scale=round_scale)
    LAUNCHES["adaln_fuse"] += 1
    return out.reshape(x.shape)


def layernorm(x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis without affine (γ = β = 0 of
    ``adaln_modulate``; the DiT's LayerNorm before cross-attention), in
    ``x``'s dtype."""
    if not x.is_cuda:
        return _ref.ref_adaln_fuse(x, None, None, eps)
    if _wants_grad(x):
        _adaln_grad_supported(x, None, None)
        return _AdaLN.apply(_rows_view(x), None, None, eps).reshape(x.shape)
    out = _adaln_fuse(_rows_view(x), None, None, eps=eps)
    LAUNCHES["adaln_fuse"] += 1
    return out.reshape(x.shape)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _adaln_grad_supported(x, gamma, beta) -> None:
    dtypes = [t.dtype for t in (x, gamma, beta) if t is not None]
    if any(dt != torch.float32 for dt in dtypes):
        raise NotImplementedError(
            f"the adaln_fuse backward takes float32 x, gamma and beta, got "
            f"{dtypes} (bf16, and round_scale with bf16 gamma, are "
            f"forward-only)")


class _AdaLN(torch.autograd.Function):
    """``adaln_fuse`` forward and its backward kernel (float32): saves
    ``x`` and ``γ`` (the backward recomputes the statistics)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        out = _adaln_fuse(x, gamma, beta, eps=eps)
        LAUNCHES["adaln_fuse"] += 1
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, d_out):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = _adaln_fuse_bwd(x, gamma, d_out, eps=ctx.eps)
        LAUNCHES["adaln_fuse_bwd"] += 1
        return dx, dgamma, dbeta, None


def _rows_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel's ``(B, S, D)`` or ``(B, G, S, D)``: other ranks
    merge their middle axes (a copy only where they cannot be merged)."""
    if x.dim() in (3, 4):
        return x
    if x.dim() < 2:
        raise ValueError(f"adaln needs (B, ..., D), got {tuple(x.shape)}")
    return x.reshape(x.shape[0], -1, x.shape[-1])


def flash_attention(
    q: torch.Tensor,          # (B, H, Sq, D)
    k: torch.Tensor,          # (B, Hkv, Skv, D)
    v: torch.Tensor,          # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    window: int = 0,
    softmax_scale: float | None = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Attention in the reference's ``(B, H, S, D)`` layout: causal,
    prefix-LM (``prefix_len`` P: positions below P see each other both
    ways; causal calls only) and sliding-window masks, softmax scale
    (default ``1/sqrt(D)``), float32 accumulation, output in ``q``'s
    dtype.  k and v may carry fewer heads
    (``Hq % Hkv == 0``; query head ``h`` reads kv head ``h // (Hq/Hkv)``)
    and a length of their own (``Sq`` query rows over ``Skv`` keys: a
    cross-attention), which a causal or windowed call refuses (the kernel's
    launcher and the plain version both raise).  Strided views are read without a copy on the card, and the
    output is laid out as ``q`` is."""
    hq, hkv = q.shape[1], k.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv "
                         f"heads")
    if q.is_cuda:
        if _wants_grad(q, k, v):
            _flash_grad_supported(q, k, v)
            return _Flash.apply(q, k, v, causal, window, softmax_scale,
                                prefix_len)
        out = _flash(q, k, v, causal=causal, window=window,
                     softmax_scale=softmax_scale, prefix_len=prefix_len)
        LAUNCHES["flash_attention"] += 1
        return out
    if _counted(q):
        return _CountedFlash.apply(q, k, v, causal, window, prefix_len)
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    return _ref.ref_flash_attention(q, k, v, causal=causal, window=window,
                                    softmax_scale=softmax_scale,
                                    prefix_len=prefix_len)


def _flash_grad_supported(q, k, v) -> None:
    dtypes = {q.dtype, k.dtype, v.dtype}
    s, d = k.shape[2], q.shape[3]
    if (len(dtypes) != 1 or q.dtype not in (torch.float32, torch.bfloat16)
            or d > _FLASH_BWD_MAX_D or s > _flash_bwd_max_s(d)):
        raise NotImplementedError(
            f"the flash_attention backward takes float32 or bf16 q, k, v of "
            f"one dtype with D ≤ {_FLASH_BWD_MAX_D} and Skv ≤ "
            f"{_flash_bwd_max_s(d)}; got {q.dtype}, {k.dtype}, {v.dtype}, "
            f"D {d}, Skv {s}")


class _Flash(torch.autograd.Function):
    """The attention kernel and its backward kernel, with the forward's
    mask and grouped kv heads: the forward also writes each row's
    log-sum-exp, saved with q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softmax_scale, prefix_len):
        out, lse = _flash(q, k, v, causal=causal, window=window,
                          softmax_scale=softmax_scale, with_lse=True,
                          prefix_len=prefix_len)
        LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, prefix_len)
        ctx.scale = softmax_scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        if d_out.stride(-1) != 1:
            d_out = d_out.contiguous()
        causal, window, prefix_len = ctx.mask
        grads = _flash_bwd(q, k, v, out, lse, d_out, causal=causal,
                           window=window, softmax_scale=ctx.scale,
                           prefix_len=prefix_len)
        LAUNCHES["flash_attention_bwd"] += 1
        return (*grads, None, None, None, None)


def _flash_shape(q, k, causal, window, prefix_len) -> dict:
    b, hq, s, d = q.shape
    return dict(b=b, hq=hq, hkv=k.shape[1], s=s, skv=k.shape[2], d=d,
                elt=q.element_size(), causal=causal, window=window,
                prefix=prefix_len)


class _CountedFlash(torch.autograd.Function):
    """The attention kernel and its backward as ``COUNTER`` sees them:
    one operation each, outputs of their shapes, nothing computed."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        ctx.shape = _flash_shape(q, k, causal, window, prefix_len)
        ctx.save_for_backward(q, k, v)
        COUNTER.kernel("flash_attention", **ctx.shape)
        return q.new_empty(q.shape)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        COUNTER.kernel("flash_attention_bwd", **ctx.shape)
        return (q.new_empty(q.shape), k.new_empty(k.shape),
                v.new_empty(v.shape), None, None, None)


def flash_attention_gqa(q, k, v, *, causal=True, window=0,
                        softmax_scale=None, prefix_len=0) -> torch.Tensor:
    """GQA front end: q ``(B, Hq, Sq, D)``, k/v ``(B, Hkv, Skv, D)``.  The
    reference repeats kv heads before its MHA kernel; the port's kernel
    indexes kv head ``h // (Hq/Hkv)`` in place (same result, no copy)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           softmax_scale=softmax_scale, prefix_len=prefix_len)


def ssd_chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk rule: ``min(chunk, S)``, which must divide
    ``S`` (``repro/kernels/ssd_scan.py:100``, ``models/mamba2.py:97``)."""
    if s < 1 or chunk < 1:
        raise ValueError(f"SSD scan of {s} positions in chunks of {chunk}")
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {q}")
    return q


def ssd_scan(
    x: torch.Tensor,          # (B, H, S, P)
    dt: torch.Tensor,         # (B, H, S)
    A: torch.Tensor,          # (H,)
    B: torch.Tensor,          # (B, S, N)
    C: torch.Tensor,          # (B, S, N)
    *,
    chunk: int = 128,
    head_block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan from the zero state, in the TPU kernel's
    layout: returns y ``(B, H, S, P)`` in x's dtype and the final state
    ``(B, H, P, N)`` in float32 — on every device (the reference's CPU path
    drops the state).  ``S`` must be a multiple of ``min(chunk, S)``.
    x, B and C may be strided views with a contiguous last axis; on the
    card y is laid out ``(B, S, H, P)`` in memory, as on the CPU.
    ``head_block`` is the TPU kernel's head tiling, accepted for its
    signature: the CUDA kernel computes C·Bᵀ once per (batch, chunk), then
    runs one block per (batch, head).  Chunks longer than 128 positions
    scan in tiles of 128 on the card (the same function).  Differentiable:
    on the card through ``_SSD`` when an input requires grad."""
    del head_block
    q = ssd_chunk_len(x.shape[2], chunk)
    if x.is_cuda:
        tile = min(q, _SSD_MAX_TILE)
        dtf, Af = dt.to(torch.float32), A.to(torch.float32)
        if _wants_grad(x, dt, A, B, C):
            _ssd_grad_supported(x, B, C)
            return _SSD.apply(x, dtf, Af, B, C, tile)
        y, state = _ssd_scan(x, dtf, Af, B, C, chunk=tile)
        LAUNCHES["ssd_scan"] += 1
        return y, state
    if _counted(x):
        return _CountedSSD.apply(x, dt, A, B, C, q)
    y, state = _ref.ref_ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), A,
                                 B, C)
    return y.transpose(1, 2), state


class _CountedSSD(torch.autograd.Function):
    """The SSD scan kernel and its backward as ``COUNTER`` sees them:
    one operation each, outputs of their shapes, nothing computed."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        b, h, s, p = x.shape
        ctx.shape = dict(b=b, h=h, s=s, p=p, n=B.shape[-1], q=chunk,
                         elt=x.element_size())
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.set_materialize_grads(False)
        COUNTER.kernel("ssd_scan", **ctx.shape)
        return (x.new_empty(x.shape),
                x.new_empty((b, h, p, B.shape[-1]), dtype=torch.float32))

    @staticmethod
    def backward(ctx, dy, d_state):
        COUNTER.kernel("ssd_scan_bwd", **ctx.shape)
        return (*(t.new_empty(t.shape) for t in ctx.saved_tensors), None)


def _ssd_grad_supported(x, B, C) -> None:
    dtypes = {x.dtype, B.dtype, C.dtype}
    p, n = x.shape[-1], B.shape[-1]
    if (len(dtypes) != 1 or x.dtype not in (torch.float32, torch.bfloat16)
            or p > _SSD_MAX_P or n > _SSD_MAX_N):
        raise NotImplementedError(
            f"the ssd_scan backward takes float32 or bf16 x, B and C of one "
            f"dtype with P ≤ {_SSD_MAX_P} and N ≤ {_SSD_MAX_N}; got "
            f"{x.dtype}, {B.dtype}, {C.dtype}, P {p}, N {n}")


class _SSD(torch.autograd.Function):
    """The SSD scan kernel and its backward kernel: the forward also
    writes the state at each tile's start, saved with its inputs (the
    backward reads it instead of scanning again)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, tile):
        y, state, starts = _ssd_scan(x, dt, A, B, C, chunk=tile,
                                     with_starts=True)
        LAUNCHES["ssd_scan"] += 1
        ctx.save_for_backward(x, dt, A, B, C, starts)
        ctx.tile = tile
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        x, dt, A, B, C, starts = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        elif dy.dtype != x.dtype or dy.stride(-1) != 1:
            dy = dy.to(x.dtype).contiguous()
        grads = _ssd_scan_bwd(x, dt, A, B, C, starts, dy, d_state,
                              chunk=ctx.tile)
        LAUNCHES["ssd_scan_bwd"] += 1
        return (*grads, None)


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
    name = _GEMM_COUNTER.get(w.dtype, "ragged_gemm")
    LAUNCHES[name] += 1
    RAGGED_PAIRS[name] += ids.shape[0]
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
