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

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.hetero_fuse import hetero_fuse_step as _fuse_step
from repro_torch.kernels.ragged_gemm import ragged_gemm as _ragged_gemm

#: CUDA launches per kernel wrapper since the last ``reset_launches()``.
LAUNCHES = {"ragged_gemm": 0, "hetero_fuse_step": 0}


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
        out = _fuse_step(pf.contiguous(), xf.contiguous(), wf.contiguous(),
                         cf.contiguous(), dt.contiguous(),
                         cfg_scale=cfg_scale, clamp=clamp,
                         alpha_min=alpha_min)
        LAUNCHES["hetero_fuse_step"] += 1
    else:
        out = _ref.ref_hetero_fuse_step(pf, xf, wf, cf, dt,
                                        cfg_scale=cfg_scale, clamp=clamp,
                                        alpha_min=alpha_min)
    return out.reshape((b,) + latent_shape)


def ragged_expert_matmul(
    x: torch.Tensor,          # (P, ..., D) per-group activations
    w: torch.Tensor,          # (K, D, F) stacked expert weights
    expert_ids: torch.Tensor,  # (P,) expert per row group
    *,
    bias: torch.Tensor | None = None,     # (K, F) stacked bias, optional
    w_scale: torch.Tensor | None = None,  # (K,) quantized stores only
) -> torch.Tensor:
    """Grouped expert dense: ``y[p] = x[p] @ w[expert_ids[p]] (+ bias)``.

    ``x`` carries ``P`` row groups (one per routed pair), each
    ``m = prod(middle dims)`` rows wide; they flatten to ``(P·m, D)`` rows
    for one ragged GEMM launch, whatever ``m`` is.  The per-expert bias is
    added after the GEMM.  Output float32 ``(P, ..., F)``.
    """
    if w_scale is not None or w.dtype != torch.float32:
        raise NotImplementedError(
            "quantized/cast expert weights (the int8/fp8 ragged_gemm body) "
            "are not ported yet — ROADMAP.md, kernel queue B")
    p = x.shape[0]
    d = x.shape[-1]
    mids = tuple(x.shape[1:-1])
    m = math.prod(mids)
    f = w.shape[-1]
    xf = x.reshape(p * m, d)
    if x.is_cuda:
        y = _ragged_gemm(xf.to(torch.float32).contiguous(), w,
                         expert_ids.to(torch.int32).contiguous(), m)
        LAUNCHES["ragged_gemm"] += 1
    else:
        y = _ref.ref_ragged_gemm(xf, w, expert_ids)
    y = y.reshape((p,) + mids + (f,))
    if bias is not None:
        y = y + bias[expert_ids].reshape((p,) + (1,) * len(mids) + (f,))
    return y
