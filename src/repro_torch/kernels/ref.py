"""Plain PyTorch versions of the port's kernels (the correctness oracles).

Each kernel has a ``ref_<name>`` here with the signature of the reference
oracle of the same name (``repro.kernels.ref``).  The CPU path of every
wrapper in ``ops.py`` runs these, the tests hold them against the JAX
package, and ``chip_smoke.py`` holds each CUDA kernel against its plain
version on the card.
"""

from __future__ import annotations

import math

import torch


def ref_hetero_fuse_coeffs(
    preds: torch.Tensor,      # (K, B, T) native predictions of routed slots
    x_t: torch.Tensor,        # (B, T)
    weights: torch.Tensor,    # (B, K) fusion weights
    coef: torch.Tensor,       # (5, K, B) unified coefficient stack
    *,
    clamp: float = 20.0,
    alpha_min: float = 0.01,
) -> torch.Tensor:
    """Coefficient-folded convert-and-fuse: per slot
    ``x̂0 = clip((x − σ·p)/max(α, α_min), ±clamp)``,
    ``v = (α′·x̂0 + σ′·p)·vscale``, then ``Σ_k w_k v_k`` → ``(B, T)``,
    summed in slot order from 0 as the kernel does (ATen's CUDA sum over a
    leading axis of more than 4 slots keeps 4 partial sums).

    FM slots carry the identity coefficients (1, 0, 0, 1, 1), under which
    ``v = 0·x̂0 + 1·p`` — exact pass-through without a flag select.
    """
    coef = coef.to(torch.float32)
    alpha, sigma, dalpha, dsigma, vscale = (coef[i] for i in range(5))
    a = torch.clamp(alpha, min=alpha_min)[..., None]
    x0h = (x_t[None] - sigma[..., None] * preds) / a
    x0h = torch.clamp(x0h, -clamp, clamp)
    v = (dalpha[..., None] * x0h + dsigma[..., None] * preds) \
        * vscale[..., None]
    w = weights.movedim(-1, 0)[..., None]                  # (K, B, 1)
    out = torch.zeros_like(x_t, dtype=torch.float32)
    for k in range(preds.shape[0]):
        out = out + w[k] * v[k]
    return out


def ref_hetero_fuse_step(
    preds: torch.Tensor,      # (K, G, B, T) per-branch routed predictions
    x_t: torch.Tensor,        # (B, T)
    weights: torch.Tensor,    # (G, B, K) fusion weights per branch
    coef: torch.Tensor,       # (5, K, G, B) unified coefficient stack
    dt: torch.Tensor,         # (1,) shared or (B,) per-row Euler step
    *,
    cfg_scale: float = 1.0,
    clamp: float = 20.0,
    alpha_min: float = 0.01,
) -> torch.Tensor:
    """Step-fused convert + fuse + CFG + Euler.

    Per-branch convert-and-fuse (``ref_hetero_fuse_coeffs`` over the
    branch-major ``G·B`` batch), the CFG combine ``u_u + s·(u_c − u_u)``
    (branch 0 = cond, branch 1 = uncond; ``G = 1`` skips it), then
    ``x − u·dt``.
    """
    k, g, b, t = preds.shape
    fused = ref_hetero_fuse_coeffs(
        preds.reshape(k, g * b, t),
        torch.cat([x_t] * g, dim=0),
        weights.reshape(g * b, k),
        coef.reshape(5, k, g * b),
        clamp=clamp, alpha_min=alpha_min,
    )                                                      # (G·B, T)
    if g == 1:
        u = fused
    else:
        u = fused[b:] + cfg_scale * (fused[:b] - fused[b:])
    return x_t - u * dt.to(torch.float32).reshape(-1, 1)


def ref_hetero_fuse_dequant(
    q: torch.Tensor,          # (R, T) quantized values (int8 / float8_e4m3fn)
    scale: torch.Tensor,      # (R,) symmetric per-row scales
    *,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """``float(q)·scale[r]`` in float32 per row, then the cast (round to
    nearest even for bf16)."""
    out = q.to(torch.float32) * scale.to(torch.float32)[:, None]
    return out.to(out_dtype)


def ref_ragged_gemm(
    x: torch.Tensor,              # (M, D) expert-sorted rows
    w: torch.Tensor,              # (K, D, F) stacked expert weights
    tile_experts: torch.Tensor,   # (M // block_m,) expert id per row tile
    x_scale: torch.Tensor | None = None,   # (M,) per-row act scales
    w_scale: torch.Tensor | None = None,   # (K,) per-expert weight scales
) -> torch.Tensor:
    """Ragged grouped GEMM ``y[r] = x[r] @ w[e(r)]`` in float32.

    ``tile_experts`` carries one expert id per equal-height row tile (the
    port passes one per row group).  Rows of each expert contract as one
    matmul against that expert's weight, so memory stays ``O(M·F)``.
    Dense operands contract in float32.  Quantized operands contract as
    the kernel does: int8×int8 exactly (int32 on the CPU; float64 on the
    card, which has no int32 matmul — exact because |acc| ≤ 127²·D <
    2⁵³), fp8×fp8 in float32; then the epilogue
    ``(float(acc)·x_scale[row])·w_scale[e(r)]``.
    """
    m, d = x.shape
    gm = tile_experts.shape[0]
    row_e = torch.repeat_interleave(tile_experts.to(torch.int64), m // gm)
    y = torch.empty((m, w.shape[2]), dtype=torch.float32, device=x.device)
    if w.dtype == torch.int8:
        acc = torch.float64 if x.is_cuda else torch.int32
    else:
        acc = torch.float32
    xa = x.to(acc)
    # the plain version syncs to list the routed experts
    for e in torch.unique(row_e).tolist():  # lint: allow-host-sync
        rows = row_e == e
        y[rows] = (xa[rows] @ w[e].to(acc)).to(torch.float32)
    if x_scale is not None and w_scale is not None:
        y = (y * x_scale.to(torch.float32)[:, None]) \
            * w_scale.to(torch.float32)[row_e][:, None]
    return y


def _masked(logits: torch.Tensor, causal: bool, window: int,
            prefix_len: int = 0):
    """``(…, Sq, Skv)`` logits with the causal (``kpos ≤ qpos``; with a
    prefix ``P``, ``kpos ≤ qpos or (qpos < P and kpos < P)``: the
    reference's prefix-LM mask) and sliding-window (``qpos − kpos <
    window``) masks at ``-1e30``.  The masks compare positions of one
    sequence: with either, ``Sq ≠ Skv`` raises (an encoder-decoder's
    cross-attention is unmasked); a prefix without ``causal`` raises."""
    if prefix_len < 0 or (prefix_len and not causal):
        raise ValueError(f"a prefix-LM mask takes causal attention and "
                         f"prefix_len ≥ 0, got causal {causal}, prefix_len "
                         f"{prefix_len}")
    if not (causal or window):
        return logits
    if logits.shape[-2] != logits.shape[-1]:
        raise ValueError(f"causal or windowed attention takes equal q and "
                         f"kv lengths, got Sq {logits.shape[-2]} and Skv "
                         f"{logits.shape[-1]}")
    pos = torch.arange(logits.shape[-1], device=logits.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones(logits.shape[-2:], dtype=torch.bool,
                      device=logits.device)
    if causal:
        mask = mask & ((kpos <= qpos)
                       | ((qpos < prefix_len) & (kpos < prefix_len)))
    if window:
        mask = mask & (qpos - kpos < window)
    return torch.where(mask, logits, logits.new_tensor(-1e30))


def ref_flash_attention(
    q: torch.Tensor,          # (B, H, Sq, D)
    k: torch.Tensor,          # (B, H, Skv, D)
    v: torch.Tensor,          # (B, H, Skv, D)
    *,
    causal: bool = True,
    window: int = 0,
    softmax_scale: float | None = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Attention of ``Sq`` query rows over ``Skv`` keys: float32 logits
    ``q·kᵀ·scale``, causal (``kpos ≤ qpos``; with ``prefix_len`` P also
    every pair below P: the prefix-LM mask, causal calls only) and
    sliding-window (``qpos − kpos < window``) masks at ``-1e30`` (each
    takes ``Sq == Skv``), a float32 softmax over keys, then ``p·v``; the
    output in ``q``'s dtype."""
    d = q.shape[3]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    logits = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) \
        * scale
    logits = _masked(logits, causal, window, prefix_len)
    p = torch.softmax(logits, dim=-1)
    return (p @ v.to(torch.float32)).to(q.dtype)


def ref_adaln_fuse(
    x: torch.Tensor,                  # (B, ..., D)
    gamma: torch.Tensor | None,       # (B, D)
    beta: torch.Tensor | None,        # (B, D)
    eps: float = 1e-6,
    *,
    round_scale: bool = False,
) -> torch.Tensor:
    """``LN(x)·(1+γ)+β``: LayerNorm over the last axis without affine
    (population variance, float32 statistics), modulated per batch row,
    in float32, then cast to ``x``'s dtype.

    ``gamma = beta = None`` is the plain LayerNorm (γ = β = 0).
    ``round_scale`` computes ``1 + γ`` in ``γ``'s dtype (rounded to bf16
    for bf16 modulations), as the DiT's ``1.0 + γ`` does; the reference's
    kernel computes it in float32.
    """
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if gamma is None:
        return y.to(x.dtype)
    ex = (gamma.shape[0],) + (1,) * (x.dim() - 2) + (gamma.shape[-1],)
    scale = (1.0 + gamma) if round_scale else (1.0 + gamma.to(torch.float32))
    out = y * scale.to(torch.float32).reshape(ex) \
        + beta.to(torch.float32).reshape(ex)
    return out.to(x.dtype)


def ref_adaln_fuse_bwd(
    x: torch.Tensor,                  # (B, ..., D)
    gamma: torch.Tensor | None,       # (B, D)
    d_out: torch.Tensor,              # x's shape
    eps: float = 1e-6,
):
    """Backward of ``ref_adaln_fuse`` (float32, written out):
    ``x̂ = (x − μ)·rstd``, ``dŷ = dy·(1+γ)``,
    ``dx = rstd·(dŷ − mean(dŷ) − x̂·mean(dŷ·x̂))`` per row, and per batch
    row ``dγ = Σ dy·x̂``, ``dβ = Σ dy`` over its other axes (``None`` both
    without ``γ``).  ``dx`` has ``x``'s shape (one gradient per row that
    was read, broadcast views included)."""
    x32 = x.to(torch.float32)
    dy = d_out.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    rstd = torch.rsqrt(var + eps)
    xh = (x32 - mu) * rstd
    if gamma is None:
        gh = dy
    else:
        ex = (gamma.shape[0],) + (1,) * (x.dim() - 2) + (gamma.shape[-1],)
        gh = dy * (1.0 + gamma.to(torch.float32)).reshape(ex)
    dx = rstd * (gh - gh.mean(dim=-1, keepdim=True)
                 - xh * (gh * xh).mean(dim=-1, keepdim=True))
    if gamma is None:
        return dx, None, None
    b, d = x.shape[0], x.shape[-1]
    dgamma = (dy * xh).reshape(b, -1, d).sum(dim=1)
    dbeta = dy.reshape(b, -1, d).sum(dim=1)
    return dx, dgamma, dbeta


def ref_flash_attention_bwd(
    q: torch.Tensor,          # (B, H, Sq, D)
    k: torch.Tensor,          # (B, Hkv, Skv, D)
    v: torch.Tensor,          # (B, Hkv, Skv, D)
    d_out: torch.Tensor,      # (B, H, Sq, D)
    *,
    causal: bool = False,
    window: int = 0,
    softmax_scale: float | None = None,
    prefix_len: int = 0,
):
    """Backward of ``ref_flash_attention`` in float32, written out, with
    its causal, prefix-LM and sliding-window masks (non-causal by default)
    and grouped kv heads (query head ``h`` reads kv head ``h // (H/Hkv)``):
    ``P = softmax(mask(q·kᵀ·scale))``, ``dV = Pᵀ·dO``,
    ``dS = P ∘ (dO·Vᵀ − Δ)`` with ``Δ = rowsum(dO ∘ O)``,
    ``dQ = scale·dS·K``, ``dK = scale·dSᵀ·Q``, dK and dV summed over the
    query heads of each group.  Returns ``(dq, dk, dv)`` float32, dk and
    dv of k's shape."""
    b, h, _, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    q32, k32, v32 = (a.to(torch.float32) for a in (q, k, v))
    if g > 1:
        k32, v32 = (a.repeat_interleave(g, dim=1) for a in (k32, v32))
    do = d_out.to(torch.float32)
    logits = (q32 @ k32.transpose(-1, -2)) * scale
    logits = _masked(logits, causal, window, prefix_len)
    p = torch.softmax(logits, dim=-1)
    o = p @ v32
    dv = p.transpose(-1, -2) @ do
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = p * (do @ v32.transpose(-1, -2) - delta)
    dq = (ds @ k32) * scale
    dk = (ds.transpose(-1, -2) @ q32) * scale
    if g > 1:
        dk, dv = (a.reshape(b, hkv, g, skv, d).sum(dim=2) for a in (dk, dv))
    return dq, dk, dv


def ref_hetero_fuse(
    preds: torch.Tensor,      # (K, B, T) native expert predictions
    x_t: torch.Tensor,        # (B, T)
    weights: torch.Tensor,    # (B, K) router weights
    is_ddpm: torch.Tensor,    # (K,) bool: needs the ε→v conversion
    alpha: torch.Tensor,      # (K, B) schedule coefficients per expert/sample
    sigma: torch.Tensor,      # (K, B)
    dalpha: torch.Tensor,     # (K, B)
    dsigma: torch.Tensor,     # (K, B)
    vscale: torch.Tensor,     # (K, B) Eq. 31 dampening (1 for FM experts)
    *,
    clamp: float = 20.0,
    alpha_min: float = 0.01,
) -> torch.Tensor:
    """Flag-form convert-and-fuse (paper Fig. 2): DDPM experts
    ``x̂0 = clip((x − σε)/max(α, α_min), ±clamp)``,
    ``v = (α′x̂0 + σ′ε)·vscale``; FM experts pass through; then
    ``Σ_k w_k v_k`` summed in expert order from 0, as the kernel does."""
    a = torch.clamp(alpha, min=alpha_min)[..., None]
    x0h = (x_t[None] - sigma[..., None] * preds) / a
    x0h = torch.clamp(x0h, -clamp, clamp)
    v_conv = (dalpha[..., None] * x0h + dsigma[..., None] * preds) \
        * vscale[..., None]
    v = torch.where(is_ddpm.to(torch.bool)[:, None, None], v_conv, preds)
    w = weights.movedim(-1, 0)[..., None]                  # (K, B, 1)
    out = torch.zeros_like(x_t, dtype=torch.float32)
    for k in range(preds.shape[0]):
        out = out + w[k] * v[k]
    return out


def ref_ssd_scan(x, dt, A, B, C):
    """Oracle SSD recurrence: ``models.mamba2.ssd_sequential`` from the
    zero state (the kernel's contract, so no ``init_state``).

    x: (b, s, h, p); dt: (b, s, h); A: (h,); B, C: (b, s, n).  Returns
    (y (b, s, h, p) in x's dtype, final state (b, h, p, n) float32).
    """
    from repro_torch.models.mamba2 import ssd_sequential   # models import ops

    return ssd_sequential(x, dt, A, B, C)


def ref_ssd_scan_prep(B, C, tile: int, cap: int = 128):
    """The SSD scan's prep, once per (batch, tile) of ``tile`` positions:
    B, C ``(b, s, n)`` → ``(b, ceil(s / tile), 3, cap, cap)`` float32 of
    ``[C·Bᵀ transposed (entry [j][i] = C_i·B_j for j ≤ i, else 0),
    C transposed ([n][i]), B ([j][n])]``, zero padded to ``cap`` positions
    and state columns (the CUDA kernel's scratch, ``cap`` = 128)."""
    b, s, n = B.shape
    nt = -(-s // tile)
    f32 = torch.float32

    def tiles(a):
        a = torch.nn.functional.pad(a.to(f32), (0, 0, 0, nt * tile - s))
        return a.reshape(b, nt, tile, n)

    Bt, Ct = tiles(B), tiles(C)
    cb = Ct @ Bt.transpose(-1, -2)                          # (b, nt, i, j)
    lower = torch.tril(torch.ones(tile, tile, dtype=torch.bool,
                                  device=B.device))
    out = torch.zeros((b, nt, 3, cap, cap), dtype=f32, device=B.device)
    out[:, :, 0, :tile, :tile] = torch.where(lower, cb, 0.0).transpose(-1, -2)
    out[:, :, 1, :n, :tile] = Ct.transpose(-1, -2)
    out[:, :, 2, :tile, :n] = Bt
    return out


def ref_ssd_scan_bwd_states(dt, A, C, dy, d_state=None, *, chunk: int = 128):
    """The gradient of the state at the end of every chunk (the plain
    version of the backward's first stage, ``ssd_scan_bwd_states``), in
    the kernel's layout: dt ``(b, h, s)``, A ``(h,)``, C ``(b, s, n)``, dy
    ``(b, h, s, p)``, ``d_state`` ``(b, h, p, n)`` or ``None`` (zero).
    Chunks of ``chunk`` positions, a last partial one padded with ``dt =
    0``.  With ``cum`` the in-chunk cumulative ``dt·A``, walking the chunks
    in reverse from ``dS = d_state``:

      dS_end[k] = dS;  dS ← exp(cum_last,k)·dS + Σ_i exp(cum_i) dy_i ⊗ C_i

    Returns ``(b, h, ceil(s / chunk), p, n)`` float32."""
    f32 = torch.float32
    b, h, s, p = dy.shape
    n = C.shape[-1]
    nt = -(-s // chunk)
    pad = nt * chunk - s
    dtf = torch.nn.functional.pad(dt.to(f32), (0, pad))
    dyf = torch.nn.functional.pad(dy.to(f32), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C.to(f32), (0, 0, 0, pad))
    cum = torch.cumsum(dtf.reshape(b, h, nt, chunk) * A.to(f32)[:, None, None],
                       dim=-1)
    ecum = torch.exp(cum)
    elast = torch.exp(cum[..., -1])                     # (b, h, nt)
    dyt = dyf.reshape(b, h, nt, chunk, p)
    Ct = Cf.reshape(b, nt, chunk, n)
    dS = (torch.zeros((b, h, p, n), dtype=f32, device=dy.device)
          if d_state is None else d_state.to(f32))
    out = torch.empty((b, h, nt, p, n), dtype=f32, device=dy.device)
    for k in reversed(range(nt)):
        out[:, :, k] = dS
        dS = elast[:, :, k, None, None] * dS + torch.einsum(
            "bhip,bin->bhpn", ecum[:, :, k, :, None] * dyt[:, :, k], Ct[:, k])
    return out


def ref_ssd_scan_bwd(x, dt, A, B, C, dy, d_state=None, *, chunk: int = 128):
    """Backward of the SSD scan from the zero state, written out chunk by
    chunk in float32 (the plain version of the ``ssd_scan_bwd`` kernel),
    in the kernel's layout: x, dy ``(b, h, s, p)``, dt ``(b, h, s)``,
    A ``(h,)``, B, C ``(b, s, n)``; ``d_state`` the gradient of the final
    state ``(b, h, p, n)`` (``None``: zero).  Chunks of ``min(chunk, s)``
    positions, a last partial one padded with ``dt = 0`` (no decay, no
    input).  Per chunk, with ``cum`` the in-chunk cumulative ``dt·A``,
    ``L_ij = exp(cum_i − cum_j)`` (i ≥ j), ``M = (C·Bᵀ)∘L``, ``S₀`` the
    state at the chunk's start and ``dS`` the gradient of the state at
    its end, walking the chunks in reverse:

      g_j   = Σ_{i≥j} M_ij dy_i + exp(cum_last − cum_j)·dS B_j
      dx_j  = dt_j g_j,   ddt_j = x_j·g_j + A·da_j
      dP_ij = dy_i·dt_j x_j;  dC_i += Σ_j (dP∘L)_ij B_j + exp(cum_i) S₀ᵀ dy_i
      dB_j += Σ_i (dP∘L)_ij C_i + exp(cum_last − cum_j) dSᵀ dt_j x_j
      dcum  from every exponential, da = reverse-cumsum(dcum),
      dA   += Σ da·dt
      dS   ← exp(cum_last)·dS + Σ_i exp(cum_i) dy_i ⊗ C_i

    Returns ``(dx, ddt, dA, dB, dC)``: dx, dB, dC in the inputs' dtypes,
    ddt and dA float32."""
    f32 = torch.float32
    b, h, s, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    nt = -(-s // q)
    pad = nt * q - s

    def tiles(a, axis):                   # pad the position axis, split it
        a = a.to(f32)
        if pad:
            widths = [0, 0] * (a.dim() - 1 - axis) + [0, pad]
            a = torch.nn.functional.pad(a, widths)
        return a.reshape(a.shape[:axis] + (nt, q) + a.shape[axis + 1:])

    xf, dyf = tiles(x, 2), tiles(dy, 2)                 # (b, h, nt, q, p)
    dtf = tiles(dt, 2)                                  # (b, h, nt, q)
    Bf, Cf = tiles(B, 1), tiles(C, 1)                   # (b, nt, q, n)
    Af = A.to(f32)
    cum = torch.cumsum(dtf * Af[:, None, None], dim=-1)
    last = cum[..., -1:]
    lower = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(lower, cum[..., :, None] - cum[..., None, :],
                              -math.inf))               # (b, h, nt, i, j)
    M = (Cf @ Bf.transpose(-1, -2))[:, None] * L
    ecum, dte = torch.exp(cum), torch.exp(last - cum)
    elast = torch.exp(last[..., 0])                     # (b, h, nt)
    xdt = xf * dtf[..., None]

    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    starts = []
    for c in range(nt):                                 # forward states
        starts.append(state)
        upd = torch.einsum("bhjp,bjn->bhpn", xdt[:, :, c] * dte[:, :, c,
                                                                :, None],
                           Bf[:, c])
        state = elast[:, :, c, None, None] * state + upd

    dS = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
          if d_state is None else d_state.to(f32))
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros((h,), dtype=f32, device=x.device)
    for c in reversed(range(nt)):
        S0, dyc, Mc, Lc = starts[c], dyf[:, :, c], M[:, :, c], L[:, :, c]
        Bc, Cc, xdc = Bf[:, c], Cf[:, c], xdt[:, :, c]
        ec, dc = ecum[:, :, c], dte[:, :, c]
        g = (torch.einsum("bhij,bhip->bhjp", Mc, dyc)
             + dc[..., None] * torch.einsum("bjn,bhpn->bhjp", Bc, dS))
        dx[:, :, c] = dtf[:, :, c, :, None] * g
        dP = torch.einsum("bhip,bhjp->bhij", dyc, xdc)
        dCB = (dP * Lc).sum(dim=1)                                # (b, i, j)
        t = dP * Mc
        dcum = t.sum(dim=-1) - t.sum(dim=-2)
        dCp = ec[..., None] * torch.einsum("bhip,bhpn->bhin", dyc, S0)
        dBp = dc[..., None] * torch.einsum("bhjp,bhpn->bhjn", xdc, dS)
        dC[:, c] = dCB @ Bc + dCp.sum(dim=1)
        dB[:, c] = dCB.transpose(-1, -2) @ Cc + dBp.sum(dim=1)
        dcum = dcum + (dCp * Cc[:, None]).sum(dim=-1)
        sj = (dBp * Bc[:, None]).sum(dim=-1)
        dcum = dcum - sj
        dcum[..., -1] += sj.sum(dim=-1) + elast[:, :, c] * (dS * S0).sum(
            dim=(-1, -2))
        da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
        ddt[:, :, c] = (xf[:, :, c] * g).sum(dim=-1) + da * Af[:, None]
        dA = dA + (da * dtf[:, :, c]).sum(dim=(0, 2))
        dS = elast[:, :, c, None, None] * dS + torch.einsum(
            "bhip,bin->bhpn", ec[..., None] * dyc, Cc)

    def untile(a, axis):
        a = a.reshape(a.shape[:axis] + (nt * q,) + a.shape[axis + 2:])
        return a.narrow(axis, 0, s)

    return (untile(dx, 2).to(x.dtype), untile(ddt, 2), dA,
            untile(dB, 1).to(B.dtype), untile(dC, 1).to(C.dtype))
