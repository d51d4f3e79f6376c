"""Mamba2 / SSD (state-space duality) backbone [arXiv:2405.21060].

Port of ``repro.models.mamba2`` (mamba2-2.7b, the pure-SSM LM).  The SSD
recurrence per head h with state (P, N):

    s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * x_t ⊗ B_t
    y_t = s_t · C_t + D_h * x_t

The parameter dict has the reference's keys and layout: the per-layer
leaves are stacked ``(num_layers, ...)`` under ``blocks`` (the
reference's ``jax.vmap`` init), dense weights ``(in, out)``, so a
reference tree carries over leaf by leaf
(``repro_torch.weights.params_from_numpy``).  Layers run in a Python
loop over views of the stack, each leaf unbound once per call
(``tree.tree_unstack``: a backward stacks each leaf's gradient once).
With ``cfg.remat`` and gradients to take, ``forward_train`` recomputes
each layer's forward in the backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` of its scan body).

Every mixer of ``forward_train`` and ``prefill`` (``mode="train"`` from
the zero state) runs its chunked scan through ``kernels.ops.ssd_scan``:
the hand-written CUDA kernel on the card, its plain version
(``ssd_sequential``) on the CPU.  A mixer given a state goes through
``ssd_chunked``, the plain chunked algorithm; ``mode="decode"`` through
``ssd_decode_step``.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import LMConfig
from repro_torch.models.transformer import cross_entropy
from repro_torch.tree import tree_leaves, tree_stack_layers, tree_unstack
from repro_torch.weights import resolve_device

# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_sequential(x, dt, A, B, C, init_state=None):
    """Reference recurrence.

    x: (b, s, h, p); dt: (b, s, h) positive steps; A: (h,) negative rates;
    B, C: (b, s, n) (single group); init_state: optional (b, h, p, n).
    Returns (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) f32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    xf, dtf, Bf, Cf = (a.to(f32) for a in (x, dt, B, C))
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * A)[:, :, None, None]       # (b,h,1,1)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] \
            * Bf[:, t, None, None, :]
        state = decay * state + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{k=j+1..i} a_k for i >= j, -inf else.  a: (..., q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x, dt, A, B, C, *, chunk: int = 128, init_state=None):
    """Chunked SSD, the plain algorithm.  Same signature as
    ``ssd_sequential``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = ops.ssd_chunk_len(s, chunk)
    nc = s // q
    f32 = torch.float32
    xf = x.to(f32).reshape(b, nc, q, h, p)
    dtf = dt.to(f32).reshape(b, nc, q, h)
    Bf = B.to(f32).reshape(b, nc, q, n)
    Cf = C.to(f32).reshape(b, nc, q, n)

    a = dtf * A                                          # (b,nc,q,h)
    a_h = a.movedim(-1, 2)                               # (b,nc,h,q)
    lmat = torch.exp(_segsum(a_h))                       # (b,nc,h,q,q)

    cb = torch.einsum("bcin,bcjn->bcij", Cf, Bf)         # (b,nc,q,q)
    scores = cb[:, :, None] * lmat                       # (b,nc,h,i,j)
    xdt = xf * dtf[..., None]                            # (b,nc,q,h,p)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores, xdt)

    cum = torch.cumsum(a_h, dim=-1)                      # (b,nc,h,q)
    total = cum[..., -1:]
    decay_to_end = torch.exp(total - cum)
    w = decay_to_end.movedim(2, -1)                      # (b,nc,q,h)
    states = torch.einsum("bcqhp,bcqh,bcqn->bchpn", xf, dtf * w, Bf)
    chunk_decay = torch.exp(total[..., 0])               # (b,nc,h)

    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = chunk_decay[:, c, :, None, None] * state + states[:, c]
    prev = torch.stack(prevs, dim=1)                     # (b,nc,h,p,n)

    decay_in = torch.exp(cum)                            # (b,nc,h,q)
    y_inter = torch.einsum("bcin,bchpn,bchi->bcihp", Cf, prev, decay_in)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), state


def ssd_decode_step(state, x, dt, A, B, C):
    """Single-token state update.

    state: (b, h, p, n); x: (b, h, p); dt: (b, h); B, C: (b, n).
    Returns (y (b, h, p), new_state).
    """
    decay = torch.exp(dt * A)[:, :, None, None]
    upd = (dt[:, :, None] * x)[..., None] * B[:, None, None, :]
    state = decay * state.to(torch.float32) + upd
    y = torch.einsum("bhpn,bn->bhp", state, C)
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 mixer block
# ---------------------------------------------------------------------------


def mixer_init(cfg: LMConfig, gen: torch.Generator, device) -> dict:
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_ch = di + 2 * n
    pd = cfg.param_dtype
    f32 = torch.float32
    dt = torch.exp(
        torch.rand((h,), generator=gen, device=device)
        * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": L.dense_init(gen, d, 2 * di + 2 * n + h, device=device,
                                dtype=pd),
        "conv_w": (torch.randn((cfg.ssm_conv_width, conv_ch), generator=gen,
                               device=device)
                   * (1.0 / math.sqrt(cfg.ssm_conv_width))).to(pd),
        "conv_b": torch.zeros((conv_ch,), device=device, dtype=pd),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device,
                                          dtype=f32)),
        "dt_bias": torch.log(torch.expm1(dt)),
        "D": torch.ones((h,), device=device, dtype=f32),
        "gate_norm": L.rmsnorm_init(di, device=device, dtype=pd),
        "out_proj": L.dense_init(gen, di, d, device=device, dtype=pd),
    }


def _causal_conv(x, w, b, init=None):
    """Depthwise causal conv1d (width K).  x: (B, S, C); w: (K, C).

    Returns (y, tail) where tail (B, K-1, C) is the new conv cache (a
    copy: a view would keep the padded input alive).  Each tap's product
    and the running sum round in x's dtype, as the reference's ``sum`` of
    ``jnp`` products does.
    """
    kw = w.shape[0]
    if init is None:
        init = torch.zeros((x.shape[0], kw - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([init.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = 0
    for i in range(kw):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    tail = xp[:, -(kw - 1):].clone() if kw > 1 else init
    return y + b.to(x.dtype), tail


def _split_proj(cfg: LMConfig, zxbcdt):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt_raw = zxbcdt[..., 2 * di + 2 * n:]
    return z, xbc, dt_raw


def mixer_apply(cfg: LMConfig, p, hid, *, conv_state=None, ssm_state=None,
                mode: str = "train"):
    """Apply the Mamba2 mixer.  mode: 'train' (chunked) | 'decode'
    (S == 1).  Returns (out, (conv_tail, ssm_state))."""
    b, s, _ = hid.shape
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    pdim = cfg.ssm_headdim

    zxbcdt = L.dense(p["in_proj"], hid)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xbc, conv_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = L.silu(xbc)
    x = xbc[..., :di].reshape(b, s, h, pdim)
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = L.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode mode takes one token, got {s}")
        f32 = torch.float32
        y1, new_state = ssd_decode_step(
            ssm_state, x[:, 0].to(f32), dt[:, 0], A, B[:, 0].to(f32),
            C[:, 0].to(f32))
        y = y1[:, None]
    elif mode != "train":
        raise ValueError(f"unknown mixer mode {mode!r}")
    elif ssm_state is None:
        # the kernel's (B, H, S, P) layout as strided views of xbc; y
        # comes back laid out (b, s, h, p)
        yk, new_state = ops.ssd_scan(
            x.transpose(1, 2), dt.transpose(1, 2), A, B, C,
            chunk=cfg.ssm_chunk)
        y = yk.transpose(1, 2)
    else:
        y, new_state = ssd_chunked(x, dt, A, B, C, chunk=cfg.ssm_chunk,
                                   init_state=ssm_state)
    y = y.to(hid.dtype)
    y = y + p["D"][None, None, :, None].to(y.dtype) * x.to(y.dtype)
    y = y.reshape(b, s, di)
    y = L.rmsnorm(p["gate_norm"], y * L.silu(z.to(y.dtype)), cfg.norm_eps)
    out = L.dense(p["out_proj"], y)
    return out.to(hid.dtype), (conv_tail.to(hid.dtype), new_state)


# ---------------------------------------------------------------------------
# Full pure-SSM model (mamba2-2.7b)
# ---------------------------------------------------------------------------


def init(cfg: LMConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's structure and init scheme,
    drawn from ``gen`` on ``device`` (``None`` → ``"cuda"``); per-layer
    leaves stacked ``(num_layers, ...)`` under ``blocks``."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    blocks = tree_stack_layers(lambda: block_init(cfg, gen, dev),
                               cfg.num_layers)
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev,
                              dtype=pd),
        "blocks": blocks,
        "ln_final": L.rmsnorm_init(cfg.d_model, device=dev, dtype=pd),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                device=dev, dtype=pd),
    }


def block_init(cfg: LMConfig, gen: torch.Generator, device) -> dict:
    """One residual mixer block's parameters (RMSNorm, mixer)."""
    return {"ln": L.rmsnorm_init(cfg.d_model, device=device,
                                 dtype=cfg.param_dtype),
            "mixer": mixer_init(cfg, gen, device)}


def block_apply(cfg: LMConfig, bp: dict, h):
    """One residual mixer block from the zero state: (h + y, the block's
    (conv_tail, state))."""
    y, cache = mixer_apply(cfg, bp["mixer"],
                           L.rmsnorm(bp["ln"], h, cfg.norm_eps))
    return h + y, cache


def residual(cfg: LMConfig, bp: dict, h):
    return block_apply(cfg, bp, h)[0]


def _layers(cfg: LMConfig, params, tokens):
    """Embed ``tokens`` and run every residual mixer block from the zero
    state, yielding the hidden states and the layer's (conv_tail, state)
    after each layer (a caller that keeps no cache holds one layer's)."""
    h = L.embed(params["embed"], tokens, cfg.activation_dtype)
    for bp in tree_unstack(params["blocks"]):
        h, cache = block_apply(cfg, bp, h)
        yield h, cache


def forward_train(cfg: LMConfig, params, tokens):
    """(B, S) tokens -> ((B, S, V) logits, zero aux loss).  With
    ``cfg.remat``, when gradients are taken, each layer keeps only its
    input and runs its forward again in the backward."""
    remat = cfg.remat and torch.is_grad_enabled() and any(
        a.requires_grad for a in tree_leaves(params))
    h = L.embed(params["embed"], tokens, cfg.activation_dtype)
    for bp in tree_unstack(params["blocks"]):
        if remat:
            h = checkpoint(residual, cfg, bp, h, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = residual(cfg, bp, h)
    h = L.rmsnorm(params["ln_final"], h, cfg.norm_eps)
    logits = L.dense(params["unembed"], h)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg: LMConfig, params, tokens, labels):
    """Next-token cross-entropy of ``forward_train``'s logits (over chunks
    of ``cfg.logits_chunk`` positions): ``(ce, {"ce": ce})``."""
    logits, _ = forward_train(cfg, params, tokens)
    ce = cross_entropy(logits, labels, chunk=cfg.logits_chunk)
    return ce, {"ce": ce}


def make_cache(cfg: LMConfig, batch: int, max_len: int = 0, device=None):
    """SSM decode cache: conv tail + state per layer.  O(1) in seq len."""
    del max_len
    dev = resolve_device(device)
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((cfg.num_layers, batch, cfg.ssm_conv_width - 1,
                             conv_ch), dtype=cfg.activation_dtype,
                            device=dev),
        "ssm": torch.zeros((cfg.num_layers, batch, cfg.ssm_nheads,
                            cfg.ssm_headdim, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
    }


def prefill(cfg: LMConfig, params, tokens):
    """(B, S) tokens -> ((B, V) last-position logits, decode cache)."""
    caches = []
    for h, cache in _layers(cfg, params, tokens):
        caches.append(cache)
    hl = L.rmsnorm(params["ln_final"], h[:, -1:], cfg.norm_eps)
    logits = L.dense(params["unembed"], hl)[:, 0]
    return logits, {"conv": torch.stack([c for c, _ in caches]),
                    "ssm": torch.stack([s for _, s in caches])}


def decode_step(cfg: LMConfig, params, cache: dict, token, pos):
    """One token (B, 1) through every layer's decode update.  Returns
    ((B, V) logits, the new cache)."""
    del pos  # state carries all history
    h = L.embed(params["embed"], token, cfg.activation_dtype)
    convs, states = [], []
    for i, bp in enumerate(tree_unstack(params["blocks"])):
        y, (conv_tail, state) = mixer_apply(
            cfg, bp["mixer"], L.rmsnorm(bp["ln"], h, cfg.norm_eps),
            conv_state=cache["conv"][i], ssm_state=cache["ssm"][i],
            mode="decode")
        h = h + y
        convs.append(conv_tail)
        states.append(state)
    h = L.rmsnorm(params["ln_final"], h, cfg.norm_eps)
    logits = L.dense(params["unembed"], h)[:, 0]
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(states)}
