"""Optimizer substrate: AdamW, the learning-rate schedule, clipping, EMA.

Port of ``repro.training.optimizer``, functional on the port's nested-dict
parameter trees (``repro_torch.tree``), in the reference's operation order
(``torch.optim.AdamW`` places its epsilon and its weight decay otherwise):
β1=0.9, β2=0.999, ε=1e-8, weight decay 0 for experts / 1e-2 for the
router, linear warmup, optional cosine decay, global-norm gradient
clipping (max 1.0), and EMA(0.9999) of parameters after every step (§6.2).

Every quantity is a float32 tensor on the parameters' device; the step
count is an int32 tensor, as in the reference.  The updates run without
autograd.  ``adamw_update`` and ``ema_update`` return new trees (the
inputs are not modified); ``adamw_update_``, the LM trainers' update,
computes the same numbers in place, a slice of each leaf at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.launch import fsdp
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 5000
    total_steps: int = 500_000
    cosine_decay: bool = False
    min_lr_ratio: float = 0.01
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    mu: PyTree
    nu: PyTree


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then constant (paper) or cosine decay (router §6.3)."""
    step = step.to(torch.float32)
    dev = step.device
    warm = torch.clamp((step + 1.0) / _f32(max(cfg.warmup_steps, 1), dev),
                       max=1.0)
    if not cfg.cosine_decay:
        return cfg.learning_rate * warm
    span = _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev)
    frac = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    floor = cfg.min_lr_ratio
    return cfg.learning_rate * warm * (floor + (1.0 - floor) * cos)


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.to(torch.float32)))
                for x in leaves)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float):
    """``(grads · min(1, max_norm / max(‖g‖, 1e-12)), ‖g‖)``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_init(params: PyTree) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
                 params: PyTree):
    """Returns ``(new_params, new_state, metrics)``; metrics hold the
    (pre-clip) ``grad_norm`` and the step's ``lr`` as 0-d tensors."""
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    out = tree_map(lambda g, m, v, p: _Updated(*_adam_leaf(
        cfg, g, m, v, p, lr, bc1, bc2)), grads, state.mu, state.nu, params)
    new_p, new_m, new_v = (tree_map(lambda o: o[i], out) for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {
        "grad_norm": gnorm, "lr": lr}


def _bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    stepf = step.to(torch.float32)
    return (1.0 - torch.pow(_f32(cfg.b1, stepf.device), stepf),
            1.0 - torch.pow(_f32(cfg.b2, stepf.device), stepf))


def _adam_leaf(cfg: AdamWConfig, g, m, v, p, lr, bc1, bc2):
    """One leaf's (or slice's) ``(new param, mu, nu)``."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = g.to(torch.float32)
    m = b1 * m + (1 - b1) * g32
    v = b2 * v + (1 - b2) * g32 * g32
    mhat = m / bc1
    vhat = v / bc2
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    if cfg.weight_decay:
        delta = delta + cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v


#: elements of one slice of ``adamw_update_``: its float32 temporaries
#: (about six at once) stay near 128 MB each.
SLICE_ELEMS = 1 << 25


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """``torch.sum(torch.square(g.to(float32)))`` — the same reduction of
    the same values as ``global_norm``'s — with one float32 temporary
    instead of two for a leaf of another dtype (squared in place)."""
    g32 = g.to(torch.float32)
    if g32 is g:
        return torch.sum(torch.square(g))
    return torch.sum(torch.square(g32, out=g32))


def _leading_slices(a: torch.Tensor):
    """Index ranges along ``a``'s leading axis, each of at most
    ``SLICE_ELEMS`` elements (at least one row); a 0-d ``a`` is one
    slice."""
    if a.dim() == 0:
        return [...]
    per = max(1, SLICE_ELEMS // max(1, a[0].numel()))
    return [slice(r, r + per) for r in range(0, a.shape[0], per)]


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
                  params: PyTree):
    """``adamw_update`` in place: the global norm, the clip and the
    update of ``adamw_update`` applied to one slice of each leaf's leading
    axis at a time (a layer of a stacked leaf), writing the new parameters
    and moments into ``params``, ``state.mu`` and ``state.nu``.  Each
    element goes through the same operations as in ``adamw_update``, so
    the results are bitwise equal on the same device; the memory is the
    parameters' and the moments' own plus one slice's temporaries, where
    ``adamw_update`` holds a second set of moments and whole-leaf float32
    temporaries.  Consumes its inputs (as a jitted step with donated
    buffers does) and returns ``(params, new state, metrics)``, the same
    parameter and moment tensors in a state with the next step count.
    Under an FSDP policy (``launch.fsdp``) the leaves are this rank's
    cuts, and the global norm sums each cut leaf's squares over the data
    ranks (``fsdp.square_sums``, the identity where none is installed)."""
    leaves = tree_leaves(grads)
    sums = fsdp.square_sums([_square_sum(g) for g in leaves])
    gnorm = torch.sqrt(sum(sums))
    scale = _clip_scale(gnorm, cfg.clip_norm) if cfg.clip_norm else None
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    for g, m, v, p in zip(leaves, tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        for sl in _leading_slices(p):
            gs = g[sl]
            if scale is not None:
                gs = gs * scale.to(gs.dtype)
            new_p, new_m, new_v = _adam_leaf(cfg, gs, m[sl], v[sl], p[sl],
                                             lr, bc1, bc2)
            p[sl] = new_p
            m[sl] = new_m
            v[sl] = new_v
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}


class _Updated:
    """One leaf's (param, mu, nu) after the update: a leaf to
    ``tree_map``, unlike a tuple."""

    def __init__(self, *parts):
        self.parts = parts

    def __getitem__(self, i):
        return self.parts[i]


# --- EMA (§6.2) --------------------------------------------------------------


def ema_init(params: PyTree) -> PyTree:
    return tree_map(lambda p: p.detach().to(torch.float32).clone(), params)


@torch.no_grad()
def ema_update(ema: PyTree, params: PyTree, decay: float = 0.9999):
    return tree_map(
        lambda e, p: decay * e + (1.0 - decay) * p.to(torch.float32),
        ema, params)
