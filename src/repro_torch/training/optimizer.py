"""Optimizer substrate: AdamW, the learning-rate schedule, clipping, EMA.

Port of ``repro.training.optimizer``, functional on the port's nested-dict
parameter trees (``repro_torch.tree``), in the reference's operation order
(``torch.optim.AdamW`` places its epsilon and its weight decay otherwise):
β1=0.9, β2=0.999, ε=1e-8, weight decay 0 for experts / 1e-2 for the
router, linear warmup, optional cosine decay, global-norm gradient
clipping (max 1.0), and EMA(0.9999) of parameters after every step (§6.2).

Every quantity is a float32 tensor on the parameters' device; the step
count is an int32 tensor, as in the reference.  The updates run without
autograd and return new trees (the inputs are not modified).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

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


def clip_by_global_norm(grads: PyTree, max_norm: float):
    """``(grads · min(1, max_norm / max(‖g‖, 1e-12)), ‖g‖)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
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
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(b1, stepf.device), stepf)
    bc2 = 1.0 - torch.pow(_f32(b2, stepf.device), stepf)

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = tree_map(lambda g, m, v, p: _Updated(*upd(g, m, v, p)), grads,
                   state.mu, state.nu, params)
    new_p, new_m, new_v = (tree_map(lambda o: o[i], out) for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {
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
