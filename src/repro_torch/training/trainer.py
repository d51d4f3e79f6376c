"""Trainers: isolated diffusion experts and the router (paper §6.2, §6.3).

Port of ``repro.training.trainer``.  The expert trainer is deliberately
self-contained — one expert, one data partition, one optimizer; nothing
references any other expert.  Training K experts is K independent
``ExpertTrainer`` runs (in the paper, on K contributors' GPUs).

The reference draws t, ε and the CFG drop mask inside its loss from one
JAX key split three ways.  The port draws them from a ``torch.Generator``
(``draw``), or takes them through ``draws=`` — one dict, as
``generate(noise=)`` takes its noise — so a caller can hand in another
run's numbers.  A step is ``torch.autograd.grad`` of the loss through the
model (on the card its LayerNorms and self-attention run the AdaLN and
attention kernels and their backward kernels), then the functional AdamW
and EMA updates of ``training.optimizer``.

Each trainer runs on ``device`` (``"cuda"`` by default; raises without a
GPU unless given ``device="cpu"``).  LM training (``make_lm_train_step``)
runs where its parameters lie: on the card every mixer's scan goes
through the SSD scan kernel and its backward kernel, and the AdamW update
runs in place (``adamw_update_``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.objectives import diffusion_loss, sample_timesteps
from repro_torch.core.schedules import Schedule, get_schedule
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update,
                                            adamw_update_, ema_init,
                                            ema_update)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import resolve_device


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: AdamWState
    ema: Any
    step: int = 0


def value_and_grad(loss_fn, params, has_aux: bool = False):
    """``loss_fn(params)`` and the gradient of its (first) value with
    respect to every leaf, as a tree of ``params``' structure."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        out = loss_fn(live)
        loss = out[0] if has_aux else out
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g)
             for p, g in zip(leaves, grads)}
    grads = tree_map(lambda p: by_id[id(p)], live)
    if has_aux:
        return (out[0].detach(),) + tree_map(lambda a: a.detach(),
                                             tuple(out[1:])), grads
    return loss.detach(), grads


def _metrics(values: dict) -> dict:
    """Floats of 0-d tensors, read in one copy from the device."""
    names = list(values)
    # the step's one read from the device  # lint: allow-host-sync
    host = torch.stack([values[n].to(torch.float32).reshape(())
                        for n in names]).cpu().tolist()
    return dict(zip(names, host))


@dataclasses.dataclass
class ExpertTrainer:
    """One decentralized diffusion expert (paper §6.2).

    apply_fn(params, x_t, t, text_emb=..., drop_mask=...) -> prediction.
    """

    apply_fn: Callable[..., torch.Tensor]
    objective: str                      # 'ddpm' | 'fm'
    schedule_name: str                  # 'cosine' | 'linear'
    opt: AdamWConfig = AdamWConfig()
    cfg_drop_prob: float = 0.1          # classifier-free guidance dropout
    ema_decay: float = 0.9999
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.schedule: Schedule = get_schedule(self.schedule_name)

    def init_state(self, params) -> TrainState:
        return TrainState(params=params, opt_state=adamw_init(params),
                          ema=ema_init(params), step=0)

    def draw(self, gen: torch.Generator, latents: torch.Tensor,
             with_text: bool = True) -> dict:
        """The step's random numbers from ``gen``: ``t`` in the
        objective's domain, ``eps`` like ``latents``, and (with text) the
        Bernoulli(``cfg_drop_prob``) drop mask; on the trainer's device."""
        b = latents.shape[0]
        dev = gen.device
        out = {
            "t": sample_timesteps(gen, b, objective=self.objective),
            "eps": torch.randn(tuple(latents.shape), generator=gen,
                               device=dev, dtype=torch.float32),
        }
        if with_text:
            out["drop"] = torch.rand((b,), generator=gen,
                                     device=dev) < self.cfg_drop_prob
        return {n: a.to(self.device) for n, a in out.items()}

    def loss(self, params, draws: dict, latents: torch.Tensor,
             text_emb: torch.Tensor | None) -> torch.Tensor:
        cond: dict = {}
        if text_emb is not None:
            # paper §2.5: conditioning dropped with p=0.1; dropped samples
            # use the learned null embedding (the model substitutes it
            # where the per-sample drop mask is set).
            cond = {"text_emb": text_emb, "drop_mask": draws["drop"]}
        return diffusion_loss(
            self.apply_fn, params, latents, draws["eps"], draws["t"],
            objective=self.objective, schedule=self.schedule, cond=cond)

    def train_step(self, state: TrainState, gen: torch.Generator | None,
                   batch: dict, *, draws: dict | None = None):
        """One AdamW step on ``batch`` (``latents``, optional
        ``text_emb``); the random numbers come from ``gen`` or, when
        given, ``draws`` (``t``, ``eps``, ``drop``).  Returns the new
        state and ``{"loss", "grad_norm", "lr"}`` as floats."""
        latents = batch["latents"].to(self.device)
        text = batch.get("text_emb")
        text = None if text is None else text.to(self.device)
        if draws is None:
            draws = self.draw(gen, latents, with_text=text is not None)
        loss, grads = value_and_grad(
            lambda p: self.loss(p, draws, latents, text), state.params)
        params, opt_state, metrics = adamw_update(
            self.opt, grads, state.opt_state, state.params)
        ema = ema_update(state.ema, params, self.ema_decay)
        return TrainState(params, opt_state, ema, state.step + 1), \
            _metrics({"loss": loss, **metrics})


@dataclasses.dataclass
class RouterTrainer:
    """Router classifier over noisy latents (paper §6.3).

    Trains with CE against ground-truth cluster ids; timesteps uniform on
    [0, 1], half the batch (by a fair coin per sample) perturbed with the
    DDPM cosine schedule and half with the FM linear path.
    """

    apply_fn: Callable[..., torch.Tensor]   # (params, x_t, t) -> logits
    num_clusters: int
    opt: AdamWConfig = AdamWConfig(
        learning_rate=5e-5, weight_decay=1e-2, warmup_steps=0,
        cosine_decay=True, min_lr_ratio=0.01,
    )
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._lin = get_schedule("linear")
        self._cos = get_schedule("cosine")

    def init_state(self, params) -> TrainState:
        return TrainState(params=params, opt_state=adamw_init(params),
                          ema=ema_init(params), step=0)

    def draw(self, gen: torch.Generator, latents: torch.Tensor) -> dict:
        """``t ~ U(0,1)``, ``eps`` like ``latents`` and the per-sample
        coin ``use_cos`` (Bernoulli 0.5) from ``gen``."""
        b = latents.shape[0]
        dev = gen.device
        out = {
            "t": torch.rand((b,), generator=gen, device=dev),
            "eps": torch.randn(tuple(latents.shape), generator=gen,
                               device=dev, dtype=torch.float32),
            "use_cos": torch.rand((b,), generator=gen, device=dev) < 0.5,
        }
        return {n: a.to(self.device) for n, a in out.items()}

    def loss(self, params, draws: dict, latents: torch.Tensor,
             labels: torch.Tensor):
        """``(cross-entropy, accuracy)`` of the router on the draws'
        perturbed latents."""
        t, eps = draws["t"], draws["eps"]
        x_cos = self._cos.perturb(latents, eps, t)
        x_lin = self._lin.perturb(latents, eps, t)
        use_cos = draws["use_cos"].reshape((-1,) + (1,) * (latents.dim()
                                                           - 1))
        x_t = torch.where(use_cos, x_cos, x_lin)
        logits = self.apply_fn(params, x_t, t)
        logp = torch.log_softmax(logits, dim=-1)
        labels = labels.to(torch.int64)
        ce = -torch.mean(torch.gather(logp, -1, labels[:, None]))
        acc = torch.mean((torch.argmax(logits, -1) == labels).to(
            torch.float32))
        return ce, acc

    def train_step(self, state: TrainState, gen: torch.Generator | None,
                   batch: dict, *, draws: dict | None = None):
        """One AdamW step on ``batch`` (``latents``, ``cluster``); returns
        the new state and ``{"loss", "acc", "grad_norm", "lr"}``."""
        latents = batch["latents"].to(self.device)
        labels = batch["cluster"].to(self.device)
        if draws is None:
            draws = self.draw(gen, latents)
        (loss, acc), grads = value_and_grad(
            lambda p: self.loss(p, draws, latents, labels), state.params,
            has_aux=True)
        params, opt_state, metrics = adamw_update(
            self.opt, grads, state.opt_state, state.params)
        ema = ema_update(state.ema, params)
        return TrainState(params, opt_state, ema, state.step + 1), \
            _metrics({"loss": loss, "acc": acc, **metrics})


def make_lm_train_step(cfg, opt: AdamWConfig):
    """LM train step of the zoo architectures:
    ``step(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)``, with ``batch`` holding ``tokens`` and ``labels`` and
    metrics ``ce``, ``grad_norm`` and ``lr`` (0-d tensors, not read from
    the device).  The gradient of ``zoo.loss_fn``, then AdamW.  The step
    consumes ``params`` and ``opt_state``, as a jitted step with donated
    buffers does: the parameters and moments are updated in place
    (``adamw_update_``, bitwise ``adamw_update``'s numbers) and returned,
    so at mamba2-2.7b's width the step holds one set of parameters,
    gradients and moments."""
    from repro_torch.models import zoo

    def step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: zoo.loss_fn(cfg, p, batch), params, has_aux=True)
        params, opt_state, om = adamw_update_(opt, grads, opt_state, params)
        return params, opt_state, loss, {**metrics, **om}

    return step
