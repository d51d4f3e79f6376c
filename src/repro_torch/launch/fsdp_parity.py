"""FSDP parity: a training step on a ``("data", "model")`` mesh of D ranks
(``launch.fsdp`` installed) against the unsharded step.

Every rank makes the same parameters (``zoo.init`` from a
``torch.Generator`` seed) and the same global batch (numpy draws from
the seed), runs the unsharded step on the whole batch
(``step_outputs``) and then the sharded one on its block
(``fsdp_outputs``), and writes a JSON line of the differences on its cut
(``compare``) — and, when asked, its cut of the outputs — into
``out_dir``.  Held, by the caller, to a gradient bound ``grad_rel``
(``GRAD_REL`` in float32):

* the loss within ``LOSS_REL`` of the unsharded loss;
* every gradient leaf within ``grad_rel`` of its largest |value| (of the
  model's largest, for a leaf whose gradient is 0 in exact arithmetic:
  below ``ZERO_GRAD_SHARE`` of it);
* the global gradient norm (the clip's, summed over the data ranks by
  ``fsdp.square_sums``) within ``grad_rel`` relative;
* the first moment (``(1 − b1)`` times the clipped gradient) within
  ``grad_rel`` of each leaf's largest |value|, as the gradients;
* every updated parameter within ``update_bound``: AdamW's first step
  moves an entry by ``lr·u/(|u| + ε)`` (``u`` the clipped gradient), so
  where the unsharded gradient is larger than the leaf's gradient
  difference the two moves share a sign and differ by at most
  ``lr·ε/(|u|_min + ε)``, plus rounding; only where it is not may the
  two move ±lr in opposite directions (``2·lr``).

    PYTHONPATH=src python -m repro_torch.launch.fsdp_parity --world 2 \\
        --device cpu [--arch internlm2-1.8b] [--full] [--layers 2]

spawns ``--world`` gloo ranks (``launch.mesh.spawn``) and prints one JSON
line per rank; a world of 1 is the ``(1, 1)`` mesh, whose step must be
bitwise the unsharded one.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.launch import fsdp
from repro_torch.launch.mesh import data_axes, make_lm_mesh, spawn
from repro_torch.launch.sharding import batch_specs, param_specs
from repro_torch.launch.steps import apply_update, make_grad_step
from repro_torch.models import zoo
from repro_torch.models.frontend_stubs import (audio_frame_embeddings,
                                               vision_patch_embeddings)
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves, tree_map

#: the loss's bound, relative to the unsharded loss
LOSS_REL = 1e-4
#: a gradient leaf's bound, relative to its largest |value| (the port's
#: first-step gradient checks; float32)
GRAD_REL = 1e-3
#: the learning rate of the compared step (warm-up of one step)
LR = 1e-3
#: a gradient leaf whose largest |value| is below this share of the
#: model's is rounding noise around an exact 0 (whisper's key biases: the
#: softmax cancels them); it is held to the model's largest
ZERO_GRAD_SHARE = 2.0 ** -17


def make_inputs(cfg, batch: int, seq: int, seed: int, device):
    """Seeded parameters and a ``(batch, seq)`` batch (its tokens and
    next-token labels drawn in numpy, the stubbed frames or patches of the
    audio and VLM families) on ``device``."""
    dev = torch.device(device)
    params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                      dev)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    out = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
           "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
    if cfg.arch_type == "audio":
        out["audio_embeds"] = audio_frame_embeddings(cfg, batch, seed, dev)
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = vision_patch_embeddings(cfg, batch, seed, dev)
    return params, out


def batch_block(batch: dict, mesh) -> dict:
    """This rank's block of a batch under ``batch_specs`` (a leaf the data
    size does not divide is whole on every rank)."""
    specs = batch_specs(None, mesh, batch)
    n, i = mesh.data_size, mesh.data_index

    def block(x, spec):
        if spec[0] is None:
            return x
        rows = x.shape[0] // n
        return x.narrow(0, i * rows, rows)

    return {k: block(v, specs[k]) for k, v in batch.items()}


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


#: the outputs ``compare`` holds (a step's loss, gradients, updated
#: parameters, first moment and global gradient norm)
OUTPUTS = ("loss", "grads", "params", "mu", "grad_norm")


def step_outputs(cfg, params, batch: dict, opt: AdamWConfig) -> dict:
    """The unsharded step on copies of ``params``: its loss, gradients,
    updated parameters, first moment and global gradient norm."""
    p = tree_map(torch.clone, params)
    loss, grads = make_grad_step(cfg)(p, batch)
    p, state, metrics = apply_update(opt, grads, adamw_init(p), p)
    return {"loss": loss, "grads": grads, "params": p, "mu": state.mu,
            "grad_norm": metrics["grad_norm"]}


def fsdp_outputs(cfg, params, batch: dict, opt: AdamWConfig, mesh) -> dict:
    """The step on ``mesh`` with the FSDP policy installed: this rank's
    cut of ``params``, its block of ``batch``.  Returns the loss, this
    rank's cut of the gradients, updated parameters and first moment, the
    global gradient norm, the step's seconds, the peak device bytes of
    its state and step (a CUDA run: the cut parameters, moments,
    gradients and activations, over what was allocated before), and the
    policy's collectives and the kernels' launches (``ops.LAUNCHES``;
    none on the CPU) during it."""
    specs = param_specs(params, mesh, fsdp=True)
    fsdp.install(mesh, specs, data_axes(mesh))
    dev = tree_leaves(params)[0].device
    if dev.type == "cuda":
        _sync(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        p = fsdp.shard_params(params)
        state = adamw_init(p)
        block = batch_block(batch, mesh)
        fsdp.reset_counts()
        ops.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        loss, grads = make_grad_step(cfg)(p, block)
        p, state, metrics = apply_update(opt, grads, state, p)
        _sync(dev)
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base
                if dev.type == "cuda" else None)
        return {"loss": loss, "grads": grads, "params": p, "mu": state.mu,
                "grad_norm": metrics["grad_norm"], "seconds": seconds, "peak_bytes": peak,
                "collectives": dict(fsdp.COUNTS),
                "launches": {k: n for k, n in ops.LAUNCHES.items() if n}}
    finally:
        fsdp.clear()


def cut_of(tree, mesh, params_shape):
    """This rank's cut of a whole tree shaped like ``params_shape`` (the
    unsharded outputs, to hold a rank's against)."""
    fsdp.install(mesh, param_specs(params_shape, mesh, fsdp=True),
                 data_axes(mesh))
    try:
        return fsdp.shard_params(tree)
    finally:
        fsdp.clear()


def _max_abs(x: torch.Tensor) -> float:
    return float(x.detach().float().abs().max()) if x.numel() else 0.0


def leaf_rel(got: list, want: list) -> list[float]:
    """Each leaf's largest difference over its largest |value| (over the
    model's largest times ``ZERO_GRAD_SHARE``, for a leaf of rounding
    noise around an exact 0)."""
    top = max(_max_abs(w) for w in want)
    return [_max_abs(g.float() - w.float())
            / max(_max_abs(w), ZERO_GRAD_SHARE * top, 1e-30)
            for g, w in zip(got, want)]


def _clip(opt: AdamWConfig, gnorm: float) -> float:
    return min(1.0, opt.clip_norm / max(gnorm, 1e-12)) if opt.clip_norm \
        else 1.0


def update_bound(p, w, g_want, g_diff: float, clip_lo: float,
                 opt: AdamWConfig) -> torch.Tensor:
    """Per entry, how far two first AdamW steps from one parameter may
    land apart when their gradients differ by at most ``g_diff`` (the
    leaf's largest difference) from the unsharded ``g_want`` and their
    clip scales are at least ``clip_lo``: where ``|g_want| > g_diff``
    both clipped gradients ``u`` share its sign and exceed ``clip_lo·(
    |g_want| − g_diff)``, so the moves ``lr·u/(|u| + ε)`` differ by at
    most ``lr·ε/(clip_lo·(|g_want| − g_diff) + ε)``; elsewhere by up to
    ``2·lr`` (opposite signs).  Plus 16 float32 roundings of the move and
    a rounding of the new value to the parameter's dtype (and float32's
    of the subtraction)."""
    lr, eps32 = opt.learning_rate, torch.finfo(torch.float32).eps
    ga = g_want.float().abs()
    # the difference as float32 computed it, rounded up
    g_diff = g_diff * (1 + 4 * eps32) + 1e-38
    # the clipped gradient rounds to the gradient's dtype before the moments
    low = clip_lo * (ga - g_diff) * (1 - torch.finfo(g_want.dtype).eps)
    k = torch.where(ga > g_diff, opt.eps / (low.clamp(min=0) + opt.eps),
                    torch.full_like(ga, 2.0))
    big = torch.maximum(p.float().abs(), w.float().abs())
    return (lr * (k + 16 * eps32)
            + (torch.finfo(w.dtype).eps + eps32) * big + 1e-30)


def compare(got: dict, want: dict, opt: AdamWConfig) -> dict:
    """The differences of a rank's outputs from the unsharded ones (both
    this rank's cut; see the module docstring): the loss's relative
    difference; the largest gradient and first-moment differences, each
    relative to its leaf's largest |value|; the global gradient norm's
    relative difference; the largest updated-parameter difference over
    its ``update_bound`` (≤ 1 holds); and whether all of them are bitwise
    equal."""
    dl = abs(float(got["loss"]) - float(want["loss"]))
    gn, wn = float(got["grad_norm"]), float(want["grad_norm"])
    bitwise = dl == 0.0 and gn == wn
    g_got, g_want = tree_leaves(got["grads"]), tree_leaves(want["grads"])
    grad_rels = leaf_rel(g_got, g_want)
    mu_rels = leaf_rel(tree_leaves(got["mu"]), tree_leaves(want["mu"]))
    clip_lo = min(_clip(opt, gn), _clip(opt, wn))
    param_ratio = 0.0
    for p, w, gg, gw in zip(tree_leaves(got["params"]),
                            tree_leaves(want["params"]), g_got, g_want):
        bitwise &= bool(torch.equal(p, w)) and bool(torch.equal(gg, gw))
        if p.numel():
            bound = update_bound(p, w, gw, _max_abs(gg.float() - gw.float()),
                                 clip_lo, opt)
            param_ratio = max(param_ratio, float(
                ((p.float() - w.float()).abs() / bound).max()))
    for m, w in zip(tree_leaves(got["mu"]), tree_leaves(want["mu"])):
        bitwise &= bool(torch.equal(m, w))
    return {"loss": float(got["loss"]),
            "loss_rel": dl / max(abs(float(want["loss"])), 1e-30),
            "grad_rel": max(grad_rels), "mu_rel": max(mu_rels),
            "grad_norm": gn, "grad_norm_rel": abs(gn - wn) / max(wn, 1e-30),
            "param_ratio": param_ratio, "bitwise": bitwise}


def within(row: dict, grad_rel: float) -> bool:
    """Whether ``compare``'s row meets the bounds (``LOSS_REL``,
    ``grad_rel`` for the gradients, the norm and the first moment, the
    parameters' ``update_bound``)."""
    return (row["loss_rel"] <= LOSS_REL and row["grad_rel"] <= grad_rel
            and row["grad_norm_rel"] <= grad_rel
            and row["mu_rel"] <= grad_rel and row["param_ratio"] <= 1.0)


def resolve_config(job: dict):
    """The job's config: the arch's full or ``reduced()`` config with the
    job's overrides (a float32 dtype named by string) and ``layers``."""
    from repro_torch.configs import get_config

    cfg = get_config(job["arch"])
    over = dict(job.get("overrides", {}))
    for k in ("param_dtype", "activation_dtype"):
        if isinstance(over.get(k), str):
            over[k] = getattr(torch, over[k])
    cfg = cfg if job.get("full") else cfg.reduced()
    if job.get("layers"):
        over["num_layers"] = job["layers"]
    return dataclasses.replace(cfg, fsdp_params=True, **over)


def run_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of a parity job (dict keys: ``arch``, ``full``,
    ``layers``, ``overrides``, ``batch``, ``seq``, ``seed``, ``device``,
    ``out_dir``; ``save`` to also write this rank's cut outputs,
    ``threads`` the rank's intra-op threads).  Returns and writes the
    JSON summary."""
    if job.get("threads"):
        torch.set_num_threads(job["threads"])
    cfg = resolve_config(job)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if job["device"] == "cuda" else torch.device(job["device"]))
    if dev.type == "cuda":
        # an earlier job's cached blocks, of other sizes, are not held on
        gc.collect()
        torch.cuda.empty_cache()
    params, batch = make_inputs(cfg, job["batch"], job["seq"], job["seed"],
                                dev)
    opt = AdamWConfig(learning_rate=LR, warmup_steps=1)
    mesh = make_lm_mesh(world, 1, device=dev)
    whole = step_outputs(cfg, params, batch, opt)
    want = {"loss": whole.pop("loss"), "grad_norm": whole.pop("grad_norm")}
    for k in ("grads", "params", "mu"):
        want[k] = cut_of(whole.pop(k), mesh, params)
    got = fsdp_outputs(cfg, params, batch, opt, mesh)
    row = {"rank": rank, "world": world, "arch": job["arch"],
           **compare(got, want, opt),
           "seconds": got["seconds"], "peak_bytes": got["peak_bytes"],
           "collectives": got["collectives"], "launches": got["launches"]}
    out_dir = job.get("out_dir")
    if out_dir:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(row, f)
        if job.get("save"):
            torch.save({k: got[k] for k in OUTPUTS},
                       os.path.join(out_dir, f"rank{rank}.pt"))
    return row


def parity_rank(rank: int, world: int, jobs: list) -> None:
    """``spawn``'s entry: every job in turn, each into its own
    ``out_dir``."""
    for job in jobs:
        run_rank(rank, world, job)


def read_rows(out_dir: str, world: int) -> list[dict]:
    rows = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            rows.append(json.load(f))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro_torch_fsdp_") as d:
        job = dict(arch=args.arch, full=args.full, layers=args.layers,
                   batch=args.batch, seq=args.seq, seed=args.seed,
                   device=args.device, out_dir=d)
        spawn(parity_rank, args.world, [job], backend=args.backend,
              device=args.device)
        for row in read_rows(d, args.world):
            print(json.dumps(row))


if __name__ == "__main__":
    main()
