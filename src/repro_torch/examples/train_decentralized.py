"""End-to-end decentralized training driver (paper Fig. 6; port of
``examples/train_decentralized.py``).

Full pipeline: corpus → stub-DINOv2 features → hierarchical k-means →
K isolated heterogeneous experts (2 DDPM + (K-2) FM, the paper's
2DDPM:6FM recipe scaled down) → independent router → self-describing
checkpoints → ensemble sampling report.

Default: tiny config.  ``--full`` trains DiT-B/2 (121M params/expert, the
paper's small scale; latent 32, 256 tokens, d 768, 12 layers) for
``--steps`` steps.  Runs on the card (every LayerNorm, attention and
their backward through the port's kernels); ``--device cpu`` runs the
kernels' plain versions.

The checkpoints are the reference's format (npz leaves plus a JSON
``__metadata__`` entry from ``expert_metadata``), so either package
serves them.  Random numbers come from ``torch.Generator``s seeded with
the reference's integers (``--seed + cid`` for an expert's init, 99 for
its steps, 777 and 55 for the router, 1 for the sampling noise): the
same recipe, other numbers.

The synthetic captions take the DiT config's ``text_len`` × ``text_dim``
(8 × 32 reduced, 77 × 768 under ``--full``); the reference keeps the
corpus default of 8 × 32 under ``--full`` too, which its text projection
(768 → 768) cannot take.

  PYTHONPATH=src python -m repro_torch.examples.train_decentralized \\
      --out ckpts
  PYTHONPATH=src python -m repro_torch.examples.train_decentralized \\
      --full --experts 8 --steps 300 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.fusion import ExpertSpec
from repro_torch.core.sampling import SamplerConfig, sample_ensemble
from repro_torch.data import SyntheticSpec, fit_clusters, sample_fid
from repro_torch.data.pipeline import ExpertDataStream, RouterDataStream
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.training import (AdamWConfig, ExpertTrainer,
                                  RouterTrainer, expert_metadata,
                                  load_checkpoint, save_checkpoint)
from repro_torch.weights import resolve_device


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _sync(device: torch.device) -> None:
    """Wait for the card's queued work before a clock read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def corpus_spec(cfg, num_clusters: int) -> SyntheticSpec:
    """The synthetic corpus of ``num_clusters`` categories at ``cfg``'s
    latent size, its captions of ``cfg``'s text length and width."""
    return SyntheticSpec(num_categories=num_clusters,
                         latent_size=cfg.latent_size, separation=3.0,
                         text_len=cfg.text_len, text_dim=cfg.text_dim)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--ddpm-experts", type=int, default=2,
                    help="paper's hetero recipe: 2 DDPM : rest FM")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "hddm_ckpts"))
    ap.add_argument("--full", action="store_true",
                    help="full DiT-B/2 (121M/expert) instead of reduced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    K = args.experts
    latent = 32 if args.full else 8
    cfg = dit_b2() if args.full else dit_b2().reduced(latent_size=latent)
    spec = corpus_spec(cfg, K)
    print(f"[1/4] clustering corpus into {K} partitions ...")
    cm, assign = fit_clusters(spec, corpus_size=1024, num_clusters=K,
                              num_fine=128, seed=args.seed, device=dev)
    print(f"      cluster sizes: {np.bincount(assign, minlength=K)}")

    apply_fn = D.make_expert_apply(cfg)
    n_params = None
    os.makedirs(args.out, exist_ok=True)

    print(f"[2/4] training {K} isolated experts "
          f"({args.ddpm_experts} DDPM : {K - args.ddpm_experts} FM) ...")
    for cid in range(K):
        obj = "ddpm" if cid < args.ddpm_experts else "fm"
        sch = "cosine" if obj == "ddpm" else "linear"
        trainer = ExpertTrainer(
            apply_fn=apply_fn, objective=obj, schedule_name=sch,
            opt=AdamWConfig(learning_rate=1e-4 if args.full else 3e-4,
                            warmup_steps=min(100, args.steps // 10)),
            ema_decay=0.9999 if args.full else 0.8, device=dev,
        )
        params = D.init(cfg, _gen(dev, args.seed + cid))
        if n_params is None:
            n_params = D.param_count(params)
            print(f"      expert size: {n_params/1e6:.1f}M params")
        state = trainer.init_state(params)
        stream = ExpertDataStream(spec, cm, cluster_id=cid,
                                  batch_size=args.batch, seed=cid,
                                  device=dev)
        step_gen = _gen(dev, 99)
        _sync(dev)
        t0 = time.time()
        for i in range(args.steps):
            state, m = trainer.train_step(state, step_gen,
                                          stream.next_batch(i))
        _sync(dev)
        print(f"      expert {cid} [{obj}] loss {m['loss']:.4f} "
              f"({time.time()-t0:.1f}s)")
        save_checkpoint(
            os.path.join(args.out, f"expert{cid}.npz"), state.ema,
            metadata=expert_metadata(
                name=f"expert{cid}", objective=obj, schedule=sch,
                cluster_id=cid, arch=cfg.name, step=args.steps,
            ),
        )
        del state, trainer

    print("[3/4] training router (independent, all clusters) ...")
    rcfg = router_b2(num_clusters=K)
    rcfg = rcfg if args.full else rcfg.reduced(latent_size=latent)
    rtrainer = RouterTrainer(
        apply_fn=lambda p, x, t: D.apply(rcfg, p, x, t), num_clusters=K,
        device=dev,
    )
    rstate = rtrainer.init_state(D.init(rcfg, _gen(dev, 777)))
    rstream = RouterDataStream(spec, cm, batch_size=args.batch, device=dev)
    router_gen = _gen(dev, 55)
    for i in range(args.steps):
        rstate, rm = rtrainer.train_step(rstate, router_gen,
                                         rstream.next_batch(i))
    print(f"      router acc {rm['acc']:.2f}")
    save_checkpoint(os.path.join(args.out, "router.npz"), rstate.params,
                    metadata={"num_clusters": K})

    print("[4/4] sampling with heterogeneous fusion ...")
    experts, eparams = [], []
    for cid in range(K):
        p, meta = load_checkpoint(os.path.join(args.out,
                                               f"expert{cid}.npz"),
                                  device=dev)
        experts.append(ExpertSpec(meta["name"], meta["objective"],
                                  meta["schedule"], apply_fn,
                                  meta["cluster_id"]))
        eparams.append(p)
    samples = sample_ensemble(
        experts, eparams, D.make_router_fn(rcfg, rstate.params),
        (64, latent, latent, 4), generator=_gen(dev, 1),
        config=SamplerConfig(num_steps=12, cfg_scale=1.0,
                             strategy="topk", top_k=2),
    )
    fid = sample_fid(spec, samples)
    print(f"done: {tuple(samples.shape)} samples, FID-proxy {fid:.3f}, "
          f"checkpoints in {args.out}")


if __name__ == "__main__":
    main()
