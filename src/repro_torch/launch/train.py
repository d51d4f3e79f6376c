"""Training launcher of the port.

``--mode expert`` trains ONE decentralized diffusion expert (the paper's
unit of work — one contributor, one GPU, zero synchronization with other
experts): ``--objective ddpm|fm`` selects the heterogeneous objective,
``--cluster`` the data partition.  The reference's flags and defaults;
reduced configs unless ``--full`` (the unreduced ``--dit`` config, whose
latent is 32: pass ``--latent-size 32`` with it).  ``--out`` saves the EMA
parameters with the expert's metadata, which ``ServingEngine.
from_checkpoint_dir`` serves.

``--mode lm`` trains one LM expert of ``--arch`` (mamba2-2.7b, the
hybrid zamba2-2.7b, the dense internlm2-1.8b — the default —,
stablelm-1.6b, deepseek-67b and deepseek-coder-33b, the MoE mixtral-8x7b
and mixtral-8x22b, the encoder-decoder whisper-large-v3, whose batches
also take the stubbed frame embeddings ``audio_frame_embeddings(cfg,
batch, seed=i)``, and the VLM paligemma-3b, whose batches take the
stubbed patch embeddings ``vision_patch_embeddings(cfg, batch, seed=i)``)
on ``lm_batch`` token batches with ``make_lm_train_step``, printing each
step's loss; reduced unless ``--full``.

Runs on the card; ``--device cpu`` runs the kernels' plain versions.

  PYTHONPATH=src python -m repro_torch.launch.train --mode expert \\
      --objective ddpm --cluster 0 --steps 200 --out ckpts/expert0.npz
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch mamba2-2.7b --steps 20 --batch 4 --seq-len 1024 --full
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch internlm2-1.8b --steps 20 --batch 4 --seq-len 1024 --full
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
      --arch mixtral-8x7b --steps 3 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
      --arch whisper-large-v3 --steps 10 --batch 4 --seq-len 1024 --full
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch paligemma-3b --steps 10 --batch 4 --seq-len 1024 --full
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_dit_config
from repro_torch.data import SyntheticSpec, fit_clusters, lm_batch
from repro_torch.data.pipeline import ExpertDataStream
from repro_torch.models import dit as D
from repro_torch.models import zoo
from repro_torch.models.frontend_stubs import (audio_frame_embeddings,
                                               vision_patch_embeddings)
from repro_torch.training import (AdamWConfig, ExpertTrainer, adamw_init,
                                  expert_metadata, make_lm_train_step,
                                  save_checkpoint)
from repro_torch.weights import resolve_device


def train_expert(args) -> None:
    dev = resolve_device(args.device)
    spec = SyntheticSpec(num_categories=args.clusters,
                         latent_size=args.latent_size)
    cm, _ = fit_clusters(spec, corpus_size=args.corpus,
                         num_clusters=args.clusters,
                         num_fine=min(256, args.corpus // 4), device=dev)
    cfg = get_dit_config(args.dit)
    if not args.full:
        cfg = cfg.reduced(latent_size=args.latent_size)
    params = D.init(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    schedule = "cosine" if args.objective == "ddpm" else "linear"
    trainer = ExpertTrainer(
        apply_fn=D.make_expert_apply(cfg),
        objective=args.objective,
        schedule_name=schedule,
        opt=AdamWConfig(learning_rate=args.lr,
                        warmup_steps=min(100, args.steps // 10)),
        device=dev,
    )
    state = trainer.init_state(params)
    stream = ExpertDataStream(spec, cm, cluster_id=args.cluster,
                              batch_size=args.batch, seed=args.seed,
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    t0 = time.time()
    for i in range(args.steps):
        state, metrics = trainer.train_step(state, gen, stream.next_batch(i))
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:6d} loss {metrics['loss']:.4f} "
                  f"lr {metrics['lr']:.2e} ({time.time()-t0:.1f}s)")
    if args.out:
        save_checkpoint(
            args.out, state.ema,
            metadata=expert_metadata(
                name=f"expert{args.cluster}", objective=args.objective,
                schedule=schedule, cluster_id=args.cluster,
                arch=cfg.name, step=state.step,
            ),
        )
        print(f"saved EMA checkpoint -> {args.out}")


def train_lm(args) -> None:
    cfg = get_config(args.arch)
    dev = resolve_device(args.device)
    if not args.full:
        cfg = cfg.reduced()
    params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                      dev)
    opt = AdamWConfig(learning_rate=args.lr, warmup_steps=5)
    opt_state = adamw_init(params)
    step_fn = make_lm_train_step(cfg, opt)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    for i in range(args.steps):
        batch = lm_batch(gen, args.batch, args.seq_len, cfg.vocab_size)
        if cfg.arch_type == "audio":
            batch["audio_embeds"] = audio_frame_embeddings(
                cfg, args.batch, seed=i, device=dev)
        if cfg.arch_type == "vlm":
            batch["vision_embeds"] = vision_patch_embeddings(
                cfg, args.batch, seed=i, device=dev)
        params, opt_state, loss, metrics = step_fn(params, opt_state, batch)
        value = loss.item()  # lint: allow-host-sync — printed
        print(f"step {i:4d} loss {value:.4f}")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("expert", "lm"), default="expert")
    # expert mode
    ap.add_argument("--objective", choices=("ddpm", "fm"), default="fm")
    ap.add_argument("--cluster", type=int, default=0)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--dit", default="dit-b2")
    ap.add_argument("--latent-size", type=int, default=8)
    ap.add_argument("--corpus", type=int, default=1024)
    ap.add_argument("--out", default="")
    # lm mode
    ap.add_argument("--arch", choices=ARCH_IDS, default="internlm2-1.8b")
    ap.add_argument("--seq-len", type=int, default=128)
    # shared
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="use the full (unreduced) config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.mode == "expert":
        train_expert(args)
    else:
        train_lm(args)


if __name__ == "__main__":
    main()
