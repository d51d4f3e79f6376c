"""Quickstart: heterogeneous decentralized diffusion in ~60 lines (port of
``examples/quickstart.py``).

Trains TWO experts in complete isolation — one DDPM (ε-prediction, cosine
schedule), one Flow Matching (velocity, linear path) — on disjoint
semantic clusters, then samples with router-weighted fusion where the
DDPM expert's predictions are unified into velocity space by the
schedule-aware conversion (paper Fig. 2).  Runs on the card;
``--device cpu`` runs the kernels' plain versions.  Random numbers come
from ``torch.Generator``s seeded with the reference's integers.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.fusion import ExpertSpec
from repro_torch.core.sampling import SamplerConfig, sample_ensemble
from repro_torch.data import SyntheticSpec, fit_clusters, sample_fid
from repro_torch.data.pipeline import ExpertDataStream, RouterDataStream
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.training import AdamWConfig, ExpertTrainer, RouterTrainer
from repro_torch.weights import resolve_device

STEPS, BATCH, K = 40, 32, 2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    dev = resolve_device(ap.parse_args(argv).device)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    # 1) cluster the corpus (stub-DINOv2 features + hierarchical k-means,
    #    §6.1)
    spec = SyntheticSpec(num_categories=K, latent_size=8, separation=3.0)
    clusters, _ = fit_clusters(spec, corpus_size=512, num_clusters=K,
                               num_fine=64, device=dev)

    # 2) train experts with HETEROGENEOUS objectives, in complete isolation
    cfg = dit_b2().reduced(latent_size=8)
    apply_fn = D.make_expert_apply(cfg)
    expert_params = []
    for cid, (objective, schedule) in enumerate([("ddpm", "cosine"),
                                                 ("fm", "linear")]):
        trainer = ExpertTrainer(
            apply_fn=apply_fn, objective=objective, schedule_name=schedule,
            opt=AdamWConfig(learning_rate=3e-4, warmup_steps=5),
            ema_decay=0.8, device=dev,
        )
        state = trainer.init_state(D.init(cfg, gen(cid)))
        stream = ExpertDataStream(spec, clusters, cluster_id=cid,
                                  batch_size=BATCH, seed=cid, device=dev)
        step_gen = gen(42)
        for i in range(STEPS):
            state, m = trainer.train_step(state, step_gen,
                                          stream.next_batch(i))
        print(f"expert {cid} ({objective}/{schedule}) final loss "
              f"{m['loss']:.4f}")
        expert_params.append(state.ema)

    # 3) train the router (independently, on all clusters, §6.3)
    rcfg = router_b2(num_clusters=K).reduced(latent_size=8)
    rtrainer = RouterTrainer(apply_fn=lambda p, x, t: D.apply(rcfg, p, x, t),
                             num_clusters=K, device=dev)
    rstate = rtrainer.init_state(D.init(rcfg, gen(9)))
    rstream = RouterDataStream(spec, clusters, batch_size=BATCH, device=dev)
    router_gen = gen(7)
    for i in range(STEPS):
        rstate, rm = rtrainer.train_step(rstate, router_gen,
                                         rstream.next_batch(i))
    print(f"router acc {rm['acc']:.2f}")

    # 4) heterogeneous fusion sampling: ε→v conversion happens inside
    experts = [ExpertSpec("ddpm-expert", "ddpm", "cosine", apply_fn, 0),
               ExpertSpec("fm-expert", "fm", "linear", apply_fn, 1)]
    samples = sample_ensemble(
        experts, expert_params, D.make_router_fn(rcfg, rstate.params),
        (64, 8, 8, 4), generator=gen(0),
        config=SamplerConfig(num_steps=12, cfg_scale=1.0, strategy="topk",
                             top_k=2),
    )
    print(f"samples {tuple(samples.shape)}, "
          f"FID-proxy {sample_fid(spec, samples):.3f}, "
          f"finite={bool(torch.isfinite(samples).all())}")


if __name__ == "__main__":
    main()
