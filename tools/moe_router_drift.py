"""Follow the MoE router's load-balance loss (``moe_aux``) through the
AdamW steps of ``chip_smoke.py``'s phase-17 training of mixtral-8x7b, at
its learning rate and at 0 (the control: the same batches, nothing
learnt), at full width (the router reads d 4096) and at d 256.

    python3 tools/moe_router_drift.py [--device cuda|cpu] [--steps 10]
        [--tokens 8192] [--variants full,d256]

Each run mirrors phase 17's: 2 layers of ``configs/mixtral_8x7b.py``
(bf16, remat, 512-token CE chunks, ``dense_scan``), weights from seed 61,
``lm_batch`` batches of 1 × ``--tokens`` from seed 62, ``AdamWConfig(
learning_rate, warmup_steps=5)``.  ``d256`` cuts the width to d 256 (4
query heads over 1 kv head of D 64, F 896).  AdamW moves each weight by
about the learning rate a step whatever its gradient, so a router logit,
a sum over d inputs, can move by up to ``lr · Σ_d |x_d|``: 16 times more
at d 4096 than at d 256.  Each run prints one JSON line: its ``moe_aux``
(the mean over layers of ``E · Σ_e f_e p_e``; 1 when balanced, E when
every token's top-1 expert is the same and certain) and loss a step, and
the mean |change| of a router weight a step.  Needs a CUDA device unless
``--device cpu`` (then use ``--variants d256``: the full width is 47 GB
of float32 Adam moments).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

#: phase 17's training recipe (``chip_smoke.py``: ``LM_TRAIN_LR``, 5
#: warm-up steps, seeds 61 and 62)
LR, WARMUP, INIT_SEED, DATA_SEED = 1e-4, 5, 61, 62
VARIANTS = {"full": {},
            "d256": dict(d_model=256, num_heads=4, num_kv_heads=1,
                         head_dim=64, d_ff=896)}


def run(variant: str, lr: float, steps: int, tokens: int, dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.models import zoo
    from repro_torch.training import AdamWConfig, adamw_init
    from repro_torch.training.trainer import make_lm_train_step

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=2,
                              **VARIANTS[variant])
    params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(INIT_SEED),
                      dev)
    state = adamw_init(params)
    step = make_lm_train_step(cfg, AdamWConfig(learning_rate=lr,
                                               warmup_steps=WARMUP))
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    aux, losses, moved = [], [], []
    for _ in range(steps):
        batch = lm_batch(gen, 1, tokens, cfg.vocab_size)
        before = params["blocks"]["moe"]["router"]["w"].clone()
        params, state, loss, m = step(params, state, batch)
        router = params["blocks"]["moe"]["router"]["w"]
        moved.append((router - before).abs().mean().item())
        aux.append(m["moe_aux"].item())
        losses.append(loss.item())
    row = dict(variant=variant, d_model=cfg.d_model, d_ff=cfg.d_ff,
               layers=cfg.num_layers, experts=cfg.num_experts,
               tokens=tokens, lr=lr, moe_aux=aux, losses=losses,
               router_mean_abs_change=moved)
    del params, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--tokens", type=int, default=8192)
    ap.add_argument("--variants", default="full,d256")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("moe_router_drift: no CUDA device")
    dev = torch.device(args.device)
    for variant in args.variants.split(","):
        for lr in (LR, 0.0):
            print("moe router drift " + json.dumps(
                run(variant, lr, args.steps, args.tokens, dev)), flush=True)


if __name__ == "__main__":
    main()
