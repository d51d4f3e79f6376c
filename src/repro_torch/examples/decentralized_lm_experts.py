"""Decentralized expert training for the LM architectures (port of
``examples/decentralized_lm_experts.py``).

The DDM half of the paper's technique (isolated cluster experts + router
fusion, Eq. 1) applied to an ``--arch`` of the model zoo: two experts
train in complete isolation on disjoint synthetic corpus clusters (the
two halves of the vocabulary), a token-prototype router routes sequences,
and next-token distributions are fused in probability space.  Reduced
configs (vocabulary 64).  Runs the ``ssm`` (mamba2-2.7b), ``hybrid``
(zamba2-2.7b), ``dense`` (internlm2-1.8b, stablelm-1.6b, deepseek-67b,
deepseek-coder-33b) and ``moe`` (mixtral-8x7b, mixtral-8x22b) families on
the card, or with ``--device cpu`` on the kernels' plain versions.  For
whisper-large-v3 and paligemma-3b, whose experts need the frontend
stubs' frames or patches, it prints the reference's note and returns
(the ensemble passes tokens only).

  PYTHONPATH=src python -m repro_torch.examples.decentralized_lm_experts \\
      --arch mamba2-2.7b
  PYTHONPATH=src python -m repro_torch.examples.decentralized_lm_experts \\
      --arch zamba2-2.7b [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.decentralized_lm_experts \
      --arch mixtral-8x7b [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.lm_ensemble import (LMExpertEnsemble,
                                          TokenPrototypeRouter,
                                          expert_perplexity)
from repro_torch.models import zoo
from repro_torch.training import AdamWConfig, adamw_init
from repro_torch.training.trainer import make_lm_train_step
from repro_torch.weights import resolve_device

VOCAB = 64


def cluster_batch(gen: torch.Generator, batch: int, seq: int, vocab: int,
                  cluster: int) -> dict:
    """Tokens uniform over cluster ``cluster``'s half of the vocabulary,
    with next-token labels, drawn from ``gen`` on its device."""
    half = vocab // 2
    lo = cluster * half
    toks = torch.randint(lo, lo + half, (batch, seq + 1), generator=gen,
                         device=gen.device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced(vocab_size=VOCAB)
    if cfg.arch_type in ("audio", "vlm"):
        print(f"note: {args.arch} needs frontend stubs; using tokens only "
              "via the dense path is unsupported here — pick a decoder "
              "arch for this demo.")
        return
    step = make_lm_train_step(cfg, AdamWConfig(learning_rate=3e-3,
                                               warmup_steps=2))
    experts = []
    print(f"training 2 isolated {args.arch} experts "
          f"(reduced: {cfg.num_layers}L d={cfg.d_model}) ...")
    for cid in range(2):
        params = zoo.init(cfg, _gen(dev, cid), dev)
        opt = adamw_init(params)
        gen = _gen(dev, 10 + cid)
        for _ in range(args.steps):
            params, opt, loss, _ = step(
                params, opt,
                cluster_batch(gen, args.batch, args.seq, VOCAB, cid))
        final = loss.item()  # lint: allow-host-sync — printed
        print(f"  expert {cid} final loss {final:.3f}")
        experts.append(params)

    corpora = [cluster_batch(_gen(dev, 99 + c), 8, 128, VOCAB,
                             c)["tokens"].cpu().numpy() for c in range(2)]
    router = TokenPrototypeRouter.fit(corpora, vocab=VOCAB)
    ens = LMExpertEnsemble(cfg=cfg, expert_params=experts, router=router,
                           strategy="topk", top_k=1)
    for cid in range(2):
        b = cluster_batch(_gen(dev, 70 + cid), args.batch, args.seq, VOCAB,
                          cid)
        right = expert_perplexity(cfg, experts[cid], b["tokens"],
                                  b["labels"])
        wrong = expert_perplexity(cfg, experts[1 - cid], b["tokens"],
                                  b["labels"])
        print(f"cluster {cid}: right-expert ppl {right:7.2f}  "
              f"wrong-expert ppl {wrong:7.2f}  "
              f"routed-ensemble ppl "
              f"{ens.perplexity(b['tokens'], b['labels']):7.2f}")


if __name__ == "__main__":
    main()
