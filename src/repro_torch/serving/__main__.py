"""Continuous-batching self-check.

Builds a toy homogeneous ensemble (analytic experts, no model weights, so
it runs in seconds), drives staggered requests through
:class:`repro_torch.serving.ContinuousScheduler`, and checks that each
resolved request equals a ``generate`` call on a twin engine bitwise.
Exits non-zero on any mismatch.  Runs on the GPU; ``--device cpu`` runs
the kernels' plain versions::

    PYTHONPATH=src python -m repro_torch.serving [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.core.fusion import ExpertSpec
from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch.serve import ServingEngine
from repro_torch.serving import ContinuousScheduler

LATENT = (4, 4, 2)
TEXT_TAIL = (3, 5)
K = 8


def _toy_apply(params, x, t, text_emb=None, drop_mask=None):
    """Analytic expert: batch-leading, row-independent, cond-sensitive."""
    tt = t.reshape((-1,) + (1,) * (x.dim() - 1))
    out = x * params["a"] + params["b"] * tt
    if text_emb is not None:
        c = torch.tanh(text_emb.mean(dim=tuple(range(1, text_emb.dim()))))
        if drop_mask is not None:
            c = torch.where(drop_mask, 0.07, c)
        out = out + 0.1 * c.reshape(tt.shape)
    return out


def _toy_router(x, t):
    m = x.mean(dim=tuple(range(1, x.dim())))
    logits = (torch.arange(K, dtype=torch.float32, device=x.device)[None]
              * 0.3 + m[:, None] * 3.0 + t[:, None])
    return torch.softmax(logits, dim=-1)


def _make_engine(device) -> ServingEngine:
    experts = [
        ExpertSpec(
            name=f"toy{i}",
            objective="ddpm" if i % 2 == 0 else "fm",
            schedule="cosine" if i % 2 == 0 else "linear",
            apply_fn=_toy_apply,
            cluster_id=i,
        )
        for i in range(K)
    ]
    params = [
        {"a": torch.tensor(0.8 + 0.03 * i, device=device),
         "b": torch.tensor(0.05 * i - 0.1, device=device)}
        for i in range(K)
    ]
    return ServingEngine(
        experts=experts, expert_params=params, router_fn=_toy_router,
        latent_shape=LATENT,
        sampler=SamplerConfig(num_steps=6, cfg_scale=3.0,
                              strategy="topk", top_k=2),
        device=device,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    engine = _make_engine(args.device)
    sched = ContinuousScheduler(engine, max_resident=4)

    # Staggered arrivals: requests join mid-flight, so the rolling batch
    # mixes timesteps before the parity check.
    specs = [(0, 1), (1, 2), (2, 1), (4, 1), (5, 2), (7, 1)]  # (tick, bs)
    handles, texts, seeds = [], [], []
    tick = 0
    for arrive, bs in specs:
        while tick < arrive:
            sched.step()
            tick += 1
        seed = 100 + len(handles)
        gen = torch.Generator().manual_seed(seed)
        text = torch.randn((bs,) + TEXT_TAIL, generator=gen).numpy()
        handles.append(sched.submit(seed, text))
        seeds.append(seed)
        texts.append(text)
    sched.run_until_idle()

    twin = _make_engine(engine.device)
    ok = True
    for i, (h, seed, text) in enumerate(zip(handles, seeds, texts)):
        want = twin.generate(seed, text, text.shape[0])
        got = h.result()
        if not torch.equal(got, want):
            ok = False
            err = (got - want).abs().max().item()  # lint: allow-host-sync
            print(f"request {i}: rolling output != generate "
                  f"(max |diff| = {err:.3e})")
    for k in ("latency_p50_s", "latency_p95_s", "queue_wait_p50_steps"):
        if k not in engine.stats:
            ok = False
            print(f"missing stats key {k!r}")
    print(sched.line())
    if not ok:
        print("continuous-batching smoke FAILED")
        return 1
    print(f"continuous-batching smoke OK: {len(handles)} staggered "
          f"requests bitwise == sequential generate()")
    return 0


if __name__ == "__main__":
    sys.exit(main())
