"""Serve a heterogeneous expert ensemble with batched requests (port of
``examples/serve_heterogeneous.py``).

Loads the self-describing checkpoints written by
``repro_torch.examples.train_decentralized`` (runs it first, as a
subprocess on the same device, if the directory holds no
``expert0.npz``) and serves batched "prompts" through the
``ServingEngine`` with the Fig. 2 inference pipeline, reporting latency
per strategy.  Runs on the card; ``--device cpu`` runs the kernels'
plain versions.

  PYTHONPATH=src python -m repro_torch.examples.serve_heterogeneous \\
      --ckpt ckpts [--device cpu]

On the card every routed expert's dense layer is one ragged grouped
GEMM over all routed (sample, slot) pairs (``ragged_gemm``), every
LayerNorm and attention runs the AdaLN and attention kernels, and each
Euler step's ε→v conversion, router fusion, CFG and update run in one
``hetero_fuse_step`` launch.

Quantized expert storage (``--param-dtype``, ``core.param_store``): the
stacked expert tree loads into a typed store whose storage dtype is
independent of the checkpoints.  ``int8``/``fp8`` quantize on load with
symmetric per-expert-per-leaf scales, drop the full-precision
per-expert param list, contract the tiled GEMM widths on the int8/fp8
bytes (``ragged_gemm``'s quantized bodies) and dequantize the other
routed leaves through ``hetero_fuse_dequant``.  Resident expert-param
bytes per stored parameter (float32 checkpoints; arithmetic, K experts):

  ============  =======================  ==========
  param_dtype   bytes/param              vs fp32
  ============  =======================  ==========
  native/fp32   4                        1.0x
  bf16          2                        2.0x
  int8          1 (+4·K/leaf scales)     ~3.99x
  fp8           1 (+4·K/leaf scales)     ~3.99x
  ============  =======================  ==========

int8 round-trip error is ≤ 1/254 ≈ 4e-3 of each expert-leaf's absmax;
fp8 (e4m3) carries ≤ 6.25e-2 element relative error.

On an **elastic** engine (``capacity=K_cap``, see the walkthrough at the
end of this example) the table scales by the capacity, not the live
count: the store is padded to ``K_cap`` slots along the expert axis, so
resident bytes carry a ``(K_cap - K)/K`` overhead of zero-filled padded
slots (int8/fp8 pad with 0 qvals and unit scales).  Padded and evicted
slots are masked by the store's validity bit-vector — never routed,
never gathered — so the overhead is memory-only, not compute.

Step-fused sampling + plan reuse (``--plan-refresh``,
``core.sampling``): every engine here runs the step-fused path by
default (``SamplerConfig.step_fused``: CFG combine + Euler update folded
into the convert-and-fuse kernel, bit-identical to the unfused chain).
``--plan-refresh R`` additionally recomputes the router posterior and
the dispatch plan only every R-th Euler step, carrying the plan between
refreshes: R = 1 routes every step (bit-identical), R > 1 runs the
router on ⌈S/R⌉ of the S steps, and the latents drift from per-step
routing as far as the routed experts change between refresh steps.

Cross-request conditioning cache (``--cond-cache``,
``ServingEngine.cond_cache_size``): a content-hash-keyed LRU dedupes
byte-identical text embeddings across ``generate()``/``submit()``
calls — the intra-prompt-diversity workload (one prompt, many seeds)
holds ONE resident device buffer per distinct prompt.  Hit/miss
behavior is observable via ``engine.stats['cond_cache_hits']`` /
``['cond_cache_misses']`` (printed below), not inferred from timings;
0 disables the cache.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch.serve import ServingEngine
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.weights import resolve_device

#: the ``src`` directory that holds ``repro_torch`` (the subprocess's path)
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _sync(device: torch.device) -> None:
    """Wait for the card's queued work before a clock read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _text(seed: int, batch: int, cfg) -> np.ndarray:
    """A batch of caption embeddings as a host ndarray, as a remote text
    encoder would deliver them — the form the conditioning cache hashes
    (device tensors pass through unhashed)."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.text_len, cfg.text_dim)).astype(np.float32)


def elastic_walkthrough(steps: int, device: torch.device) -> None:
    """Fault-tolerant elastic membership, end to end.

    Builds a 6-expert ensemble with 8 capacity slots, admits a request,
    then — *mid-serving* — hot-adds a freshly published 7th expert and
    evicts expert 2.  The in-flight request still completes against the
    membership it was admitted under (its routing snapshot); the next
    request routes over the new membership; ``flush`` runs one dispatch
    per membership epoch.  The reference's line also counts its compiled
    traces; the port compiles none, so its lines leave ``traces=`` out.
    """
    from repro_torch.models import dit as D
    from repro_torch.training import expert_metadata, save_checkpoint

    def init(c, seed):
        return D.init(c, torch.Generator(device=device).manual_seed(seed))

    cfg = dit_b2().reduced(latent_size=8)
    rcfg = router_b2(num_clusters=8).reduced(latent_size=8)
    with tempfile.TemporaryDirectory() as d:
        for cid in range(6):
            save_checkpoint(
                os.path.join(d, f"expert{cid}.npz"), init(cfg, 10 + cid),
                metadata=expert_metadata(
                    name=f"e{cid}", objective="fm" if cid % 2 else "ddpm",
                    schedule="linear" if cid % 2 else "cosine",
                    cluster_id=cid, arch=cfg.name),
            )
        save_checkpoint(os.path.join(d, "router.npz"), init(rcfg, 99))
        engine = ServingEngine.from_checkpoint_dir(
            d, dit_cfg=cfg, router_cfg=rcfg,
            sampler=SamplerConfig(num_steps=steps, cfg_scale=1.0,
                                  strategy="topk", top_k=2),
            capacity=8, device=device,
        )
        print(f"elastic: {engine.membership_line()}")
        text = _text(0, 4, cfg)
        h_inflight = engine.submit(0, text, 4)     # 6-expert membership
        # a 7th contributor publishes a checkpoint mid-serving ...
        joiner = os.path.join(d, "joiner.npz")
        save_checkpoint(joiner, init(cfg, 16),
                        metadata=expert_metadata(
                            name="e6", objective="fm", schedule="linear",
                            cluster_id=6, arch=cfg.name))
        slot = engine.add_expert(joiner)
        # ... and expert 2's node drops out
        engine.evict_expert(2)
        h_after = engine.submit(1, text, 4)
        dispatches = engine.flush()    # one dispatch per membership epoch
        for h in (h_inflight, h_after):
            assert bool(torch.isfinite(h.result()).all())
        print(f"elastic: hot-added slot {slot}, evicted slot 2 between "
              f"submit() and flush() — {dispatches} dispatches")
        print(f"elastic: {engine.membership_line()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "hddm_ckpts"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--dispatch", default="gathered",
                    choices=("gathered", "grouped"),
                    help="expert-dispatch executor for the routed "
                         "strategies (core.dispatch): 'gathered' = "
                         "per-sample param gather, 'grouped' = "
                         "sort-based grouped segment execution (one "
                         "forward per resident expert)")
    ap.add_argument("--param-dtype", default="native",
                    choices=("native", "fp32", "bf16", "int8", "fp8"),
                    help="stacked expert-param storage "
                         "(core.param_store): int8/fp8 quantize on load "
                         "(~4x fewer resident bytes, see module "
                         "docstring) and dequantize routed slices "
                         "through the dequant kernel")
    ap.add_argument("--plan-refresh", type=int, default=1,
                    help="recompute router posterior + dispatch plan only "
                         "every R-th Euler step (R=1 per-step routing, "
                         "bit-identical; see the module docstring)")
    ap.add_argument("--cond-cache", type=int, default=64,
                    help="cross-request conditioning LRU capacity "
                         "(content-hash dedupe of text embeddings; "
                         "0 disables)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if not os.path.exists(os.path.join(args.ckpt, "expert0.npz")):
        print(f"no checkpoints under {args.ckpt} — training a tiny "
              "ensemble first ...", flush=True)
        path = os.environ.get("PYTHONPATH")
        subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.train_decentralized",
             "--out", args.ckpt, "--steps", "40", "--device", str(dev)],
            check=True,
            env={**os.environ,
                 "PYTHONPATH": SRC + (os.pathsep + path if path else "")},
        )

    dit_cfg = dit_b2().reduced(latent_size=8)
    rcfg = router_b2(num_clusters=4).reduced(latent_size=8)

    for strategy in ("top1", "topk", "full"):
        # routed strategies go through the selected executor backend and
        # param store; the 'full' strategy runs every expert, where only
        # the dense executor applies (and needs the full-precision
        # per-expert params), so it stays on auto/native.
        routed = strategy in ("top1", "topk")
        dispatch = args.dispatch if routed else "auto"
        param_dtype = args.param_dtype if routed else "native"
        engine = ServingEngine.from_checkpoint_dir(
            args.ckpt, dit_cfg=dit_cfg, router_cfg=rcfg,
            sampler=SamplerConfig(num_steps=args.steps, cfg_scale=1.0,
                                  strategy=strategy, top_k=2,
                                  dispatch=dispatch,
                                  param_dtype=param_dtype,
                                  plan_refresh_every=args.plan_refresh),
            cond_cache_size=args.cond_cache, device=dev,
        )
        objectives = [e.objective for e in engine.experts]
        lat = []
        for r in range(args.requests):
            text = _text(r, args.batch, dit_cfg)
            _sync(dev)
            t0 = time.time()
            out = engine.generate(r, text, args.batch)
            _sync(dev)
            lat.append(time.time() - t0)
            assert bool(torch.isfinite(out).all())
        # first request includes the kernels' first launches; report
        # steady-state
        steady = np.mean(lat[1:]) if len(lat) > 1 else lat[0]
        print(f"strategy={strategy:5s} dispatch={dispatch:8s} "
              f"params={param_dtype:6s} experts={objectives} "
              f"first={lat[0]:.2f}s steady={steady:.2f}s "
              f"({args.batch/steady:.1f} img/s) "
              f"cond_cache={engine.stats['cond_cache_hits']}h/"
              f"{engine.stats['cond_cache_misses']}m "
              f"plan_refreshes={engine.stats['plan_refreshes']}")

    elastic_walkthrough(args.steps, dev)


if __name__ == "__main__":
    main()
