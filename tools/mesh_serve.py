"""Serve the DiT ensemble on every ``("expert", "data")`` mesh of N cards,
one process a card, against the unsharded engine.

    python3 tools/mesh_serve.py --world 4

Writes ``chip_smoke.py``'s phase-4 ensemble (8 full-width DiT-B/2 experts,
2 DDPM : 6 FM, and ``router_b2``; ``write_ensemble``, seed 11) under
``build/mesh_serve/``, serves phase 21's request (batch 8, 8 steps, CFG
7.5, top-2) on the unsharded engine on card 0, then spawns ``--world``
ranks (NCCL, ``cuda:<rank>``) that serve it on each mesh ``(E, D)`` with
``E · D = world``: one warm-up request, then ``--requests`` timed ones.
Each rank loads the checkpoints on the host once and builds each mesh's
engine from them (only its resident slice reaches its card).

Prints a line per mesh and rank (request seconds, store bytes,
``ragged_gemm`` launches and pairs of one request, max |Δ| against the
unsharded latents) and, last, one JSON object with the unsharded and
every mesh's median request seconds.  Fails when a rank's latents are
not within ``1e-5 · max |latent|`` of the unsharded engine's or the
ranks' pairs do not sum to the unsharded request's.  ``--reduced
--device cpu --backend gloo`` runs the same at the reduced width on CPU
ranks.

``--continuous`` serves phase 11's traffic instead (8 staggered requests
of batch 1, 2, 1, 4, 2, 1, 3, 2, one every 2 ticks, into a rolling batch
of 8: ``chip_smoke._mesh_rolling``) through the ``ContinuousScheduler``
on every mesh; each run's seconds and img/s, and each request's latents
against the unsharded rolling run's::

    python3 tools/mesh_serve.py --world 4 --continuous
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402

REL_TOL = 1e-5


def _configs(reduced: bool):
    from repro_torch.models.config import dit_b2, router_b2

    cfg, rcfg = dit_b2(), router_b2(num_clusters=len(C.MIX))
    if reduced:
        cfg, rcfg = cfg.reduced(latent_size=8), rcfg.reduced(latent_size=8)
    return cfg, rcfg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _serve(ops, eng, text, dev, requests: int, cfg=None) -> tuple:
    """One warm-up request, then ``requests`` timed ones: the last
    latents, the seconds, and one request's launches and pairs.  With
    ``cfg`` (the experts' config), a run of phase 11's rolling traffic
    for each request (the latents a list, one a request; the seconds a
    run's)."""
    if cfg is not None:
        seconds = []
        for _ in range(requests + 1):
            outs, row = C._mesh_rolling(ops, eng, cfg, C.ROLLING_BATCHES,
                                        41, 800)
            seconds.append(row["seconds"])
        return outs, seconds[1:], row["launches"], row["pairs"]
    eng.generate(C.MESH_SEED, text, C.BATCH)
    _sync(dev)
    seconds = []
    for _ in range(requests):
        ops.reset_launches()
        t0 = time.perf_counter()
        out = eng.generate(C.MESH_SEED, text, C.BATCH)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
    return out, seconds, dict(ops.LAUNCHES), dict(ops.RAGGED_PAIRS)


def _rank(rank: int, world: int, job: dict) -> None:
    from repro_torch.core.sampling import SamplerConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import dit as D
    from repro_torch.training.checkpoint import load_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)       # the ranks share the host's cores
    cfg, rcfg = _configs(job["reduced"])
    text = C._texts(cfg, [C.BATCH], C.MESH_TEXT_SEED)[0]
    host = ServingEngine.from_checkpoint_dir(job["path"], dit_cfg=cfg,
                                             device="cpu")
    experts, params = host.experts, host.expert_params
    del host
    router_fn = D.make_router_fn(rcfg, load_checkpoint(
        os.path.join(job["path"], "router.npz"), device=dev)[0])
    for e, d in job["meshes"]:
        eng = ServingEngine(
            experts=experts, expert_params=params, router_fn=router_fn,
            latent_shape=(cfg.latent_size, cfg.latent_size,
                          cfg.latent_channels),
            sampler=SamplerConfig(num_steps=C.STEPS, cfg_scale=7.5, top_k=2),
            device=dev, n_expert_shards=e, n_data_shards=d,
            dist_backend=job["backend"])
        out, seconds, launches, pairs = _serve(
            ops, eng, text, dev, job["requests"],
            cfg if job["continuous"] else None)
        tag = f"{e}x{d}_rank{rank}"
        outs = out if job["continuous"] else [out]
        np.savez(os.path.join(job["out"], f"{tag}.npz"),
                 *[o.cpu().numpy() for o in outs])
        with open(os.path.join(job["out"], f"{tag}.json"), "w") as f:
            json.dump(dict(mesh={"expert": e, "data": d}, rank=rank,
                           device=str(dev), request_seconds=seconds,
                           store_bytes=eng.param_store.nbytes(),
                           ragged_gemm_launches=launches["ragged_gemm"],
                           pairs=pairs["ragged_gemm"]), f)
        del eng, out


def main() -> None:
    ap = argparse.ArgumentParser(prog="python3 tools/mesh_serve.py")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced DiT (latent 8) instead of full width")
    ap.add_argument("--continuous", action="store_true",
                    help="phase 11's rolling traffic through the "
                         "ContinuousScheduler instead of one request")
    args = ap.parse_args()
    from repro_torch.core.sampling import SamplerConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import ServingEngine

    dev = torch.device(args.device)
    if dev.type == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
        t0 = time.perf_counter()
        _build.build_all()
        print(f"kernel build {time.perf_counter() - t0:.1f} s")
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg, rcfg = _configs(args.reduced)
    path = os.path.join(ROOT, "build", "mesh_serve")
    shutil.rmtree(path, ignore_errors=True)
    C.write_ensemble(path, cfg, rcfg, dev, seed=11)
    text = C._texts(cfg, [C.BATCH], C.MESH_TEXT_SEED)[0]
    base = ServingEngine.from_checkpoint_dir(
        path, dit_cfg=cfg, router_cfg=rcfg,
        sampler=SamplerConfig(num_steps=C.STEPS, cfg_scale=7.5, top_k=2),
        device=dev)
    want, seconds, _, pairs = _serve(ops, base, text, dev, args.requests,
                                     cfg if args.continuous else None)
    want = [w.cpu() for w in want] if args.continuous else [want.cpu()]
    del base
    print("unsharded " + json.dumps(dict(request_seconds=seconds,
                                         pairs=pairs["ragged_gemm"])))
    meshes = [(e, args.world // e) for e in range(args.world, 0, -1)
              if args.world % e == 0]
    summary = {"world": args.world, "unsharded_s": statistics.median(seconds),
               "meshes": {}}
    with tempfile.TemporaryDirectory(prefix="mesh_serve_") as out:
        spawn(_rank, args.world, dict(
            path=path, out=out, meshes=meshes, device=dev.type,
            backend=args.backend, reduced=args.reduced,
            requests=args.requests, continuous=args.continuous),
            backend=args.backend, device=dev.type)
        for e, d in meshes:
            rows = []
            for rank in range(args.world):
                with open(os.path.join(out, f"{e}x{d}_rank{rank}.json")) as f:
                    row = json.load(f)
                with np.load(os.path.join(out,
                                          f"{e}x{d}_rank{rank}.npz")) as z:
                    got = [torch.from_numpy(z[f"arr_{i}"])
                           for i in range(len(want))]
                row["max_abs_diff"] = max(float((g - w).abs().max())
                                          for g, w in zip(got, want))
                row["max_abs"] = max(float(w.abs().max()) for w in want)
                print("mesh " + json.dumps(row))
                if row["max_abs_diff"] > REL_TOL * row["max_abs"]:
                    raise SystemExit(f"mesh ({e}, {d}) rank {rank}: max |Δ| "
                                     f"{row['max_abs_diff']}")
                rows.append(row)
            total = sum(r["pairs"] for r in rows)
            if total != pairs["ragged_gemm"]:
                raise SystemExit(f"mesh ({e}, {d}): pairs {total} != "
                                 f"{pairs['ragged_gemm']}")
            summary["meshes"][f"{e}x{d}"] = dict(
                median_s=statistics.median(
                    s for r in rows for s in r["request_seconds"]),
                store_bytes=[r["store_bytes"] for r in rows])
            if args.continuous:
                summary["meshes"][f"{e}x{d}"]["img_per_s"] = sum(
                    C.ROLLING_BATCHES) / summary["meshes"][f"{e}x{d}"][
                    "median_s"]
    if args.continuous:
        summary["unsharded_img_per_s"] = sum(C.ROLLING_BATCHES) / \
            summary["unsharded_s"]
    shutil.rmtree(path, ignore_errors=True)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
