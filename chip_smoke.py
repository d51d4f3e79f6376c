"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases (each a hard failure — non-zero exit, no result line — on error):

1. device check: needs CUDA; prints the card's name and power limit;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (all
   ``nvcc`` processes at once) and prints the build seconds;
3. holds each kernel against its plain PyTorch version on the card, at
   the shapes of the serving main path, and times kernel, plain version
   and one PyTorch library call doing the same function (device time of
   calls replayed from a CUDA graph, except the ragged GEMM's plain
   version, which syncs; ``wrapper_ms`` adds the host's cost per call);
4. serves the full-width heterogeneous DiT-B/2 ensemble — 8 random,
   seeded experts (2 DDPM/cosine + 6 FM/linear) and a router, written to
   checkpoints and loaded with ``ServingEngine.from_checkpoint_dir`` — for
   two requests of batch 8 with CFG 7.5, top-2, 8 steps; the kernel launch
   counters must show every dense layer and every step went through the
   kernels;
5. serves one more such request under ``torch.profiler`` and prints where
   its device time goes (by kernel and by category) and the device's idle
   share;
6. runs the same engine code at a reduced width on the GPU and on the CPU
   (plain versions) and compares the latents.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# float32 outside the tensor cores (TF32 is excluded by design).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

GEMM_REL_TOL = 1e-5        # float32 sums in another order than ATen
STEP_REL_TOL = 1e-6        # no FMA contraction: same op order as plain
E2E_REL_TOL = 1e-4         # latents after 8 CFG-7.5 steps, GPU vs CPU

STEPS, BATCH, REQUESTS = 8, 8, 2
MIX = [("ddpm", "cosine")] * 2 + [("fm", "linear")] * 6

#: device kernel-name fragments -> category of the profile, first match wins.
CATEGORIES = (
    ("ragged_gemm", "ragged_gemm (experts' dense layers)"),
    ("hetero_fuse_step", "hetero_fuse_step"),
    ("gemm", "cuBLAS GEMM (router dense, attention QK/PV)"),
    ("softmax", "softmax"),
    ("reduce", "reductions (LayerNorm, sums)"),
    ("elementwise", "elementwise"),
    ("Memcpy", "copies"),
    ("Memset", "sets"),
)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call without host overhead: ``iters``
    calls captured in one CUDA graph, replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_ragged_gemm(ops, ref, dev) -> dict:
    """The ragged GEMM at the main path's row-group widths; 16 groups
    (8 samples × top-2) over 8 experts, experts 4, 6 and 7 empty.  The
    last case passes its weight as the main path does: layer 5 of a
    ``(K, L, D, F)`` stack, a strided view."""
    pe = torch.tensor([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 5, 5, 5, 5],
                      dtype=torch.int32, device=dev)
    cases = [(512, 768, 3072, 0), (512, 3072, 768, 0), (256, 768, 3072, 0),
             (256, 3072, 768, 0), (154, 768, 768, 0), (1, 768, 4608, 0),
             (512, 768, 3072, 12)]
    gen = torch.Generator(device=dev).manual_seed(3)
    rows, worst = [], 0.0
    for m, d, f, layers in cases:
        p = pe.shape[0]
        x = torch.randn(p, m, d, generator=gen, device=dev)
        if layers:
            stack = torch.randn(8, layers, d, f, generator=gen,
                                device=dev) / math.sqrt(d)
            w = stack[:, 5]
        else:
            w = torch.randn(8, d, f, generator=gen, device=dev) / math.sqrt(d)
        got = ops.ragged_expert_matmul(x, w, pe)
        plain = ref.ref_ragged_gemm(x.reshape(p * m, d), w, pe).reshape(
            p, m, f)
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        scale = plain.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= GEMM_REL_TOL * scale
        wg = w[pe.long()]                  # gathered outside the timing
        xg = x.contiguous()
        t_k = graph_ms(lambda: ops.ragged_expert_matmul(x, w, pe))
        t_w = cuda_ms(lambda: ops.ragged_expert_matmul(x, w, pe))
        # the plain version syncs (it lists the routed experts): events
        t_p = cuda_ms(lambda: ref.ref_ragged_gemm(x.reshape(p * m, d), w,
                                                  pe), iters=10)
        t_l = graph_ms(lambda: torch.bmm(xg, wg))
        n_exp = len(set(pe.tolist()))
        flops = 2.0 * p * m * d * f
        nbytes = 4.0 * (p * m * d + n_exp * d * f + p * m * f + p)
        t_b, by = bound_ms(nbytes, flops)
        row = dict(m=m, D=d, F=f, layer_view=bool(layers),
                   max_abs_err=err, tol=GEMM_REL_TOL * scale,
                   ms=t_k, wrapper_ms=t_w, plain_ms=t_p, library_ms=t_l,
                   bound_ms=t_b, bound_by=by, tflops=flops / t_k / 1e9)
        print("ragged_gemm case " + json.dumps(row))
        if not ok:
            fail(f"ragged_gemm disagrees with its plain version: {row}")
        worst = max(worst, err)
        rows.append(row)
    main = rows[0]                          # the MLP up-projection shape
    return dict(max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"])


def check_fused_step(ops, ref, dev) -> dict:
    """The step kernel at the main path's shape: K = 2 slots, B = 8,
    T = 32·32·4, with and without CFG, shared and per-row dt; alpha below
    alpha_min and clamped x̂0 present."""
    k, b, t = 2, 8, 32 * 32 * 4
    gen = torch.Generator(device=dev).manual_seed(4)
    kw = dict(cfg_scale=7.5, clamp=20.0, alpha_min=0.01)
    worst, main = 0.0, None
    for g in (2, 1):
        for per_row in (False, True):
            preds = 4 * torch.randn(k, g, b, t, generator=gen, device=dev)
            x = 3 * torch.randn(b, t, generator=gen, device=dev)
            w = torch.rand(g, b, k, generator=gen, device=dev)
            coef = 1.5 * torch.rand(5, k, g, b, generator=gen, device=dev)
            coef[0, 0] = 0.001                  # alpha below alpha_min
            coef[1, 0] = 1.0                    # x̂0 beyond ±clamp
            dt = torch.rand(b if per_row else 1, generator=gen, device=dev)
            args = (preds.reshape(k, g * b, t), x, w.reshape(g * b, k),
                    coef.reshape(5, k, g * b), dt)
            got = ops.fused_step(*args, g=g, **kw)
            plain = ref.ref_hetero_fuse_step(preds, x, w, coef, dt, **kw)
            torch.cuda.synchronize()
            x0 = (x[None] - coef[1, 0, :, :, None] * preds[0]) / 0.01
            if not bool((x0.abs() > 20).any()):
                fail("fused_step check does not reach the clamp")
            err = (got - plain).abs().max().item()
            scale = plain.abs().max().item()
            t_k = graph_ms(lambda: ops.fused_step(*args, g=g, **kw), 100)
            t_w = cuda_ms(lambda: ops.fused_step(*args, g=g, **kw), 50)
            t_p = graph_ms(lambda: ref.ref_hetero_fuse_step(
                preds, x, w, coef, dt, **kw), 100)
            nbytes = 4.0 * (k * g * b * t + 2 * b * t + g * b * k
                            + 5 * k * g * b + dt.numel())
            flops = 12.0 * k * g * b * t + 5.0 * b * t
            t_b, by = bound_ms(nbytes, flops)
            row = dict(G=g, dt_per_row=per_row, max_abs_err=err,
                       tol=STEP_REL_TOL * scale, ms=t_k, wrapper_ms=t_w,
                       plain_ms=t_p, library_ms=None, bound_ms=t_b,
                       bound_by=by)
            print("hetero_fuse_step case " + json.dumps(row))
            if not (bool(torch.isfinite(got).all())
                    and err <= STEP_REL_TOL * scale):
                fail(f"hetero_fuse_step disagrees with its plain version: "
                     f"{row}")
            worst = max(worst, err)
            if main is None:                    # G = 2, shared dt: serving
                main = row
    return dict(max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=None, bound_ms=main["bound_ms"],
                bound_by=main["bound_by"])


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serving main path
# ---------------------------------------------------------------------------


def write_ensemble(path, dit_cfg, router_cfg, dev, seed):
    """8 random experts (2 DDPM + 6 FM) and a router as checkpoints.

    Every leaf is jittered with seeded noise: fresh init zeroes the output
    layers, which would make every prediction exactly 0.
    """
    from repro_torch.models import dit as D
    from repro_torch.training.checkpoint import (expert_metadata,
                                                 save_checkpoint)

    gen = torch.Generator(device=dev).manual_seed(seed)

    def jittered(cfg):
        params = D.init(cfg, gen)
        return D.tree_map(lambda a: a + 0.02 * torch.randn(
            a.shape, generator=gen, device=a.device), params)

    os.makedirs(path, exist_ok=True)
    for cid, (obj, sched) in enumerate(MIX):
        save_checkpoint(os.path.join(path, f"expert{cid}.npz"),
                        jittered(dit_cfg),
                        metadata=expert_metadata(
                            name=f"expert{cid}", objective=obj,
                            schedule=sched, cluster_id=cid,
                            arch=dit_cfg.name))
    save_checkpoint(os.path.join(path, "router.npz"), jittered(router_cfg),
                    metadata={"num_clusters": len(MIX)})


def serve_full_width(ops, dev) -> dict:
    from repro_torch.core.sampling import SamplerConfig
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models.config import dit_b2, router_b2
    from repro_torch.models.dit import param_count

    dit_cfg, router_cfg = dit_b2(), router_b2(num_clusters=len(MIX))
    path = os.path.join(WORK, "dit_b2")
    t0 = time.perf_counter()
    write_ensemble(path, dit_cfg, router_cfg, dev, seed=11)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = ServingEngine.from_checkpoint_dir(
        path, dit_cfg=dit_cfg, router_cfg=router_cfg,
        sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    shutil.rmtree(path)
    n_params = param_count(engine.expert_params[0])
    print(f"full width: DiT-B/2 experts of {n_params} parameters, "
          f"{len(MIX)} experts + router_b2; checkpoints written in "
          f"{t_write:.1f} s, loaded in {t_load:.1f} s")
    rng = np.random.default_rng(5)
    texts = [rng.standard_normal((BATCH, dit_cfg.text_len,
                                  dit_cfg.text_dim)).astype(np.float32)
             for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    ops.reset_launches()
    requests = []
    for i, text in enumerate(texts):
        t0 = time.perf_counter()
        out = engine.generate(100 + i, text, BATCH)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        finite = bool(torch.isfinite(out).all())
        requests.append(dict(request=i, seconds=sec, img_per_s=BATCH / sec,
                             finite=finite, shape=list(out.shape),
                             max_abs=out.abs().max().item(),
                             launches_so_far=dict(ops.LAUNCHES)))
        print("request " + json.dumps(requests[-1]))
        if not finite or tuple(out.shape) != (BATCH, 32, 32, 4):
            fail(f"request {i} output is not finite (B, 32, 32, 4)")
    launches = dict(ops.LAUNCHES)
    print("main-path launches " + json.dumps(launches))
    want = {"ragged_gemm": 128 * STEPS * REQUESTS,
            "hetero_fuse_step": STEPS * REQUESTS}
    if launches != want:
        fail(f"main path launches {launches}, expected {want}")
    print(f"engine stats {json.dumps(engine.stats)}")
    return launches, engine


def _category(name: str) -> str:
    for frag, cat in CATEGORIES:
        if frag.lower() in name.lower():
            return cat
    return "other"


def profile_request(engine) -> None:
    """One more full-width request under ``torch.profiler``: device ms by
    kernel and by category, and the device's idle share ``1 − busy /
    profiled wall`` (the profiler's own host cost inflates the wall)."""
    from repro_torch.models.config import dit_b2

    cfg = dit_b2()
    text = np.random.default_rng(7).standard_normal(
        (BATCH, cfg.text_len, cfg.text_dim)).astype(np.float32)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.generate(200, text, BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] += evt.self_device_time_total / 1e3      # ms
    busy = sum(by_name.values())
    if busy <= 0:
        fail("the profiler recorded no device time")
    by_cat: dict[str, float] = defaultdict(float)
    for name, ms in by_name.items():
        by_cat[_category(name)] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print("profile " + json.dumps({
        "batch": BATCH, "steps": STEPS,
        "profiled_request_s": wall, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
        "ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "ms_by_kernel_top12": dict(top)}))


def compare_gpu_cpu(dev) -> None:
    from repro_torch.core.sampling import SamplerConfig
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models.config import dit_b2, router_b2

    dit_cfg = dit_b2().reduced(latent_size=16)
    router_cfg = router_b2(num_clusters=len(MIX)).reduced(latent_size=16)
    path = os.path.join(WORK, "reduced")
    write_ensemble(path, dit_cfg, router_cfg, dev, seed=12)
    sampler = SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2)
    rng = np.random.default_rng(6)
    text = rng.standard_normal((BATCH, dit_cfg.text_len,
                                dit_cfg.text_dim)).astype(np.float32)
    noise = rng.standard_normal((BATCH, 16, 16, 4)).astype(np.float32)
    outs = {}
    for name in ("cuda", "cpu"):
        engine = ServingEngine.from_checkpoint_dir(
            path, dit_cfg=dit_cfg, router_cfg=router_cfg, sampler=sampler,
            device=name)
        outs[name] = engine.generate(0, text, BATCH, noise=noise).cpu()
    shutil.rmtree(path)
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    print("reduced gpu-vs-cpu " + json.dumps(dict(
        max_abs_err=err, tol=E2E_REL_TOL * scale, max_abs=scale)))
    if not (bool(torch.isfinite(outs["cuda"]).all())
            and err <= E2E_REL_TOL * scale):
        fail(f"GPU latents differ from the CPU run by {err} "
             f"(tolerance {E2E_REL_TOL * scale})")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(logs)) or 'cached'})")
    for stem, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")

    gemm = check_ragged_gemm(ops, ref, dev)
    step = check_fused_step(ops, ref, dev)

    launches, engine = serve_full_width(ops, dev)
    profile_request(engine)
    compare_gpu_cpu(dev)

    kernels = [
        dict(name="ragged_gemm", route="cuda",
             source="src/repro_torch/kernels/csrc/ragged_gemm.cu",
             replaces="src/repro/kernels/ragged_gemm.py:73",
             launches=launches["ragged_gemm"], **gemm),
        dict(name="hetero_fuse_step", route="cuda",
             source="src/repro_torch/kernels/csrc/hetero_fuse.cu",
             replaces="src/repro/kernels/hetero_fuse.py:161",
             launches=launches["hetero_fuse_step"], **step),
    ]
    for kern in kernels:
        if kern["launches"] <= 0:
            fail(f"{kern['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
