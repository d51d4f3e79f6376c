"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases (each a hard failure — non-zero exit, no result line — on error):

1. device check: needs CUDA; prints the card's name and power limit;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (all
   ``nvcc`` processes at once) and prints the build seconds;
3. holds each kernel against its plain PyTorch version on the card, at
   the shapes of the serving main paths, and times kernel, plain version
   and one PyTorch library call doing the same function where there is
   one (device time of calls replayed from a CUDA graph, except the
   ragged GEMM's plain version, which syncs; ``wrapper_ms`` adds the
   host's cost per call; the float32 GEMM and attention rows also print
   their share of the bound, ``bound_ms / ms``, each GEMM width the tile,
   wide or narrow, that served it, and the first row of each the SM clock
   and board power under load): the ragged GEMM's float32, bf16-weight,
   int8 and fp8 bodies (with the error and time of each e4m3 contraction
   the fp8 body can use), the step kernel, the velocity kernel, the dequant
   kernel, the AdaLN kernel (at the ragged MLP modulate site, float32,
   with bf16 modulations and in bf16), the attention kernel (the DiT's
   self-attention, and a causal sliding-window GQA case at Mixtral-8x7B's
   head shape), the flag-form fuse kernel, whose path
   ``ops.fused_convert_and_fuse`` is then driven once with the launch
   counts set to 0 and must equal ``fused_velocity`` bitwise, and the SSD
   scan kernel at mamba2-2.7b's mixer shape (bf16 and float32 strided
   views of the projection, and ``S`` < chunk), timed beside its plain
   (sequential) version and the plain chunked algorithm in PyTorch;
4. loads the full-width heterogeneous DiT-B/2 ensemble — 8 random,
   seeded experts (2 DDPM/cosine + 6 FM/linear) and a router, written to
   checkpoints and loaded once with ``ServingEngine.from_checkpoint_dir``
   — and serves two batch-8, CFG-7.5, top-2, 8-step requests on each
   path: the native store (the first slice's path), ``bf16``, ``int8``
   and ``fp8`` stores, and the native store on the unfused step path
   (``step_fused=False``), whose latents must equal the fused ones
   bitwise.  Each path's kernel launch counts, computed from the config,
   must match exactly — every LayerNorm of the router and the experts
   through the AdaLN kernel, every self-attention through the attention
   kernel.  Each path prints its store's bytes and its
   engine's device memory once built, at its build peak and at its
   serving peak, all net of the engines still resident from other paths;
5. serves one more native, one more int8 and one more fp8 request under
   ``torch.profiler`` and prints where their device time goes (by kernel
   and by category) and the device's idle share;
6. runs the same engine code at a reduced width on the GPU and on the CPU
   (plain versions): native, bf16, unfused and two-pass CFG compare their
   latents; int8 and fp8 replay every GEMM, dequant, AdaLN and attention
   call of the GPU request on the CPU with the same inputs (their
   latents' spread is printed beside the CPU run's own under a 2-ulp
   change of its noise);
7. serves the decentralized LM-expert ensemble at the full width of
   mamba2-2.7b (64 layers, d 2560, 80 SSD heads, vocab 50280, bf16): two
   random, seeded experts built on the card with the port's ``init``, a
   token-prototype router fitted on two seeded corpora, top-1 routing —
   two ``perplexity`` requests of 4 × 1024 tokens (exactly 128
   ``ssd_scan`` launches each: 2 experts × 64 layers), one
   ``decode_greedy`` request (batch 2, prompt 16, 16 new tokens; 0
   launches: the prompt replays token by token) and one ``zoo.prefill``
   of 4 × 1024 tokens on one expert (64 launches), with request seconds,
   tokens/s and device memory; then profiles one scoring request (device
   ms by kernel and category, idle share);
8. runs the reduced mamba2 ensemble (float32) on the GPU and on the CPU:
   fused log-probabilities, prefill logits and state, and greedy tokens
   must agree, and on the GPU prefill followed by a decode step must
   reproduce ``forward_train``'s logits.

It prints each phase's seconds, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, ...}``.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
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

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, dense
# float32 outside the tensor cores (TF32 is excluded by design), and the
# dense int8/fp8 and bf16 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
FP8_FLOP_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12

GEMM_REL_TOL = 1e-5        # float32 sums in another order than ATen
#: AdaLN and attention kernels: float32 sums (and the online softmax's
#: rescaling) in another order than ATen; bf16 outputs round once from
#: float32 on both sides, so a flipped rounding is one bf16 ulp.
NORM_ATTN_REL_TOL = 1e-5
BF16_OUT_REL_TOL = 2.0 ** -7
STEP_REL_TOL = 1e-6        # no FMA contraction: same op order as plain
E2E_REL_TOL = 1e-4         # latents after 8 CFG-7.5 steps, GPU vs CPU
#: GPU vs CPU latents of the bf16 store: the GPU sums float32 in another
#: order, which can flip the rounding of one bf16 value (1/256) in the
#: bf16 timestep path.
E2E_BF16_REL_TOL = 5e-3

#: SSD scan, chunked kernel against the sequential recurrence: the chunked
#: algorithm forms every decay factor exp(cum_i − cum_j) from float32
#: cumulative log-decays that reach |cum| ≈ 200 over a 128-position chunk
#: (A = −16, dt 0.1), so each factor carries a relative error of an ulp of
#: |cum| (1.5e-5); three of those.  bf16 y rounds once from float32 on
#: both sides: one bf16 ulp (BF16_OUT_REL_TOL).
SSD_REL_TOL = 5e-5
#: reduced mamba2 ensemble, GPU (kernel, chunked) vs CPU (sequential):
#: two layers of float32 GEMMs and RMSNorms on top of SSD_REL_TOL.
LM_REL_TOL = 1e-4

STEPS, BATCH, REQUESTS = 8, 8, 2
MIX = [("ddpm", "cosine")] * 2 + [("fm", "linear")] * 6

#: device kernel-name fragments -> category of the profile, first match wins.
CATEGORIES = (
    ("ragged_gemm_int8", "ragged_gemm int8 body"),
    ("ragged_gemm_fp8", "ragged_gemm fp8 body"),
    ("ragged_gemm", "ragged_gemm (experts' dense layers)"),
    ("hetero_fuse_step", "hetero_fuse_step"),
    ("hetero_fuse_coeffs", "hetero_fuse_coeffs"),
    ("hetero_fuse_dequant", "hetero_fuse_dequant"),
    ("adaln_fuse", "adaln_fuse (every LayerNorm and modulation)"),
    ("flash_attention", "flash_attention (self-attention)"),
    ("gemm", "cuBLAS GEMM (router dense, cross-attention QK/PV)"),
    ("softmax", "softmax"),
    ("reduce", "reductions (sums, row absmax)"),
    ("elementwise", "elementwise"),
    ("Memcpy", "copies"),
    ("Memset", "sets"),
)


#: the LM scoring request's kernel-name fragments -> category
LM_CATEGORIES = (
    ("ssd_scan", "ssd_scan (every mixer's chunked scan)"),
    ("gemm", "cuBLAS bf16 GEMM (projections, unembedding)"),
    ("nvjet", "cuBLAS bf16 GEMM (projections, unembedding)"),
    ("xmma", "cuBLAS bf16 GEMM (projections, unembedding)"),
    ("softmax", "log-softmax"),
    ("reduce", "reductions (RMSNorm means, logsumexp, histograms)"),
    ("elementwise", "elementwise (conv taps, silu, softplus, gating, "
                    "residuals)"),
    ("CatArrayBatchedCopy", "copies and concatenations"),
    ("Memcpy", "copies and concatenations"),
    ("index", "embedding gather, scatter"),
    ("scatter", "embedding gather, scatter"),
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


def clocks_under(fn, seconds: float = 1.5) -> dict:
    """The SM clock (MHz) and board power (W) that ``nvidia-smi`` reads
    while ``fn`` runs back to back for ``seconds``: lowest and highest of
    the samples taken after the first half second."""
    import threading

    samples, stop = [], threading.Event()

    def poll():
        time.sleep(0.5)
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30).stdout
            mhz, watts = out.strip().splitlines()[0].split(",")
            samples.append((float(mhz), float(watts)))
            time.sleep(0.2)

    poller = threading.Thread(target=poll)
    poller.start()
    end = time.perf_counter() + seconds
    try:
        while time.perf_counter() < end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        stop.set()
        poller.join()
    if not samples:
        return dict(sm_mhz=None, power_w=None)
    mhz, watts = zip(*samples)
    return dict(sm_mhz=[min(mhz), max(mhz)], power_w=[min(watts), max(watts)])


def bound_ms(nbytes: float, flops: float,
             peak: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(got, want) -> tuple[float, float]:
    """``(max |got − want|, max |want|)`` as floats."""
    return ((got - want).abs().max().item(), want.abs().max().item())


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _dense_tile_rows():
    """The dense bodies' tile rule: ``rows(P, m, F)`` is the block tile's
    row count (128 wide, 32 narrow) the kernel library picks for ``P``
    groups of ``m`` rows into ``F`` columns on this card."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.load_library("ragged_gemm").ragged_gemm_dense_tile_rows
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return fn


#: 16 row groups (8 samples × top-2) over 8 experts, 4, 6 and 7 empty.
GROUP_EXPERTS = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 5, 5, 5, 5]


def check_ragged_gemm(ops, ref, dev) -> dict:
    """The dense body at the main path's row-group widths.  The last two
    cases pass their weight as the main path does: layer 5 of a
    ``(K, L, D, F)`` stack, a strided view — float32, then bf16 (a bf16
    store)."""
    pe = torch.tensor(GROUP_EXPERTS, dtype=torch.int32, device=dev)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(512, 768, 3072, 0, f32), (512, 3072, 768, 0, f32),
             (256, 768, 3072, 0, f32), (256, 3072, 768, 0, f32),
             (154, 768, 768, 0, f32), (1, 768, 4608, 0, f32),
             (512, 768, 3072, 12, f32), (512, 768, 3072, 12, bf16)]
    tile_rows = _dense_tile_rows()
    gen = torch.Generator(device=dev).manual_seed(3)
    rows, worst = [], 0.0
    for m, d, f, layers, wdtype in cases:
        p = pe.shape[0]
        x = torch.randn(p, m, d, generator=gen, device=dev)
        if layers:
            stack = torch.randn(8, layers, d, f, generator=gen,
                                device=dev) / math.sqrt(d)
            w = stack.to(wdtype)[:, 5]
        else:
            w = torch.randn(8, d, f, generator=gen, device=dev) / math.sqrt(d)
        got = ops.ragged_expert_matmul(x, w, pe)
        plain = ref.ref_ragged_gemm(x.reshape(p * m, d), w, pe).reshape(
            p, m, f)
        torch.cuda.synchronize()
        err, scale = rel_err(got, plain)
        ok = bool(torch.isfinite(got).all()) and err <= GEMM_REL_TOL * scale
        wg = w[pe.long()].float()          # gathered outside the timing
        xg = x.contiguous()
        t_k = graph_ms(lambda: ops.ragged_expert_matmul(x, w, pe))
        t_w = cuda_ms(lambda: ops.ragged_expert_matmul(x, w, pe))
        # the plain version syncs (it lists the routed experts): events
        t_p = cuda_ms(lambda: ref.ref_ragged_gemm(x.reshape(p * m, d), w,
                                                  pe), iters=10)
        t_l = graph_ms(lambda: torch.bmm(xg, wg))
        n_exp = len(set(pe.tolist()))
        flops = 2.0 * p * m * d * f
        nbytes = (4.0 * (p * m * d + p * m * f + p)
                  + w.element_size() * n_exp * d * f)
        t_b, by = bound_ms(nbytes, flops)
        row = dict(m=m, D=d, F=f, layer_view=bool(layers),
                   weights=str(wdtype).replace("torch.", ""),
                   max_abs_err=err, tol=GEMM_REL_TOL * scale,
                   ms=t_k, wrapper_ms=t_w, plain_ms=t_p, library_ms=t_l,
                   bound_ms=t_b, bound_by=by, share_of_bound=t_b / t_k,
                   tile="narrow" if tile_rows(p, m, f) < 128 else "wide",
                   tflops=flops / t_k / 1e9)
        if not rows:                        # the main shape: clocks too
            row.update(clocks_under(
                lambda: ops.ragged_expert_matmul(x, w, pe)))
        print("ragged_gemm case " + json.dumps(row))
        if not ok:
            fail(f"ragged_gemm disagrees with its plain version: {row}")
        worst = max(worst, err)
        rows.append(row)
    main = rows[0]                          # the MLP up-projection shape
    return dict(max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"])


def _library_quant_mm(xq, wq, pe, m, fp8: bool):
    """One PyTorch call per row group computing the quantized product:
    ``torch._int_mm`` (int8, int32 out) or ``torch._scaled_mm`` (e4m3,
    unit tensor-wise scales, float32 out), weights pre-laid out
    column-major outside the timing.  Returns its milliseconds and its
    unscaled product ``(P·m, F)`` in float32; ``(None, None)`` (with the
    reason printed) where this PyTorch refuses the call."""
    cols = {e: wq[e].t().contiguous().t() for e in set(pe.tolist())}
    one = torch.ones((), device=xq.device)
    groups = [(xq[i * m:(i + 1) * m], cols[e])
              for i, e in enumerate(pe.tolist())]

    def run():
        if fp8:
            return [torch._scaled_mm(a, b, one, one, out_dtype=torch.float32)
                    for a, b in groups]
        return [torch._int_mm(a, b) for a, b in groups]

    try:
        product = torch.cat(run()).to(torch.float32)
        return graph_ms(run), product
    except RuntimeError as exc:                  # a yardstick only
        print(f"library yardstick unavailable: {str(exc).splitlines()[0]}")
        return None, None


def check_ragged_gemm_quant(ops, ref, dev, qdtype) -> dict:
    """The int8 or fp8 body at the main path's tiled widths, on
    activations quantized as the wrapper does: the MLP's two GEMMs, the
    first at m 256 too and on layer 5 of a ``(K, L, D, F)`` quantized
    stack, the patch embedding (D 16), the attention projections (768 →
    768 at m 512 and 256) and the final layer (F 16).  int8 must be
    bitwise equal to its plain version (exact integer sums, same
    epilogue), fp8 within ``1e-5 · max|plain|``.  For fp8 every e4m3
    contraction of the kernel source is also run and its error and time
    printed (``variant`` lines); the served body is the one that meets
    the tolerance."""
    from repro_torch.kernels.ragged_gemm import (
        FP8_VARIANTS, ragged_gemm, ragged_gemm_fp8_variant)

    fp8 = qdtype == torch.float8_e4m3fn
    name = "ragged_gemm_fp8" if fp8 else "ragged_gemm_int8"
    pe = torch.tensor(GROUP_EXPERTS, dtype=torch.int32, device=dev)
    p = pe.shape[0]
    cases = [(512, 768, 3072, 0), (512, 3072, 768, 0), (256, 768, 3072, 0),
             (512, 768, 3072, 12), (256, 16, 768, 0), (512, 768, 768, 0),
             (256, 768, 768, 0), (512, 768, 16, 0)]
    gen = torch.Generator(device=dev).manual_seed(5 + fp8)
    rows, worst = [], 0.0
    for m, d, f, layers in cases:
        x = torch.randn(p * m, d, generator=gen, device=dev)
        w32 = torch.randn(8, max(layers, 1), d, f, generator=gen,
                          device=dev) / math.sqrt(d)
        wq, ws = ops.quantize_rows(w32.reshape(8, -1), qdtype)
        wq = wq.reshape(w32.shape)[:, 5 if layers else 0]
        xq, xs = ops.quantize_rows(x, qdtype)
        got = ragged_gemm(xq, wq, pe, m, xs, ws)
        plain = ref.ref_ragged_gemm(xq, wq, pe, xs, ws)
        torch.cuda.synchronize()
        err, scale = rel_err(got, plain)
        tol = 0.0 if not fp8 else GEMM_REL_TOL * scale
        ok = bool(torch.isfinite(got).all()) and err <= tol
        t_k = graph_ms(lambda: ragged_gemm(xq, wq, pe, m, xs, ws))
        xw = x.reshape(p, m, d)
        t_w = cuda_ms(lambda: ops.ragged_expert_matmul(xw, wq, pe,
                                                        w_scale=ws))
        t_p = cuda_ms(lambda: ref.ref_ragged_gemm(xq, wq, pe, xs, ws),
                      iters=5)
        t_l, lib = _library_quant_mm(xq, wq, pe, m, fp8)
        # the yardstick's own error, after the same epilogue
        lib_err = None if lib is None else rel_err(
            (lib * xs[:, None]) * ws[pe.long()].repeat_interleave(m)[:, None],
            plain)[0]
        n_exp = len(set(pe.tolist()))
        ops_n = 2.0 * p * m * d * f
        nbytes = (1.0 * (p * m * d + n_exp * d * f)
                  + 4.0 * (p * m + 8 + p * m * f + p))
        t_b, by = bound_ms(nbytes, ops_n,
                           FP8_FLOP_PER_S if fp8 else INT8_OP_PER_S)
        row = dict(m=m, D=d, F=f, layer_view=bool(layers),
                   max_abs_err=err, tol=tol, ms=t_k, wrapper_ms=t_w,
                   plain_ms=t_p, library_ms=t_l, library_max_abs_err=lib_err,
                   bound_ms=t_b, bound_by=by, tops=ops_n / t_k / 1e9)
        print(f"{name} case " + json.dumps(row))
        if not ok:
            fail(f"{name} disagrees with its plain version: {row}")
        worst = max(worst, err)
        rows.append(row)
        for v, label in enumerate(FP8_VARIANTS if fp8 else ()):
            got = ragged_gemm_fp8_variant(xq, wq, pe, m, xs, ws, v)
            err_v, _ = rel_err(got, plain)
            print(f"{name} variant " + json.dumps(dict(
                m=m, D=d, F=f, layer_view=bool(layers), variant=label,
                max_abs_err=err_v, rel_err=err_v / scale,
                within_tol=err_v <= tol,
                ms=graph_ms(lambda: ragged_gemm_fp8_variant(
                    xq, wq, pe, m, xs, ws, v)))))
    main = rows[0]
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


def check_fuse_coeffs(ops, ref, dev) -> dict:
    """The velocity kernel at the unfused path's shape: K = 2 slots,
    B = 16 (8 samples × 2 CFG branches), T = 32·32·4; alpha below
    alpha_min and clamped x̂0 present.  Bitwise against its plain version
    (built without FMA contraction, same op order)."""
    k, b, t = 2, 16, 32 * 32 * 4
    gen = torch.Generator(device=dev).manual_seed(8)
    preds = 4 * torch.randn(k, b, t, generator=gen, device=dev)
    x = 3 * torch.randn(b, t, generator=gen, device=dev)
    w = torch.rand(b, k, generator=gen, device=dev)
    coef = 1.5 * torch.rand(5, k, b, generator=gen, device=dev)
    coef[0, 0] = 0.001
    coef[1, 0] = 1.0
    kw = dict(clamp=20.0, alpha_min=0.01)
    got = ops.fused_velocity(preds, x, w, coef, **kw)
    plain = ref.ref_hetero_fuse_coeffs(preds, x, w, coef, **kw)
    torch.cuda.synchronize()
    err, _ = rel_err(got, plain)
    t_k = graph_ms(lambda: ops.fused_velocity(preds, x, w, coef, **kw), 100)
    t_w = cuda_ms(lambda: ops.fused_velocity(preds, x, w, coef, **kw), 50)
    t_p = graph_ms(lambda: ref.ref_hetero_fuse_coeffs(preds, x, w, coef,
                                                      **kw), 100)
    nbytes = 4.0 * (k * b * t + 2 * b * t + b * k + 5 * k * b)
    t_b, by = bound_ms(nbytes, 12.0 * k * b * t)
    row = dict(K=k, B=b, T=t, max_abs_err=err, tol=0.0, ms=t_k,
               wrapper_ms=t_w, plain_ms=t_p, library_ms=None, bound_ms=t_b,
               bound_by=by)
    print("hetero_fuse_coeffs case " + json.dumps(row))
    if not (bool(torch.isfinite(got).all()) and torch.equal(got, plain)):
        fail(f"hetero_fuse_coeffs disagrees with its plain version: {row}")
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=None,
                bound_ms=t_b, bound_by=by)


def check_dequant(ops, ref, dev) -> dict:
    """The dequant kernel on one full-width MLP leaf, ``(8, 768·3072)``
    int8 and e4m3 to float32 (and int8 to bf16): bitwise against its
    plain version.  Library yardstick: ``q * s[:, None]`` for int8 (one
    promoting multiply; PyTorch does not promote float8)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    leaf = torch.randn(8, 768 * 3072, generator=gen, device=dev)
    out = None
    for qdtype, odtype in ((torch.int8, torch.float32),
                           (torch.float8_e4m3fn, torch.float32),
                           (torch.int8, torch.bfloat16)):
        q, s = ops.quantize_rows(leaf, qdtype)
        got = ops.dequant_params(q, s, out_dtype=odtype)
        plain = ref.ref_hetero_fuse_dequant(q, s, out_dtype=odtype)
        torch.cuda.synchronize()
        err, _ = rel_err(got.float(), plain.float())
        t_k = graph_ms(lambda: ops.dequant_params(q, s, out_dtype=odtype))
        t_w = cuda_ms(lambda: ops.dequant_params(q, s, out_dtype=odtype))
        t_p = graph_ms(lambda: ref.ref_hetero_fuse_dequant(
            q, s, out_dtype=odtype))
        t_l = (graph_ms(lambda: q * s[:, None])
               if (qdtype, odtype) == (torch.int8, torch.float32) else None)
        n = q.numel()
        t_b, by = bound_ms(n * (1.0 + got.element_size()) + 4.0 * 8, n)
        row = dict(q=str(qdtype).replace("torch.", ""),
                   out=str(odtype).replace("torch.", ""), shape=list(q.shape),
                   max_abs_err=err, tol=0.0, ms=t_k, wrapper_ms=t_w,
                   plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by)
        print("hetero_fuse_dequant case " + json.dumps(row))
        if not torch.equal(got, plain):
            fail(f"hetero_fuse_dequant disagrees with its plain version: "
                 f"{row}")
        out = out or row                    # int8 -> float32: the main row
    return dict(max_abs_err=out["max_abs_err"], ms=out["ms"],
                plain_ms=out["plain_ms"], library_ms=out["library_ms"],
                bound_ms=out["bound_ms"], bound_by=out["bound_by"])


def check_adaln(ops, ref, dev) -> dict:
    """The AdaLN kernel at the ragged MLP modulate site: x ``(16, 2, 256,
    768)`` (16 pairs × 2 CFG replicas = 32 sequences of 256 tokens),
    γ/β one slice of the ``(P, L, 6, d)`` modulation stack; float32 (the
    native store), float32 with bf16 modulations rounded as the DiT does
    (a bf16 store), and x in bf16; then the layer-0 replica broadcast
    (no copy) and the plain LayerNorm before cross-attention.  Library
    yardstick: no single call computes it; ``F.layer_norm`` plus the two
    elementwise ops."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(13)
    p, g, t, d = 16, 2, 256, 768
    base = 3 * torch.randn(p, g, t, d, generator=gen, device=dev) + 1
    mods = 0.3 * torch.randn(p, 12, 6, d, generator=gen, device=dev)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("f32", base, mods, False), ("bf16_mods", base, mods.to(bf16),
                                          True),
             ("bf16", base.to(bf16), mods.to(bf16), False),
             ("broadcast", base[:, 0][:, None].expand(p, g, t, d), mods,
              False),
             ("layernorm", base, None, False)]
    rows, main = [], None
    for name, x, m, rs in cases:
        gamma = None if m is None else m[:, 5, 3]
        beta = None if m is None else m[:, 5, 4]
        if m is None:
            def kern():
                return ops.layernorm(x)

            def plain():
                return ref.ref_adaln_fuse(x, None, None)
        else:
            def kern():
                return ops.adaln_modulate(x, gamma, beta, round_scale=rs)

            def plain():
                return ref.ref_adaln_fuse(x, gamma, beta, round_scale=rs)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, scale = rel_err(got.float(), want.float())
        tol = (NORM_ATTN_REL_TOL if x.dtype == f32 else BF16_OUT_REL_TOL) \
            * scale
        ok = (bool(torch.isfinite(got).all()) and got.dtype == x.dtype
              and err <= tol)
        t_k = graph_ms(kern, 50)
        t_w = cuda_ms(kern, 50)
        t_p = graph_ms(plain, 20)
        if m is None:
            t_l = graph_ms(lambda: F.layer_norm(x, (d,), eps=1e-6), 50)
        else:
            def lib():
                return F.layer_norm(x, (d,), eps=1e-6) \
                    * (1 + gamma[:, None, None]) + beta[:, None, None]
            t_l = graph_ms(lib, 50)
        n = x.numel()
        read = n // g if name == "broadcast" else n    # one replica read
        nbytes = (read + n) * x.element_size()
        if m is not None:
            nbytes += 2 * p * d * gamma.element_size()
        t_b, by = bound_ms(nbytes, 8.0 * n)
        row = dict(case=name, x=list(x.shape),
                   x_dtype=str(x.dtype).replace("torch.", ""),
                   max_abs_err=err, tol=tol, ms=t_k, wrapper_ms=t_w,
                   plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by)
        print("adaln_fuse case " + json.dumps(row))
        if not ok:
            fail(f"adaln_fuse disagrees with its plain version: {row}")
        rows.append(row)
        main = main or row                     # float32: the native path
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"])


def _open_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs a mask leaves open over one head."""
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = q + 1 if causal else np.full_like(q, s)
    return int((hi - lo).sum())


#: (case, B, Hq, Hkv, S, D, causal, window, dtype) of the attention check
FLASH_CASES = (
    ("dit_self_attention", 32, 12, 12, 256, 64, False, 0, torch.float32),
    ("mixtral_gqa_swa", 1, 32, 8, 8192, 128, True, 4096, torch.bfloat16))


def check_flash(ops, ref, dev) -> dict:
    """The attention kernel at the DiT's self-attention shape — q, k, v
    ``(B·g 32, S 256, H 12, D 64)`` projections read as ``(B, H, S, D)``
    views, non-causal, float32 — and a causal sliding-window GQA case at
    Mixtral-8x7B's head shape (``configs/mixtral_8x7b.py``: Hq 32, Hkv 8,
    D 128, window 4096) over S 8192, batch 1, bf16.  Library yardstick:
    ``scaled_dot_product_attention`` on the same inputs (float32 for the
    DiT; the bf16 GQA case with its mask)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for name, b, hq, hkv, s, d, causal, window, dtype in FLASH_CASES:
        q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(b, s, hkv, d, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
        kw = dict(causal=causal, window=window)

        def kern():
            return ops.flash_attention(q, k, v, **kw)

        def plain():
            rep = hq // hkv
            return ref.ref_flash_attention(q, k.repeat_interleave(rep, 1),
                                           v.repeat_interleave(rep, 1), **kw)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, scale = rel_err(got.float(), want.float())
        tol = (NORM_ATTN_REL_TOL if dtype == torch.float32
               else BF16_OUT_REL_TOL) * scale
        ok = bool(torch.isfinite(got).all()) and err <= tol
        del want
        t_k = graph_ms(kern, 20 if s <= 256 else 3)
        t_w = cuda_ms(kern, 20 if s <= 256 else 3)
        t_p = cuda_ms(plain, 10 if s <= 256 else 2, warmup=1)
        if causal or window:
            pos = torch.arange(s, device=dev)
            mask = (pos[None] <= pos[:, None]) if causal else None
            if window:
                wm = pos[:, None] - pos[None] < window
                mask = wm if mask is None else mask & wm

            def lib():
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask,
                                                      enable_gqa=hq != hkv)
        else:
            def lib():
                return F.scaled_dot_product_attention(q, k, v)
        try:
            lib()
            t_l = cuda_ms(lib, 20 if s <= 256 else 3)
        except RuntimeError as exc:                  # a yardstick only
            print(f"library yardstick unavailable: "
                  f"{str(exc).splitlines()[0]}")
            t_l = None
        pairs = _open_pairs(s, causal, window) * b * hq
        flops = 4.0 * d * pairs
        nbytes = q.element_size() * d * s * b * (2 * hq + 2 * hkv)
        t_b, by = bound_ms(nbytes, flops, FP32_FLOP_PER_S
                           if dtype == torch.float32 else BF16_FLOP_PER_S)
        row = dict(case=name, B=b, Hq=hq, Hkv=hkv, S=s, D=d, causal=causal,
                   window=window, dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=err, tol=tol, ms=t_k, wrapper_ms=t_w,
                   plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by,
                   share_of_bound=t_b / t_k, tflops=flops / t_k / 1e9)
        if not rows:                        # the DiT shape: clocks too
            row.update(clocks_under(kern))
        print("flash_attention case " + json.dumps(row))
        if not ok:
            fail(f"flash_attention disagrees with its plain version: {row}")
        rows.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    main = rows[0]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"])


def check_hetero_fuse(ops, ref, dev) -> dict:
    """The flag-form fuse kernel at K 8, B 16, T 4096 with the 2 DDPM + 6
    FM mix, bitwise against its plain version; then its path: the launch
    counts set to 0, one ``ops.fused_convert_and_fuse`` call from
    objectives, schedules and times as a caller makes it, the counts read
    (exactly one launch, of this kernel), and its output bitwise equal to
    ``fused_velocity`` given the matching ``(5, K, B)`` unified
    coefficients (FM experts as the identity ``(1, 0, 0, 1, 1)``)."""
    from repro_torch.core.conversion import velocity_scale
    from repro_torch.core.schedules import get_schedule
    from repro_torch.kernels.hetero_fuse import hetero_fuse

    k, b, t = len(MIX), 16, 32 * 32 * 4
    gen = torch.Generator(device=dev).manual_seed(15)
    objectives = [o for o, _ in MIX]
    schedules = [get_schedule(n) for _, n in MIX]
    preds = 4 * torch.randn(k, b, t, generator=gen, device=dev)
    x = 3 * torch.randn(b, t, generator=gen, device=dev)
    w = torch.softmax(torch.randn(b, k, generator=gen, device=dev), -1)
    tb = torch.rand(b, generator=gen, device=dev)
    tb[0] = 0.999                                # alpha below alpha_min
    ddpm = torch.tensor([o == "ddpm" for o in objectives], device=dev)
    alpha = torch.stack([s.alpha(tb) for s in schedules])          # (K, B)
    sigma = torch.stack([s.sigma(tb) for s in schedules])
    dalpha = torch.stack([s.dalpha(tb) for s in schedules])
    dsigma = torch.stack([s.dsigma(tb) for s in schedules])
    vscale = torch.where(ddpm[:, None], velocity_scale(tb, "piecewise")[None],
                         1.0)
    coef = torch.stack([alpha, sigma, dalpha, dsigma, vscale])
    kw = dict(clamp=20.0, alpha_min=0.01)
    got = hetero_fuse(preds, x, w, ddpm, coef, **kw)
    want = ref.ref_hetero_fuse(preds, x, w, ddpm, alpha, sigma, dalpha,
                               dsigma, vscale, **kw)
    torch.cuda.synchronize()
    err, _ = rel_err(got, want)
    t_k = graph_ms(lambda: hetero_fuse(preds, x, w, ddpm, coef, **kw), 100)
    t_w = cuda_ms(lambda: ops.fused_convert_and_fuse(
        preds, x, w, objectives, schedules, tb), 50)
    t_p = graph_ms(lambda: ref.ref_hetero_fuse(
        preds, x, w, ddpm, alpha, sigma, dalpha, dsigma, vscale, **kw), 50)
    n_ddpm = int(ddpm.sum().item())
    nbytes = 4.0 * (k * b * t + 2 * b * t + b * k + 5 * k * b) + k
    flops = 12.0 * n_ddpm * b * t + 2.0 * k * b * t
    t_b, by = bound_ms(nbytes, flops)
    row = dict(K=k, B=b, T=t, ddpm=n_ddpm, max_abs_err=err, tol=0.0, ms=t_k,
               wrapper_ms=t_w, plain_ms=t_p, library_ms=None, bound_ms=t_b,
               bound_by=by)
    print("hetero_fuse case " + json.dumps(row))
    if not (bool(torch.isfinite(got).all()) and torch.equal(got, want)):
        fail(f"hetero_fuse disagrees with its plain version: {row}")

    # its path: the per-step fusion op of Fig. 2, as a caller runs it
    torch.cuda.synchronize()
    ops.reset_launches()
    fused = ops.fused_convert_and_fuse(preds, x, w, objectives, schedules,
                                       tb)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    print("fused_convert_and_fuse launches " + json.dumps(launches))
    if launches != dict(dict.fromkeys(ops.LAUNCHES, 0), hetero_fuse=1):
        fail(f"fused_convert_and_fuse launched {launches}")
    ident = torch.tensor([1.0, 0.0, 0.0, 1.0, 1.0], device=dev)
    unified = torch.where(ddpm[None, :, None], coef, ident[:, None, None])
    velocity = ops.fused_velocity(preds, x, w, unified)
    torch.cuda.synchronize()
    print("fused_convert_and_fuse vs fused_velocity " + json.dumps(dict(
        max_abs_diff=rel_err(fused, velocity)[0],
        max_abs=velocity.abs().max().item())))
    if not torch.equal(fused, velocity):
        fail("fused_convert_and_fuse differs from fused_velocity given the "
             "matching unified coefficients")
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=None,
                bound_ms=t_b, bound_by=by,
                launches=launches["hetero_fuse"])


#: mamba2-2.7b's mixer in one scoring request (batch 4 × 1024 tokens):
#: (b, h, s, p, n, chunk)
SSD_SHAPE = (4, 80, 1024, 64, 128, 128)


def _ssd_inputs(dev, b, h, s, p, n, dtype, seed):
    """x, B, C as the mixer makes them: strided slices of one
    ``(b, s, h·p + 2n)`` projection (x read as the kernel's ``(B, H, S, P)``
    view); dt ``(b, s, h)`` float32 = softplus(N/2 + dt_bias) with the
    init's dt range [0.001, 0.1], read as ``(B, H, S)``; A the init's
    ``−linspace(1, 16, h)``."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed)
    xbc = torch.randn(b, s, h * p + 2 * n, generator=gen,
                      device=dev).to(dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p).transpose(1, 2)
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt0 = torch.exp(torch.rand(h, generator=gen, device=dev)
                    * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt = F.softplus(0.5 * torch.randn(b, s, h, generator=gen, device=dev)
                    + torch.log(torch.expm1(dt0)))
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    return x, dt.transpose(1, 2), A, B, C


def ssd_work(b, h, s, p, n, q, elt) -> tuple[float, float]:
    """(operations, bytes) of one scan: the chunked algorithm's products —
    C·Bᵀ once per (batch, chunk), then per (batch, head, chunk) the
    intra-chunk (q × q)·(q × P), inter-chunk (q × N)·(N × P) and state
    (P × q)·(q × N) products — and each input read once, y and the state
    written once."""
    chunks = b * (s // q)
    flops = 2.0 * chunks * q * q * n + 2.0 * chunks * h * (
        q * q * p + 2 * q * p * n)
    nbytes = (elt * (2.0 * b * s * h * p + 2.0 * b * s * n)
              + 4.0 * (b * s * h + h + b * h * p * n))
    return flops, nbytes


def check_ssd_scan(ops, ref, dev) -> dict:
    """The SSD scan kernel at mamba2-2.7b's mixer shape in one scoring
    request — x ``(4, 80, 1024, 64)`` bf16 as a strided view of a
    ``(4, 1024, 80·64 + 256)`` projection, B/C ``(4, 1024, 128)`` strided,
    dt float32, chunk 128 — in bf16, in float32, and with ``S`` = 100 <
    chunk.  y and the state against the plain (sequential) version.
    Times: the kernel, the plain version and the plain chunked algorithm
    in PyTorch (``mamba2.ssd_chunked``: torch einsums, i.e. cuBLAS); no
    single PyTorch call computes the scan (library null).  Bound: the
    convention of the other rows goes by input dtype (bf16 inputs: bf16
    tensor-core peak and HBM bytes); the float32 CUDA-core figure, the
    rate the kernel computes at, is printed beside it."""
    from repro_torch.models.mamba2 import ssd_chunked

    b, h, s, p, n, chunk = SSD_SHAPE
    cases = (("mixer_bf16", s, torch.bfloat16), ("mixer_f32", s, torch.float32),
             ("short_bf16", 100, torch.bfloat16))
    rows = []
    for name, seq, dtype in cases:
        x, dt, A, B, C = _ssd_inputs(dev, b, h, seq, p, n, dtype, seed=16)
        q = min(chunk, seq)

        def kern():
            return ops.ssd_scan(x, dt, A, B, C, chunk=chunk)

        def plain():
            return ref.ref_ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), A,
                                    B, C)
        (y, state), (wy, ws) = kern(), plain()
        torch.cuda.synchronize()
        err, scale = rel_err(y.transpose(1, 2).float(), wy.float())
        serr, sscale = rel_err(state, ws)
        tol = (SSD_REL_TOL if dtype == torch.float32 else BF16_OUT_REL_TOL) \
            * scale
        ok = (bool(torch.isfinite(y).all()) and y.dtype == dtype
              and bool(torch.isfinite(state).all()) and err <= tol
              and serr <= SSD_REL_TOL * sscale)
        del wy, ws
        t_k = graph_ms(kern, 10)
        t_w = cuda_ms(kern, 10)
        t_p = cuda_ms(plain, 2, warmup=1)
        t_c = cuda_ms(lambda: ssd_chunked(x.transpose(1, 2),
                                          dt.transpose(1, 2), A, B, C,
                                          chunk=chunk), 3, warmup=1)
        flops, nbytes = ssd_work(b, h, seq, p, n, q, x.element_size())
        peak = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
        t_b, by = bound_ms(nbytes, flops, peak)
        t_b32, by32 = bound_ms(nbytes, flops, FP32_FLOP_PER_S)
        row = dict(case=name, x=[b, h, seq, p], N=n, chunk=q,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   tol=tol, state_err=serr, state_tol=SSD_REL_TOL * sscale,
                   ms=t_k, wrapper_ms=t_w, plain_ms=t_p,
                   chunked_torch_ms=t_c, library_ms=None, bound_ms=t_b,
                   bound_by=by, bound_f32_ms=t_b32, bound_f32_by=by32,
                   gflop=flops / 1e9, mbytes=nbytes / 1e6,
                   tflops=flops / t_k / 1e9)
        print("ssd_scan case " + json.dumps(row))
        if not ok:
            fail(f"ssd_scan disagrees with its plain version: {row}")
        rows.append(row)
        del x, dt, A, B, C, y, state
        gc.collect()
        torch.cuda.empty_cache()
    main = rows[0]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
                bound_ms=main["bound_ms"], bound_by=main["bound_by"])


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serving main paths
# ---------------------------------------------------------------------------


def write_ensemble(path, dit_cfg, router_cfg, dev, seed):
    """8 random experts (2 DDPM + 6 FM) and a router as checkpoints.

    Every leaf is jittered with seeded noise: fresh init zeroes the output
    layers, which would make every prediction exactly 0.
    """
    from repro_torch.models import dit as D
    from repro_torch.training.checkpoint import (expert_metadata,
                                                 save_checkpoint)
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=dev).manual_seed(seed)

    def jittered(cfg):
        params = D.init(cfg, gen)
        return tree_map(lambda a: a + 0.02 * torch.randn(
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


def expected_launches(cfg, router_cfg, ops, param_dtype: str,
                      step_fused: bool, requests: int) -> dict:
    """Kernel launches of ``requests`` batched-CFG requests of ``STEPS``
    steps, computed from the DiT and router configs and the wrapper's
    row-tile rule.

    Per step, the router's dense forward runs two AdaLN launches (msa,
    mlp) and one attention launch per layer.  One ragged forward (cond
    and uncond batched, ``g = 2``) runs three AdaLN launches per layer
    (msa, the LayerNorm before cross-attention, mlp) and one for the
    final layer, one attention launch per layer (layer 0's on the
    per-pair prefix), and one ragged GEMM per dense layer, each over row
    groups of width ``m``.
    A quantized store contracts the tiled widths in its int8/fp8 body and
    the others in the float32 body after one dequant of the weights; it
    also dequantizes every bias it adds and the four embedding leaves the
    forward reads (position, timestep table, block embedding, null text).
    """
    g, layers = 2, cfg.num_layers
    tokens = (cfg.latent_size // cfg.patch_size) ** 2
    text = g * cfg.text_len
    widths = ([tokens]                      # patch embedding
              + [1] * 4                     # timestep and AdaLN MLPs
              + [tokens] * 4                # layer-0 self-attention, per pair
              + [g * tokens] * 4 * (layers - 1)   # later self-attention
              + [g * tokens] * 2 * layers   # cross-attention q, out
              + [text] * (2 * layers + 1)   # cross-attention k, v; text proj
              + [g * tokens] * 2 * layers   # MLP
              + [1, g * tokens])            # final modulation, output
    # patch embed, timestep MLP x2, AdaLN mlp1, text proj, MLP w1/w2 each
    # layer
    biases = 5 + 2 * layers
    embeddings = 4
    n = STEPS * requests
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["hetero_fuse_step" if step_fused else "hetero_fuse_coeffs"] = n
    lns = 3 if cfg.use_text else 2
    want["adaln_fuse"] = (2 * router_cfg.num_layers
                          + lns * layers + 1) * n
    want["flash_attention"] = (router_cfg.num_layers + layers) * n
    if param_dtype in ("int8", "fp8"):
        tiled = sum(ops.ragged_block_m(m) is not None for m in widths)
        narrow = len(widths) - tiled
        want[f"ragged_gemm_{param_dtype}"] = tiled * n
        want["ragged_gemm"] = narrow * n
        want["hetero_fuse_dequant"] = (narrow + biases + embeddings) * n
    else:
        want["ragged_gemm"] = len(widths) * n
    return want


def serve_path(ops, engine, name, texts, seeds, want, mem) -> tuple:
    """Serve one request per (text, seed) with the launch counters set to
    0 just before and read just after; check outputs and counts.

    ``mem`` holds the device bytes allocated before the engine was built
    (``base``: engines of other paths still resident) and what the build
    added; every memory figure printed is net of ``base``, so it is this
    path's engine alone."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    outs = []
    for i, (text, seed) in enumerate(zip(texts, seeds)):
        t0 = time.perf_counter()
        out = engine.generate(seed, text, BATCH)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        finite = bool(torch.isfinite(out).all())
        print("request " + json.dumps(dict(
            path=name, request=i, seconds=sec, img_per_s=BATCH / sec,
            finite=finite, shape=list(out.shape),
            max_abs=out.abs().max().item())))
        if not finite or tuple(out.shape) != (BATCH, 32, 32, 4):
            fail(f"{name} request {i} output is not finite (B, 32, 32, 4)")
        outs.append(out)
    launches = dict(ops.LAUNCHES)
    print(f"{name} launches " + json.dumps(launches))
    if launches != want:
        fail(f"{name} path launches {launches}, expected {want}")
    print(f"{name} store " + json.dumps(dict(
        param_dtype=engine.sampler.param_dtype,
        store_bytes=engine.param_store.nbytes(),
        other_engines_bytes=mem["base"],
        resident_bytes=mem["resident"],
        load_peak_bytes=mem["load_peak"],
        serve_peak_bytes=torch.cuda.max_memory_allocated() - mem["base"])))
    return outs, launches


def serve_full_width(ops, dev) -> tuple[dict, dict]:
    """Phase 4.  Returns the launches of each path and the native, int8
    and fp8 engines (profiled in phase 5)."""
    from repro_torch.core.sampling import SamplerConfig
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models.config import dit_b2, router_b2
    from repro_torch.models.dit import param_count

    dit_cfg, router_cfg = dit_b2(), router_b2(num_clusters=len(MIX))
    path = os.path.join(WORK, "dit_b2")
    t0 = time.perf_counter()
    write_ensemble(path, dit_cfg, router_cfg, dev, seed=11)
    t_write = time.perf_counter() - t0
    sampler = SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2)

    def load(**kw):
        """Build one engine; also return the device bytes allocated before
        it (``base``), what it holds once built and its peak while built,
        the last two net of ``base``."""
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServingEngine.from_checkpoint_dir(
            path, dit_cfg=dit_cfg, router_cfg=router_cfg,
            sampler=dataclasses.replace(sampler, **kw))
        torch.cuda.synchronize()
        print(f"engine {json.dumps(kw)} loaded in "
              f"{time.perf_counter() - t0:.1f} s")
        return eng, dict(
            base=base, resident=torch.cuda.memory_allocated() - base,
            load_peak=torch.cuda.max_memory_allocated() - base)

    engines, mems = {}, {}
    engines["native"], mems["native"] = load()
    n_params = param_count(engines["native"].expert_params[0])
    print(f"full width: DiT-B/2 experts of {n_params} parameters, "
          f"{len(MIX)} experts + router_b2; checkpoints written in "
          f"{t_write:.1f} s")
    rng = np.random.default_rng(5)
    texts = [rng.standard_normal((BATCH, dit_cfg.text_len,
                                  dit_cfg.text_dim)).astype(np.float32)
             for _ in range(REQUESTS)]
    seeds = [100 + i for i in range(REQUESTS)]
    launches = {}
    outs, launches["native"] = serve_path(
        ops, engines["native"], "native", texts, seeds,
        expected_launches(dit_cfg, router_cfg, ops, "native", True,
                          REQUESTS),
        mems["native"])
    for name, kw in (("unfused", dict(step_fused=False)),
                     ("bf16", dict(param_dtype="bf16")),
                     ("int8", dict(param_dtype="int8")),
                     ("fp8", dict(param_dtype="fp8"))):
        engines[name], mems[name] = load(**kw)
        path_outs, launches[name] = serve_path(
            ops, engines[name], name, texts, seeds,
            expected_launches(dit_cfg, router_cfg, ops,
                              engines[name].sampler.param_dtype,
                              engines[name].sampler.step_fused, REQUESTS),
            mems[name])
        for i, (out, ref_out) in enumerate(zip(path_outs, outs)):
            diff = (out - ref_out).abs().max().item()
            print(f"{name} vs native request {i} " + json.dumps(dict(
                max_abs_diff=diff,
                max_abs_native=ref_out.abs().max().item())))
            if name == "unfused" and not torch.equal(out, ref_out):
                fail(f"unfused request {i} differs from the fused one by "
                     f"{diff}")
        if name not in ("int8", "fp8"):
            del engines[name]
    shutil.rmtree(path)
    print(f"engine stats {json.dumps(engines['native'].stats)}")
    return launches, engines


def _category(name: str, table=CATEGORIES) -> str:
    for frag, cat in table:
        if frag.lower() in name.lower():
            return cat
    return "other"


def profiled(run, table, **fields) -> None:
    """``run()`` under ``torch.profiler``: prints device ms by kernel and by
    category of ``table``, and the device's idle share ``1 − busy /
    profiled wall`` (the profiler's own host cost inflates the wall)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
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
        by_cat[_category(name, table)] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print("profile " + json.dumps({
        **fields, "profiled_request_s": wall, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
        "ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "ms_by_kernel_top12": dict(top)}))


def profile_request(engine, label: str) -> None:
    """One more full-width DiT request under ``torch.profiler``."""
    from repro_torch.models.config import dit_b2

    cfg = dit_b2()
    text = np.random.default_rng(7).standard_normal(
        (BATCH, cfg.text_len, cfg.text_dim)).astype(np.float32)
    profiled(lambda: engine.generate(200, text, BATCH), CATEGORIES,
             path=label, batch=BATCH, steps=STEPS)


#: wrappers whose calls phase 6 records on the GPU and replays on the CPU
REPLAYED = ("ragged_expert_matmul", "dequant_params", "adaln_modulate",
            "layernorm", "flash_attention")


def replay_on_cpu(ops, engine, text, noise) -> dict:
    """Serve one request on the GPU, recording the inputs and output of
    every call of the ``REPLAYED`` wrappers (each call as the model made
    it, strided and broadcast views included), then replay each call's
    exact inputs through the CPU plain versions.  Returns the worst
    ``max |Δ| / max |out|`` per wrapper."""
    calls = []
    real = {name: getattr(ops, name) for name in REPLAYED}

    def record(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, fn, args, kw, out))
            return out
        return call

    for name in REPLAYED:
        setattr(ops, name, record(name, real[name]))
    try:
        latents = engine.generate(0, text, BATCH, noise=noise)
    finally:
        for name in REPLAYED:
            setattr(ops, name, real[name])

    def cpu(a):
        return a.cpu() if isinstance(a, torch.Tensor) else a

    worst = {}
    for name, fn, args, kw, out in calls:
        want = fn(*map(cpu, args), **{k: cpu(v) for k, v in kw.items()})
        err, scale = rel_err(out.cpu().float(), want.float())
        worst[name] = max(worst.get(name, 0.0), err / max(scale, 1e-30))
    worst["calls"] = len(calls)
    return worst, latents.cpu()


def compare_gpu_cpu(ops, dev) -> None:
    """Phase 6: the same reduced ensemble and request on the GPU and on the
    CPU, for every served path.

    The float32 paths (native, unfused, two-pass CFG) and bf16 are held
    on their latents after 8 steps.  The int8/fp8 latents are not: each
    tiled GEMM quantizes its activations per row, so an ulp of difference
    upstream (the GPU sums float32 in another order) can flip one
    activation's rounding (1/127 of it for int8, 1/16 for fp8), and the
    DDPM conversion near t = 1 divides by α_min = 0.01 — the GPU and CPU
    latents drift apart as the CPU run drifts from itself under a 2-ulp
    change of its starting noise (both printed).  Instead every GEMM,
    dequant, AdaLN and attention call of the GPU request is replayed on
    the CPU with its exact inputs and must agree within
    ``1e-5 · max|out|`` (the dequant calls bitwise): the card quantizes
    activations exactly as the CPU does.
    """
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
    paths = (("native", {}, E2E_REL_TOL),
             ("bf16", dict(param_dtype="bf16"), E2E_BF16_REL_TOL),
             ("int8", dict(param_dtype="int8"), None),
             ("fp8", dict(param_dtype="fp8"), None),
             ("unfused", dict(step_fused=False), E2E_REL_TOL),
             ("two_pass_cfg", dict(batched_cfg=False), E2E_REL_TOL))

    def engine(device, kw):
        return ServingEngine.from_checkpoint_dir(
            path, dit_cfg=dit_cfg, router_cfg=router_cfg,
            sampler=dataclasses.replace(sampler, **kw), device=device)

    failed = []
    for name, kw, rel in paths:
        cpu_engine = engine("cpu", kw)
        cpu = cpu_engine.generate(0, text, BATCH, noise=noise)
        if rel is not None:
            gpu = engine("cuda", kw).generate(0, text, BATCH,
                                              noise=noise).cpu()
            err, scale = rel_err(gpu, cpu)
            print("reduced gpu-vs-cpu " + json.dumps(dict(
                path=name, max_abs_err=err, tol=rel * scale,
                max_abs=scale)))
            if not (bool(torch.isfinite(gpu).all()) and err <= rel * scale):
                failed.append(f"{name}: {err} > {rel * scale}")
            continue
        worst, gpu = replay_on_cpu(ops, engine("cuda", kw), text, noise)
        moved = cpu_engine.generate(
            0, text, BATCH,
            noise=(noise * np.float32(1 + 2 ** -22)).astype(np.float32))
        print("reduced gpu-vs-cpu " + json.dumps(dict(
            path=name, replayed_calls=worst.pop("calls"),
            rel_err_by_wrapper=worst, tol=GEMM_REL_TOL,
            norm_attn_tol=NORM_ATTN_REL_TOL,
            latents_gpu_vs_cpu=rel_err(gpu, cpu)[0],
            latents_cpu_vs_cpu_noise_2ulp=rel_err(moved, cpu)[0],
            max_abs=cpu.abs().max().item())))
        if not (bool(torch.isfinite(gpu).all())
                and set(worst) == set(REPLAYED)
                and worst["ragged_expert_matmul"] <= GEMM_REL_TOL
                and worst["dequant_params"] == 0.0
                and all(worst[n] <= NORM_ATTN_REL_TOL for n in (
                    "adaln_modulate", "layernorm", "flash_attention"))):
            failed.append(f"{name}: replayed calls {worst}")
    shutil.rmtree(path)
    if failed:
        fail(f"GPU run differs from the CPU run: {failed}")


# ---------------------------------------------------------------------------
# Phases 7 and 8: the LM-expert ensemble (mamba2-2.7b)
# ---------------------------------------------------------------------------

LM_EXPERTS, LM_BATCH, LM_SEQ, LM_REQUESTS = 2, 4, 1024, 2
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 2, 16, 16


def lm_corpora(vocab: int, rng) -> list[np.ndarray]:
    """Two seeded corpora of 8 × 1024 tokens, one per half of the
    vocabulary (the two clusters the experts would be trained on)."""
    half = vocab // 2
    return [rng.integers(c * half, (c + 1) * half, (8, 1024))
            for c in range(2)]


def lm_request(vocab: int, rng, batch: int, seq: int):
    """(tokens, labels) ``(batch, seq)``: rows alternate between the two
    clusters' halves of the vocabulary; labels are the next tokens."""
    half = vocab // 2
    toks = np.stack([rng.integers((i % 2) * half, (i % 2 + 1) * half,
                                  seq + 1) for i in range(batch)])
    return toks[:, :-1], toks[:, 1:]


def lm_ensemble(cfg, experts, seed: int):
    from repro_torch.core.lm_ensemble import (LMExpertEnsemble,
                                              TokenPrototypeRouter)

    router = TokenPrototypeRouter.fit(
        lm_corpora(cfg.vocab_size, np.random.default_rng(seed)),
        vocab=cfg.vocab_size)
    return LMExpertEnsemble(cfg=cfg, expert_params=experts, router=router,
                            strategy="topk", top_k=1)


def _check_launches(ops, label: str, ssd: int) -> dict:
    """The counts since the last reset: exactly ``ssd`` scan launches and
    no other kernel (the LM path runs no other kernel of the port)."""
    launches = dict(ops.LAUNCHES)
    print(f"{label} launches " + json.dumps(launches))
    want = dict(dict.fromkeys(ops.LAUNCHES, 0), ssd_scan=ssd)
    if launches != want:
        fail(f"{label} launched {launches}, expected {want}")
    return launches


def serve_lm_full_width(ops, dev):
    """Phase 7: the mamba2-2.7b two-expert ensemble at full width.  Returns
    the scoring path's launches and the ensemble (profiled next)."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.tree import tree_leaves

    cfg = get_config("mamba2-2.7b")
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    experts = [zoo.init(cfg, torch.Generator(device=dev).manual_seed(21 + k),
                        dev) for k in range(LM_EXPERTS)]
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() - base
    build_peak = torch.cuda.max_memory_allocated() - base
    leaves = tree_leaves(experts[0])
    n_params = sum(a.numel() for a in leaves)
    expert_bytes = sum(a.numel() * a.element_size() for a in leaves)
    ens = lm_ensemble(cfg, experts, seed=8)
    print(f"full width: mamba2-2.7b, {LM_EXPERTS} experts of {n_params} "
          f"parameters ({expert_bytes} bytes each), built on the card in "
          f"{t_init:.1f} s; top-1 token-prototype routing")
    rng = np.random.default_rng(10)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for i in range(LM_REQUESTS):
        toks, labels = lm_request(cfg.vocab_size, rng, LM_BATCH, LM_SEQ)
        tt, tl = torch.from_numpy(toks).to(dev), torch.from_numpy(labels).to(dev)
        t0 = time.perf_counter()
        ppl = ens.perplexity(tt, tl)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print("lm request " + json.dumps(dict(
            path="scoring", request=i, batch=LM_BATCH, tokens=LM_SEQ,
            seconds=sec, tokens_per_s=LM_BATCH * LM_SEQ / sec,
            perplexity=ppl, finite=math.isfinite(ppl))))
        if not (math.isfinite(ppl) and ppl > 1.0):
            fail(f"scoring request {i}: perplexity {ppl}")
    launches = {"lm_scoring": _check_launches(
        ops, "lm_scoring", LM_EXPERTS * cfg.num_layers * LM_REQUESTS)}
    print("lm_scoring store " + json.dumps(dict(
        param_dtype=str(cfg.param_dtype).replace("torch.", ""),
        store_bytes=LM_EXPERTS * expert_bytes, other_bytes=base,
        resident_bytes=resident, load_peak_bytes=build_peak,
        serve_peak_bytes=torch.cuda.max_memory_allocated() - base)))

    prompt = torch.from_numpy(lm_request(cfg.vocab_size, rng, DECODE_BATCH,
                                         DECODE_PROMPT)[0]).to(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = ens.decode_greedy(prompt, DECODE_NEW)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    new = out[:, DECODE_PROMPT:]
    print("lm request " + json.dumps(dict(
        path="decode_greedy", batch=DECODE_BATCH, prompt=DECODE_PROMPT,
        new_tokens=DECODE_NEW, seconds=sec,
        new_tokens_per_s=DECODE_BATCH * DECODE_NEW / sec,
        shape=list(out.shape), tokens=new.tolist())))
    if (tuple(out.shape) != (DECODE_BATCH, DECODE_PROMPT + DECODE_NEW)
            or not torch.equal(out[:, :DECODE_PROMPT], prompt)
            or bool(((new < 0) | (new >= cfg.vocab_size)).any())):
        fail("decode_greedy output is not the prompt and in-vocabulary "
             "tokens")
    launches["lm_decode"] = _check_launches(ops, "lm_decode", 0)

    toks = torch.from_numpy(lm_request(cfg.vocab_size, rng, LM_BATCH,
                                       LM_SEQ)[0]).to(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = zoo.prefill(cfg, experts[0], {"tokens": toks})
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(a).all()) for a in (
        logits, cache["ssm"], cache["conv"]))
    print("lm request " + json.dumps(dict(
        path="prefill", batch=LM_BATCH, tokens=LM_SEQ, seconds=sec,
        tokens_per_s=LM_BATCH * LM_SEQ / sec, finite=finite,
        logits=list(logits.shape), ssm_cache=list(cache["ssm"].shape),
        conv_cache=list(cache["conv"].shape))))
    if not (finite and tuple(logits.shape) == (LM_BATCH, cfg.vocab_size)
            and tuple(cache["ssm"].shape) == (
                cfg.num_layers, LM_BATCH, cfg.ssm_nheads, cfg.ssm_headdim,
                cfg.ssm_state)):
        fail("prefill output is not finite logits (B, V) and a full cache")
    launches["lm_prefill"] = _check_launches(ops, "lm_prefill",
                                             cfg.num_layers)
    return launches, ens


def profile_lm_request(ens) -> None:
    """One more scoring request (4 × 1024 tokens) under
    ``torch.profiler``."""
    toks, labels = lm_request(ens.cfg.vocab_size, np.random.default_rng(11),
                              LM_BATCH, LM_SEQ)
    tt, tl = torch.from_numpy(toks).cuda(), torch.from_numpy(labels).cuda()
    profiled(lambda: ens.perplexity(tt, tl), LM_CATEGORIES,
             path="lm_scoring", batch=LM_BATCH, tokens=LM_SEQ,
             experts=LM_EXPERTS)


def compare_lm_gpu_cpu(ops, dev) -> None:
    """Phase 8: the reduced mamba2 ensemble (float32, 2 layers, chunk 16)
    on the GPU (scan kernel) and on the CPU (plain sequential scan):
    fused log-probabilities, prefill logits and state within
    ``LM_REL_TOL · max|out|``, greedy tokens equal (the smallest top-1/top-2
    gap printed).  On the GPU, prefill followed by a decode step must
    reproduce ``forward_train``'s logits (the reference's invariant,
    ``tests/test_arch_smoke.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.tree import tree_map

    cfg = get_config("mamba2-2.7b").reduced()
    cpu_experts = [zoo.init(cfg, torch.Generator().manual_seed(31 + k), "cpu")
                   for k in range(LM_EXPERTS)]
    gpu_experts = [tree_map(lambda a: a.to(dev), e) for e in cpu_experts]
    ens = {"cpu": lm_ensemble(cfg, cpu_experts, seed=9),
           "gpu": lm_ensemble(cfg, gpu_experts, seed=9)}
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(lm_request(cfg.vocab_size, rng, 4, 64)[0])
    prompt = toks[:2, :8]
    failed, rows = [], {}

    def check(name, gpu, cpu, tol=LM_REL_TOL):
        err, scale = rel_err(gpu.cpu().float(), cpu.float())
        rows[name] = dict(max_abs_err=err, tol=tol * scale, max_abs=scale)
        if not (bool(torch.isfinite(gpu).all()) and err <= tol * scale):
            failed.append(f"{name}: {err} > {tol * scale}")

    ops.reset_launches()
    lp = {d: e.fused_logprobs(toks.to(dev if d == "gpu" else "cpu"))
          for d, e in ens.items()}
    check("fused_logprobs", lp["gpu"], lp["cpu"])
    pre = {d: zoo.prefill(cfg, e.expert_params[0],
                          {"tokens": toks.to(dev if d == "gpu" else "cpu")})
           for d, e in ens.items()}
    check("prefill_logits", pre["gpu"][0], pre["cpu"][0])
    check("prefill_ssm_state", pre["gpu"][1]["ssm"], pre["cpu"][1]["ssm"])
    check("prefill_conv_cache", pre["gpu"][1]["conv"], pre["cpu"][1]["conv"])
    if ops.LAUNCHES["ssd_scan"] != (LM_EXPERTS + 1) * cfg.num_layers:
        failed.append(f"reduced GPU run launched {ops.LAUNCHES}")
    out = {d: e.decode_greedy(prompt.to(dev if d == "gpu" else "cpu"), 8)
           for d, e in ens.items()}
    gen_lp = ens["cpu"].fused_logprobs(out["cpu"][:, :-1])[:, 7:]
    top2 = torch.topk(gen_lp, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).min().item()
    rows["decode_greedy"] = dict(equal=torch.equal(out["gpu"].cpu(),
                                                   out["cpu"]),
                                 min_top2_margin=margin)
    if not rows["decode_greedy"]["equal"]:
        failed.append(f"greedy tokens differ (smallest margin {margin})")

    # prefill + one decode step == forward_train, on the GPU
    experts = ens["gpu"].expert_params
    full, _ = zoo.forward_train(cfg, experts[1], {"tokens": toks.to(dev)})
    last, cache = zoo.prefill(cfg, experts[1], {"tokens": toks[:, :48].to(dev)})
    step, _ = zoo.decode_step(cfg, experts[1], cache,
                              toks[:, 48:49].to(dev), None)
    check("gpu_prefill_vs_forward", last, full[:, 47].cpu())
    check("gpu_decode_vs_forward", step, full[:, 48].cpu())
    print("lm reduced gpu-vs-cpu " + json.dumps(rows))
    if failed:
        fail(f"reduced LM GPU run differs from the CPU run: {failed}")


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

    t_phase = time.perf_counter()

    def phase_done(label: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {label} seconds {now - t_phase:.1f}")
        t_phase = now

    logs = _build.build_all()
    print(f"kernel build {time.perf_counter() - t_phase:.1f} s "
          f"({', '.join(sorted(logs)) or 'cached'})")
    for stem, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")
    phase_done("2 (build)")

    summary = {
        "ragged_gemm": check_ragged_gemm(ops, ref, dev),
        "ragged_gemm_int8": check_ragged_gemm_quant(ops, ref, dev,
                                                    torch.int8),
        "ragged_gemm_fp8": check_ragged_gemm_quant(ops, ref, dev,
                                                   torch.float8_e4m3fn),
        "hetero_fuse_step": check_fused_step(ops, ref, dev),
        "hetero_fuse_coeffs": check_fuse_coeffs(ops, ref, dev),
        "hetero_fuse_dequant": check_dequant(ops, ref, dev),
        "adaln_fuse": check_adaln(ops, ref, dev),
        "flash_attention": check_flash(ops, ref, dev),
        "hetero_fuse": check_hetero_fuse(ops, ref, dev),
        "ssd_scan": check_ssd_scan(ops, ref, dev),
    }
    # the flag-form fuse kernel's path is its entry point, driven above
    launches_fuse = summary["hetero_fuse"].pop("launches")
    phase_done("3 (kernels against plain versions)")

    launches, engines = serve_full_width(ops, dev)
    phase_done("4 (DiT serving)")
    profile_request(engines["native"], "native")
    profile_request(engines["int8"], "int8")
    profile_request(engines["fp8"], "fp8")
    del engines
    phase_done("5 (DiT profiles)")
    compare_gpu_cpu(ops, dev)
    phase_done("6 (DiT reduced GPU vs CPU)")
    gc.collect()
    torch.cuda.empty_cache()

    lm_launches, ens = serve_lm_full_width(ops, dev)
    launches.update(lm_launches)
    profile_lm_request(ens)
    del ens
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("7 (LM serving and profile)")
    compare_lm_gpu_cpu(ops, dev)
    phase_done("8 (LM reduced GPU vs CPU)")

    # each kernel's launches on the served path that exercises it
    where = {"ragged_gemm": "native", "ragged_gemm_int8": "int8",
             "ragged_gemm_fp8": "fp8", "hetero_fuse_step": "native",
             "hetero_fuse_coeffs": "unfused", "hetero_fuse_dequant": "int8",
             "adaln_fuse": "native", "flash_attention": "native",
             "hetero_fuse": "fused_convert_and_fuse",
             "ssd_scan": "lm_scoring"}
    launches["fused_convert_and_fuse"] = {"hetero_fuse": launches_fuse}
    sources = {
        "ragged_gemm": ("ragged_gemm.cu", "ragged_gemm.py:73"),
        "ragged_gemm_int8": ("ragged_gemm.cu", "ragged_gemm.py:148"),
        "ragged_gemm_fp8": ("ragged_gemm.cu", "ragged_gemm.py:148"),
        "hetero_fuse_step": ("hetero_fuse.cu", "hetero_fuse.py:161"),
        "hetero_fuse_coeffs": ("hetero_fuse.cu", "hetero_fuse.py:95"),
        "hetero_fuse_dequant": ("hetero_fuse.cu", "hetero_fuse.py:231"),
        "adaln_fuse": ("adaln_fuse.cu", "adaln_fuse.py:34"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:82"),
        "hetero_fuse": ("hetero_fuse.cu", "hetero_fuse.py:266"),
        "ssd_scan": ("ssd_scan.cu", "ssd_scan.py:86"),
    }
    kernels = []
    for name, (src, tpu) in sources.items():
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/{tpu}",
            launches=launches[where[name]][name], path=where[name],
            **summary[name]))
    for kern in kernels:
        if kern["launches"] <= 0:
            fail(f"{kern['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
