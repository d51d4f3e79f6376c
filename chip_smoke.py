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
   host's cost per call; the float32 GEMM, attention and SSD scan rows
   also print their share of the bound, ``bound_ms / ms``, each GEMM width
   the tile, wide or narrow, that served it, and the first row of each the
   SM clock and board power under load): the ragged GEMM's float32,
   bf16-weight, int8 and fp8 bodies (with the error and time of each e4m3
   contraction the fp8 body can use), the step kernel and the velocity
   kernel (bitwise; each case also times ``floor_ms``, one ATen pass over
   the latent; the step kernel also at K 8 slots, the full strategy's
   shape), the dequant
   kernel, the AdaLN kernel (at the ragged MLP modulate site, float32,
   with bf16 modulations and in bf16), the attention kernel (the DiT's
   self-attention and its cross-attention — a top-2 request's 32 rows of
   256 latent tokens over the 77 text tokens, 12 heads of D 64, float32 —,
   a causal sliding-window GQA case at Mixtral-8x7B's
   head shape — phase 17's 1 × 8192-token request — and the causal bf16
   attention of phase 15's two LM paths: zamba2-2.7b's 32 heads of D 80
   and internlm2-1.8b's 16 query heads over 8 kv heads of D 128, batch 4,
   S 1024, and deepseek-coder-33b's 56 over 8 (a group of 7), each with
   the staging its operands take and the design that ran: the bf16 cases
   must run the tensor-core kernel, ``"wgmma bf16"``, the float32 DiT
   cases the FFMA template), the flag-form fuse kernel (the K 8 serving
   mix, K 12 on the runtime slot loop, K 2 all-DDPM and all-FM; bitwise,
   with ``floor_ms``), whose path
   ``ops.fused_convert_and_fuse`` is then driven once with the launch
   counts set to 0 and must equal ``fused_velocity`` bitwise, and the SSD
   scan kernel at mamba2-2.7b's mixer shape (bf16 and float32 strided
   views of the projection, and ``S`` < chunk; its C·Bᵀ prep first against
   its own plain version) and at zamba2-2.7b's (state N 64), timed
   beside its plain (sequential) version and the plain chunked algorithm
   in PyTorch; then the two backward kernels
   at the training shapes (batch 32 of DiT-B/2): the AdaLN backward at a
   modulate site (and without γ) and the attention backward from the
   forward's log-sum-exp (the self-attention and the cross-attention over
   the 77 text tokens), each against its plain version's gradients
   (and bitwise repeatable), timed beside its plain version and the
   library's backward (``F.layer_norm`` + the modulation's elementwise
   ops; ``scaled_dot_product_attention``), the attention backward also
   causal in bf16 at phase 14's two LM training shapes (internlm2-1.8b's
   16 query heads over 8 kv heads of D 128, zamba2-2.7b's 32 heads of D
   80, batch 4, S 1024), at phase 17's mixtral-8x7b step (32 over 8, D
   128, 1 × 8192 tokens, window 4096) and at deepseek-coder-33b's group
   of 7 (bound by the bf16 and by the float32 rule, SDPA's bf16 causal
   GQA backward beside it, masked where the window is), each case on its
   route
   (the LM cases the tensor-core dK/dV and dQ kernels, the DiT cases the
   FFMA tile kernel) with each kernel's device ms, and the tensor-core
   kernels' registers and spill bytes (none); and the SSD scan's backward
   kernel at the mixer shape (bf16 with ``d_state`` zero and not, float32,
   and ``S`` < chunk) from the forward's tile-start states, against its
   plain version's five gradients (bitwise repeatable), timed beside its
   plain version and the autograd backward of the plain chunked
   algorithm;
4. loads the full-width heterogeneous DiT-B/2 ensemble — 8 random,
   seeded experts (2 DDPM/cosine + 6 FM/linear) and a router, written to
   checkpoints and loaded once with ``ServingEngine.from_checkpoint_dir``
   — and serves two batch-8, CFG-7.5, top-2, 8-step requests on each
   path: the native store (the first slice's path), ``bf16``, ``int8``
   and ``fp8`` stores, and the native store on the unfused step path
   (``step_fused=False``), whose latents must equal the fused ones
   bitwise.  Each path's kernel launch counts, computed from the config,
   must match exactly — every LayerNorm of the router and the experts
   through the AdaLN kernel, every attention (self-attention, and the
   experts' cross-attention over the 77 text tokens) through the
   attention kernel.  Each path prints its store's bytes and its
   engine's device memory once built, at its build peak and at its
   serving peak, all net of the engines still resident from other paths.
   Then, on the native engine, one request each with plan reuse
   (``plan_refresh_every`` 1, 2, 4: the router's launches fall to
   ⌈8/R⌉ steps) and the §7.3 DDPM gate, a ``submit``/``flush`` of three
   requests (batch 1, 3, 4) as one dispatch held against ``generate``,
   and a request expired by its deadline before dispatch.  Then one
   request on each of the other strategies, engines and executors
   (``STRATEGY_PATHS``: ``full``, ``dense_topk``, ``threshold`` on the
   native and int8 stores, ``reference``, ``snr_match``, ``grouped``,
   ``gathered``) and on a full-width per-block adaLN-Zero ensemble, each
   with its exact launch counts and its max |Δ| against the native top-2
   request from the same noise (``dense_topk``, ``reference``,
   ``grouped`` and ``gathered`` compute that request's function and must
   match it);
5. serves one more native (with and without plan reuse every 2 steps),
   one more int8, one more fp8, one ``full`` and one ``threshold``
   request under
   ``torch.profiler`` and prints where their device time goes (by kernel
   and by category), the device's idle share and the host's op count,
   self time and copies;
6. runs the same engine code at a reduced width on the GPU and on the CPU
   (plain versions): native, bf16, unfused, two-pass CFG, plan reuse
   every 2 steps, the DDPM gate, every path of ``STRATEGY_PATHS`` and a
   per-block adaLN-Zero ensemble compare their
   latents; int8 and fp8 replay every GEMM, dequant, AdaLN and attention
   call of the GPU request on the CPU with the same inputs (their
   latents' spread is printed beside the CPU run's own under a 2-ulp
   change of its noise); and one training step (loss, every gradient
   leaf, the parameters after AdamW) of a reduced DDPM expert, FM expert
   and router, from the same draws;
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
   reproduce ``forward_train``'s logits; and one reduced float32
   ``make_lm_train_step`` step on both (the loss, every gradient leaf, the
   parameters after the step);
9. runs the serving CLI, ``python -m repro_torch.launch.serve``, five
   times at once on the card over reduced checkpoints (latent 8):
   ``--coalesce --plan-refresh 2 --track-padding``, ``--strategy full``,
   ``--coalesce --deadline-s 0``, ``--continuous --capacity 10
   --journal-dir …`` and ``--on-bad-checkpoint skip`` over a copy with one
   truncated checkpoint; each must exit 0, serve every request and print
   its lines; beside them the training CLI, ``python -m
   repro_torch.launch.train --mode expert --steps 20 --out …``, must exit
   0 and write a checkpoint that loads, and ``--mode lm --arch
   mamba2-2.7b --steps 3``, ``--arch internlm2-1.8b`` and ``--arch
   mixtral-8x7b`` (reduced) and the LM example (``python -m
   repro_torch.examples.decentralized_lm_experts``, ``--arch
   mamba2-2.7b``, ``zamba2-2.7b`` and ``mixtral-8x7b``) must exit 0 and
   print their lines;
10. (after phase 5, over phase 4's checkpoints) elastic membership at full
   width: capacity-10 native and int8 engines, all-live against the
   fixed engine, a request submitted before an eviction bitwise its
   ``generate`` before it, ``add_expert`` of a ninth checkpoint (the int8
   slot bitwise a store quantized from scratch), retire / quarantine /
   trip / restore, a NaN-poisoned evicted slot, a profiled elastic
   request, an eviction in mid-flight through a rolling batch, and one
   live slot under top-2 (``degraded_steps``);
11. continuous batching at full width: staggered requests (batch 1, 2, 1,
   4, 2, 1, 3, 2, one every 2 ticks) through a rolling batch of 8 at
   ``steps_per_tick`` 1 and 2 (one ``hetero_fuse_step`` per bucket step,
   each request against ``generate``), img/s against one ``flush``, plan
   reuse R 2 (the router only on refresh ticks) and a profiled tick;
12. the resilience layer: a watchdog trip, a breaker trip from a poisoned
   slot through heal, canary and restore, an expired deadline,
   kill-and-restore from a journal (bitwise an uninterrupted twin) and a
   60-tick chaos soak on the toy ensemble;
13. (after phase 6) training at full DiT-B/2 width: clusters fitted on a
   seeded synthetic corpus (latent 32, 2 clusters), a random class-free
   DiT-B/2 converted by ``convert_checkpoint`` (Eq. 20), a DDPM/cosine
   expert from ``init`` and an FM/linear expert from the converted
   parameters on their clusters' streams and ``router_b2(num_clusters=2)``,
   each 20 steps at batch 32 — per-step seconds, images/s, peak memory,
   exact forward and backward launches per step, the first step's
   gradients against the plain path's on the card, finite losses and a
   falling loss on one fixed batch — then the three EMA checkpoints serve
   one batch-8, 8-step, CFG-7.5, top-2 request;
14. (after phase 8) LM training at the full width and depth of
   mamba2-2.7b, internlm2-1.8b and zamba2-2.7b (bf16, remat, 512-token CE
   chunks): for each, a float32 model of 2 layers (zamba2: one group, 6
   mixers and the shared block) at full width, its first-step gradients
   on the kernel path against the plain path on the card, then one
   expert from random seeded weights trained 10 steps of 4 × 1024
   ``lm_batch`` tokens through ``make_lm_train_step`` (cut from the
   reference's 256 × 4096) — per-step seconds, tokens/s, peak device
   memory (under 80 GB), exact launches per step (mamba2 ``ssd_scan``
   128, ``ssd_scan_bwd`` 64; internlm2 ``flash_attention`` 48,
   ``flash_attention_bwd`` 24; zamba2 ``ssd_scan`` 108, ``ssd_scan_bwd``
   54, ``flash_attention`` 18, ``flash_attention_bwd`` 9), finite losses
   and a falling loss on one fixed batch — and one more step under the
   profiler;
15. (after phase 14) serves zamba2-2.7b (the hybrid: 54 mamba2 layers,
   d 2560, state 64, the shared attention + SwiGLU block after every 6,
   32 heads of D 80, vocab 32000) and internlm2-1.8b (dense: 24 layers,
   d 2048, 16 query heads over 8 kv heads of D 128, d_ff 8192, vocab
   92544) at full width and depth in bf16, as phase 7 serves mamba2:
   two random seeded experts each, two scoring requests (exactly 108
   ``ssd_scan`` + 18 ``flash_attention`` launches a zamba2 request, 48
   ``flash_attention`` an internlm2 one), a greedy decode (no launch),
   a prefill (54 + 9; 24) whose cache has ``make_cache``'s leaves,
   one profiled scoring request each, and each at full width and cut
   depth (zamba2 6 layers, internlm2 2) in bf16: one request's fused
   log-probabilities through the attention kernel against the same
   request with the plain attention on the card;
16. runs the reduced zamba2, internlm2 and mixtral-8x7b (4 query heads
   over 2 kv heads; 4 experts, window 64) ensembles (float32) on the GPU
   and on the CPU, as phase 8: fused log-probabilities, prefill logits
   and every cache leaf, greedy tokens, and on the GPU prefill + decode
   against ``forward_train``; and one reduced ``make_lm_train_step`` step
   of each on both; mixtral under its ``dense_scan`` and under the
   capacity dispatch at a factor that drops, which must drop the same
   assignments on both (the smallest router gap printed); and the reduced
   whisper-large-v3 (2 encoder and 2 decoder layers, 16 frames) from the
   same parameters, tokens and frames on both: ``forward_train`` and
   ``prefill`` logits, every cache leaf, the greedy tokens of prefill and
   then ``decode_step``, prefill + decode against ``forward_train`` on
   the GPU, and one ``make_lm_train_step`` step; and the reduced
   paligemma-3b (2 layers, d 256, 4 query heads over 1 of D 64, 8
   patches) the same way — its prefix-LM attention on the kernel — with
   its ``forward_train`` logits also at ``reduced(head_dim=256)`` (the D
   256 instances under float32), and one ``make_lm_train_step`` step;
17. (after phase 16) the MoE and deepseek LM experts on the card:
   mixtral-8x7b (d 4096, 32 over 8 heads of D 128, window 4096, 8
   experts of F 14336, top-2, ``dense_scan``, vocab 32000, bf16) at full
   width and 8 of its 32 layers — its full depth does not fit one card —
   served as phase 15 serves internlm2: two experts, two 4 × 1024 scoring
   requests (exactly 16 ``flash_attention`` launches each), one 1 × 8192
   request (``lm_moe``: the window masks; 16), a greedy decode (none), a
   prefill (8), a profiled scoring request; mixtral-8x22b (d 6144, 48
   over 8 heads, F 16384, vocab 32768) at 4 of its 56 layers, two scoring
   requests; one mixtral-8x7b MoE layer's ``moe_apply`` under each
   ``impl`` against ``dense_scan`` (the capacity dispatch at E/k, and at
   1.25 with its drops counted), each timed; mixtral-8x7b trained at 2
   layers, 10 steps of 1 × 8192 tokens (launches 4 and 2 a step, after a
   1-layer float32 first-step gradient check against the plain path);
   and deepseek-67b and deepseek-coder-33b at full width and 2 layers:
   one scoring request each, its fused log-probabilities through the
   attention kernel against the plain attention on the card;
18. (after phase 17) whisper-large-v3 at full width and depth (32
   encoder and 32 decoder layers, d 1280, 20 heads of D 64, vocab 51866,
   bf16; 1,614,382,080 parameters), one random seeded expert: two
   scoring requests (``zoo.forward_train`` over 4 × 1024 tokens and the
   stubbed frontend's 4 × 1500 frames; exactly 96 ``flash_attention``
   launches each — 32 encoder, 32 causal self-, 32 cross-attentions over
   the frames), a prefill of 4 × 1024 through ``make_prefill_step`` (96),
   a greedy decode (batch 2, prompt 16, 16 new: the prefill, 96, then
   ``make_serve_step``, none), a profiled scoring request; then, after a
   2 + 2-layer float32 first-step gradient check against the plain path,
   10 training steps of 4 × 1024 tokens over 4 × 1500 frames through
   ``make_lm_train_step`` (192 attention launches a step under remat, 96
   backward; step seconds, tokens/s, peak memory) and a profiled step.
   Phase 3 holds the attention kernel and its backward at whisper's
   encoder (S 1500) and cross (1024 over 1500) shapes, bf16 on the
   tensor cores and the cross shape in float32 on the FFMA route;
19. (after phase 18) paligemma-3b at full width and depth (18 layers, d
   2048, 8 query heads over 1 of D 256, d_ff 16384, vocab 257216, bf16;
   3,039,635,456 parameters), one random seeded expert, as phase 18
   serves whisper: two scoring requests (``zoo.forward_train`` over 4 ×
   1024 tokens after the stubbed frontend's 4 × 256 patches; exactly 18
   ``flash_attention`` launches each, every one under the prefix-LM
   mask), a prefill through ``make_prefill_step`` (18), a greedy decode
   (batch 2, 16 + 16; none a decode step), a profiled request; then,
   after a 2-layer float32 first-step gradient check against the plain
   path, 10 training steps of 4 × 1024 tokens over 4 × 256 patches (36
   attention launches a step under remat, 18 backward) and a profiled
   step.  Phase 3 holds its attention (B 4, S 1280, P 256, bf16) and two
   more prefix cases — bf16 at D 128 (16 over 8), which the tensor-core
   kernels would take without the prefix, and float32 at D 64 — forward
   and backward, every one on the FFMA route (the backward at D 256 on
   key tiles of 32, its registers and spill bytes printed);
20. (after phase 9) the paper's four DiT examples as a user runs them,
   each ``python -m repro_torch.examples.<name>`` in a subprocess that
   must exit 0 and print the reference example's lines: ``train_
   decentralized --full --experts 8 --ddpm-experts 2 --steps 20 --batch
   32`` (the paper's 2 DDPM : 6 FM recipe at full DiT-B/2 width, 8 ×
   120.6 M parameters, each expert trained alone, then the router, then
   the sampling report; its seconds a step and device peak), its 8
   checkpoints then served at full width in this process (one batch-8,
   8-step, CFG-7.5, top-2 request, finite, exact launches),
   ``serve_heterogeneous`` over an empty directory (it trains its tiny
   ensemble through the port's trainer first) and again with
   ``--param-dtype int8 --dispatch grouped``, ``convert_checkpoint`` and
   ``quickstart``;
21. (after phase 12, over phase 4's checkpoints) the ensemble on
   ``("expert", "data")`` meshes of ``torch.distributed`` ranks (ROADMAP
   A.8), one batch-8, 8-step, CFG-7.5, top-2 request twice a case: a
   one-rank NCCL ``(1, 1)`` mesh in this process (latents and launches
   bitwise the unsharded engine's); two gloo ranks sharing ``cuda:0``
   (NCCL refuses two ranks on one card) on ``(2, 1)`` native and int8 and
   ``(1, 2)`` native, each rank's whole batch within 1e-5 of max of the
   unsharded engine's, its store half of the whole on ``(2, 1)``, the
   ranks' ``ragged_gemm`` pairs summing to the unsharded request's; and
   the serving CLI under ``torchrun --nproc-per-node 2`` (``--backend
   gloo --expert-shards 2 --coalesce``, latent 8), which must print
   ``mesh={'expert': 2, 'data': 1}``.  The rolling schedulers and the
   reference engine on the mesh (ROADMAP A.8b), ``mesh rolling`` lines:
   on the ``(1, 1)`` mesh phase 11's staggered requests, latents and
   launches bitwise phase 11's; on the two ranks, in each case's engine,
   three staggered requests into a rolling batch of 8 (within 1e-5 of
   max of the unsharded rolling run, the ranks equal and their pairs
   summing to its), on ``(2, 1)`` the resilient scheduler killed after 3
   ticks and restored on both ranks from rank 0's journal (bitwise its
   twin), and the reference engine against the unsharded one; the CLI
   also with ``--continuous --journal-dir``;
22. FSDP training and the dry-run (ROADMAP A.8b's LM half, A.11):
   deepseek-coder-33b at full width (d 7168, 56 query heads over 8 of D
   128, d_ff 19200, bf16, remat) and 2 layers, one AdamW step of a global
   2 × 1024-token batch unsharded, on a one-rank NCCL ``(1, 1)`` mesh with
   ``launch.fsdp`` installed (loss, every gradient and updated parameter
   bitwise the unsharded step's; its attention on the ``wgmma`` forward
   and backward kernels, counted) and on two gloo ranks sharing
   ``cuda:0`` as ``(2, 1)`` (each rank's cut against the unsharded step
   on the rank: loss within 1e-4; gradients, first moment and global
   norm within ``FSDP_GRAD_REL``; parameters within AdamW's first-step
   bound), with two witnesses that this bf16 bound is rounding: the
   unsharded step in two microbatches, and ``(2, 1)`` in float32 at full
   width (1 layer) held to the float32 checks' 1e-3; the
   seconds a step, peak bytes a rank, gathers and reduce-scatters and
   attention launches a step, beside the dry-run of the same step and
   mesh; then ``dryrun_one("deepseek-coder-33b", "train_4k")`` and
   ``("mixtral-8x7b", "train_4k", multi_pod=True)`` on the production
   meshes' fake worlds (no card).

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
import re
import shutil
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
#: the full-width checkpoints phases 4 and 10-12 load (deleted after 12)
DIT_PATH = os.path.join(WORK, "dit_b2")

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
    ("flash_attention", "flash_attention (self- and cross-attention)"),
    ("gemm", "cuBLAS GEMM (dense dit.apply layers: the router, the "
             "dense-engine experts)"),
    ("softmax", "softmax"),
    ("reduce", "reductions (sums, row absmax)"),
    ("elementwise", "elementwise"),
    ("Memcpy", "copies"),
    ("Memset", "sets"),
)


#: the LM scoring request's kernel-name fragments -> category
LM_CATEGORIES = (
    ("ssd_scan", "ssd_scan (every mixer's chunked scan)"),
    ("flash_attention", "flash_attention (causal attention)"),
    ("gemm", "cuBLAS bf16 GEMM (projections, MoE experts, unembedding)"),
    ("nvjet", "cuBLAS bf16 GEMM (projections, MoE experts, unembedding)"),
    ("xmma", "cuBLAS bf16 GEMM (projections, MoE experts, unembedding)"),
    ("softmax", "log-softmax"),
    ("reduce", "reductions (RMSNorm means, logsumexp, histograms)"),
    ("elementwise", "elementwise (conv taps, silu, softplus, gating, RoPE, "
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


def floor_ms(x: torch.Tensor) -> float:
    """Device ms of one ATen one-pass kernel over ``x`` (``x + x``): the
    practical floor of any one-pass launch at that shape, which the bytes
    bound cannot show.  A yardstick, not the same function."""
    o = torch.empty_like(x)
    return graph_ms(lambda: torch.add(x, x, out=o), 100)


def check_fused_step(ops, ref, dev) -> dict:
    """The step kernel at the main path's shape: K = 2 slots, B = 8,
    T = 32·32·4, with and without CFG, shared and per-row dt, at the
    full strategy's and dense engine's shape, K = 8 slots with CFG, and
    at the threshold strategy's, K = 1 slot with CFG; alpha below
    alpha_min and clamped x̂0 present.  Bitwise against its
    plain version (built without FMA contraction, same op order)."""
    b, t = 8, 32 * 32 * 4
    gen = torch.Generator(device=dev).manual_seed(4)
    kw = dict(cfg_scale=7.5, clamp=20.0, alpha_min=0.01)
    worst, main = 0.0, None
    for k, g, per_row in ((2, 2, False), (2, 2, True), (2, 1, False),
                          (2, 1, True), (8, 2, False), (1, 2, False)):
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
        t_k = graph_ms(lambda: ops.fused_step(*args, g=g, **kw), 100)
        t_w = cuda_ms(lambda: ops.fused_step(*args, g=g, **kw), 50)
        t_p = graph_ms(lambda: ref.ref_hetero_fuse_step(
            preds, x, w, coef, dt, **kw), 100)
        nbytes = 4.0 * (k * g * b * t + 2 * b * t + g * b * k
                        + 5 * k * g * b + dt.numel())
        flops = 12.0 * k * g * b * t + 5.0 * b * t
        t_b, by = bound_ms(nbytes, flops)
        row = dict(K=k, G=g, dt_per_row=per_row, max_abs_err=err, tol=0.0,
                   ms=t_k, wrapper_ms=t_w, plain_ms=t_p,
                   floor_ms=floor_ms(x), library_ms=None, bound_ms=t_b,
                   bound_by=by)
        print("hetero_fuse_step case " + json.dumps(row))
        if not (bool(torch.isfinite(got).all())
                and torch.equal(got, plain)):
            fail(f"hetero_fuse_step disagrees with its plain version: "
                 f"{row}")
        worst = max(worst, err)
        if main is None:                # K 2, G 2, shared dt: serving
            main = row
    return dict(max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=None, bound_ms=main["bound_ms"],
                bound_by=main["bound_by"])


def check_fuse_coeffs(ops, ref, dev) -> dict:
    """The velocity kernel at the unfused paths' shapes: B = 16 (8
    samples × 2 CFG branches), T = 32·32·4, K = 2 slots (the routed
    top-2 path) and K = 8 (the full strategy's); alpha below alpha_min
    and clamped x̂0 present.  Bitwise against its plain version (built
    without FMA contraction, same op order)."""
    b, t = 16, 32 * 32 * 4
    gen = torch.Generator(device=dev).manual_seed(8)
    kw = dict(clamp=20.0, alpha_min=0.01)
    worst, main = 0.0, None
    for k in (2, 8):
        preds = 4 * torch.randn(k, b, t, generator=gen, device=dev)
        x = 3 * torch.randn(b, t, generator=gen, device=dev)
        w = torch.rand(b, k, generator=gen, device=dev)
        coef = 1.5 * torch.rand(5, k, b, generator=gen, device=dev)
        coef[0, 0] = 0.001
        coef[1, 0] = 1.0
        got = ops.fused_velocity(preds, x, w, coef, **kw)
        plain = ref.ref_hetero_fuse_coeffs(preds, x, w, coef, **kw)
        torch.cuda.synchronize()
        err, _ = rel_err(got, plain)
        t_k = graph_ms(lambda: ops.fused_velocity(preds, x, w, coef, **kw),
                       100)
        t_w = cuda_ms(lambda: ops.fused_velocity(preds, x, w, coef, **kw),
                      50)
        t_p = graph_ms(lambda: ref.ref_hetero_fuse_coeffs(
            preds, x, w, coef, **kw), 100)
        nbytes = 4.0 * (k * b * t + 2 * b * t + b * k + 5 * k * b)
        t_b, by = bound_ms(nbytes, 12.0 * k * b * t)
        row = dict(K=k, B=b, T=t, max_abs_err=err, tol=0.0, ms=t_k,
                   wrapper_ms=t_w, plain_ms=t_p, floor_ms=floor_ms(x),
                   library_ms=None, bound_ms=t_b, bound_by=by)
        print("hetero_fuse_coeffs case " + json.dumps(row))
        if not (bool(torch.isfinite(got).all())
                and torch.equal(got, plain)):
            fail(f"hetero_fuse_coeffs disagrees with its plain version: "
                 f"{row}")
        worst = max(worst, err)
        if main is None:                # K 2: the routed unfused path
            main = row
    return dict(max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=None, bound_ms=main["bound_ms"],
                bound_by=main["bound_by"])


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


def _open_pairs(s: int, causal: bool, window: int,
                skv: int | None = None, prefix: int = 0) -> int:
    """(query, key) pairs a mask leaves open over one head (``s`` query
    rows over ``skv`` keys, ``s`` by default; a mask takes equal lengths;
    under ``causal`` a ``prefix`` P opens every pair below P)."""
    if skv is not None and skv != s:
        return s * skv
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = (np.minimum(s, np.maximum(q + 1, prefix)) if causal
          else np.full_like(q, s))
    return int((hi - lo).sum())


def _prefix_mask(s: int, causal: bool, window: int, prefix: int, dev):
    """The boolean ``(S, S)`` mask of ``ref._masked`` (True: open), for
    SDPA's ``attn_mask``; ``None`` where a call needs none."""
    if not (causal or window):
        return None
    pos = torch.arange(s, device=dev)
    mask = torch.ones(s, s, dtype=torch.bool, device=dev)
    if causal:
        mask &= (pos[None] <= pos[:, None]) | (
            (pos[None] < prefix) & (pos[:, None] < prefix))
    if window:
        mask &= pos[:, None] - pos[None] < window
    return mask


#: (case, B, Hq, Hkv, S, D, causal, window, dtype) of the attention check: the
#: DiT's self-attention and its cross-attention (the 256 latent tokens over the
#: 77 text tokens, ``FLASH_SKV``) at a top-2 request's 32 (pair, replica) rows,
#: float32 on the FFMA template; then the LM serving shapes of phases 15 and 17
#: (a 4 × 1024-token scoring request): zamba2-2.7b's shared block (32 heads of
#: D 80), internlm2-1.8b's layers (16 query heads over 8 kv heads of D 128),
#: deepseek-coder-33b's (56 over 8: a group of 7; also at phase 22's 2 ×
#: 1024-token FSDP training step), mixtral-8x7b's (32 over 8,
#: its window of 4096 past the request) and mixtral-8x22b's (48 over 8: a group
#: of 6); the first Mixtral case is phase 17's 1 × 8192-token request, where
#: the window masks; then phase 18's whisper-large-v3 (20 heads of D 64,
#: non-causal): the encoder over 4 × 1500 frames, the decoder's
#: cross-attention, 4 × 1024 rows over the 1500 frames (``FLASH_SKV``), the
#: decoder's causal self-attention over its 4 × 1024 tokens, and that cross
#: shape in float32 (the FFMA template, phase 18's gradient check); then phase
#: 19's paligemma-3b (8 query heads over 1 of D 256, causal with the prefix-LM
#: mask over its 256 patches, ``FLASH_PREFIX``: 4 × (256 + 1024) positions),
#: and two prefix cases that hold the routing rule — bf16 at D 128 (16 over
#: 8), which the tensor-core kernel would take without the prefix, and
#: float32 at D 64 — every prefix case on the FFMA template
FLASH_CASES = (
    ("dit_self_attention", 32, 12, 12, 256, 64, False, 0, torch.float32),
    ("dit_cross_attention", 32, 12, 12, 256, 64, False, 0, torch.float32),
    ("mixtral_gqa_swa", 1, 32, 8, 8192, 128, True, 4096, torch.bfloat16),
    ("zamba2_causal", 4, 32, 32, 1024, 80, True, 0, torch.bfloat16),
    ("internlm2_causal_gqa", 4, 16, 8, 1024, 128, True, 0, torch.bfloat16),
    ("deepseek_coder_group7", 4, 56, 8, 1024, 128, True, 0, torch.bfloat16),
    ("deepseek_coder_group7_b2", 2, 56, 8, 1024, 128, True, 0,
     torch.bfloat16),
    ("mixtral_8x7b_scoring", 4, 32, 8, 1024, 128, True, 4096,
     torch.bfloat16),
    ("mixtral_8x22b_group6", 4, 48, 8, 1024, 128, True, 4096,
     torch.bfloat16),
    ("whisper_encoder", 4, 20, 20, 1500, 64, False, 0, torch.bfloat16),
    ("whisper_cross", 4, 20, 20, 1024, 64, False, 0, torch.bfloat16),
    ("whisper_decoder_causal", 4, 20, 20, 1024, 64, True, 0, torch.bfloat16),
    ("whisper_cross_f32", 4, 20, 20, 1024, 64, False, 0, torch.float32),
    ("paligemma_prefix", 4, 8, 1, 1280, 256, True, 0, torch.bfloat16),
    ("prefix_gqa_bf16_d128", 4, 16, 8, 1280, 128, True, 0, torch.bfloat16),
    ("prefix_f32_d64", 4, 8, 1, 1280, 64, True, 0, torch.float32))
#: the kv length of a case whose keys are not its queries (the
#: cross-attention's encoder frames)
FLASH_SKV = {"dit_cross_attention": 77, "whisper_cross": 1500,
             "whisper_cross_f32": 1500}
#: the prefix-LM mask's P of a case (paligemma's 256 patches)
FLASH_PREFIX = {"paligemma_prefix": 256, "prefix_gqa_bf16_d128": 256,
                "prefix_f32_d64": 256}
#: the LM paths whose kernels line entries take a phase-3 case's numbers
#: (whisper's also carry its cross and decoder cases' under ``cross`` and
#: ``causal``)
FLASH_PATH_CASES = {"lm_hybrid": "zamba2_causal",
                    "lm_train_fsdp": "deepseek_coder_group7_b2",
                    "lm_dense": "internlm2_causal_gqa",
                    "lm_moe": "mixtral_gqa_swa",
                    "lm_moe_scoring": "mixtral_8x7b_scoring",
                    "lm_moe_8x22b": "mixtral_8x22b_group6",
                    "lm_audio": "whisper_encoder",
                    "lm_vlm": "paligemma_prefix"}
#: the whisper paths' other attention cases, forward and backward: the
#: cross-attention and the decoder's causal self-attention
FLASH_MORE_CASES = {path: {"cross": "whisper_cross",
                           "causal": "whisper_decoder_causal"}
                    for path in ("lm_audio", "lm_train_audio")}


def check_flash(ops, ref, dev) -> dict:
    """The attention kernel at the DiT's self-attention shape — q, k, v
    ``(B·g 32, S 256, H 12, D 64)`` projections read as ``(B, H, S, D)``
    views, non-causal, float32 — a causal sliding-window GQA case at
    Mixtral-8x7B's head shape (``configs/mixtral_8x7b.py``: Hq 32, Hkv 8,
    D 128, window 4096) over S 8192, batch 1, bf16, and the causal bf16
    attention of the LM serving paths (zamba2-2.7b, internlm2-1.8b,
    deepseek-coder-33b's group of 7, mixtral-8x7b, mixtral-8x22b's group
    of 6) at a 4 × 1024-token request (the group of 7 also at phase 22's
    2 × 1024 tokens), and whisper-large-v3's non-causal
    bf16 encoder (S 1500) and cross-attention (1024 rows over 1500 keys),
    its causal bf16 decoder self-attention (S 1024) and that cross shape
    in float32, and paligemma-3b's causal prefix-LM attention (8 query
    heads over 1 of D 256 over 4 × 1280 positions, P 256) with the bf16
    D 128 and float32 D 64 prefix cases.  Library yardstick:
    ``scaled_dot_product_attention`` on the same inputs (float32 for the
    DiT; the cases with a window or a prefix with their boolean mask,
    ``enable_gqa``; the causal ones ``is_causal=True, enable_gqa=True``;
    the cross ones at their two lengths).  Each row names the kernel
    design that ran (``kernels/flash_attention.py::design``, the
    launcher's rule mirrored, as ``staging_is_vec`` mirrors its 16-byte
    staging rule): the bf16 cases without a prefix must run the
    tensor-core kernel, the float32 and prefix cases the FFMA template.
    Returns
    the DiT case's numbers and, under ``by_path``, each LM path's
    case's."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import design as flash_design
    from repro_torch.kernels.flash_attention import staging_is_vec

    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for name, b, hq, hkv, s, d, causal, window, dtype in FLASH_CASES:
        skv = FLASH_SKV.get(name, s)
        prefix = FLASH_PREFIX.get(name, 0)
        q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(b, skv, hkv, d, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        design = flash_design(q, k, v, prefix_len=prefix)
        want_design = ("FFMA" if dtype == torch.float32 or prefix
                       else "wgmma bf16")

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
        if causal and not window and not prefix:
            def lib():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=hq != hkv)
        elif causal or window:
            mask = _prefix_mask(s, causal, window, prefix, dev)

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
        pairs = _open_pairs(s, causal, window, skv, prefix) * b * hq
        flops = 4.0 * d * pairs
        nbytes = q.element_size() * d * b * (2 * hq * s + 2 * hkv * skv)
        t_b, by = bound_ms(nbytes, flops, FP32_FLOP_PER_S
                           if dtype == torch.float32 else BF16_FLOP_PER_S)
        row = dict(case=name, B=b, Hq=hq, Hkv=hkv, S=s,
                   **({"Skv": skv} if skv != s else {}), D=d, causal=causal,
                   window=window, **({"prefix": prefix} if prefix else {}),
                   dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=err, tol=tol, ms=t_k, wrapper_ms=t_w,
                   plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by,
                   share_of_bound=t_b / t_k, tflops=flops / t_k / 1e9,
                   staging="cp.async 16-byte" if staging_is_vec(q, k, v)
                   else "element by element", design=design)
        if not rows:                        # the DiT shape: clocks too
            row.update(clocks_under(kern))
        print("flash_attention case " + json.dumps(row))
        if not ok:
            fail(f"flash_attention disagrees with its plain version: {row}")
        if design != want_design:
            fail(f"flash_attention ran the {design} design where "
                 f"{want_design} was due: {row}")
        rows.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    case = {r["case"]: r for r in rows}
    return dict(_summary(rows[0], max(r["max_abs_err"] for r in rows)),
                cross=_cross_summary(case["dit_cross_attention"]),
                by_path=_path_summaries(case, FLASH_PATH_CASES))


def _cross_summary(row: dict) -> dict:
    """A kernels line entry's numbers of a second case on its path (a
    cross-attention, a decoder's causal self-attention), with the case's
    name and lengths."""
    return dict(_summary(row, row["max_abs_err"]), case=row["case"],
                S=row["S"], Skv=row.get("Skv", row["S"]))


def _path_summaries(case: dict, path_cases: dict) -> dict:
    """Each path's kernels line numbers from its phase-3 case; a whisper
    path's also carry its cross-attention and decoder self-attention
    cases' under ``cross`` and ``causal``."""
    out = {}
    for path, name in path_cases.items():
        out[path] = _summary(case[name], case[name]["max_abs_err"])
        for key, more in FLASH_MORE_CASES.get(path, {}).items():
            out[path][key] = _cross_summary(case[more])
    return out


def _summary(row: dict, max_abs_err: float) -> dict:
    """A kernels line entry's numbers from a phase-3 case row (and its
    design, where the row names one)."""
    return dict(max_abs_err=max_abs_err, ms=row["ms"],
                plain_ms=row["plain_ms"], library_ms=row["library_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                **{k: row[k] for k in ("design",) if k in row})


#: backward kernels against their plain versions (float32): row and
#: cross-row sums (dγ/dβ over 256 rows, the attention's 256-term products)
#: in another order than ATen, each gradient within this share of the
#: largest |gradient| of its call.
GRAD_REL_TOL = 1e-5
#: the training batch of phases 3 and 13 (DiT-B/2, 256 tokens)
TRAIN_BATCH = 32


def _library_bwd_ms(fn, inputs, d_out) -> float:
    """Device ms of one backward of ``fn`` through autograd: forward and
    backward replayed from a CUDA graph, less the forward alone."""
    leaves = [a.detach().requires_grad_(True) for a in inputs]

    def both():
        return torch.autograd.grad(fn(*leaves), leaves, d_out)

    with torch.no_grad():
        fwd = graph_ms(lambda: fn(*leaves), 20)
    return graph_ms(both, 20) - fwd


def check_adaln_bwd(ops, ref, dev) -> dict:
    """The AdaLN backward kernel at the dense training forward's modulate
    site: x ``(32, 256, 768)`` float32 (batch 32 of DiT-B/2), γ/β slices
    of the ``(B, L, 6, d)`` modulation stack, against its plain version's
    dx, dγ, dβ; and without γ (the LayerNorm before cross-attention).
    Library yardstick: no single call computes it — the backward of
    ``F.layer_norm`` followed by the modulation's elementwise ops; without
    γ, ``F.layer_norm``'s alone.  The summary carries the γ case and the
    γ-less case's ``ms``, ``library_ms`` and ``share_of_bound`` as
    ``*_no_gamma``."""
    import torch.nn.functional as F

    from repro_torch.kernels.adaln_fuse import adaln_fuse_bwd

    gen = torch.Generator(device=dev).manual_seed(23)
    b, t, d = TRAIN_BATCH, 256, 768
    x = 3 * torch.randn(b, t, d, generator=gen, device=dev) + 1
    mods = 0.3 * torch.randn(b, 12, 6, d, generator=gen, device=dev)
    dy = torch.randn(b, t, d, generator=gen, device=dev)
    rows = []
    for name, gamma, beta in (("modulate", mods[:, 5, 0], mods[:, 5, 1]),
                              ("layernorm", None, None)):
        def kern():
            return adaln_fuse_bwd(x, gamma, dy)

        def plain():
            return ref.ref_adaln_fuse_bwd(x, gamma, dy)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        want = [w for w in want if w is not None]
        got = [g for g in got if g is not None]
        top = max(w.abs().max().item() for w in want)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        again = kern()
        bitwise = all(torch.equal(a, g) for a, g in zip(
            [a for a in again if a is not None], got))
        t_k = graph_ms(kern, 50)
        t_p = graph_ms(plain, 20)
        if gamma is None:
            t_l = _library_bwd_ms(
                lambda xx: F.layer_norm(xx, (d,), eps=1e-6), [x], dy)
        else:
            t_l = _library_bwd_ms(
                lambda xx, gg, bb: F.layer_norm(xx, (d,), eps=1e-6)
                * (1 + gg[:, None]) + bb[:, None], [x, gamma, beta], dy)
        n = x.numel()
        nbytes = 3 * n * 4                  # x, dy read; dx written
        if gamma is not None:
            nbytes += 3 * b * d * 4         # γ read; dγ, dβ written
        t_b, by = bound_ms(nbytes, 14.0 * n)
        row = dict(case=name, x=[b, t, d], max_abs_err=err,
                   tol=GRAD_REL_TOL * top, bitwise_repeatable=bitwise,
                   ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=t_b,
                   bound_by=by, share_of_bound=t_b / t_k)
        print("adaln_fuse_bwd case " + json.dumps(row))
        if not (err <= GRAD_REL_TOL * top and bitwise and all(
                bool(torch.isfinite(g).all()) for g in got)):
            fail(f"adaln_fuse_bwd disagrees with its plain version: {row}")
        rows.append(row)
    main, no_gamma = rows
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"],
                share_of_bound=main["share_of_bound"],
                ms_no_gamma=no_gamma["ms"],
                library_ms_no_gamma=no_gamma["library_ms"],
                share_of_bound_no_gamma=no_gamma["share_of_bound"])


#: bf16 attention gradients against the plain version's float32 ones: half
#: a bf16 ulp of each element from the final rounding, and Δ formed from
#: the forward's bf16-rounded output where the plain version forms it from
#: its float32 one (up to 0.9 of a bf16 ulp of the gradient's max in a CPU
#: emulation at S 1024, D 80 and 128): two bf16 ulps of each gradient's
#: largest |value|, on top of GRAD_REL_TOL of the largest of the three
BF16_GRAD_REL_TOL = 2.0 ** -7

#: (case, B, Hq, Hkv, S, D, causal, window, dtype, launches a training
#: step) of the attention backward check: the DiT's training shapes (its
#: self-attention, and its cross-attention over the 77 text tokens), then
#: the causal bf16 attention of phase 14's two LM training paths (a 4 ×
#: 1024-token step): internlm2-1.8b's 24 layers (16 query heads over 8 kv
#: heads of D 128) and zamba2-2.7b's 9 shared-block applications (32
#: heads of D 80); phase 17's mixtral-8x7b step of 1 × 8192 tokens (32
#: over 8, window 4096, its 2 layers) and deepseek-coder-33b's group of 7
#: at a 4 × 1024-token batch, and at phase 22's 2 × 1024-token FSDP step
#: (its 2 layers); phase 18's
#: whisper-large-v3 step of 4 × 1024 tokens over 4 × 1500 frames, bf16,
#: its 32 encoder layers and 32 cross-attentions (1024 rows over the 1500
#: frames, ``FLASH_SKV``), non-causal, and its 32 causal decoder
#: self-attentions, and the cross shape in float32 (the FFMA route, phase
#: 18's gradient check)
FLASH_BWD_CASES = (
    ("dit_self_attention", TRAIN_BATCH, 12, 12, 256, 64, False, 0,
     torch.float32, 12),
    ("dit_cross_attention", TRAIN_BATCH, 12, 12, 256, 64, False, 0,
     torch.float32, 12),
    ("internlm2_causal_gqa", 4, 16, 8, 1024, 128, True, 0, torch.bfloat16,
     24),
    ("zamba2_causal", 4, 32, 32, 1024, 80, True, 0, torch.bfloat16, 9),
    ("mixtral_gqa_swa", 1, 32, 8, 8192, 128, True, 4096, torch.bfloat16, 2),
    ("deepseek_coder_group7", 4, 56, 8, 1024, 128, True, 0, torch.bfloat16,
     None),
    ("deepseek_coder_group7_b2", 2, 56, 8, 1024, 128, True, 0,
     torch.bfloat16, 2),
    ("whisper_encoder", 4, 20, 20, 1500, 64, False, 0, torch.bfloat16, 32),
    ("whisper_cross", 4, 20, 20, 1024, 64, False, 0, torch.bfloat16, 32),
    ("whisper_decoder_causal", 4, 20, 20, 1024, 64, True, 0, torch.bfloat16,
     32),
    ("whisper_cross_f32", 4, 20, 20, 1024, 64, False, 0, torch.float32,
     None),
    ("paligemma_prefix", 4, 8, 1, 1280, 256, True, 0, torch.bfloat16, 18),
    ("prefix_gqa_bf16_d128", 4, 16, 8, 1280, 128, True, 0, torch.bfloat16,
     None),
    ("prefix_f32_d64", 4, 8, 1, 1280, 64, True, 0, torch.float32, None))
#: the LM training paths whose kernels line entries take a case's numbers
FLASH_BWD_PATH_CASES = {"lm_train_dense": "internlm2_causal_gqa",
                        "lm_train_fsdp": "deepseek_coder_group7_b2",
                        "lm_train_hybrid": "zamba2_causal",
                        "lm_train_moe": "mixtral_gqa_swa",
                        "lm_train_audio": "whisper_encoder",
                        "lm_train_vlm": "paligemma_prefix"}


#: the attention backward's kernels on each route (``bwd_design``), in
#: launch order
FLASH_BWD_KERNELS = {
    "FFMA": ("flash_attention_bwd_delta", "flash_attention_bwd_tile",
             "flash_attention_bwd_dq_sum"),
    "wgmma bf16": ("flash_attention_bwd_delta",
                   "flash_attention_bwd_dkdv_wgmma",
                   "flash_attention_bwd_dq_wgmma")}


def _grid_tail(works, slots: int) -> float:
    """Blocks of ``works`` (each block's time, in dispatch order)
    list-scheduled on ``slots`` block slots: the makespan over the ideal
    (total / slots).  Arithmetic on the grid, not a measurement."""
    import heapq

    heap, end = [0] * slots, 0
    for w in works:
        t = heapq.heappop(heap) + w
        heapq.heappush(heap, t)
        end = max(end, t)
    return end * slots / sum(works)


def _bwd_grid_tails(route, b, hq, hkv, s, d, causal, window=0,
                    skv=None, prefix=0) -> dict:
    """Each tile kernel's grid tail (``_grid_tail``) on 132 SMs, a block's
    time its tile pairs.  FFMA: the tile kernel's grid (b·kv head, key
    tile of 64, of 32 at D > 128), key tiles the slow axis, two blocks an
    SM at D ≤ 64 and one above, a block the group's query tiles its keys
    see (every one for a key tile that starts below the prefix).  wgmma:
    the dK/dV kernel's grid of the same shape and work, two blocks an SM;
    the dQ kernel's (b·h, query tile of 128), causal tiles last first, one
    block an SM, a block the kv tiles of 64 its rows see (under a window,
    at most the tiles the window spans).  ``skv`` keys (``s`` by
    default) under ``s`` query rows."""
    skv = s if skv is None else skv
    bk = 32 if route == "FFMA" and d > 128 else 64
    nt, nq, nq64 = -(-skv // bk), -(-s // 128), -(-s // 64)
    wk = -(-window // 64) + 1 if window else nq64
    wq = -(-(128 + window) // 64) if window else nt

    def seen(kt):
        first = kt * bk // 64 if causal and kt * bk >= prefix else 0
        return min(nq64 - first, wk)
    keys = [hq // hkv * seen(kt) for kt in range(nt) for _ in range(b * hkv)]
    if route == "FFMA":
        return {"flash_attention_bwd_tile":
                _grid_tail(keys, 132 * (2 if d <= 64 else 1))}
    rows = [min(-(-min(s, 128 * (nq - y)) // 64) if causal else nt, wq)
            for y in range(nq) for _ in range(b * hq)]
    return {"flash_attention_bwd_dkdv_wgmma": _grid_tail(keys, 264),
            "flash_attention_bwd_dq_wgmma": _grid_tail(rows, 132)}


def _kernel_ms(fn, calls: int = 5) -> dict:
    """Device ms a call of each kernel ``fn()`` launches, under
    ``torch.profiler`` over ``calls`` calls, by the kernel's name without
    its namespace and template arguments."""
    import re

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms: dict[str, float] = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"(\w+)(<[^>]*>)?\(", evt.key)
            key = name.group(1) if name else evt.key
            ms[key] += evt.self_device_time_total / 1e3 / calls
    return dict(ms)


def _plain_bwd(ref, q, k, v, do, **mask):
    """``ref.ref_flash_attention_bwd`` under ``mask`` (``causal``,
    ``window``, ``prefix_len``); past 2³¹ scores (Mixtral's 32 heads over
    S 8192: 8.6 GB of float32 a score tensor, five of them) one kv head's
    group of query heads at a time, its dk and dv that kv head's."""
    b, hq, s, _ = q.shape
    hkv = k.shape[1]
    if b * hq * s * k.shape[2] <= 2 ** 31:
        return ref.ref_flash_attention_bwd(q, k, v, do, **mask)
    g = hq // hkv
    parts = [ref.ref_flash_attention_bwd(
        q[:, j * g:(j + 1) * g], k[:, j:j + 1], v[:, j:j + 1],
        do[:, j * g:(j + 1) * g], **mask)
        for j in range(hkv)]
    return tuple(torch.cat(t, dim=1) for t in zip(*parts))


def check_flash_bwd(ops, ref, dev) -> dict:
    """The attention backward kernel from the forward's output and row
    log-sum-exp against its plain version's dq, dk, dv, bitwise
    repeatable: at the DiT's training shape — q, k, v and dO ``(32, 256,
    12, 64)`` projections read as ``(B, H, S, D)`` views, non-causal
    float32 (within ``GRAD_REL_TOL`` of the largest gradient) — and at the
    LM training shapes, causal bf16 (within that plus
    ``BF16_GRAD_REL_TOL`` of each gradient's largest), Mixtral's with its
    window of 4096 over S 8192 (the plain version one kv head's group at
    a time there: ``_plain_bwd``), and whisper-large-v3's non-causal
    encoder (S 1500) and cross-attention (1024 rows over 1500 keys) and
    causal decoder self-attention (S 1024) in bf16 and that cross shape in
    float32, and paligemma-3b's prefix-LM training attention (8 query
    heads over 1 of D 256, 4 × 1280 positions, P 256: the FFMA route on
    key tiles of 32) with the bf16 D 128 and float32 D 64 prefix cases.
    Library yardstick: the
    backward of ``scaled_dot_product_attention`` on the same inputs (the
    LM shapes ``is_causal``, ``enable_gqa``, bf16; the windowed and prefix
    ones with their boolean mask; the cross ones at their two lengths).
    Bound: five products a head over the pairs the masks leave open
    (recompute q·kᵀ, dO·vᵀ, Pᵀ·dO, dS·k, dSᵀ·q) at the input dtype's rate
    (``bound_ms``) and at the float32 rate (``bound_ms_f32``), or the
    bytes of q, k, v, o, dO, lse, dq, dk, dv.  Each row names its route
    (``design``: the bf16 cases without a prefix must take ``"wgmma
    bf16"``, the float32 and prefix ones ``"FFMA"``), the kernels one call
    launched with each one's device ms (``kernel_ms``, from the profiler;
    they must be the route's own), the float32 scratch, on the tensor-core
    route each kernel's registers a thread and spill bytes (there must be
    none), and on the FFMA route the tile kernel's (``tile_kernel``,
    printed).  Returns the DiT
    case's numbers and, under ``by_path``, each LM training path's
    case's."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (bwd_design,
                                                     bwd_scratch_floats,
                                                     bwd_tc_attrs,
                                                     bwd_tile_attrs,
                                                     flash_attention,
                                                     flash_attention_bwd)

    gen = torch.Generator(device=dev).manual_seed(24)
    rows = []
    for (name, b, hq, hkv, s, d, causal, window, dtype,
         per_step) in FLASH_BWD_CASES:
        skv = FLASH_SKV.get(name, s)
        prefix = FLASH_PREFIX.get(name, 0)
        q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(b, skv, hkv, d, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        do = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
        q, k, v, do = (a.transpose(1, 2) for a in (q, k, v, do))
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        out, lse = flash_attention(q, k, v, with_lse=True, **kw)

        def kern():
            return flash_attention_bwd(q, k, v, out, lse, do, **kw)

        def plain():
            return _plain_bwd(ref, q, k, v, do, **kw)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        top = max(w.abs().max().item() for w in want)
        errs = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
        tols = [GRAD_REL_TOL * top + (BF16_GRAD_REL_TOL * w.abs().max().item()
                                      if dtype == torch.bfloat16 else 0.0)
                for w in want]
        bitwise = all(torch.equal(a, g) for a, g in zip(kern(), got))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        del want
        design = bwd_design(q, k, v, do, prefix_len=prefix)
        kernel_ms = _kernel_ms(kern)
        tc = bwd_tc_attrs(d) if design == "wgmma bf16" else {}
        tile = bwd_tile_attrs(d, dtype) if design == "FFMA" else {}
        t_k = graph_ms(kern, 10)
        t_p = cuda_ms(plain, 10 if s <= 256 else 3, warmup=1)
        mask = (_prefix_mask(s, causal, window, prefix, dev)
                if window or prefix else None)
        try:
            t_l = _library_bwd_ms(
                lambda qq, kk, vv: F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask,
                    is_causal=causal and mask is None,
                    enable_gqa=hq != hkv),
                [q, k, v], do)
        except RuntimeError as exc:                  # a yardstick only
            print(f"library yardstick unavailable: "
                  f"{str(exc).splitlines()[0]}")
            t_l = None
        pairs = _open_pairs(s, causal, window, skv, prefix) * b * hq
        flops = 5 * 2.0 * d * pairs
        elt = q.element_size()
        nbytes = (elt * d * b * (4 * hq * s + 4 * hkv * skv)  # q o dO dq;
                  + 4 * b * hq * s)               # k v dk dv; lse
        t_b, by = bound_ms(nbytes, flops, FP32_FLOP_PER_S
                           if dtype == torch.float32 else BF16_FLOP_PER_S)
        t_b32, by32 = bound_ms(nbytes, flops)
        row = dict(case=name, B=b, Hq=hq, Hkv=hkv, S=s,
                   **({"Skv": skv} if skv != s else {}), D=d, causal=causal,
                   window=window, **({"prefix": prefix} if prefix else {}),
                   dtype=str(dtype).replace("torch.", ""),
                   design=design, kernel_ms=kernel_ms, tc_kernels=tc,
                   tile_kernel=tile,
                   scratch_mbytes=4 * bwd_scratch_floats(
                       q, k, v, out, do, **kw) / 1e6,
                   max_abs_err=max(errs), errs_dq_dk_dv=errs,
                   tols_dq_dk_dv=tols, bitwise_repeatable=bitwise, ms=t_k,
                   plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by,
                   share_of_bound=t_b / t_k, bound_ms_f32=t_b32,
                   bound_by_f32=by32, share_of_bound_f32=t_b32 / t_k,
                   tflops=flops / t_k / 1e9,
                   launches_per_training_step=per_step,
                   grid_tail_share=_bwd_grid_tails(design, b, hq, hkv, s, d,
                                                   causal, window, skv,
                                                   prefix))
        row.update(clocks_under(kern))
        print("flash_attention_bwd case " + json.dumps(row))
        if not (finite and bitwise and all(
                e <= t for e, t in zip(errs, tols))):
            fail(f"flash_attention_bwd disagrees with its plain version: "
                 f"{row}")
        want_design = ("FFMA" if dtype == torch.float32 or prefix
                       else "wgmma bf16")
        if (design != want_design
                or sorted(kernel_ms) != sorted(FLASH_BWD_KERNELS[design])
                or any(a["spill_bytes"] for a in tc.values())):
            fail(f"flash_attention_bwd case {name} took the wrong route, "
                 f"launched other kernels or spills: {row}")
        rows.append(row)
        del got, out, lse
        gc.collect()
        torch.cuda.empty_cache()
    case = {r["case"]: r for r in rows}
    return dict(_summary(rows[0], rows[0]["max_abs_err"]),
                cross=_cross_summary(case["dit_cross_attention"]),
                by_path=_path_summaries(case, FLASH_BWD_PATH_CASES))


#: the flag-form fuse kernel's cases: (name, objectives); the first is
#: the main shape (the serving mix), K 12 runs the runtime slot loop.
FLAG_CASES = (("mix_k8", [o for o, _ in MIX]),
              ("mixed_k12", ["ddpm" if i % 2 == 0 else "fm"
                             for i in range(12)]),
              ("all_ddpm_k2", ["ddpm"] * 2),
              ("all_fm_k2", ["fm"] * 2))


def check_hetero_fuse(ops, ref, dev) -> dict:
    """The flag-form fuse kernel at T 4096 on each of ``FLAG_CASES`` —
    the K 8, B 16 serving mix (2 DDPM + 6 FM), K 12 alternating (the
    runtime slot loop), and K 2 all-DDPM and all-FM — bitwise against its
    plain version; ``wrapper_ms`` is ``ops.fused_convert_and_fuse`` from
    objectives, schedules and times.  Then its path: the launch counts set
    to 0, one ``ops.fused_convert_and_fuse`` call as a caller makes it,
    the counts read (exactly one launch, of this kernel), and its output
    bitwise equal to ``fused_velocity`` given the matching ``(5, K, B)``
    unified coefficients (FM experts as the identity ``(1, 0, 0, 1,
    1)``)."""
    from repro_torch.core.conversion import velocity_scale
    from repro_torch.core.schedules import get_schedule
    from repro_torch.kernels.hetero_fuse import hetero_fuse

    b, t = 16, 32 * 32 * 4
    gen = torch.Generator(device=dev).manual_seed(15)
    kw = dict(clamp=20.0, alpha_min=0.01)
    rows = []
    for name, objectives in FLAG_CASES:
        k = len(objectives)
        schedules = [get_schedule("cosine" if o == "ddpm" else "linear")
                     for o in objectives]
        preds = 4 * torch.randn(k, b, t, generator=gen, device=dev)
        x = 3 * torch.randn(b, t, generator=gen, device=dev)
        w = torch.softmax(torch.randn(b, k, generator=gen, device=dev), -1)
        tb = torch.rand(b, generator=gen, device=dev)
        tb[0] = 0.999                            # alpha below alpha_min
        ddpm = torch.tensor([o == "ddpm" for o in objectives], device=dev)
        alpha = torch.stack([s.alpha(tb) for s in schedules])      # (K, B)
        sigma = torch.stack([s.sigma(tb) for s in schedules])
        dalpha = torch.stack([s.dalpha(tb) for s in schedules])
        dsigma = torch.stack([s.dsigma(tb) for s in schedules])
        vscale = torch.where(ddpm[:, None],
                             velocity_scale(tb, "piecewise")[None], 1.0)
        coef = torch.stack([alpha, sigma, dalpha, dsigma, vscale])
        got = hetero_fuse(preds, x, w, ddpm, coef, **kw)
        want = ref.ref_hetero_fuse(preds, x, w, ddpm, alpha, sigma, dalpha,
                                   dsigma, vscale, **kw)
        torch.cuda.synchronize()
        err, _ = rel_err(got, want)
        t_k = graph_ms(lambda: hetero_fuse(preds, x, w, ddpm, coef, **kw),
                       100)
        t_w = cuda_ms(lambda: ops.fused_convert_and_fuse(
            preds, x, w, objectives, schedules, tb), 50)
        t_p = graph_ms(lambda: ref.ref_hetero_fuse(
            preds, x, w, ddpm, alpha, sigma, dalpha, dsigma, vscale, **kw),
            50)
        n_ddpm = objectives.count("ddpm")
        nbytes = 4.0 * (k * b * t + 2 * b * t + b * k + 5 * k * b) + k
        flops = 12.0 * n_ddpm * b * t + 2.0 * k * b * t
        t_b, by = bound_ms(nbytes, flops)
        row = dict(case=name, K=k, B=b, T=t, ddpm=n_ddpm, max_abs_err=err,
                   tol=0.0, ms=t_k, wrapper_ms=t_w, plain_ms=t_p,
                   floor_ms=floor_ms(x), library_ms=None, bound_ms=t_b,
                   bound_by=by)
        print("hetero_fuse case " + json.dumps(row))
        if not (bool(torch.isfinite(got).all()) and torch.equal(got, want)):
            fail(f"hetero_fuse disagrees with its plain version: {row}")
        rows.append(row)
        if len(rows) == 1:                      # the main shape's inputs
            main_args = (preds, x, w, objectives, schedules, tb, ddpm, coef)
    main = rows[0]
    preds, x, w, objectives, schedules, tb, ddpm, coef = main_args

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
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                launches=launches["hetero_fuse"])


#: mamba2-2.7b's mixer in one scoring request (batch 4 × 1024 tokens):
#: (b, h, s, p, n, chunk)
SSD_SHAPE = (4, 80, 1024, 64, 128, 128)
#: (case, S, N, dtype) of the scan check at SSD_SHAPE's batch and heads:
#: mamba2-2.7b's mixer (N 128) in bf16 and float32, S < chunk, and
#: zamba2-2.7b's mixer (N 64; phase 15's ``lm_hybrid`` path)
SSD_CASES = (("mixer_bf16", 1024, 128, torch.bfloat16),
             ("mixer_f32", 1024, 128, torch.float32),
             ("short_bf16", 100, 128, torch.bfloat16),
             ("zamba2_bf16", 1024, 64, torch.bfloat16))
SSD_PATH_CASES = {"lm_hybrid": "zamba2_bf16"}


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
    """(operations, bytes) of one scan: the chunked algorithm's products
    that these inputs need — C·Bᵀ once per (batch, chunk) and the
    intra-chunk (q × q)·(q × P) product, both on the causal triangle
    (q(q + 1)/2 of the q² pairs: the rest is masked to 0), then per
    (batch, head, chunk) the inter-chunk (q × N)·(N × P) and state
    (P × q)·(q × N) products — and each input read once, y and the state
    written once."""
    chunks = b * (s // q)
    tri = q * (q + 1) / 2
    flops = 2.0 * chunks * tri * n + 2.0 * chunks * h * (
        tri * p + 2 * q * p * n)
    nbytes = (elt * (2.0 * b * s * h * p + 2.0 * b * s * n)
              + 4.0 * (b * s * h + h + b * h * p * n))
    return flops, nbytes


def check_ssd_scan(ops, ref, dev) -> dict:
    """The SSD scan kernel at mamba2-2.7b's mixer shape in one scoring
    request — x ``(4, 80, 1024, 64)`` bf16 as a strided view of a
    ``(4, 1024, 80·64 + 256)`` projection, B/C ``(4, 1024, 128)`` strided,
    dt float32, chunk 128 — in bf16, in float32, and with ``S`` = 100 <
    chunk; and at zamba2-2.7b's (the same x, state N 64).  y and the
    state against the plain (sequential) version.  Times: the kernel (its prep, C·Bᵀ once per (batch, chunk), also
    alone), the plain version and the plain chunked algorithm in PyTorch
    (``mamba2.ssd_chunked``: torch einsums, i.e. cuBLAS); no single
    PyTorch call computes the scan (library null).  Bound: the convention
    of the other rows goes by input dtype (bf16 inputs: bf16 tensor-core
    peak and HBM bytes); the float32 CUDA-core figure, the rate the kernel
    computes at, is printed beside it, with the share of each.  The prep
    is first held against its own plain version (``ssd_scan_prep case``:
    C·Bᵀ within ``GEMM_REL``, C and B bitwise)."""
    from repro_torch.kernels.ssd_scan import blocks_per_sm, ssd_scan_prep
    from repro_torch.models.mamba2 import ssd_chunked

    b, h, _, p, _, chunk = SSD_SHAPE
    rows = []
    for name, seq, n, dtype in SSD_CASES:
        x, dt, A, B, C = _ssd_inputs(dev, b, h, seq, p, n, dtype, seed=16)
        q = min(chunk, seq)
        if not rows:                        # the prep at the mixer shape
            got = ssd_scan_prep(B, C, tile=q)
            want = ref.ref_ssd_scan_prep(B, C, q)
            torch.cuda.synchronize()
            perr, pscale = rel_err(got[:, :, 0], want[:, :, 0])
            prow = dict(B=b, S=seq, N=n, tile=q, max_abs_err=perr,
                        tol=GEMM_REL_TOL * pscale,
                        c_b_equal=bool(torch.equal(got[:, :, 1:],
                                                   want[:, :, 1:])))
            print("ssd_scan_prep case " + json.dumps(prow))
            if not (perr <= prow["tol"] and prow["c_b_equal"]):
                fail(f"ssd_scan_prep disagrees with its plain version: "
                     f"{prow}")
            del got, want

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
        t_prep = graph_ms(lambda: ssd_scan_prep(B, C, tile=q), 10)
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
                   ms=t_k, prep_ms=t_prep, wrapper_ms=t_w, plain_ms=t_p,
                   chunked_torch_ms=t_c, library_ms=None, bound_ms=t_b,
                   bound_by=by, share_of_bound=t_b / t_k,
                   bound_f32_ms=t_b32, bound_f32_by=by32,
                   share_of_bound_f32=t_b32 / t_k, gflop=flops / 1e9,
                   mbytes=nbytes / 1e6, tflops=flops / t_k / 1e9,
                   blocks_per_sm=blocks_per_sm(dtype))
        if not rows:                        # the mixer shape: clocks too
            row.update(clocks_under(kern))
        print("ssd_scan case " + json.dumps(row))
        if not ok:
            fail(f"ssd_scan disagrees with its plain version: {row}")
        rows.append(row)
        del x, dt, A, B, C, y, state
        gc.collect()
        torch.cuda.empty_cache()
    case = {r["case"]: r for r in rows}
    return dict(_summary(rows[0], max(r["max_abs_err"] for r in rows)),
                by_path={path: _summary(case[name], case[name]["max_abs_err"])
                         for path, name in SSD_PATH_CASES.items()})


#: the SSD scan's backward kernel against its plain version
#: (``ref_ssd_scan_bwd``), each float32 gradient within
#: ``SSD_BWD_REL_TOL · max |want|``: both run the chunked backward in
#: float32 from the same inputs, the kernel's sums in another order (up to
#: 128·64 products, a reverse cumulative sum of 128 terms of both signs
#: for ddt, every position and batch for dA); bf16 gradients round once
#: from float32 on both sides (BF16_OUT_REL_TOL).
SSD_BWD_REL_TOL = 1e-4


def ssd_bwd_work(b, h, s, p, n, q, elt, with_dstate) -> tuple:
    """(operations, bytes, scratch bytes by part) of one backward of the
    scan: the chunked backward's products that these inputs need — per
    (batch, chunk) C·Bᵀ again and the head-summed (dP∘L)·B and (dP∘L)ᵀ·C,
    on the causal triangle; per (batch, head, chunk) the triangle's M·dy
    and dy·(dt x)ᵀ, and the four (q × P)·(P × N)-sized products (B·dSᵀ,
    dy·S₀, x·dS, the carry dyᵀ·C) — with each input read once (x, dy, B,
    C, dt, A, the tile-start states, d_state) and each gradient written
    once.  The scratch, written and read back once each: the head groups'
    sums (``head_partials``: three 128 × 128 float32 tiles per (batch,
    chunk, group of ``GROUP_HEADS`` heads)) and the state gradient at each
    chunk's end (``d_state_end``)."""
    from repro_torch.kernels.ssd_scan import GROUP_HEADS

    nc = -(-s // q)
    chunks = b * nc
    tri = q * (q + 1) / 2
    flops = 3 * 2.0 * chunks * tri * n + chunks * h * (
        2 * 2.0 * tri * p + 4 * 2.0 * q * p * n)
    nbytes = (elt * (3.0 * b * s * h * p + 4.0 * b * s * n)
              + 4.0 * (2 * b * s * h + 2 * h + b * h * nc * p * n
                       + (b * h * p * n if with_dstate else 0)))
    groups = -(-h // GROUP_HEADS)
    scratch = dict(head_partials=2 * 4.0 * chunks * groups * 3 * 128 * 128,
                   d_state_end=2 * 4.0 * chunks * h * p * n)
    return flops, nbytes, scratch


def check_ssd_scan_bwd(ops, ref, dev) -> dict:
    """The SSD scan's backward kernel at mamba2-2.7b's mixer shape in one
    training step — x ``(4, 80, 1024, 64)`` and dy strided as in the
    mixer, N 128, chunk 128 — in bf16 with ``d_state`` zero (what
    ``forward_train`` gives) and non-zero, in float32, and with ``S`` =
    100 < chunk, from the forward's tile-start states.  Every gradient
    against the plain version's on the card (``SSD_BWD_REL_TOL``; one
    bf16 ulp for bf16 gradients), bitwise repeatable.  Times: the kernels
    (five launches; ``states_ms`` the first three alone, the gradient of
    the state at each tile's end), the plain version, and the yardstick,
    the autograd backward of the plain chunked algorithm
    (``mamba2.ssd_chunked``, einsums through cuBLAS; forward and backward
    less the forward); no single PyTorch call computes it (library null).
    Bound as the forward's row: by the input dtype's rule, with the
    float32 CUDA-core figure beside it.  ``scratch_mbytes`` is what the
    kernels write and read back: the head groups' sums and the end-of-tile
    state gradients, each also on its own; ``blocks_per_sm`` the main
    kernel's."""
    from repro_torch.kernels.ssd_scan import (bwd_blocks_per_sm, ssd_scan,
                                              ssd_scan_bwd,
                                              ssd_scan_bwd_states)
    from repro_torch.models.mamba2 import ssd_chunked

    b, h, s, p, n, chunk = SSD_SHAPE
    cases = (("mixer_bf16", s, torch.bfloat16, False),
             ("mixer_bf16_dstate", s, torch.bfloat16, True),
             ("mixer_f32", s, torch.float32, False),
             ("short_bf16_dstate", 100, torch.bfloat16, True))
    rows = []
    for name, seq, dtype, with_ds in cases:
        x, dt, A, B, C = _ssd_inputs(dev, b, h, seq, p, n, dtype, seed=17)
        q = min(chunk, seq)
        gen = torch.Generator(device=dev).manual_seed(18)
        dy = torch.randn(b, seq, h, p, generator=gen, device=dev).to(
            dtype).transpose(1, 2)
        ds = (torch.randn(b, h, p, n, generator=gen, device=dev)
              if with_ds else None)
        _, _, starts = ssd_scan(x, dt, A, B, C, chunk=q, with_starts=True)

        def kern():
            return ssd_scan_bwd(x, dt, A, B, C, starts, dy, ds, chunk=q)

        def plain():
            return ref.ref_ssd_scan_bwd(x, dt, A, B, C, dy, ds, chunk=q)
        got, want = kern(), plain()
        again = kern()
        torch.cuda.synchronize()
        errs, ok = {}, True
        for g_name, g, w, g2 in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                    want, again):
            err, scale = rel_err(g.float(), w.float())
            tol = (BF16_OUT_REL_TOL if g.dtype == torch.bfloat16
                   else SSD_BWD_REL_TOL) * scale
            errs[g_name] = dict(max_abs_err=err, tol=tol, max_abs=scale,
                                bitwise_repeatable=bool(torch.equal(g, g2)))
            ok = ok and bool(torch.isfinite(g).all()) and err <= tol \
                and torch.equal(g, g2) and g.dtype == w.dtype
        del got, want, again
        t_k = graph_ms(kern, 10)
        t_s = graph_ms(lambda: ssd_scan_bwd_states(x, dt, A, B, C, dy, ds,
                                                   chunk=q), 10)
        t_w = cuda_ms(kern, 10)
        t_p = cuda_ms(plain, 2, warmup=1)
        leaves = [a.detach().requires_grad_(True) for a in (x, dt, A, B, C)]

        def fwd():
            return ssd_chunked(leaves[0].transpose(1, 2),
                               leaves[1].transpose(1, 2), *leaves[2:],
                               chunk=q)[0]

        def both():
            return torch.autograd.grad(fwd(), leaves, dy.transpose(1, 2))
        with torch.no_grad():
            t_f = cuda_ms(fwd, 3, warmup=1)
        t_c = cuda_ms(both, 3, warmup=1) - t_f
        del leaves
        flops, nbytes, scratch = ssd_bwd_work(b, h, seq, p, n, q,
                                              x.element_size(), with_ds)
        peak = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
        t_b, by = bound_ms(nbytes, flops, peak)
        t_b32, by32 = bound_ms(nbytes, flops, FP32_FLOP_PER_S)
        row = dict(case=name, x=[b, h, seq, p], N=n, chunk=q,
                   dtype=str(dtype).replace("torch.", ""),
                   d_state=with_ds, gradients=errs,
                   max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                   ms=t_k, wrapper_ms=t_w, plain_ms=t_p,
                   chunked_autograd_ms=t_c, library_ms=None, bound_ms=t_b,
                   bound_by=by, share_of_bound=t_b / t_k,
                   bound_f32_ms=t_b32, bound_f32_by=by32,
                   share_of_bound_f32=t_b32 / t_k, gflop=flops / 1e9,
                   mbytes=nbytes / 1e6,
                   scratch_mbytes=sum(scratch.values()) / 1e6,
                   head_partials_mbytes=scratch["head_partials"] / 1e6,
                   d_state_end_mbytes=scratch["d_state_end"] / 1e6,
                   states_ms=t_s, tflops=flops / t_k / 1e9,
                   blocks_per_sm=bwd_blocks_per_sm(dtype))
        if not rows:
            row.update(clocks_under(kern))
        print("ssd_scan_bwd case " + json.dumps(row))
        if not ok:
            fail(f"ssd_scan_bwd disagrees with its plain version: {row}")
        rows.append(row)
        del x, dt, A, B, C, dy, ds, starts
        gc.collect()
        torch.cuda.empty_cache()
    main = rows[0]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
                chunked_autograd_ms=main["chunked_autograd_ms"],
                states_ms=main["states_ms"],
                head_partials_mbytes=main["head_partials_mbytes"],
                d_state_end_mbytes=main["d_state_end_mbytes"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                bound_f32_ms=main["bound_f32_ms"],
                share_of_bound_f32=main["share_of_bound_f32"],
                ms_f32=rows[2]["ms"])


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serving main paths
# ---------------------------------------------------------------------------


def jittered(cfg, gen):
    """Random DiT parameters drawn from ``gen``, every leaf jittered with
    seeded noise: fresh init zeroes the output layers, which would make
    every prediction exactly 0."""
    from repro_torch.models import dit as D
    from repro_torch.tree import tree_map

    return tree_map(lambda a: a + 0.02 * torch.randn(
        a.shape, generator=gen, device=a.device), D.init(cfg, gen))


def write_ensemble(path, dit_cfg, router_cfg, dev, seed):
    """8 random experts (2 DDPM + 6 FM) and a router as checkpoints, each
    ``jittered``."""
    from repro_torch.training.checkpoint import (expert_metadata,
                                                 save_checkpoint)

    gen = torch.Generator(device=dev).manual_seed(seed)
    os.makedirs(path, exist_ok=True)
    for cid, (obj, sched) in enumerate(MIX):
        save_checkpoint(os.path.join(path, f"expert{cid}.npz"),
                        jittered(dit_cfg, gen),
                        metadata=expert_metadata(
                            name=f"expert{cid}", objective=obj,
                            schedule=sched, cluster_id=cid,
                            arch=dit_cfg.name))
    save_checkpoint(os.path.join(path, "router.npz"),
                    jittered(router_cfg, gen),
                    metadata={"num_clusters": len(MIX)})


def expected_launches(cfg, router_cfg, ops, param_dtype: str,
                      step_fused: bool, requests: int,
                      refresh: int = 1) -> dict:
    """Kernel launches of ``requests`` batched-CFG requests of ``STEPS``
    steps, computed from the DiT and router configs and the wrapper's
    row-tile rule.

    The router's dense forward runs on ⌈STEPS / refresh⌉ steps of a
    request (``plan_refresh_every``), two AdaLN launches (msa, mlp) and
    one attention launch per layer.  One ragged forward (cond
    and uncond batched, ``g = 2``) runs three AdaLN launches per layer
    (msa, the LayerNorm before cross-attention, mlp) and one for the
    final layer, two attention launches per layer (the self-attention,
    layer 0's on the per-pair prefix, and the cross-attention over the
    text tokens), and one ragged GEMM per dense layer, each over row
    groups of width ``m``.
    With ``adaln_single=False`` the AdaLN-Single MLP gives way to one
    modulation GEMM per layer.
    A quantized store contracts the tiled widths in its int8/fp8 body and
    the others in the float32 body after one dequant of the weights; it
    also dequantizes every bias it adds and the four embedding leaves the
    forward reads (position, timestep table, block embedding, null text).
    """
    g, layers = 2, cfg.num_layers
    tokens = (cfg.latent_size // cfg.patch_size) ** 2
    text = g * cfg.text_len
    modulation = 2 if cfg.adaln_single else layers
    widths = ([tokens]                      # patch embedding
              + [1] * (2 + modulation)      # timestep MLP, modulations
              + [tokens] * 4                # layer-0 self-attention, per pair
              + [g * tokens] * 4 * (layers - 1)   # later self-attention
              + [g * tokens] * 2 * layers   # cross-attention q, out
              + [text] * (2 * layers + 1)   # cross-attention k, v; text proj
              + [g * tokens] * 2 * layers   # MLP
              + [1, g * tokens])            # final modulation, output
    # patch embed, timestep MLP x2, AdaLN mlp1, text proj, MLP w1/w2 each
    # layer
    biases = 4 + cfg.adaln_single + 2 * layers
    embeddings = 3 + cfg.adaln_single
    n = STEPS * requests
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["hetero_fuse_step" if step_fused else "hetero_fuse_coeffs"] = n
    n_router = -(-STEPS // refresh) * requests
    lns = 3 if cfg.use_text else 2
    attn = 2 if cfg.use_text else 1
    want["adaln_fuse"] = (2 * router_cfg.num_layers * n_router
                          + (lns * layers + 1) * n)
    want["flash_attention"] = (router_cfg.num_layers * n_router
                               + attn * layers * n)
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
    0 just before and read just after; check outputs and counts (``want``
    None: the caller checks the counts it returns).

    ``mem`` holds the device bytes allocated before the engine was built
    (``base``: engines of other paths still resident) and what the build
    added; every memory figure printed is net of ``base``, so it is this
    path's engine alone (``None``: an engine served before, no store
    line)."""
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
    if want is not None and launches != want:
        fail(f"{name} path launches {launches}, expected {want}")
    if mem is None:
        return outs, launches
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
    path = DIT_PATH
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
    print(f"engine stats {json.dumps(engines['native'].stats)}")
    return launches, engines


def serve_options(ops, engine) -> dict:
    """Phase 4, the request options on the native engine (its sampler
    swapped per option, then restored), each with the launch counts set to
    0 just before and read just after:

    * one request at ``plan_refresh_every`` 1, 2 and 4: the router's
      AdaLN and attention launches fall to ⌈8/R⌉ steps of 8, the experts'
      are unchanged; the latents' drift from R = 1 is printed;
    * one request with the §7.3 gate, ``ddpm_low_noise_only = 0.5``: the
      launches of R = 1, latents finite and not R = 1's;
    * ``submit``/``flush`` of three requests of batch 1, 3 and 4 with
      text: one dispatch into bucket 8 with one request's launches, each
      request's rows within ``E2E_REL_TOL · max|out|`` of ``generate``
      from the same seed (the same noise and function; the router's
      cuBLAS GEMMs run at another batch and may take another algorithm,
      so sums in another order, through 8 CFG steps);
    * a request with ``deadline_s = 0``: DEADLINE_EXCEEDED at ``flush``,
      no launch.
    """
    from repro_torch.models.config import dit_b2, router_b2
    from repro_torch.serving.resilience import DeadlineExceeded

    cfg, router_cfg = dit_b2(), router_b2(num_clusters=len(MIX))
    rng = np.random.default_rng(8)
    text = rng.standard_normal((BATCH, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    base = engine.sampler
    launches, outs = {}, {}
    try:
        for name, kw, refresh in (
                ("plan_refresh_1", {}, 1),
                ("plan_refresh_2", dict(plan_refresh_every=2), 2),
                ("plan_refresh_4", dict(plan_refresh_every=4), 4),
                ("ddpm_gate", dict(ddpm_low_noise_only=0.5), 1)):
            engine.sampler = dataclasses.replace(base, **kw)
            (outs[name],), launches[name] = serve_path(
                ops, engine, name, [text], [300],
                expected_launches(cfg, router_cfg, ops, "native", True, 1,
                                  refresh), None)
    finally:
        engine.sampler = base
    ref = outs["plan_refresh_1"]
    for name in ("plan_refresh_2", "plan_refresh_4", "ddpm_gate"):
        print(f"{name} vs plan_refresh_1 " + json.dumps(dict(
            max_abs_diff=rel_err(outs[name], ref)[0],
            max_abs=ref.abs().max().item())))
    if torch.equal(outs["ddpm_gate"], ref):
        fail("the ddpm_low_noise_only gate left the latents unchanged")

    batches, seeds = (1, 3, 4), (400, 401, 402)
    texts = [rng.standard_normal((b, cfg.text_len, cfg.text_dim)).astype(
        np.float32) for b in batches]
    before = dict(engine.stats)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    handles = [engine.submit(s, t) for s, t in zip(seeds, texts)]
    dispatched = engine.flush()
    results = [h.result() for h in handles]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches["coalesced"] = dict(ops.LAUNCHES)
    merged = engine.stats["merged_batches"] - before["merged_batches"]
    print("coalesced " + json.dumps(dict(
        batches=list(batches), bucket=8, seconds=sec,
        img_per_s=sum(batches) / sec, dispatches=dispatched,
        merged_batches=merged, launches=launches["coalesced"])))
    if not (dispatched == merged == 1 and launches["coalesced"]
            == expected_launches(cfg, router_cfg, ops, "native", True, 1)):
        fail(f"submit/flush of {batches} did not run as one dispatch")
    for i, (b, s, t, got) in enumerate(zip(batches, seeds, texts, results)):
        want = engine.generate(s, t, b)
        err, scale = rel_err(got, want)
        print(f"coalesced vs generate request {i} " + json.dumps(dict(
            batch=b, max_abs_err=err, tol=E2E_REL_TOL * scale,
            max_abs=scale)))
        if not (bool(torch.isfinite(got).all())
                and tuple(got.shape) == (b, 32, 32, 4)
                and err <= E2E_REL_TOL * scale):
            fail(f"coalesced request {i} differs from generate by {err}")

    ops.reset_launches()
    late = engine.submit(500, texts[0], deadline_s=0)
    dispatched = engine.flush()
    torch.cuda.synchronize()
    try:
        late.result()
        fail("a request past its deadline returned a result")
    except DeadlineExceeded as e:
        expired = str(e)
    print("deadline " + json.dumps(dict(
        state=late.state, dispatches=dispatched, error=expired,
        launches=sum(ops.LAUNCHES.values()))))
    if late.state != "DEADLINE_EXCEEDED" or dispatched or any(
            ops.LAUNCHES.values()):
        fail("the deadline request was dispatched")
    return launches


def forward_launches(cfg, router_cfg, ops, expert_forwards: int,
                     router_forwards: int, fuse_steps: int,
                     dequant: int = 0, step_fused: bool = True) -> dict:
    """Launches of a request whose experts run dense ``dit.apply``
    forwards (the dense, gathered, grouped and reference executors and
    engines): each expert forward three AdaLN launches a layer and one
    for the final layer and two attention launches a layer (self- and
    cross-attention), each router forward two AdaLN and one attention
    launch a layer; the dense GEMMs run in cuBLAS.  ``fuse_steps``
    step-kernel launches (velocity-kernel launches with
    ``step_fused=False``); ``dequant`` the quantized store's
    expansions."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["adaln_fuse"] = (2 * router_cfg.num_layers * router_forwards
                          + (3 * cfg.num_layers + 1) * expert_forwards)
    want["flash_attention"] = (router_cfg.num_layers * router_forwards
                               + 2 * cfg.num_layers * expert_forwards)
    want["hetero_fuse_step" if step_fused else "hetero_fuse_coeffs"] = \
        fuse_steps
    want["hetero_fuse_dequant"] = dequant
    return want


#: phase 4's paths of the other strategies, engines and executors:
#: name -> (engine, sampler overrides, the native top-2 request's
#: function?)
STRATEGY_PATHS = {
    "full": ("native", "auto", dict(strategy="full"), False),
    "full_unfused": ("native", "auto",
                     dict(strategy="full", step_fused=False), False),
    "dense_topk": ("native", "dense", {}, True),
    "threshold": ("native", "auto", dict(strategy="threshold"), False),
    "threshold_int8": ("int8", "auto", dict(strategy="threshold"), False),
    "reference": ("native", "reference", {}, True),
    "snr_match": ("native", "auto", dict(time_map="snr_match"), False),
    "grouped": ("native", "auto", dict(dispatch="grouped"), True),
    "gathered": ("native", "auto", dict(dispatch="gathered"), True),
}


def serve_strategies(ops, engines, dev) -> dict:
    """Phase 4, the other strategies, engines and executors: one request
    on each path of ``STRATEGY_PATHS`` (the native and int8 engines with
    their sampler and engine mode swapped, then restored) and one on a
    full-width ensemble with per-block adaLN-Zero (``adaln_single=False``,
    top-2 ragged), each with the launch counts set to 0 just before and
    read just after, computed from the configs and checked exactly:

    * ``full`` and ``dense_topk`` (every expert, dense ``dit.apply``): a
      step runs the router and the 8 experts over the CFG-doubled batch,
      and one step kernel fuses 8 slots (``full_unfused``: one velocity
      kernel, its latents bitwise ``full``'s);
    * ``threshold`` (one gathered expert a step, no router); its int8
      form expands every quantized leaf of that expert a step;
    * ``reference`` and ``snr_match``: the router and 16 expert forwards
      a step (8 experts × 2 CFG branches), fused in plain ops;
    * ``grouped`` and ``gathered``: the router and one forward per
      non-empty segment a step, counted from the step's plan (grouped
      over power-of-two buckets, gathered over exactly the segment).

    Each prints its max |Δ| against the native top-2 request from the same
    text and noise; ``dense_topk``, ``reference``, ``grouped`` and
    ``gathered`` compute that request's function and must agree within
    ``E2E_REL_TOL · max|out|`` (the others compute other functions).
    """
    from repro_torch.core import sampling
    from repro_torch.core.fusion import ExpertSpec
    from repro_torch.core.sampling import SamplerConfig
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import dit as D
    from repro_torch.models.config import dit_b2, router_b2
    from repro_torch.tree import tree_leaves

    cfg, router_cfg = dit_b2(), router_b2(num_clusters=len(MIX))
    k = len(MIX)
    text = np.random.default_rng(9).standard_normal(
        (BATCH, cfg.text_len, cfg.text_dim)).astype(np.float32)
    seed = 600
    launches = {}
    (ref,), launches["native_top2"] = serve_path(
        ops, engines["native"], "native_top2", [text], [seed],
        expected_launches(cfg, router_cfg, ops, "native", True, 1), None)
    scale = ref.abs().max().item()
    quant_leaves = len(tree_leaves(engines["int8"].param_store.qvals))
    expert_forwards = {"full": k * STEPS, "full_unfused": k * STEPS,
                       "dense_topk": k * STEPS,
                       "threshold": STEPS, "threshold_int8": STEPS,
                       "reference": 2 * k * STEPS,
                       "snr_match": 2 * k * STEPS}

    def compare(name, out, same_function):
        err = rel_err(out, ref)[0]
        line = dict(max_abs_diff=err, max_abs_native=scale)
        if same_function:
            line["tol"] = E2E_REL_TOL * scale
        print(f"{name} vs native_top2 " + json.dumps(line))
        if same_function and err > E2E_REL_TOL * scale:
            fail(f"{name} differs from the native top-2 request by {err}")

    plans, outs = [], {}
    make_plan = sampling.make_dispatch_plan

    def recording(w, k_slots, **kw):
        plans.append(make_plan(w, k_slots, **kw))
        return plans[-1]

    for name, (store, mode, kw, same) in STRATEGY_PATHS.items():
        eng = engines[store]
        base, base_mode = eng.sampler, eng.engine
        eng.sampler, eng.engine = dataclasses.replace(base, **kw), mode
        plans.clear()
        sampling.make_dispatch_plan = recording
        try:
            if name in ("grouped", "gathered"):
                # segments are known once the request has run: serve it,
                # then count
                (out,), got = serve_path(ops, eng, name, [text], [seed],
                                         None, None)
                segments = sum(int(p.slot_idx.unique().numel())
                               for p in plans)
                want = forward_launches(cfg, router_cfg, ops, segments,
                                        STEPS, STEPS)
                print(f"{name} segments " + json.dumps(dict(
                    forwards=segments, per_step=segments / STEPS)))
                if got != want:
                    fail(f"{name} path launches {got}, expected {want}")
            else:
                routed = kw.get("strategy") != "threshold"
                want = forward_launches(
                    cfg, router_cfg, ops, expert_forwards[name],
                    STEPS if routed else 0,
                    0 if mode == "reference" or name == "snr_match"
                    else STEPS,
                    quant_leaves * STEPS if store == "int8" else 0,
                    kw.get("step_fused", True))
                (out,), got = serve_path(ops, eng, name, [text], [seed],
                                         want, None)
        finally:
            sampling.make_dispatch_plan = make_plan
            eng.sampler, eng.engine = base, base_mode
        launches[name] = got
        outs[name] = out
        compare(name, out, same)
    if not torch.equal(outs["full_unfused"], outs["full"]):
        fail("the unfused full request differs from the fused one")

    # per-block adaLN-Zero: a full-width ensemble built on the card (the
    # router is the native engine's), top-2 through the ragged executor
    pb_cfg = dit_b2(adaln_single=False)
    gen = torch.Generator(device=dev).manual_seed(14)
    apply_fn = D.make_expert_apply(pb_cfg)
    ragged_fn = D.make_ragged_expert_apply(pb_cfg)
    experts = [ExpertSpec(name=f"per_block{i}", objective=obj,
                          schedule=sched, apply_fn=apply_fn, cluster_id=i,
                          ragged_apply_fn=ragged_fn)
               for i, (obj, sched) in enumerate(MIX)]
    eng = ServingEngine(
        experts=experts, expert_params=[jittered(pb_cfg, gen) for _ in MIX],
        router_fn=engines["native"].router_fn, latent_shape=(32, 32, 4),
        sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2),
        device=dev)
    print("per_block ensemble " + json.dumps(dict(
        parameters_per_expert=D.param_count(eng.expert_params[0]),
        store_bytes=eng.param_store.nbytes())))
    (out,), launches["per_block"] = serve_path(
        ops, eng, "per_block", [text], [seed],
        expected_launches(pb_cfg, router_cfg, ops, "native", True, 1),
        None)
    compare("per_block", out, False)
    del eng, experts
    gc.collect()
    return launches


def _category(name: str, table=CATEGORIES) -> str:
    for frag, cat in table:
        if frag.lower() in name.lower():
            return cat
    return "other"


#: host ops whose counts each profile line prints: the ones that read a
#: device value (``item``, ``tolist``, ``bincount`` sizing its output) or
#: copy between host and device
HOST_OPS = ("aten::_local_scalar_dense", "aten::bincount", "aten::_to_copy",
            "aten::copy_", "aten::index_put_")


def profiled(run, table, **fields) -> None:
    """``run()`` under ``torch.profiler``: prints device ms by kernel and by
    category of ``table``, the device's idle share ``1 − busy / profiled
    wall`` (the profiler's own host cost inflates the wall), and the host
    side: the count and self ms of the CPU events it recorded (ATen ops and
    CUDA runtime calls), in all and for the six costliest, and the count
    of ``cudaMemcpyAsync`` and ``cudaStreamSynchronize`` calls (PyTorch's
    copies between host and device wait for the stream)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = defaultdict(float)
    host: dict[str, list] = {}                      # name -> [count, ms]
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] += evt.self_device_time_total / 1e3      # ms
        else:
            host[evt.key] = [evt.count, evt.self_cpu_time_total / 1e3]
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
        "host_events": sum(c for c, _ in host.values()),
        "host_self_ms": sum(ms for _, ms in host.values()),
        "cuda_memcpy_async": host.get("cudaMemcpyAsync", [0])[0],
        "cuda_stream_synchronize": host.get("cudaStreamSynchronize",
                                            [0])[0],
        "host_op_counts": {k: host.get(k, [0])[0] for k in HOST_OPS},
        "host_top6": dict(sorted(host.items(), key=lambda kv: -kv[1][1])[:6]),
        "ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "ms_by_kernel_top12": dict(top)}))


def profile_request(engine, label: str, **sampler) -> None:
    """One more full-width DiT request under ``torch.profiler``, with the
    engine's sampler options replaced by ``sampler`` for it."""
    from repro_torch.models.config import dit_b2

    cfg = dit_b2()
    text = np.random.default_rng(7).standard_normal(
        (BATCH, cfg.text_len, cfg.text_dim)).astype(np.float32)
    base = engine.sampler
    engine.sampler = dataclasses.replace(base, **sampler)
    try:
        profiled(lambda: engine.generate(200, text, BATCH), CATEGORIES,
                 path=label, batch=BATCH, steps=STEPS, **sampler)
    finally:
        engine.sampler = base


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
    pb_cfg = dataclasses.replace(dit_cfg, adaln_single=False)
    pb_path = os.path.join(WORK, "reduced_per_block")
    write_ensemble(pb_path, pb_cfg, router_cfg, dev, seed=15)
    paths = (("native", {}, E2E_REL_TOL),
             ("bf16", dict(param_dtype="bf16"), E2E_BF16_REL_TOL),
             ("int8", dict(param_dtype="int8"), None),
             ("fp8", dict(param_dtype="fp8"), None),
             ("unfused", dict(step_fused=False), E2E_REL_TOL),
             ("two_pass_cfg", dict(batched_cfg=False), E2E_REL_TOL),
             ("plan_refresh_2", dict(plan_refresh_every=2), E2E_REL_TOL),
             ("ddpm_gate", dict(ddpm_low_noise_only=0.5), E2E_REL_TOL),
             # the int8 threshold path expands the store bitwise and runs
             # float32 forwards: no activation is quantized, so its
             # latents are held like the native ones
             *((name, dict(kw, param_dtype="int8" if store == "int8"
                           else "native", engine_mode=mode), E2E_REL_TOL)
               for name, (store, mode, kw, _) in STRATEGY_PATHS.items()),
             ("per_block", dict(ensemble="per_block"), E2E_REL_TOL))

    def engine(device, kw):
        kw = dict(kw)
        mode = kw.pop("engine_mode", "auto")
        per_block = kw.pop("ensemble", None) == "per_block"
        return ServingEngine.from_checkpoint_dir(
            pb_path if per_block else path,
            dit_cfg=pb_cfg if per_block else dit_cfg, router_cfg=router_cfg,
            sampler=dataclasses.replace(sampler, **kw), engine=mode,
            device=device)

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
    shutil.rmtree(pb_path)
    if failed:
        fail(f"GPU run differs from the CPU run: {failed}")


#: phase 9's CLI runs: extra flags -> (lines printed, the line that
#: shows the run served every request); ``CLI_BAD`` and ``CLI_JOURNAL``
#: stand for directories under ``WORK``
CLI_RUNS = (
    (["--coalesce", "--plan-refresh", "2", "--track-padding"], 3,
     "coalesced 2 requests -> 1 dispatch(es): 6 imgs"),
    (["--strategy", "full"], 4, "request 1: (3, 8, 8, 4)"),
    # --deadline-s acts under --continuous only, as in the reference CLI
    (["--coalesce", "--deadline-s", "0"], 3,
     "coalesced 2 requests -> 1 dispatch(es): 6 imgs"),
    (["--continuous", "--capacity", "10", "--journal-dir", "CLI_JOURNAL"],
     5, "continuous 2 requests in"),
    # the directory whose expert3.npz is truncated
    (["--ckpt-dir", "CLI_BAD", "--on-bad-checkpoint", "skip"], 6,
     "request 1: (3, 8, 8, 4)"),
)


#: the LM side's command lines, run beside the serving CLI: (module,
#: arguments, lines printed) — the training CLI's reduced mamba2-2.7b and
#: the LM example (two experts, 30 steps each, then three scores)
LM_CLI = (
    ("repro_torch.launch.train", ["--mode", "lm", "--arch", "mamba2-2.7b",
                                  "--steps", "3"], 3),
    ("repro_torch.examples.decentralized_lm_experts",
     ["--arch", "mamba2-2.7b"], 5),
    ("repro_torch.launch.train", ["--mode", "lm", "--arch",
                                  "internlm2-1.8b", "--steps", "3"], 3),
    ("repro_torch.examples.decentralized_lm_experts",
     ["--arch", "zamba2-2.7b"], 5),
    ("repro_torch.launch.train", ["--mode", "lm", "--arch", "mixtral-8x7b",
                                  "--steps", "3"], 3),
    ("repro_torch.examples.decentralized_lm_experts",
     ["--arch", "mixtral-8x7b"], 5),
    ("repro_torch.launch.train", ["--mode", "lm", "--arch", "paligemma-3b",
                                  "--steps", "3"], 3),
)


def check_trained_checkpoint(path: str, dev) -> None:
    """The training CLI's checkpoint loads onto the card, with its expert
    metadata and finite float32 leaves."""
    from repro_torch.training.checkpoint import load_checkpoint
    from repro_torch.tree import tree_leaves

    params, meta = load_checkpoint(path, device=dev)
    leaves = tree_leaves(params)
    ok = (meta.get("objective") == "fm" and meta.get("step") == 20
          and all(bool(torch.isfinite(x).all()) for x in leaves))
    print("cli train checkpoint " + json.dumps(dict(
        leaves=len(leaves), parameters=sum(x.numel() for x in leaves),
        metadata=meta, ok=ok)))
    if not ok:
        fail(f"the training CLI's checkpoint does not load as an expert: "
             f"{meta}")


def run_cli(dev) -> None:
    """Phase 9: ``python -m repro_torch.launch.serve`` as a user runs it, on
    the card, over checkpoints at the reference CLI's reduced width
    (latent 8), two batch-3 requests of 4 steps: coalesced into one
    dispatch with plan reuse every 2 steps; the full strategy; coalesced
    with ``--deadline-s 0``, which must serve both; ``--continuous`` on a
    capacity-10 elastic engine writing a journal; and
    ``--on-bad-checkpoint skip`` over a copy of the checkpoints whose
    ``expert3.npz`` is truncated (quarantined, its slot masked).  The runs
    start together; each must exit 0 and print its lines."""
    from repro_torch.launch.faults import truncate_checkpoint
    from repro_torch.models.config import dit_b2, router_b2

    path = os.path.join(WORK, "cli")
    bad = os.path.join(WORK, "cli_bad")
    journal = os.path.join(WORK, "cli_journal")
    write_ensemble(path, dit_b2().reduced(latent_size=8),
                   router_b2(num_clusters=len(MIX)).reduced(latent_size=8),
                   dev, seed=13)
    shutil.rmtree(bad, ignore_errors=True)
    shutil.rmtree(journal, ignore_errors=True)
    shutil.copytree(path, bad)
    truncate_checkpoint(os.path.join(bad, "expert3.npz"))
    where = {"CLI_BAD": bad, "CLI_JOURNAL": journal}
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--ckpt-dir",
            path, "--batch", "3", "--requests", "2", "--steps", "4"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    trained = os.path.join(WORK, "cli_train")
    shutil.rmtree(trained, ignore_errors=True)
    train_cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode",
                 "expert", "--steps", "20", "--out",
                 os.path.join(trained, "expert0.npz")]
    lm_cmds = [[sys.executable, "-m", cmd, *args] for cmd, args, _ in LM_CLI]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT)
             for cmd in [base + [where.get(f, f) for f in flags]
                         for flags, _, _ in CLI_RUNS] + lm_cmds
             + [train_cmd]]
    try:
        results = [p.communicate(timeout=300) for p in procs]
        train_proc, (train_out, train_err) = procs.pop(), results.pop()
        for (cmd, args, n_lines), p, (out, err) in zip(
                reversed(LM_CLI), [procs.pop() for _ in LM_CLI],
                [results.pop() for _ in LM_CLI]):
            lines = out.strip().splitlines()
            for line in lines:
                print(f"cli {cmd} {' '.join(args)} | {line}")
            if p.returncode != 0 or len(lines) != n_lines:
                fail(f"{cmd} {args} exited {p.returncode} with "
                     f"{len(lines)} lines: {err.strip()[-2000:]}")
        for line in train_out.strip().splitlines():
            print(f"cli train | {line}")
        if train_proc.returncode != 0:
            fail(f"the training CLI exited {train_proc.returncode}: "
                 f"{train_err.strip()[-2000:]}")
        check_trained_checkpoint(os.path.join(trained, "expert0.npz"), dev)
    finally:
        for p in procs:
            p.kill()
        for d in (path, bad, journal, trained):
            shutil.rmtree(d, ignore_errors=True)
    for (flags, n_lines, served), p, (out, err) in zip(CLI_RUNS, procs,
                                                       results):
        lines = out.strip().splitlines()
        for line in lines:
            print(f"cli {' '.join(flags)} | {line}")
        if p.returncode != 0 or len(lines) != n_lines or not any(
                line.startswith(served) for line in lines):
            fail(f"the serving CLI {flags} exited {p.returncode}: "
                 f"{err.strip()[-2000:]}")


# ---------------------------------------------------------------------------
# Phase 20: the paper's four DiT examples
# ---------------------------------------------------------------------------

#: phase 20's ``train_decentralized`` run: the paper's 2 DDPM : 6 FM
#: recipe at full DiT-B/2 width, 20 steps of batch 32 an expert
EXAMPLE_EXPERTS, EXAMPLE_DDPM, EXAMPLE_STEPS = 8, 2, 20
EXAMPLE_TRAIN = ["--full", "--experts", str(EXAMPLE_EXPERTS),
                 "--ddpm-experts", str(EXAMPLE_DDPM), "--steps",
                 str(EXAMPLE_STEPS), "--batch", "32"]
#: ``python -m <module> <args>`` as ``runpy`` runs it, then the process's
#: peak of allocated device bytes on a line of its own
PEAK_MAIN = ("import runpy, sys, torch; mod = sys.argv[1]; "
             "sys.argv = sys.argv[1:]; "
             "runpy.run_module(mod, run_name='__main__', alter_sys=True); "
             "print('peak_bytes', torch.cuda.max_memory_allocated())")
_NUM = r"(-?[0-9.]+(?:e[-+][0-9]+)?|nan|inf)"


def _train_lines(k: int, ddpm: int, latent: int, size: str,
                 out: str) -> list[str]:
    """``train_decentralized``'s lines (the reference example's), as
    patterns."""
    return ([rf"\[1/4\] clustering corpus into {k} partitions \.\.\.",
             r"      cluster sizes: \[[0-9 ]+\]",
             rf"\[2/4\] training {k} isolated experts \({ddpm} DDPM : "
             rf"{k - ddpm} FM\) \.\.\.",
             rf"      expert size: {size}M params"]
            + [rf"      expert {c} \[{'ddpm' if c < ddpm else 'fm'}\] "
               rf"loss {_NUM} \({_NUM}s\)" for c in range(k)]
            + [r"\[3/4\] training router \(independent, all clusters\) "
               r"\.\.\.", rf"      router acc {_NUM}",
               r"\[4/4\] sampling with heterogeneous fusion \.\.\.",
               rf"done: \(64, {latent}, {latent}, 4\) samples, FID-proxy "
               rf"{_NUM}, checkpoints in {re.escape(out)}"])


def _serve_lines(dispatch: str, params: str) -> list[str]:
    """``serve_heterogeneous``'s lines after any training: a line per
    strategy, then the elastic walkthrough's three (less ``traces=``)."""
    lines = []
    for strategy in ("top1", "topk", "full"):
        routed = strategy != "full"
        lines.append(
            rf"strategy={strategy:5s} "
            rf"dispatch={dispatch if routed else 'auto':8s} "
            rf"params={params if routed else 'native':6s} "
            rf"experts=\['ddpm', 'ddpm', 'fm', 'fm'\] first={_NUM}s "
            rf"steady={_NUM}s \({_NUM} img/s\) cond_cache=0h/3m "
            rf"plan_refreshes=24")
    return lines + [r"elastic: membership: live=6/8 added=0 evicted=0 .*",
                    r"elastic: hot-added slot 6, evicted slot 2 between "
                    r"submit\(\) and flush\(\) — 2 dispatches",
                    r"elastic: membership: live=6/8 added=1 evicted=1 .*"]


#: the other examples' lines: convert_checkpoint (the Eq. 20 report's
#: nine groups, Eq. 21's table) and quickstart
CONVERT_LINES = (
    [r"=== Eq\. 20: ImageNet-DDPM checkpoint -> text-conditioned FM expert"]
    + [rf"  {g:18s} -> {a}" for g, a in (
        ("adaln_single", "transfer"), ("blocks", "transfer"),
        ("cross_attn", "new"), ("final_layer", "reinit"),
        ("null_text_embed", "new"), ("patch_embed", "transfer"),
        ("pos_embed", "transfer"), ("t_embed", "transfer"),
        ("text_proj", "new"))]
    + [r"  converted expert forward OK: \(2, 8, 8, 4\), finite=True", "",
       r"=== Eq\. 21: continuous FM time -> discrete DiT table index",
       r"  t=0\.000 -> t_DiT=0", r"  t=0\.123 -> t_DiT=123",
       r"  t=0\.500 -> t_DiT=500", r"  t=1\.000 -> t_DiT=999", "",
       r"=== Eqs\. 22–25: schedule-aware ε→velocity conversion",
       rf"  linear: \|v - \(eps - x0\)\| = {_NUM}  \(Eq\. 25 identity\)",
       rf"  cosine: velocity norms per t: \[{_NUM}, {_NUM}, {_NUM}, "
       rf"{_NUM}\]", r"  safeguards: .*"])
QUICKSTART_LINES = [rf"expert 0 \(ddpm/cosine\) final loss {_NUM}",
                    rf"expert 1 \(fm/linear\) final loss {_NUM}",
                    rf"router acc {_NUM}",
                    rf"samples \(64, 8, 8, 4\), FID-proxy {_NUM}, "
                    r"finite=True"]


def _check_lines(label: str, lines: list[str], patterns: list[str]) -> list:
    """Every line against its pattern, in order, every number finite;
    returns the matches."""
    matches = [re.fullmatch(p, ln) for p, ln in zip(patterns, lines)]
    if len(lines) != len(patterns) or not all(matches):
        bad = [(p, ln) for p, ln, m in zip(patterns, lines, matches)
               if not m]
        fail(f"{label} printed {len(lines)} lines for {len(patterns)} "
             f"expected; first mismatch {bad[:1]}")
    for m in matches:
        for g in m.groups():
            if g is not None and not math.isfinite(float(g)):
                fail(f"{label}: a number is not finite: {m.string!r}")
    return matches


def _run_example(label: str, cmd: list[str], env: dict,
                 timeout: float = 600) -> tuple[list[str], float]:
    """One example as a subprocess: exits 0, its lines printed."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=timeout)
    sec = time.perf_counter() - t0
    lines = proc.stdout.rstrip("\n").splitlines()
    for line in lines:
        print(f"example {label} | {line}")
    print(f"example {label} " + json.dumps(dict(exit=proc.returncode,
                                                seconds=sec)))
    if proc.returncode != 0:
        fail(f"example {label} exited {proc.returncode}: "
             f"{proc.stderr.strip()[-2000:]}")
    return lines, sec


def run_examples(ops, dev) -> dict:
    """Phase 20: the four DiT examples (``python -m
    repro_torch.examples.<name>``) as a user runs them, on the card, each
    a subprocess that must exit 0 and print the reference example's lines
    with finite numbers:

    * ``train_decentralized --full --experts 8 --ddpm-experts 2 --steps
      20 --batch 32``: the paper's 2 DDPM : 6 FM recipe at full DiT-B/2
      width (120.6 M parameters an expert), each expert trained alone on
      its cluster's stream, then the router, then the top-2 sampling
      report; run through ``runpy.run_module`` as ``-m`` runs it, which
      then prints the process's device peak (``PEAK_MAIN``);
    * its 8 checkpoints served at full width in this process through
      ``ServingEngine.from_checkpoint_dir`` (``router_b2(num_clusters=
      8)``): one batch-8, 8-step, CFG-7.5, top-2 request, finite, with
      exact launches (``expected_launches``);
    * ``serve_heterogeneous --ckpt <empty> --batch 8 --requests 3 --steps
      8``, which first trains its tiny ensemble through the port's
      ``train_decentralized`` as a subprocess, then once more over those
      checkpoints with ``--param-dtype int8 --dispatch grouped``;
      ``convert_checkpoint`` (its linear identity within 1e-5) and
      ``quickstart``, those three at once.
    Prints each run's seconds, the trainer's seconds a step per expert
    and the training run's peak.  Returns the served request's launches.
    """
    from repro_torch.core.sampling import SamplerConfig
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models.config import dit_b2, router_b2

    root = os.path.join(WORK, "examples")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    full = os.path.join(root, "full")
    lines, train_s = _run_example(
        "train_decentralized",
        [sys.executable, "-c", PEAK_MAIN,
         "repro_torch.examples.train_decentralized", *EXAMPLE_TRAIN,
         "--out", full], env)
    peak = int(lines.pop().split()[1])
    found = _check_lines("train_decentralized", lines, _train_lines(
        EXAMPLE_EXPERTS, EXAMPLE_DDPM, 32, "120.6", full))
    per_step = [float(m.group(2)) / EXAMPLE_STEPS
                for m in found[4:4 + EXAMPLE_EXPERTS]]
    print("example train_decentralized " + json.dumps(dict(
        experts=EXAMPLE_EXPERTS, ddpm=EXAMPLE_DDPM, steps=EXAMPLE_STEPS,
        batch=32, seconds=train_s, expert_step_s=per_step,
        images_per_s=32 / float(np.median(per_step)), peak_bytes=peak)))

    dit_cfg = dit_b2()
    router_cfg = router_b2(num_clusters=EXAMPLE_EXPERTS)
    gc.collect()
    base = _peak_reset(dev)
    t0 = time.perf_counter()
    engine = ServingEngine.from_checkpoint_dir(
        full, dit_cfg=dit_cfg, router_cfg=router_cfg,
        sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2),
        device=dev)
    _sync(dev)
    print("example checkpoints loaded " + json.dumps(dict(
        seconds=time.perf_counter() - t0,
        objectives=[e.objective for e in engine.experts])))
    mem = dict(base=base, resident=torch.cuda.memory_allocated() - base,
               load_peak=_peak(dev, base))
    text = _texts(dit_cfg, [BATCH], 61)[0]
    _, launches = serve_path(
        ops, engine, "examples_full_width", [text], [900],
        expected_launches(dit_cfg, router_cfg, ops, "native", True, 1), mem)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = os.path.join(root, "served")
    serve = [sys.executable, "-m", "repro_torch.examples.serve_heterogeneous",
             "--ckpt", ckpt, "--batch", "8", "--requests", "3", "--steps",
             "8"]
    runs = {"serve_heterogeneous": serve,
            "convert_checkpoint": [sys.executable, "-m",
                                   "repro_torch.examples.convert_checkpoint"],
            "quickstart": [sys.executable, "-m",
                           "repro_torch.examples.quickstart"]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    env=env, cwd=ROOT)
             for name, cmd in runs.items()}
    try:
        outs = {name: p.communicate(timeout=600) for name, p in
                procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for name, p in procs.items():
        out, err = outs[name]
        for line in out.rstrip("\n").splitlines():
            print(f"example {name} | {line}")
        if p.returncode != 0:
            fail(f"example {name} exited {p.returncode}: "
                 f"{err.strip()[-2000:]}")
    print("example three at once " + json.dumps(dict(
        seconds=time.perf_counter() - t0)))
    lines = outs["serve_heterogeneous"][0].rstrip("\n").splitlines()
    _check_lines("serve_heterogeneous", lines, [
        rf"no checkpoints under {re.escape(ckpt)} — training a tiny "
        r"ensemble first \.\.\."]
        + _train_lines(4, 2, 8, "1.0", ckpt)
        + _serve_lines("gathered", "native"))
    found = _check_lines(
        "convert_checkpoint",
        outs["convert_checkpoint"][0].rstrip("\n").splitlines(),
        CONVERT_LINES)
    identity = float(next(m for m in found if m.string.startswith(
        "  linear")).group(1))
    if identity > 1e-5:
        fail(f"convert_checkpoint: the linear identity errs by {identity}")
    _check_lines("quickstart",
                 outs["quickstart"][0].rstrip("\n").splitlines(),
                 QUICKSTART_LINES)
    lines, _ = _run_example("serve_heterogeneous int8 grouped",
                            serve + ["--param-dtype", "int8", "--dispatch",
                                     "grouped"], env)
    _check_lines("serve_heterogeneous int8 grouped", lines,
                 _serve_lines("grouped", "int8"))
    shutil.rmtree(root)
    return {"examples_full_width": launches}


# ---------------------------------------------------------------------------
# Phases 10-12: elastic membership, continuous batching, resilience
# ---------------------------------------------------------------------------

#: the continuous phase's traffic: batch sizes, one request every
#: ARRIVAL_EVERY ticks, each with text
ROLLING_BATCHES = (1, 2, 1, 4, 2, 1, 3, 2)
ARRIVAL_EVERY = 2


def _texts(cfg, batches, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, cfg.text_len, cfg.text_dim)).astype(
        np.float32) for b in batches]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak_reset(dev):
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()
    return 0


def _peak(dev, base):
    return (torch.cuda.max_memory_allocated() - base
            if dev.type == "cuda" else 0)


def _compare(label, got, want, tol_rel=E2E_REL_TOL, bitwise=False):
    """Print ``label``'s max |Δ| against ``want`` (and whether it is
    bitwise); fail past ``tol_rel · max|want|``, or on any difference
    with ``bitwise``."""
    err, scale = rel_err(got, want)
    print(f"{label} " + json.dumps(dict(
        max_abs_diff=err, bitwise=bool(torch.equal(got, want)),
        tol=0.0 if bitwise else tol_rel * scale, max_abs=scale)))
    finite = bool(torch.isfinite(got).all())
    if not finite or (bitwise and not torch.equal(got, want)) or \
            err > tol_rel * scale:
        fail(f"{label}: max |Δ| {err} (finite={finite})")
    return err


def serve_elastic(ops, engines, dev, path, dit_cfg, router_cfg) -> dict:
    """Phase 10: elastic membership at full width over the phase-4
    checkpoints (``path``), each path with the launch counts set to 0
    just before and read just after:

    * native and int8 engines at capacity 10 with the 8 experts loaded
      (``store`` lines: bytes, build and serving peaks);
    * all 8 live against the fixed-membership engine on the same noise
      (the reference claims bitwise; printed, held to ``E2E_REL_TOL``);
    * a request submitted, a slot it routes to evicted, then ``flush``:
      bitwise the ``generate`` run before the eviction;
    * ``add_expert`` of a ninth jittered checkpoint into slot 8 on both
      engines (the int8 slot's bytes and scales bitwise a store quantized
      from scratch; the add's device peak printed), one request each;
    * retire (DRAINING → EVICTED at ``flush``), quarantine, trip, restore;
    * a NaN-poisoned evicted slot: latents finite;
    * evicted down to 1 live slot under top-2: ``degraded_steps`` grows by
      8 a request;
    * a profiled elastic request (blocking copies against the fixed
      engine's);
    * one eviction mid-flight through a rolling batch: requests admitted
      before it resolve under their epoch (against ``generate`` before
      the eviction, within ``E2E_REL_TOL``), one admitted after under the
      new one.
    Returns the launches of each path."""
    from repro_torch.core import param_store
    from repro_torch.core.fusion import fusion_weights
    from repro_torch.core.sampling import _time_grid
    from repro_torch.launch import faults
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.training.checkpoint import (expert_metadata,
                                                 save_checkpoint)
    from repro_torch.tree import tree_leaves, tree_map

    joiner = os.path.join(path, "joiner", "expert8.npz")
    gen = torch.Generator(device=dev).manual_seed(21)
    save_checkpoint(joiner, jittered(dit_cfg, gen), metadata=expert_metadata(
        name="expert8", objective="fm", schedule="linear", cluster_id=3,
        arch=dit_cfg.name))
    fixed = engines["native"]
    sampler = fixed.sampler
    launches, el = {}, {}
    for name, pd in (("elastic_native", "native"), ("elastic_int8", "int8")):
        gc.collect()
        base = _peak_reset(dev)
        t0 = time.perf_counter()
        el[pd] = ServingEngine.from_checkpoint_dir(
            path, dit_cfg=dit_cfg, router_cfg=router_cfg, sampler=sampler,
            param_dtype=pd, capacity=10, device=dev)
        _sync(dev)
        print(f"{name} engine loaded in {time.perf_counter() - t0:.1f} s: "
              f"{el[pd].membership_line()}")
        mem = dict(base=base, resident=(torch.cuda.memory_allocated() - base
                                        if dev.type == "cuda" else 0),
                   load_peak=_peak(dev, base))
        text = _texts(dit_cfg, [BATCH], 31)[0]
        (out,), launches[name] = serve_path(
            ops, el[pd], name, [text], [700],
            expected_launches(dit_cfg, router_cfg, ops, pd, True, 1), mem)
        if pd == "native":
            _compare("elastic all-live vs fixed membership", out,
                     fixed.generate(700, text, BATCH))
    eng, eng8 = el["native"], el["int8"]

    # submit, evict a slot the request routes to, flush: its snapshot
    text = _texts(dit_cfg, [BATCH], 32)[0]
    before = eng.generate(701, text, BATCH)
    t_text = eng._cached_cond(text)
    noise = eng._noise(701, BATCH)
    t0 = _time_grid(STEPS)[0].to(dev).expand(BATCH)
    w = fusion_weights(eng.experts, eng.router_fn, noise, t0,
                       strategy="topk", top_k=2,
                       valid=eng.param_store.valid,
                       cluster_map=eng._cluster_map)
    routed = int(w.sum(dim=0).argmax())
    h = eng.submit(701, text)
    eng.evict_expert(routed)
    eng.flush()
    _compare(f"elastic submit, evict slot {routed}, flush vs generate "
             f"before", h.result(), before, bitwise=True)
    after = eng.generate(701, text, BATCH)
    print("elastic after eviction " + json.dumps(dict(
        max_abs_diff_vs_before=rel_err(after, before)[0])))
    del t_text

    # add a ninth expert into slot 8, both stores
    for name, e in (("elastic_native_add", eng), ("elastic_int8_add", eng8)):
        base = _peak_reset(dev)
        slot = e.add_expert(joiner, slot=8)
        add_peak = _peak(dev, base)
        (out,), launches[name] = serve_path(
            ops, e, name, [text], [702],
            expected_launches(dit_cfg, router_cfg, ops,
                              e.sampler.param_dtype, True, 1), None)
        print(f"{name} " + json.dumps(dict(
            slot=slot, add_peak_bytes=add_peak,
            store_bytes=e.param_store.nbytes(),
            membership=e.membership_line())))
    from repro_torch.training.checkpoint import load_checkpoint

    params, _ = load_checkpoint(joiner, device=dev)
    scratch = param_store.make_store(tree_map(lambda a: a[None], params),
                                     dtype="int8")
    slot_leaves = [a[8] for a in tree_leaves((eng8.param_store.qvals,
                                              eng8.param_store.scales))]
    same = all(torch.equal(a, b[0]) for a, b in zip(
        slot_leaves, tree_leaves((scratch.qvals, scratch.scales))))
    print("elastic int8 slot 8 vs quantized from scratch " + json.dumps(
        dict(leaves=len(slot_leaves), bitwise=same)))
    if not same:
        fail("the int8 slot written by add_expert differs from a store "
             "quantized from scratch")
    del eng8, el, scratch, params
    gc.collect()

    # retire, quarantine, trip, restore
    h = eng.submit(703, text)
    eng.retire_expert(5)
    draining = eng.expert_health[5]
    eng.flush()
    if not (draining == "DRAINING" and eng.expert_health[5] == "EVICTED"
            and bool(torch.isfinite(h.result()).all())):
        fail(f"retire: {draining} -> {eng.expert_health[5]}")
    eng.quarantine_expert(6, "chip smoke")
    eng.restore_expert(6)
    eng.trip_expert(7)
    eng.restore_expert(7)
    print(f"elastic lifecycle {eng.membership_line()} "
          f"health={eng.expert_health}")

    # a NaN-poisoned evicted slot never reaches the latents
    faults.poison_expert_runtime(eng, routed)
    out = eng.generate(704, text, BATCH)
    print("elastic poisoned evicted slot " + json.dumps(dict(
        slot=routed, finite=bool(torch.isfinite(out).all()),
        max_abs=out.abs().max().item())))
    if not bool(torch.isfinite(out).all()):
        fail("a poisoned evicted slot reached the latents")

    # a profiled elastic request
    profiled(lambda: eng.generate(200, text, BATCH), CATEGORIES,
             path="elastic_native", batch=BATCH, steps=STEPS,
             membership=eng.membership_line())

    # one eviction mid-flight through the rolling batch: requests
    # admitted before it resolve under their epoch
    from repro_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler(eng, max_resident=BATCH)
    early = _texts(dit_cfg, (2, 2), 43)
    want_early = [eng.generate(900 + i, t, 2) for i, t in enumerate(early)]
    hs = [sched.submit(900 + i, t) for i, t in enumerate(early)]
    sched.step()
    sched.step()
    victim = [i for i, hh in enumerate(eng.expert_health)
              if hh == "ACTIVE"][-1]
    eng.evict_expert(victim)
    late = _texts(dit_cfg, (2,), 44)[0]
    want_late = eng.generate(910, late, 2)
    hl = sched.submit(910, late)
    sched.run_until_idle()
    for i, (h, want) in enumerate(zip(hs, want_early)):
        _compare(f"rolling elastic admitted before evicting slot {victim} "
                 f"request {i}", h.result(), want)
    _compare("rolling elastic admitted after the eviction", hl.result(),
             want_late)
    print(f"rolling elastic {eng.membership_line()} "
          f"buckets_left={len(sched._buckets)}")

    # evict down to one live slot under top-2
    for s in [i for i, hh in enumerate(eng.expert_health)
              if hh == "ACTIVE"][1:]:
        eng.evict_expert(s)
    before = eng.stats["degraded_steps"]
    out = eng.generate(705, text, BATCH)
    grew = eng.stats["degraded_steps"] - before
    print(f"elastic degraded {eng.membership_line()} " + json.dumps(dict(
        degraded_steps_per_request=grew,
        finite=bool(torch.isfinite(out).all()))))
    if grew != STEPS or not bool(torch.isfinite(out).all()):
        fail(f"one live slot under top-2: degraded_steps grew by {grew}")
    return launches


def _rolling_run(sched, engine, cfg, texts, seeds):
    """Submit ``texts`` (one request every ``ARRIVAL_EVERY`` ticks) and
    tick until idle.  Returns the handles, the wall seconds, the ticks and
    the ``_advance`` calls (bucket ticks)."""
    advances = [0]
    real = sched._advance

    def advance(bucket):
        advances[0] += 1
        return real(bucket)

    sched._advance = advance
    _sync(engine.device)
    t0 = time.perf_counter()
    handles = []
    for seed, text in zip(seeds, texts):
        handles.append(sched.submit(seed, text))
        for _ in range(ARRIVAL_EVERY):
            sched.step()
    sched.run_until_idle()
    results = [h.result() for h in handles]
    _sync(engine.device)
    return handles, results, time.perf_counter() - t0, advances[0]


#: phase 11's run at ``steps_per_tick`` 1 (its latents and launches),
#: which phase 21's (1, 1) rolling case must equal bitwise
ROLLING_SPT1: dict = {}


def serve_continuous(ops, engines, dev, dit_cfg) -> dict:
    """Phase 11: continuous batching at full width on the native engine,
    each run with the launch counts set to 0 just before and read just
    after: requests of batch 1, 2, 1, 4, 2, 1, 3, 2 with text arriving
    every 2 ticks into a rolling batch of 8 —

    * ``steps_per_tick`` 1: each request against ``generate`` on the same
      noise and text (bitwise or within ``E2E_REL_TOL``, printed), exactly
      one ``hetero_fuse_step`` a bucket tick, img/s against one ``flush``
      of the same requests (its latents and launches kept in
      ``ROLLING_SPT1`` for phase 21);
    * ``steps_per_tick`` 2: two step launches a bucket tick, the latents
      against the run at 1 (other batch compositions; printed, held to
      ``E2E_REL_TOL``, bitwise where the forwards are row-independent);
    * plan reuse R 2: the router runs only on ticks where some row is at
      its refresh phase (counted, against the host mirror's count);
    * a profiled full tick (device busy, idle share, blocking copies;
      host seconds beside device ms).
    Returns the launches of each run."""
    from repro_torch.serving import ContinuousScheduler
    from repro_torch.serving.batch import advanced

    eng = engines["native"]
    texts = _texts(dit_cfg, ROLLING_BATCHES, 41)
    seeds = [800 + i for i in range(len(texts))]
    launches, runs = {}, {}
    for spt in (1, 2):
        sched = ContinuousScheduler(eng, max_resident=BATCH,
                                    steps_per_tick=spt)
        _sync(dev)
        ops.reset_launches()
        handles, outs, sec, adv = _rolling_run(sched, eng, dit_cfg, texts,
                                               seeds)
        name = f"rolling_spt{spt}"
        launches[name] = dict(ops.LAUNCHES)
        imgs = sum(ROLLING_BATCHES)
        print(f"{name} " + json.dumps(dict(
            requests=len(handles), images=imgs, ticks=sched.step_count,
            bucket_ticks=adv, seconds=sec, img_per_s=imgs / sec,
            launches=launches[name], line=sched.line())))
        if launches[name]["hetero_fuse_step"] != adv * spt or \
                any(h.state != "DONE" for h in handles):
            fail(f"{name}: {launches[name]['hetero_fuse_step']} step "
                 f"launches for {adv} bucket ticks of {spt} steps")
        runs[spt] = outs
    for i, (a, b) in enumerate(zip(runs[2], runs[1])):
        _compare(f"rolling steps_per_tick 2 vs 1 request {i}", a, b)
    bitwise = 0
    for i, (seed, text, got) in enumerate(zip(seeds, texts, runs[1])):
        want = eng.generate(seed, text, text.shape[0])
        err = _compare(f"rolling vs generate request {i} batch "
                       f"{text.shape[0]}", got, want)
        bitwise += err == 0.0
    print("rolling vs generate " + json.dumps(dict(
        requests=len(texts), bitwise=bitwise)))
    # which layer depends on the batch: the router posterior of one row
    # alone against the same row in a batch of 8 (its GEMMs run M = 256
    # and 2048 rows)
    from repro_torch.core.sampling import _time_grid

    x8 = eng._noise(850, BATCH)
    t8 = _time_grid(STEPS)[0].to(dev).expand(BATCH)
    p8 = eng.router_fn(x8, t8)
    p1 = eng.router_fn(x8[:1], t8[:1])
    print("router row 0 alone vs in a batch of 8 " + json.dumps(dict(
        max_abs_diff=rel_err(p1, p8[:1])[0],
        bitwise=bool(torch.equal(p1, p8[:1])))))

    # the same requests through one lockstep flush
    _sync(dev)
    t0 = time.perf_counter()
    handles = [eng.submit(s, t) for s, t in zip(seeds, texts)]
    eng.flush()
    [h.result() for h in handles]
    _sync(dev)
    sec = time.perf_counter() - t0
    print("flush of the same requests " + json.dumps(dict(
        images=sum(ROLLING_BATCHES), seconds=sec,
        img_per_s=sum(ROLLING_BATCHES) / sec)))

    # plan reuse R 2: the router only on ticks where some row refreshes
    base = eng.sampler
    real_router = eng.router_fn
    calls = [0]

    def router(x, t):
        calls[0] += 1
        return real_router(x, t)

    eng.sampler = dataclasses.replace(base, plan_refresh_every=2)
    eng.router_fn = router
    try:
        sched = ContinuousScheduler(eng, max_resident=BATCH)
        want_calls = [0]
        real_adv = sched._advance

        def advance(bucket):
            t = bucket.t_host
            want_calls[0] += bool(((t < STEPS) & (t % 2 == 0)).any())
            return real_adv(bucket)

        sched._advance = advance
        ops.reset_launches()
        handles, _, sec, adv = _rolling_run(sched, eng, dit_cfg, texts,
                                            seeds)
        launches["rolling_R2"] = dict(ops.LAUNCHES)
    finally:
        eng.sampler, eng.router_fn = base, real_router
    print("rolling_R2 " + json.dumps(dict(
        bucket_ticks=adv, router_calls=calls[0],
        router_calls_expected=want_calls[0], seconds=sec,
        launches=launches["rolling_R2"])))
    if calls[0] != want_calls[0] or calls[0] >= adv:
        fail(f"rolling R 2: {calls[0]} router calls, expected "
             f"{want_calls[0]} of {adv} ticks")

    # a profiled full tick: 8 rows resident in flight
    sched = ContinuousScheduler(eng, max_resident=BATCH)
    for seed, text in zip(seeds[:4], _texts(dit_cfg, (2, 2, 2, 2), 42)):
        sched.submit(seed, text)
    sched.step()
    sched.step()
    _sync(dev)
    t0 = time.perf_counter()
    sched.step()
    host_s = time.perf_counter() - t0
    _sync(dev)
    synced_s = time.perf_counter() - t0
    profiled(sched.step, CATEGORIES, path="rolling_tick", rows=BATCH,
             unprofiled_tick_host_s=host_s,
             unprofiled_tick_synced_s=synced_s)
    sched.run_until_idle()

    ROLLING_SPT1.update(outs=runs[1], launches=launches["rolling_spt1"])
    return launches


def serve_resilience(ops, engines, dev, path, dit_cfg, router_cfg) -> dict:
    """Phase 12: the resilience layer at full width on the native engine,
    and a short chaos soak on the closed-form toy ensemble:

    * a watchdog trip, with the tick budget set to a quarter of a
      measured tick: the request is re-queued, then FAILED;
    * a breaker trip from a NaN-poisoned slot on a capacity-10 engine:
      the request re-queues under a fresh snapshot and resolves finite;
      the slot is healed, a canary probe passes and restores it;
    * an expired deadline (``max_steps`` 2);
    * kill-and-restore from a journal under ``build/chip_smoke/``: the
      restored continuation bitwise an uninterrupted twin's;
    * ``launch.chaos.run_soak`` for 60 ticks, its verdict printed.
    Returns the launches of the kill-and-restore continuation."""
    from repro_torch.core.fusion import fusion_weights
    from repro_torch.core.sampling import _time_grid
    from repro_torch.launch import chaos, faults
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.serving import (ContinuousScheduler, ResiliencePolicy,
                                     ResilientScheduler)

    eng = engines["native"]
    text = _texts(dit_cfg, [1], 51)[0]

    # the watchdog: a budget a quarter of a measured tick
    probe = ContinuousScheduler(eng, max_resident=BATCH)
    probe.submit(1000, text)
    probe.step()
    _sync(dev)
    t0 = time.perf_counter()
    probe.step()
    tick_s = time.perf_counter() - t0
    probe.run_until_idle()
    sched = ResilientScheduler(
        eng, max_resident=BATCH,
        policy=ResiliencePolicy(tick_budget_s=tick_s / 4))
    before = dict(eng.stats)
    h = sched.submit(1001, text)
    for _ in range(8):
        sched.step()
        if h.state == "FAILED":
            break
    trips = eng.stats["watchdog_trips"] - before["watchdog_trips"]
    print("watchdog " + json.dumps(dict(
        tick_s=tick_s, budget_s=tick_s / 4, trips=trips, state=h.state,
        requeues=h.requeues)))
    if trips < 1 or h.state != "FAILED":
        fail(f"watchdog: {trips} trips, request {h.state}")

    # an expired deadline
    sched = ResilientScheduler(eng, max_resident=BATCH)
    h = sched.submit(1002, text, max_steps=2)
    sched.run_until_idle()
    print("rolling deadline " + json.dumps(dict(
        state=h.state, error=str(h.error))))
    if h.state != "DEADLINE_EXCEEDED":
        fail(f"max_steps 2 resolved {h.state}")

    # the breaker: poison a slot the request routes to, trip, heal, probe
    el = ServingEngine.from_checkpoint_dir(
        path, dit_cfg=dit_cfg, router_cfg=router_cfg,
        sampler=eng.sampler, capacity=10, device=dev)
    noise = el._noise(1003, 2)
    w = fusion_weights(el.experts, el.router_fn, noise,
                       _time_grid(STEPS)[0].to(dev).expand(2),
                       strategy="topk", top_k=2, valid=el.param_store.valid,
                       cluster_map=el._cluster_map)
    victim = int(w.sum(dim=0).argmax())
    sched = ResilientScheduler(el, max_resident=BATCH,
                               policy=ResiliencePolicy(probe_base_ticks=1))
    clean = faults.poison_expert_runtime(el, victim)
    h = sched.submit(1003, _texts(dit_cfg, [2], 52)[0])
    for _ in range(STEPS + 1):
        sched.step()
    tripped = el.expert_health[victim]
    sched.run_until_idle()
    faults.heal_expert_runtime(el, victim, clean)
    for _ in range(40):
        sched.step()
        if el.expert_health[victim] == "ACTIVE" and not sched.breaker.probation:
            break
    print("breaker " + json.dumps(dict(
        slot=victim, tripped_to=tripped, request=h.state,
        requeues=h.requeues, finite=bool(torch.isfinite(h.result()).all()),
        restored_to=el.expert_health[victim])) + " " + el.membership_line())
    if not (tripped == "PROBATION" and h.state == "DONE"
            and el.expert_health[victim] == "ACTIVE"
            and el.stats["breaker_restores"] >= 1):
        fail("the breaker cycle trip -> probe -> restore did not complete")
    del el, clean, sched
    gc.collect()

    # kill and restore from a journal
    journal = os.path.join(WORK, "journal")
    shutil.rmtree(journal, ignore_errors=True)
    texts = _texts(dit_cfg, (1, 2, 1), 53)

    def traffic(s):
        return [s.submit(1100 + i, t) for i, t in enumerate(texts)]

    dead = ResilientScheduler(eng, max_resident=BATCH, journal_dir=journal)
    traffic(dead)
    for _ in range(3):
        dead.step()
    dead.journal.close()
    del dead                                   # the crash: no drain
    twin = ResilientScheduler(eng, max_resident=BATCH)
    want = traffic(twin)
    twin.run_until_idle()
    ops.reset_launches()
    restored = eng.restore(journal)
    got = {r.seq: r for b in restored._buckets.values()
           for r in b.resident_requests()}
    got.update({r.seq: r for r in restored._queue})
    restored.run_until_idle()
    launches = {"journal_restore": dict(ops.LAUNCHES)}
    same = [torch.equal(got[s].result(), w.result())
            for s, w in zip(sorted(got), want)]
    print("kill and restore " + json.dumps(dict(
        killed_at_tick=3, requests=len(got), bitwise=same,
        launches=launches["journal_restore"])))
    if len(same) != len(texts) or not all(same):
        fail(f"journal restore differs from the uninterrupted twin: {same}")
    shutil.rmtree(journal)

    # a short chaos soak on the toy ensemble
    soak_dir = os.path.join(WORK, "soak")
    verdict = chaos.run_soak(60, 0, soak_dir, device=dev)
    print("chaos soak " + json.dumps(verdict))
    shutil.rmtree(soak_dir)
    return launches


# ---------------------------------------------------------------------------
# Phase 21: the expert/data mesh (ROADMAP A.8)
# ---------------------------------------------------------------------------

#: phase 21's two-rank cases: (label, (expert shards, data shards),
#: param_dtype) — the ranks share cuda:0 over gloo
MESH_CASES = (("mesh_2x1", (2, 1), "native"),
              ("mesh_2x1_int8", (2, 1), "int8"),
              ("mesh_1x2", (1, 2), "native"))
#: phase 21's request: one batch-8, 8-step, CFG-7.5, top-2 request
MESH_SEED, MESH_TEXT_SEED = 800, 41
#: the CLI under torchrun (two ranks on the card over gloo, at the
#: reference CLI's reduced width over phase 9's checkpoints)
MESH_CLI = ["--backend", "gloo", "--expert-shards", "2", "--coalesce",
            "--batch", "3", "--requests", "2", "--steps", "4"]
#: the same under ``--continuous``, journaled (the resilient scheduler)
MESH_CLI_ROLLING = ["--backend", "gloo", "--expert-shards", "2",
                    "--continuous", "--batch", "3", "--requests", "2",
                    "--steps", "4", "--arrival-every", "1"]
#: phase 21's rolling cases: three staggered requests (batch 1, 2, 1;
#: text from seed 43, noise seeds 810, 811, 812) into a rolling batch of 8
MESH_ROLLING, MESH_ROLLING_TEXT_SEED, MESH_ROLLING_SEED = (1, 2, 1), 43, 810


def _mesh_rolling(ops, eng, cfg, batches=MESH_ROLLING,
                  text_seed=MESH_ROLLING_TEXT_SEED,
                  seed=MESH_ROLLING_SEED) -> tuple[list, dict]:
    """Requests of ``batches`` through a ``ContinuousScheduler`` of 8 rows
    on ``eng`` (phase 11's ``_rolling_run``), the launch and pair counts
    set to 0 just before and read just after: the latents and a row of
    seconds a request, ticks, store bytes, launches, pairs and, on a
    mesh, the host agreements and joins a tick."""
    from repro_torch.serving import ContinuousScheduler

    texts = _texts(cfg, batches, text_seed)
    seeds = [seed + i for i in range(len(texts))]
    sched = ContinuousScheduler(eng, max_resident=BATCH)
    before = dict(eng.mesh.counts) if eng.mesh is not None else {}
    ops.reset_launches()
    handles, outs, sec, adv = _rolling_run(sched, eng, cfg, texts, seeds)
    row = dict(requests=len(outs), images=sum(batches),
               ticks=sched.step_count, bucket_ticks=adv, seconds=sec,
               seconds_per_request=sec / len(outs),
               store_bytes=eng.param_store.nbytes(),
               launches=dict(ops.LAUNCHES), pairs=dict(ops.RAGGED_PAIRS))
    for key, n in before.items():
        row[f"{key}_per_tick"] = (eng.mesh.counts[key] - n) / sched.step_count
    if any(h.state != "DONE" for h in handles):
        fail(f"rolling on {eng.mesh and eng.mesh.shape}: "
             f"{[h.state for h in handles]}")
    return outs, row


def _mesh_requests(ops, eng, text) -> tuple:
    """Phase 21's request, served twice (the first pays the process's
    first collectives): the first latents, each request's seconds, and
    the second's launches and pairs (counts set to 0 just before it)."""
    outs, seconds = [], []
    for _ in range(2):
        ops.reset_launches()
        t0 = time.perf_counter()
        outs.append(eng.generate(MESH_SEED, text, BATCH))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return outs[0], seconds, dict(ops.LAUNCHES), dict(ops.RAGGED_PAIRS)


def _mesh_rank(rank: int, world: int, job: dict) -> None:
    """One rank of phase 21's case (b).  The phase-4 checkpoints load once
    onto the host (``from_checkpoint_dir(device="cpu")``: the checks, the
    specs, the experts' parameters) and the router onto the card; each
    case's engine is built from them on its mesh (only the resident
    slice reaches the card), then serves one request and the rolling case
    (``_mesh_rolling``) with the launch and pair counts set to 0 just
    before each and read just after; on ``(2, 1)`` native also the
    resilient case (``kill_and_restore``: rank 0 journals, every rank
    restores after 3 ticks); after the cases, the reference engine on
    ``(2, 1)`` serves phase 21's request.  Everything is written to
    ``job["out"]`` for the parent to check."""
    from repro_torch.launch.sharded_parity import kill_and_restore
    from repro_torch.core.sampling import SamplerConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import dit as D
    from repro_torch.models.config import dit_b2, router_b2
    from repro_torch.training.checkpoint import load_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dit_b2()
    text = _texts(cfg, [BATCH], MESH_TEXT_SEED)[0]
    t0 = time.perf_counter()
    host = ServingEngine.from_checkpoint_dir(job["path"], dit_cfg=cfg,
                                             device="cpu")
    experts, params = host.experts, host.expert_params
    del host
    router_fn = D.make_router_fn(
        router_b2(num_clusters=len(MIX)),
        load_checkpoint(os.path.join(job["path"], "router.npz"),
                        device=dev)[0])
    host_load_s = time.perf_counter() - t0
    for label, (e, d), pd in MESH_CASES:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng = ServingEngine(
            experts=experts, expert_params=params, router_fn=router_fn,
            latent_shape=(cfg.latent_size, cfg.latent_size,
                          cfg.latent_channels),
            sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2,
                                  param_dtype=pd),
            device=dev, n_expert_shards=e, n_data_shards=d,
            dist_backend="gloo")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        out, seconds, launches, pairs = _mesh_requests(ops, eng, text)
        np.save(os.path.join(job["out"], f"{label}_rank{rank}.npy"),
                out.cpu().numpy())
        with open(os.path.join(job["out"], f"{label}_rank{rank}.json"),
                  "w") as f:
            json.dump(dict(
                case=label, rank=rank, mesh={"expert": e, "data": d},
                param_dtype=pd, backend=eng.mesh.backend,
                expert_range=list(eng.mesh.expert_range(len(eng.experts))),
                host_load_seconds=host_load_s, build_seconds=load_s,
                request_seconds=seconds,
                store_bytes=eng.param_store.nbytes(),
                resident_bytes=torch.cuda.memory_allocated(),
                serve_peak_bytes=torch.cuda.max_memory_allocated(),
                launches=launches, pairs=pairs), f)
        rolled, row = _mesh_rolling(ops, eng, cfg)
        _save_rank(job["out"], f"{label}_rolling", rank, rolled,
                   dict(row, case=label, rank=rank))
        if label == "mesh_2x1":
            texts = _texts(cfg, MESH_ROLLING, MESH_ROLLING_TEXT_SEED)
            reqs = [dict(seed=MESH_ROLLING_SEED + i, text=t)
                    for i, t in enumerate(texts)]
            t0 = time.perf_counter()
            got, twin = kill_and_restore(
                eng, reqs, os.path.join(job["out"], "journal_2x1"),
                kill_at=3, max_resident=BATCH)
            sec = time.perf_counter() - t0
            same = [bool(torch.equal(a, b)) for a, b in zip(got, twin)]
            if len(got) != len(reqs) or not all(same):
                raise AssertionError(
                    f"restore on (2, 1) rank {rank}: {same}")
            _save_rank(job["out"], "mesh_2x1_restore", rank, got, dict(
                case="mesh_2x1_restore", rank=rank, killed_at_tick=3,
                seconds=sec, bitwise_twin=same))
        del eng, out
    # the reference engine on the expert split
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = ServingEngine(
        experts=experts, expert_params=params, router_fn=router_fn,
        latent_shape=(cfg.latent_size, cfg.latent_size,
                      cfg.latent_channels),
        sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2),
        engine="reference", device=dev, n_expert_shards=2, n_data_shards=1,
        dist_backend="gloo")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(MESH_SEED, text, BATCH)
    torch.cuda.synchronize()
    _save_rank(job["out"], "mesh_reference_2x1", rank, [out], dict(
        case="mesh_reference_2x1", rank=rank, build_seconds=load_s,
        request_seconds=time.perf_counter() - t0,
        store_bytes=eng.param_store.nbytes(),
        launches=dict(ops.LAUNCHES), joins=eng.mesh.counts["joins"]))


def _save_rank(out_dir, label, rank, outs, row) -> None:
    """A rank's latents (``<label>_rank<r>.npz``, ``out_<i>``) and row
    (``….json``)."""
    stem = os.path.join(out_dir, f"{label}_rank{rank}")
    np.savez(stem + ".npz", **{f"out_{i}": o.cpu().numpy()
                               for i, o in enumerate(outs)})
    with open(stem + ".json", "w") as f:
        json.dump(row, f)


def _load_ranks(out_dir, label, dev) -> list:
    """Both ranks' ``(latents, row)`` of ``_save_rank``."""
    ranks = []
    for rank in range(2):
        stem = os.path.join(out_dir, f"{label}_rank{rank}")
        with np.load(stem + ".npz") as z:
            outs = [torch.from_numpy(z[f"out_{i}"]).to(dev)
                    for i in range(len(z.files))]
        with open(stem + ".json") as f:
            ranks.append((outs, json.load(f)))
    return ranks


def serve_mesh(ops, engines, dev, path, dit_cfg) -> dict:
    """Phase 21: the ensemble served on ``("expert", "data")`` meshes of
    ``torch.distributed`` ranks, over the phase-4 checkpoints (``path``),
    one batch-8, 8-step, CFG-7.5, top-2 request a case:

    (a) one rank, NCCL, mesh ``(1, 1)`` in this process, built from the
        native engine's experts: latents and launches bitwise the
        unsharded native engine's on the same request;
    (b) two ranks sharing ``cuda:0`` over gloo (NCCL refuses two ranks on
        one card): ``(2, 1)`` native and int8, ``(1, 2)`` native, each
        rank's whole batch within ``1e-5 · max |latent|`` of the unsharded
        engine on the card, each ``(2, 1)`` rank's store half of the
        whole (the int8 scales with their leaves), the ranks'
        ``ragged_gemm`` pairs summing to the unsharded request's;
    (c) the serving CLI under ``torchrun --standalone --nproc-per-node 2``
        with ``--backend gloo --expert-shards 2 --coalesce`` at latent 8
        over phase 9's checkpoints: exit 0 and the reference's
        ``mesh={'expert': 2, 'data': 1}``; and the same with
        ``--continuous --journal-dir`` (the resilient scheduler).

    The rolling cases (A.8b's serving remainder), ``mesh rolling`` lines:
    (a) on the ``(1, 1)`` mesh phase 11's staggered requests, latents and
    launches bitwise phase 11's unsharded rolling run; (b) in each case's
    engine three staggered requests (batch 1, 2, 1) into a rolling batch
    of 8, each rank's whole requests within ``1e-5 · max |latent|`` of the
    unsharded rolling run on the card and bitwise equal across ranks, the
    ranks' pairs summing to its pairs; on ``(2, 1)`` the resilient
    scheduler killed after 3 ticks and restored on both ranks from rank
    0's journal (bitwise its uninterrupted twin on each rank); and the
    reference engine on ``(2, 1)`` against the unsharded reference engine
    on the card.

    Each case serves the request twice and prints both seconds (the first
    pays the first collectives and, in (b), the process's start); the
    second request's launches and pairs are counted.  The seconds are a
    record, not a measure of sharding: the two ranks share one card, and
    gloo moves the collectives through the host.  Returns the launches
    of (a) and, per rank, of (b)'s rolling and reference cases."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models.config import dit_b2 as _dit_b2
    from repro_torch.models.config import router_b2 as _router_b2

    out_dir = os.path.join(WORK, "mesh")
    cli_dir = os.path.join(WORK, "mesh_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    write_ensemble(cli_dir, _dit_b2().reduced(latent_size=8),
                   _router_b2(num_clusters=len(MIX)).reduced(latent_size=8),
                   dev, seed=13)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    journal = os.path.join(WORK, "mesh_cli_journal")
    shutil.rmtree(journal, ignore_errors=True)
    clis = {
        tuple(argv): subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
             "--ckpt-dir", cli_dir, *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
        for argv in (MESH_CLI,
                     MESH_CLI_ROLLING + ["--journal-dir", journal])}
    launches = {}
    try:
        text = _texts(dit_cfg, [BATCH], MESH_TEXT_SEED)[0]
        want, want_launches, want_pairs = {}, {}, {}
        want_roll, want_roll_row = {}, {}
        for pd in ("native", "int8"):
            ops.reset_launches()
            want[pd] = engines[pd].generate(MESH_SEED, text, BATCH)
            torch.cuda.synchronize()
            want_launches[pd] = dict(ops.LAUNCHES)
            want_pairs[pd] = dict(ops.RAGGED_PAIRS)
            want_roll[pd], want_roll_row[pd] = _mesh_rolling(
                ops, engines[pd], dit_cfg)
            print(f"mesh rolling unsharded_{pd} "
                  + json.dumps(want_roll_row[pd]))
        native = engines["native"]
        mode, native.engine = native.engine, "reference"
        try:
            ops.reset_launches()
            t0 = time.perf_counter()
            want_ref = native.generate(MESH_SEED, text, BATCH)
            torch.cuda.synchronize()
            print("mesh reference unsharded " + json.dumps(dict(
                request_seconds=time.perf_counter() - t0,
                launches=dict(ops.LAUNCHES))))
        finally:
            native.engine = mode

        # (a) one rank, NCCL, built from the native engine's experts
        native = engines["native"]
        started = not dist.is_initialized()
        try:
            base = _peak_reset(dev)
            t0 = time.perf_counter()
            eng = ServingEngine(
                experts=native.experts, expert_params=native.expert_params,
                router_fn=native.router_fn, latent_shape=native.latent_shape,
                sampler=native.sampler, device=dev, n_expert_shards=1,
                n_data_shards=1, dist_backend="nccl")
            _sync(dev)
            load_s = time.perf_counter() - t0
            resident = torch.cuda.memory_allocated() - base
            got, seconds, launches, pairs = _mesh_requests(ops, eng, text)
            print("mesh case " + json.dumps(dict(
                case="mesh_1x1_nccl", rank=0, mesh=eng.mesh.shape,
                backend=eng.mesh.backend, build_seconds=load_s,
                request_seconds=seconds,
                store_bytes=eng.param_store.nbytes(),
                resident_bytes=resident, serve_peak_bytes=_peak(dev, base),
                launches=launches, pairs=pairs)))
            _compare("mesh_1x1_nccl vs unsharded", got, want["native"],
                     bitwise=True)
            if launches != want_launches["native"]:
                fail(f"the (1, 1) mesh launched {launches}, the unsharded "
                     f"engine {want_launches['native']}")
            launches = {"mesh_1x1_nccl": launches}
            # phase 11's staggered requests on the (1, 1) mesh
            rolled, row = _mesh_rolling(ops, eng, dit_cfg, ROLLING_BATCHES,
                                        41, 800)
            print("mesh rolling rolling_1x1_nccl " + json.dumps(row))
            for i, (a, b) in enumerate(zip(rolled, ROLLING_SPT1["outs"])):
                _compare(f"rolling_1x1_nccl request {i} vs phase 11", a, b,
                         bitwise=True)
            if row["launches"] != ROLLING_SPT1["launches"]:
                fail(f"the (1, 1) rolling run launched {row['launches']}, "
                     f"phase 11's {ROLLING_SPT1['launches']}")
            launches["mesh_rolling_1x1_nccl"] = row["launches"]
            del eng, got, rolled
        finally:
            if started and dist.is_initialized():
                dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()

        # (b) two ranks sharing the card over gloo
        t0 = time.perf_counter()
        spawn(_mesh_rank, 2, dict(path=path, out=out_dir), backend="gloo",
              device="cuda")
        print(f"mesh two-rank spawn {time.perf_counter() - t0:.1f} s")
        for label, (e, d), pd in MESH_CASES:
            rows = []
            for rank in range(2):
                with open(os.path.join(out_dir,
                                       f"{label}_rank{rank}.json")) as f:
                    row = json.load(f)
                got = torch.from_numpy(np.load(os.path.join(
                    out_dir, f"{label}_rank{rank}.npy"))).to(dev)
                whole = engines[pd].param_store.nbytes()
                row["whole_store_bytes"] = whole
                print("mesh case " + json.dumps(row))
                _compare(f"{label} rank {rank} vs unsharded", got, want[pd],
                         tol_rel=GEMM_REL_TOL)
                if row["store_bytes"] * e != whole:
                    fail(f"{label} rank {rank} holds {row['store_bytes']} "
                         f"store bytes of {whole} on {e} expert shards")
                rows.append(row)
            for name in want_pairs[pd]:
                total = sum(r["pairs"][name] for r in rows)
                if total != want_pairs[pd][name]:
                    fail(f"{label}: the ranks' {name} pairs sum to {total}, "
                         f"the unsharded request's {want_pairs[pd][name]}")
            print(f"{label} pairs " + json.dumps(dict(
                ranks=[r["pairs"] for r in rows],
                unsharded=want_pairs[pd])))

            # the rolling case of the same engines
            ranks = _load_ranks(out_dir, f"{label}_rolling", dev)
            for outs, row in ranks:
                launches[f"{label}_rolling_rank{row['rank']}"] = \
                    row["launches"]
                bitwise = [bool(torch.equal(a, b))
                           for a, b in zip(outs, want_roll[pd])]
                print(f"mesh rolling {label} " + json.dumps(dict(
                    row, bitwise_unsharded=bitwise,
                    unsharded_seconds_per_request=want_roll_row[pd][
                        "seconds_per_request"])))
                for i, (a, b) in enumerate(zip(outs, want_roll[pd])):
                    _compare(f"{label} rolling rank {row['rank']} request "
                             f"{i} vs unsharded", a, b, tol_rel=GEMM_REL_TOL)
            if not all(torch.equal(a, b) for a, b in zip(ranks[0][0],
                                                         ranks[1][0])):
                fail(f"{label} rolling: the ranks' requests differ")
            for name, n in want_roll_row[pd]["pairs"].items():
                total = sum(row["pairs"][name] for _, row in ranks)
                if total != n:
                    fail(f"{label} rolling: the ranks' {name} pairs sum to "
                         f"{total}, the unsharded run's {n}")
            print(f"mesh rolling {label} pairs " + json.dumps(dict(
                ranks=[row["pairs"] for _, row in ranks],
                unsharded=want_roll_row[pd]["pairs"])))

        # the resilient case: rank 0's journal, restored on both ranks
        ranks = _load_ranks(out_dir, "mesh_2x1_restore", dev)
        with open(os.path.join(out_dir, "journal_2x1",
                               "journal.jsonl")) as f:
            events = [json.loads(line)["ev"] for line in f]
        for outs, row in ranks:
            print("mesh rolling mesh_2x1_restore " + json.dumps(dict(
                row, journal_opens=events.count("open"),
                journal_records=len(events))))
            for i, (a, b) in enumerate(zip(outs, want_roll["native"])):
                _compare(f"mesh_2x1_restore rank {row['rank']} request {i} "
                         f"vs unsharded", a, b)
        if events.count("open") != 2 or "restored" not in events or not \
                all(torch.equal(a, b) for a, b in zip(ranks[0][0],
                                                      ranks[1][0])):
            fail(f"restore on (2, 1): journal {events}")

        # the reference engine on the expert split
        ranks = _load_ranks(out_dir, "mesh_reference_2x1", dev)
        for outs, row in ranks:
            launches[f"mesh_reference_2x1_rank{row['rank']}"] = \
                row["launches"]
            print("mesh rolling mesh_reference_2x1 " + json.dumps(dict(
                row, bitwise_unsharded=bool(torch.equal(outs[0],
                                                        want_ref)))))
            _compare(f"mesh_reference_2x1 rank {row['rank']} vs unsharded",
                     outs[0], want_ref, tol_rel=GEMM_REL_TOL)
        if not torch.equal(ranks[0][0][0], ranks[1][0][0]):
            fail("mesh_reference_2x1: the ranks' latents differ")

        # (c) the CLI under torchrun
        for argv, cli in clis.items():
            cli_out, cli_err = cli.communicate(timeout=300)
            for line in cli_out.strip().splitlines():
                print(f"cli torchrun {' '.join(argv)} | {line}")
            done = ("continuous 2 requests in " if "--continuous" in argv
                    else "coalesced 2 requests -> 1 dispatch(es)")
            if cli.returncode != 0 or "mesh={'expert': 2, 'data': 1}" \
                    not in cli_out or done not in cli_out:
                fail(f"the serving CLI under torchrun exited "
                     f"{cli.returncode}: {cli_err.strip()[-3000:]}")
    finally:
        for cli in clis.values():
            cli.kill()
        shutil.rmtree(cli_dir, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(journal, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 13 (and phase 6's training rows): training on the card
# ---------------------------------------------------------------------------

TRAIN_STEPS = 20
#: the first step's gradients on the kernel path against the same step
#: through the plain versions on the card, per leaf as a share of the
#: leaf's max |plain gradient|: float32 chains through 12 layers whose
#: LayerNorm and attention kernels each differ from their plain versions
#: by ≤ 1e-5 (phase 3); a missing or wrong gradient path errs by ~1.
TRAIN_GRAD_REL_TOL = 1e-3
#: phase 6's training rows, GPU vs CPU, two reduced layers: the loss,
#: each gradient leaf (share of its max), and the parameters after one
#: AdamW step: within ``param`` of the leaf's max plus a hundredth of the
#: step where the gradient is clear of the gradient tolerance, and within
#: two steps everywhere — Adam's first step is ``lr·g/(|g| + ε)``, so an
#: entry whose gradient is zero to within rounding may step either way.
TRAIN_E2E = dict(loss=1e-5, grad=1e-4, param=1e-5)
TRAIN_LR = 1e-4
_PLAIN_WRAPPERS = ("adaln_modulate", "layernorm", "flash_attention")


#: a training step's kernel-name fragments -> category, first match wins
TRAIN_CATEGORIES = (
    ("adaln_fuse_bwd", "adaln_fuse_bwd (every LayerNorm's backward)"),
    ("adaln_fuse", "adaln_fuse (forward)"),
    ("flash_attention_bwd_delta", "flash_attention_bwd Δ"),
    ("flash_attention_bwd_dkdv_wgmma", "flash_attention_bwd dK/dV kernel "
                                       "(wgmma)"),
    ("flash_attention_bwd_dq_wgmma", "flash_attention_bwd dQ kernel "
                                     "(wgmma)"),
    ("flash_attention_bwd_tile", "flash_attention_bwd dK, dV and dQ shares"),
    ("flash_attention_bwd_dq_sum", "flash_attention_bwd dQ sum"),
    ("flash_attention", "flash_attention (forward, with log-sum-exp)"),
    ("gemm", "cuBLAS float32 GEMM (dense layers forward and backward)"),
    ("nvjet", "cuBLAS float32 GEMM (dense layers forward and backward)"),
    ("softmax", "softmax"),
    ("reduce", "reductions (loss, global norm, bias and mean grads)"),
    ("elementwise", "elementwise (AdamW, EMA, activations, residuals)"),
    ("index", "gathers and scatters (timestep table, drop mask)"),
    ("scatter", "gathers and scatters (timestep table, drop mask)"),
    ("Memcpy", "copies"),
    ("Memset", "sets"),
)


def _plain_ops(ops, ref):
    """The three differentiable wrappers as their plain versions, on any
    device (the reference path of phase 13's gradient check)."""
    def adaln_modulate(x, gamma, beta, *, eps=1e-6, round_scale=False):
        return ref.ref_adaln_fuse(x, gamma, beta, eps,
                                  round_scale=round_scale)

    def layernorm(x, *, eps=1e-6):
        return ref.ref_adaln_fuse(x, None, None, eps)

    def flash_attention(q, k, v, *, causal=True, window=0,
                        softmax_scale=None, prefix_len=0):
        rep = q.shape[1] // k.shape[1]     # GQA: repeat the kv heads
        return ref.ref_flash_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
            causal=causal, window=window, softmax_scale=softmax_scale,
            prefix_len=prefix_len)
    return dict(adaln_modulate=adaln_modulate, layernorm=layernorm,
                flash_attention=flash_attention)


def _train_launches(cfg) -> dict:
    """The kernel launches of one dense training step, forward and
    backward alike: (3L + 1) AdaLN launches with text (msa, the LayerNorm
    before cross-attention, mlp, the final layer), 2L for the router; 2L
    attention launches with text (self- and cross-attention), L for the
    router."""
    layers = cfg.num_layers
    ln = 2 * layers if cfg.num_classes else 3 * layers + 1
    attn = layers if cfg.num_classes else 2 * layers
    return dict(adaln_fuse=ln, adaln_fuse_bwd=ln, flash_attention=attn,
                flash_attention_bwd=attn)


def _fixed_loss(trainer, params, draws, batch, router: bool) -> float:
    """The loss of ``params`` on one fixed batch with fixed draws (no
    grad): what the 'losses fall' check compares before and after."""
    with torch.no_grad():
        if router:
            return trainer.loss(params, draws, batch["latents"],
                                batch["cluster"])[0].item()
        return trainer.loss(params, draws, batch["latents"],
                            batch["text_emb"]).item()


def _grad_check(ops, ref, label, trainer, params, draws, batch, router):
    """The first step's gradients through the kernels and through the
    plain versions, both on the card: every leaf within
    ``TRAIN_GRAD_REL_TOL`` of the plain one's max, and non-zero wherever
    the plain path's is."""
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree import tree_leaves

    if router:
        def loss(p):
            return trainer.loss(p, draws, batch["latents"], batch["cluster"])
    else:
        def loss(p):
            return trainer.loss(p, draws, batch["latents"], batch["text_emb"])
    got_loss, got = value_and_grad(loss, params, has_aux=router)
    saved = {n: getattr(ops, n) for n in _PLAIN_WRAPPERS}
    try:
        for name, fn in _plain_ops(ops, ref).items():
            setattr(ops, name, fn)
        want_loss, want = value_and_grad(loss, params, has_aux=router)
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
    if router:
        got_loss, want_loss = got_loss[0], want_loss[0]
    worst, dead = 0.0, []
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        top = w.abs().max().item()
        if top > 0:
            worst = max(worst, (g - w).abs().max().item() / top)
            if g.abs().max().item() == 0.0:
                dead.append(i)
    row = dict(loss_kernels=got_loss.item(), loss_plain=want_loss.item(),
               leaves=len(tree_leaves(got)), worst_leaf_rel_err=worst,
               tol=TRAIN_GRAD_REL_TOL, leaves_without_gradient=dead)
    print(f"train {label} first-step gradients kernels vs plain "
          + json.dumps(row))
    if dead or not worst <= TRAIN_GRAD_REL_TOL:
        fail(f"{label}: kernel-path gradients differ from the plain "
             f"path's: {row}")


def train_full_width(ops, ref, dev) -> dict:
    """Phase 13: the port's training path at full DiT-B/2 width.

    Fits the two-stage clustering on a seeded synthetic corpus (latent 32,
    2 clusters, DiT-B/2's 77 × 768 captions); converts a seeded, random,
    class-free DiT-B/2 (``dit_b2(use_text=False)``, the 'ImageNet DiT')
    into the text-conditioned template with ``convert_checkpoint``
    (Eq. 20; the paper's pretrained weights are not in the repository);
    trains a DDPM/cosine expert from ``init`` on cluster 0's stream and an
    FM/linear expert from the converted parameters on cluster 1's, and
    ``router_b2(num_clusters=2)`` on the router stream, each for
    ``TRAIN_STEPS`` steps at batch 32; saves the three EMA checkpoints and
    serves one batch-8, 8-step, CFG-7.5, top-2 request from them.

    Each step's kernel launches must equal ``_train_launches``; the first
    step's gradients are held against the plain path's on the card; every
    loss must be finite and the loss on one fixed batch with fixed draws
    must fall from the initial to the trained parameters."""
    from repro_torch.core.conversion import convert_checkpoint
    from repro_torch.core.sampling import SamplerConfig
    from repro_torch.data import SyntheticSpec, fit_clusters
    from repro_torch.data.pipeline import ExpertDataStream, RouterDataStream
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import dit as D
    from repro_torch.models.config import dit_b2, router_b2
    from repro_torch.training import (AdamWConfig, ExpertTrainer,
                                      RouterTrainer, expert_metadata,
                                      save_checkpoint)

    cfg, rcfg = dit_b2(), router_b2(num_clusters=2)
    spec = SyntheticSpec(num_categories=2, latent_size=cfg.latent_size,
                         text_len=cfg.text_len, text_dim=cfg.text_dim)
    t0 = time.perf_counter()
    cm, assign = fit_clusters(spec, corpus_size=1024, num_clusters=2,
                              num_fine=256, device=dev)
    print("train clusters " + json.dumps(dict(
        corpus=1024, latent=[spec.latent_size] * 2 + [4],
        balance=np.bincount(assign, minlength=2).tolist(),
        seconds=time.perf_counter() - t0)))
    gen = torch.Generator(device=dev).manual_seed(31)
    source = D.init(dit_b2(use_text=False), gen)
    converted, report = convert_checkpoint(source, D.init(cfg, gen), gen=gen)
    print("train convert_checkpoint " + json.dumps(report, sort_keys=True))
    runs = (("ddpm", "cosine", 0, D.init(cfg, gen), "init"),
            ("fm", "linear", 1, converted, "converted"))
    path = os.path.join(WORK, "trained")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    want_expert, want_router = _train_launches(cfg), _train_launches(rcfg)
    total = dict.fromkeys(ops.LAUNCHES, 0)

    def run(label, trainer, state, next_batch, router, want):
        step_gen = torch.Generator(device=dev).manual_seed(41)
        fixed = next_batch(10_000)
        fixed_draws = trainer.draw(torch.Generator(device=dev).manual_seed(
            43), fixed["latents"])
        first_fixed = _fixed_loss(trainer, state.params, fixed_draws, fixed,
                                  router)
        losses, secs = [], []
        base = _peak_reset(dev)
        for i in range(TRAIN_STEPS):
            batch = next_batch(i)
            draws = trainer.draw(step_gen, batch["latents"])
            if i == 0:
                _grad_check(ops, ref, label, trainer, state.params, draws,
                            batch, router)
                base = _peak_reset(dev)
            _sync(dev)
            ops.reset_launches()
            t = time.perf_counter()
            state, m = trainer.train_step(state, None, batch, draws=draws)
            _sync(dev)
            secs.append(time.perf_counter() - t)
            got = {n: c for n, c in ops.LAUNCHES.items() if c}
            if got != want:
                fail(f"train {label} step {i} launched {got}, want {want}")
            for n, c in got.items():
                total[n] += c
            losses.append(m["loss"])
        peak = _peak(dev, base)
        if not router and label.startswith("expert0"):
            # one more step of the same batch, thrown away, under the
            # profiler: where a training step's device time goes
            profiled(lambda: trainer.train_step(state, None, batch,
                                                draws=draws),
                     TRAIN_CATEGORIES, path=f"train_{label}",
                     batch=TRAIN_BATCH)
        last_fixed = _fixed_loss(trainer, state.params, fixed_draws, fixed,
                                 router)
        steady = secs[1:]
        row = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                   first_step_s=secs[0],
                   step_s_median=float(np.median(steady)),
                   step_s_min=min(steady),
                   images_per_s=TRAIN_BATCH / float(np.median(steady)),
                   peak_bytes=peak, launches_per_step=want,
                   losses=losses,
                   last5_mean=float(np.mean(losses[-5:])),
                   fixed_batch_loss=[first_fixed, last_fixed],
                   final_metrics=m)
        print(f"train {label} " + json.dumps(row))
        if not (all(math.isfinite(x) for x in losses)
                and last_fixed < first_fixed):
            fail(f"train {label}: losses not finite or not falling: {row}")
        return state

    for obj, sched, cid, params, start in runs:
        trainer = ExpertTrainer(
            apply_fn=D.make_expert_apply(cfg), objective=obj,
            schedule_name=sched,
            opt=AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=2),
            device=dev)
        stream = ExpertDataStream(spec, cm, cluster_id=cid,
                                  batch_size=TRAIN_BATCH, seed=cid,
                                  device=dev)
        state = run(f"expert{cid}_{obj}_from_{start}", trainer,
                    trainer.init_state(params), stream.next_batch, False,
                    want_expert)
        save_checkpoint(os.path.join(path, f"expert{cid}.npz"), state.ema,
                        metadata=expert_metadata(
                            name=f"expert{cid}", objective=obj,
                            schedule=sched, cluster_id=cid, arch=cfg.name,
                            step=state.step))
        del state, trainer
        gc.collect()
    rtrainer = RouterTrainer(
        apply_fn=lambda p, x, t: D.apply(rcfg, p, x, t), num_clusters=2,
        device=dev)
    rstream = RouterDataStream(spec, cm, batch_size=TRAIN_BATCH, device=dev)
    rstate = run("router", rtrainer, rtrainer.init_state(D.init(rcfg, gen)),
                 rstream.next_batch, True, want_router)
    save_checkpoint(os.path.join(path, "router.npz"), rstate.ema,
                    metadata={"num_clusters": 2})
    del rstate, rtrainer
    gc.collect()
    torch.cuda.empty_cache()

    engine = ServingEngine.from_checkpoint_dir(
        path, dit_cfg=cfg, router_cfg=rcfg,
        sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2),
        device=dev)
    rng = np.random.default_rng(44)
    text = rng.standard_normal((BATCH, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    _sync(dev)
    t = time.perf_counter()
    lat = engine.generate(0, text, BATCH)
    _sync(dev)
    row = dict(batch=BATCH, steps=STEPS, experts=len(engine.experts),
               seconds=time.perf_counter() - t, shape=list(lat.shape),
               finite=bool(torch.isfinite(lat).all()),
               max_abs=lat.abs().max().item())
    print("train served request " + json.dumps(row))
    if not row["finite"]:
        fail(f"the trained checkpoints served non-finite latents: {row}")
    del engine
    shutil.rmtree(path)
    return {"train": total}


def compare_train_gpu_cpu(dev) -> None:
    """Phase 6's training rows: one training step of a reduced DDPM expert,
    a reduced FM expert and a reduced router on the GPU (kernels and
    backward kernels) and on the CPU (plain versions), from the same
    parameters, batch and draws: the loss, every gradient leaf and the
    parameters after the AdamW step (``TRAIN_E2E``)."""
    from repro_torch.models import dit as D
    from repro_torch.models.config import dit_b2, router_b2
    from repro_torch.training import (AdamWConfig, ExpertTrainer,
                                      RouterTrainer)
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cpu = torch.device("cpu")
    failed = []
    for label in ("ddpm", "fm", "router"):
        router = label == "router"
        cfg = (router_b2(num_clusters=3) if router else dit_b2()).reduced(
            latent_size=16)
        gen = torch.Generator().manual_seed(51)
        params = jittered(cfg, gen)
        opt = AdamWConfig(learning_rate=1e-3, warmup_steps=2)
        lat = torch.randn(4, 16, 16, 4, generator=gen)
        batch = {"latents": lat,
                 "text_emb": torch.randn(4, cfg.text_len, cfg.text_dim,
                                         generator=gen),
                 "cluster": torch.tensor([0, 2, 1, 2])}

        def trainer(device):
            if router:
                return RouterTrainer(
                    apply_fn=lambda p, x, t: D.apply(cfg, p, x, t),
                    num_clusters=3, opt=opt, device=device)
            return ExpertTrainer(
                apply_fn=D.make_expert_apply(cfg), objective=label,
                schedule_name="cosine" if label == "ddpm" else "linear",
                opt=opt, device=device)
        draws = trainer(cpu).draw(torch.Generator().manual_seed(52), lat)
        out = {}
        for device in (cpu, dev):
            tr = trainer(device)
            p = tree_map(lambda a: a.to(device), params)
            d = {n: a.to(device) for n, a in draws.items()}
            b = {n: a.to(device) for n, a in batch.items()}
            if router:
                loss, grads = value_and_grad(lambda q: tr.loss(
                    q, d, b["latents"], b["cluster"]), p, has_aux=True)
                loss = loss[0]
            else:
                loss, grads = value_and_grad(lambda q: tr.loss(
                    q, d, b["latents"], b["text_emb"]), p)
            state, _ = tr.train_step(tr.init_state(p), None, b, draws=d)
            out[device.type] = (loss.item(), [g.cpu() for g in tree_leaves(
                grads)], [q.cpu() for q in tree_leaves(state.params)])
        (lc, gcpu, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
        lr = opt.learning_rate
        loss_err = abs(lg - lc) / abs(lc)
        grad_err = param_err = param_steps = 0.0
        for g, w, p, q in zip(gg, gcpu, pg, pc):
            top = max(w.abs().max().item(), 1e-30)
            grad_err = max(grad_err, (g - w).abs().max().item() / top)
            diff = (p - q).abs()
            clear = w.abs() > TRAIN_E2E["grad"] * top
            if bool(clear.any()):
                param_err = max(param_err, (diff[clear].max().item()
                                            - lr / 100)
                                / max(q.abs().max().item(), 1e-30))
            param_steps = max(param_steps, diff.max().item() / lr)
        row = dict(path=f"train_{label}", loss_rel_err=loss_err,
                   grad_worst_leaf_rel_err=grad_err,
                   param_worst_leaf_rel_err_past_lr_over_100=param_err,
                   param_max_diff_in_steps=param_steps, tol=TRAIN_E2E)
        print("reduced gpu-vs-cpu " + json.dumps(row))
        if not (loss_err <= TRAIN_E2E["loss"]
                and grad_err <= TRAIN_E2E["grad"]
                and param_err <= TRAIN_E2E["param"] and param_steps <= 2.0):
            failed.append(row)
    if failed:
        fail(f"GPU training step differs from the CPU's: {failed}")


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


#: the LM serving paths of phases 7, 15 and 17: arch -> the labels of its
#: scoring, greedy-decode and prefill launches (mixtral-8x22b serves
#: scoring requests only)
LM_PATHS = {"mamba2-2.7b": ("lm_scoring", "lm_decode", "lm_prefill"),
            "zamba2-2.7b": ("lm_hybrid", "lm_hybrid_decode",
                            "lm_hybrid_prefill"),
            "internlm2-1.8b": ("lm_dense", "lm_dense_decode",
                               "lm_dense_prefill"),
            "mixtral-8x7b": ("lm_moe_scoring", "lm_moe_decode",
                             "lm_moe_prefill"),
            "mixtral-8x22b": ("lm_moe_8x22b", None, None)}
#: phase 17's long request, 1 × 8192 tokens (the window of 4096 masks):
#: arch -> its label
LM_LONG_PATHS = {"mixtral-8x7b": "lm_moe"}
LONG_SEQ = 8192


def lm_forward_launches(cfg) -> dict:
    """One forward's (or prefill's) kernel launches: an ``ssd_scan`` per
    mixer, a ``flash_attention`` per attention — each application of the
    hybrid's shared block, each dense, MoE or VLM layer, each encoder
    layer and each decoder layer's self- and cross-attention of
    whisper."""
    ssd = cfg.num_layers if cfg.arch_type in ("ssm", "hybrid") else 0
    attn = {"hybrid": cfg.num_layers // max(cfg.attn_every, 1),
            "dense": cfg.num_layers,
            "moe": cfg.num_layers,
            "vlm": cfg.num_layers,
            "audio": (cfg.num_encoder_layers or cfg.num_layers)
            + 2 * cfg.num_layers}.get(cfg.arch_type, 0)
    return {"ssd_scan": ssd, "flash_attention": attn}


def _check_launches(ops, label: str, forwards: int, cfg) -> dict:
    """The counts since the last reset: exactly ``forwards`` times a
    forward's launches of ``cfg``'s backbone and no other kernel (the LM
    paths run no other kernel of the port)."""
    launches = dict(ops.LAUNCHES)
    print(f"{label} launches " + json.dumps(launches))
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update({k: forwards * n for k, n in lm_forward_launches(cfg).items()})
    if launches != want:
        fail(f"{label} launched {launches}, expected {want}")
    return launches


def serve_lm_full_width(ops, dev, arch: str, layers: int = 0):
    """Phases 7, 15 and 17: ``arch``'s two-expert ensemble at full width
    and depth (``layers`` deep when given): two scoring requests, then
    (``LM_LONG_PATHS``) one 1 × 8192-token request, a greedy decode and
    a prefill where ``LM_PATHS`` names them.  Returns the launches of its
    paths and the ensemble (profiled next)."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    scoring, decoding, prefilling = LM_PATHS[arch]
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
    cut = (f", depth cut {get_config(arch).num_layers} -> "
           f"{cfg.num_layers}" if layers else "")
    print(f"full width: {arch}, {LM_EXPERTS} experts of {n_params} "
          f"parameters ({expert_bytes} bytes each{cut}), built on the card "
          f"in {t_init:.1f} s; top-1 token-prototype routing")
    rng = np.random.default_rng(10)

    def score(path, i, batch, seq):
        toks, labels = lm_request(cfg.vocab_size, rng, batch, seq)
        tt, tl = torch.from_numpy(toks).to(dev), torch.from_numpy(labels).to(dev)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ppl = ens.perplexity(tt, tl)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print("lm request " + json.dumps(dict(
            arch=arch, path=path, layers=cfg.num_layers, request=i,
            batch=batch, tokens=seq, seconds=sec,
            tokens_per_s=batch * seq / sec, perplexity=ppl,
            finite=math.isfinite(ppl),
            peak_bytes=torch.cuda.max_memory_allocated())))
        if not (math.isfinite(ppl) and ppl > 1.0):
            fail(f"{arch} {path} request {i}: perplexity {ppl}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    serve_peak = 0
    ops.reset_launches()
    for i in range(LM_REQUESTS):
        score("scoring", i, LM_BATCH, LM_SEQ)
        serve_peak = max(serve_peak, torch.cuda.max_memory_allocated())
    launches = {scoring: _check_launches(
        ops, scoring, LM_EXPERTS * LM_REQUESTS, cfg)}
    print(f"{scoring} store " + json.dumps(dict(
        param_dtype=str(cfg.param_dtype).replace("torch.", ""),
        store_bytes=LM_EXPERTS * expert_bytes, other_bytes=base,
        resident_bytes=resident, load_peak_bytes=build_peak,
        serve_peak_bytes=serve_peak - base)))
    if arch in LM_LONG_PATHS:
        long_path = LM_LONG_PATHS[arch]
        ops.reset_launches()
        score("scoring_long", 0, 1, LONG_SEQ)
        launches[long_path] = _check_launches(ops, long_path, LM_EXPERTS,
                                              cfg)
    if decoding is None:
        return launches, ens

    prompt = torch.from_numpy(lm_request(cfg.vocab_size, rng, DECODE_BATCH,
                                         DECODE_PROMPT)[0]).to(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = ens.decode_greedy(prompt, DECODE_NEW)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    new = out[:, DECODE_PROMPT:]
    print("lm request " + json.dumps(dict(
        arch=arch, path="decode_greedy", batch=DECODE_BATCH,
        prompt=DECODE_PROMPT, new_tokens=DECODE_NEW, seconds=sec,
        new_tokens_per_s=DECODE_BATCH * DECODE_NEW / sec,
        shape=list(out.shape), tokens=new.tolist())))
    if (tuple(out.shape) != (DECODE_BATCH, DECODE_PROMPT + DECODE_NEW)
            or not torch.equal(out[:, :DECODE_PROMPT], prompt)
            or bool(((new < 0) | (new >= cfg.vocab_size)).any())):
        fail(f"{arch} decode_greedy output is not the prompt and "
             f"in-vocabulary tokens")
    launches[decoding] = _check_launches(ops, decoding, 0, cfg)

    toks = torch.from_numpy(lm_request(cfg.vocab_size, rng, LM_BATCH,
                                       LM_SEQ)[0]).to(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = zoo.prefill(cfg, experts[0], {"tokens": toks})
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(a).all()) for a in (logits, *(
        a for k, a in cache.items() if k != "pos")))
    shapes = {k: list(a.shape) for k, a in cache.items()}
    want = {k: list(a.shape) for k, a in zoo.make_cache(
        cfg, LM_BATCH, LM_SEQ, torch.device("meta")).items()}
    print("lm request " + json.dumps(dict(
        arch=arch, path="prefill", batch=LM_BATCH, tokens=LM_SEQ,
        seconds=sec, tokens_per_s=LM_BATCH * LM_SEQ / sec, finite=finite,
        logits=list(logits.shape), cache=shapes)))
    if not (finite and tuple(logits.shape) == (LM_BATCH, cfg.vocab_size)
            and shapes == want):
        fail(f"{arch} prefill output is not finite logits (B, V) and a full "
             f"cache {want}")
    if "pos" in cache and not torch.equal(
            cache["pos"], torch.arange(LM_SEQ, device=dev,
                                       dtype=torch.int32).expand(LM_BATCH,
                                                                 -1)):
        fail(f"{arch} prefill cache positions are not 0 .. S-1")
    launches[prefilling] = _check_launches(ops, prefilling, 1, cfg)
    del logits, cache
    return launches, ens


def profile_lm_request(ens) -> None:
    """One more scoring request (4 × 1024 tokens) under
    ``torch.profiler``."""
    toks, labels = lm_request(ens.cfg.vocab_size, np.random.default_rng(11),
                              LM_BATCH, LM_SEQ)
    tt, tl = torch.from_numpy(toks).cuda(), torch.from_numpy(labels).cuda()
    profiled(lambda: ens.perplexity(tt, tl), LM_CATEGORIES,
             path=LM_PATHS[ens.cfg.name][0], arch=ens.cfg.name,
             batch=LM_BATCH, tokens=LM_SEQ, experts=LM_EXPERTS)


#: phase 15's bf16 check: fused log-probabilities of two experts at full
#: width and cut depth, attention through the kernel against the same
#: request with the plain attention (``_plain_ops``) on the card.  Both
#: run one bf16 model; their attention outputs differ by at most a bf16
#: ulp (phase 3), which the bf16 layers after it carry on to the bf16
#: logits: the port's bf16 model bound, two bf16 ulps of the largest
#: |logit| (``BF16_MODEL_REL`` in ``tests/test_torch_transformer.py``).
#: A log-probability is its logit less the row's log-sum-exp, which moves
#: by a softmax-weighted mean of the logits' changes.
LM_BF16_REL_TOL = 2.0 ** -6
#: the cut depths: zamba2's first 6 layers (its shared block once),
#: internlm2's and the deepseek models' first 2 (few bf16 layers after
#: the attention to carry a rounding flip further; deepseek-67b's 2
#: layers are 2.77 GB an expert, its embedding and unembedding 3.36)
LM_BF16_LAYERS = {"zamba2-2.7b": 6, "internlm2-1.8b": 2, "deepseek-67b": 2,
                  "deepseek-coder-33b": 2}


def compare_lm_attention_bf16(ops, ref, dev, arch: str) -> None:
    """Phases 15 and 17's kernel-vs-plain check of the bf16 attention in a
    served model: ``arch`` at full width, ``LM_BF16_LAYERS`` deep, bf16,
    two random seeded experts, one 4 × 1024-token request's fused
    log-probabilities through the attention kernel (the tensor-core
    design) and through ``_plain_ops``' attention, within
    ``LM_BF16_REL_TOL`` of the experts' largest |logit| (their forward
    with the plain attention); exactly one attention launch per attention
    of each expert's forward; the request's seconds (after a 64-token
    warm-up request).  The largest error is taken apart (``at_worst``):
    the routed expert's bf16 logit there and its row's log-sum-exp on
    each path (the log-probability is the one less the other), and the
    row's logits that moved; ``top_errs`` are the five largest errors;
    ``nudged_max_abs_err`` is the error of the kernel's attention output
    raised by one bf16 ulp (``(1 + 2⁻⁷)·out``), which each model carries
    to its own logits."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    cfg = dataclasses.replace(get_config(arch),
                              num_layers=LM_BF16_LAYERS[arch])
    experts = [zoo.init(cfg, torch.Generator(device=dev).manual_seed(41 + k),
                        dev) for k in range(LM_EXPERTS)]
    ens = lm_ensemble(cfg, experts, seed=13)
    toks = torch.from_numpy(lm_request(cfg.vocab_size,
                                       np.random.default_rng(14), LM_BATCH,
                                       LM_SEQ)[0]).to(dev)
    ens.fused_logprobs(toks[:, :64])                 # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    got = ens.fused_logprobs(toks)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = ops.LAUNCHES["flash_attention"]
    saved = ops.flash_attention
    plain = _plain_ops(ops, ref)["flash_attention"]

    def nudged(*args, **kw):
        out = saved(*args, **kw)
        return (out.float() * (1 + 2.0 ** -7)).to(out.dtype)

    try:
        ops.flash_attention = plain
        want = ens.fused_logprobs(toks)
        scale = max(zoo.forward_train(cfg, p, {"tokens": toks})[0]
                    .abs().max().item() for p in experts)
        ops.flash_attention = nudged
        nudged_err = (ens.fused_logprobs(toks).float()
                      - want.float()).abs().max().item()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        top_errs = torch.topk(diff.flatten(), 5).values.tolist()
        err_at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
        del diff
        b, s, v = (int(i) for i in err_at)
        routed = experts[int(ens._log_weights(toks)[:, b].argmax())]
        worst = {}
        for name, attn in (("kernel", saved), ("plain", plain)):
            ops.flash_attention = attn
            row = zoo.forward_train(cfg, routed, {"tokens": toks})[0][b, s]
            worst[name] = row.float()
    finally:
        ops.flash_attention = saved
    moved = worst["kernel"] - worst["plain"]
    at_worst = {f"{name}_{what}": val for name, row in worst.items()
                for what, val in (("logit", row[v].item()),
                                  ("lse", torch.logsumexp(row, 0).item()))}
    at_worst.update(logit_moved=moved[v].item(),
                    row_logits_moved=int((moved != 0).sum()),
                    row_largest_move=moved.abs().max().item())
    n_attn = LM_EXPERTS * lm_forward_launches(cfg)["flash_attention"]
    row = dict(arch=arch, layers=cfg.num_layers, dtype="bfloat16",
               heads=[cfg.num_heads, cfg.num_kv_heads], d_model=cfg.d_model,
               batch=LM_BATCH, tokens=LM_SEQ, seconds=sec,
               tokens_per_s=LM_BATCH * LM_SEQ / sec, max_abs_err=err,
               err_at=[int(i) for i in err_at], rel_err=err / scale,
               max_abs_logit=scale, at_worst=at_worst, top_errs=top_errs,
               nudged_max_abs_err=nudged_err,
               tol=LM_BF16_REL_TOL * scale, flash_attention=launches,
               flash_attention_want=n_attn)
    print("lm bf16 attention kernel-vs-plain " + json.dumps(row))
    if not (bool(torch.isfinite(got).all()) and err <= LM_BF16_REL_TOL * scale
            and launches == n_attn):
        fail(f"{arch}: bf16 log-probabilities through the attention kernel "
             f"differ from the plain attention's: {row}")


#: phases 8 and 16's reduced float32 models: arch -> reduced() overrides
#: (internlm2 and mixtral with 4 query heads over 2 kv heads: their own
#: reduction is 4/4, and the GQA path is the one to hold)
LM_REDUCED = {"mamba2-2.7b": {}, "zamba2-2.7b": {},
              "internlm2-1.8b": dict(num_kv_heads=2),
              "mixtral-8x7b": dict(num_kv_heads=2), "whisper-large-v3": {},
              "paligemma-3b": {}}
#: phase 16's MoE runs: the config's ``dense_scan``, and the capacity
#: dispatch at a factor at which experts overflow (4 × 64 tokens: 64
#: slots an expert for 128 assignments each on average)
MOE_RUNS = ({}, dict(moe_impl="dropping", moe_capacity_factor=0.5))


def _with_room(zoo, cfg, cache: dict, batch: int, room: int, dev) -> dict:
    """A prefill's cache copied into ``make_cache(room)`` (the KV caches'
    first slots, the rest empty): a decode step after it then attends to
    every prefilled position (the prefill's own ring would take slot 0)."""
    out = zoo.make_cache(cfg, batch, room, dev)
    for key, a in cache.items():
        if key in ("k", "v"):
            out[key][:, :, :a.shape[2]] = a
        elif key == "pos":
            out[key][:, :a.shape[1]] = a
        else:
            out[key] = a
    return out


def compare_lm_gpu_cpu(ops, dev, arch: str = "mamba2-2.7b",
                       over: dict | None = None) -> None:
    """Phases 8 and 16: the reduced ensemble of ``arch`` (float32, 2
    layers; ``over`` more ``reduced()`` overrides) on the GPU (scan and
    attention kernels) and on the CPU (plain versions): fused
    log-probabilities, prefill logits and every cache leaf within
    ``LM_REL_TOL · max|out|`` (slot positions equal), greedy tokens equal
    (the smallest top-1/top-2 gap printed); an MoE model's fused
    log-probabilities drop the same assignments on both (the smallest
    router gap printed).  On the GPU, prefill followed by a decode step
    must reproduce ``forward_train``'s logits (the reference's invariant,
    ``tests/test_arch_smoke.py``), except under the capacity dispatch,
    whose capacity differs between a sequence and a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, zoo
    from repro_torch.tree import tree_map

    cfg = get_config(arch).reduced(**LM_REDUCED[arch], **(over or {}))
    cpu_experts = [zoo.init(cfg, torch.Generator().manual_seed(31 + k), "cpu")
                   for k in range(LM_EXPERTS)]
    gpu_experts = [tree_map(lambda a: a.to(dev), e) for e in cpu_experts]
    ens = {"cpu": lm_ensemble(cfg, cpu_experts, seed=9),
           "gpu": lm_ensemble(cfg, gpu_experts, seed=9)}
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(lm_request(cfg.vocab_size, rng, 4, 64)[0])
    prompt = toks[:2, :8]
    failed, rows = [], {"arch": arch, **(over or {})}

    def check(name, gpu, cpu, tol=LM_REL_TOL):
        err, scale = rel_err(gpu.cpu().float(), cpu.float())
        rows[name] = dict(max_abs_err=err, tol=tol * scale, max_abs=scale)
        if not (bool(torch.isfinite(gpu).all()) and err <= tol * scale):
            failed.append(f"{name}: {err} > {tol * scale}")

    ops.reset_launches()
    lp, routed = {}, {}
    for d, e in ens.items():
        with layers.MoERecorder() as routed[d]:
            lp[d] = e.fused_logprobs(toks.to(dev if d == "gpu" else "cpu"))
    check("fused_logprobs", lp["gpu"], lp["cpu"])
    if cfg.num_experts:
        same = (len(routed["gpu"].keeps) == len(routed["cpu"].keeps)
                and all(torch.equal(a, b) for a, b in zip(
                    routed["gpu"].keeps, routed["cpu"].keeps)))
        rows["moe"] = dict(impl=cfg.moe_impl,
                           capacity_factor=cfg.moe_capacity_factor,
                           min_router_gap=routed["cpu"].min_gap,
                           drops_gpu=routed["gpu"].drops,
                           drops_cpu=routed["cpu"].drops,
                           same_drops=same)
        if not same:
            failed.append("the GPU run dropped other assignments")
    pre = {d: zoo.prefill(cfg, e.expert_params[0],
                          {"tokens": toks.to(dev if d == "gpu" else "cpu")})
           for d, e in ens.items()}
    check("prefill_logits", pre["gpu"][0], pre["cpu"][0])
    for key, a in pre["gpu"][1].items():
        if key == "pos":
            if not torch.equal(a.cpu(), pre["cpu"][1][key]):
                failed.append("prefill cache positions differ")
        else:
            check(f"prefill_{key}_cache", a, pre["cpu"][1][key])
    want = {k: (LM_EXPERTS + 1) * n for k, n in
            lm_forward_launches(cfg).items()}
    if any(ops.LAUNCHES[k] != n for k, n in want.items()):
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
    if not (cfg.num_experts and cfg.moe_impl not in ("dense", "dense_scan",
                                                     "dense_fused")):
        experts = ens["gpu"].expert_params
        full, _ = zoo.forward_train(cfg, experts[1], {"tokens": toks.to(dev)})
        last, cache = zoo.prefill(cfg, experts[1],
                                  {"tokens": toks[:, :48].to(dev)})
        step, _ = zoo.decode_step(
            cfg, experts[1], _with_room(zoo, cfg, cache, 4, 64, dev),
            toks[:, 48:49].to(dev),
            torch.full((4,), 48, dtype=torch.int32, device=dev))
        check("gpu_prefill_vs_forward", last, full[:, 47].cpu())
        check("gpu_decode_vs_forward", step, full[:, 48].cpu())
    print("lm reduced gpu-vs-cpu " + json.dumps(rows))
    if failed:
        fail(f"reduced {arch} GPU run differs from the CPU run: {failed}")


# ---------------------------------------------------------------------------
# Phase 17: the MoE LM experts' routed layer at full width
# ---------------------------------------------------------------------------

#: phase 17's serving depth cuts: two experts at full width and these
#: depths hold 47.5 GB (mixtral-8x7b: 2.903 GB of bf16 weights a layer,
#: 0.524 GB of embedding and unembedding) and 41.7 GB (mixtral-8x22b:
#: 5.008 and 0.805 GB); their full depths (93.4 and 281.3 GB an expert)
#: do not fit one card
MOE_SERVE_LAYERS = {"mixtral-8x7b": 8, "mixtral-8x22b": 4}
#: phase 17's ``moe_apply`` check: every ``impl`` against ``dense_scan``
#: on one bf16 layer.  Each rounds its expert products and its weighted
#: sum to bf16 at other points — ``dense`` sums a token's two weighted
#: expert outputs in float32 and rounds once where ``dense_scan`` rounds
#: each product and each partial sum; ``dense_fused`` rounds the weighted
#: activations before one GEMM over experts and F; the capacity dispatch
#: multiplies gathered rows in another GEMM shape — so an output element
#: differs by a few half-ulps of its own magnitude: two bf16 ulps of the
#: largest |output| bound it (the port's bf16 rule, ``LM_BF16_REL_TOL``).
MOE_IMPL_REL_TOL = 2.0 ** -6


def compare_moe_impls(dev) -> None:
    """Phase 17: one mixtral-8x7b MoE layer at full width (d 4096, 8
    experts of F 14336, top-2, bf16, a seeded router) on seeded bf16
    hidden states of 4 × 1024 tokens: ``dense``, ``dense_fused`` and the
    capacity dispatch at capacity factor E/k = 4 (no drops) within
    ``MOE_IMPL_REL_TOL`` of ``dense_scan``; the capacity dispatch at the
    config's 1.25 prints the (token, k) assignments it drops and its
    difference; each run's device ms (CUDA events), TFLOP/s of the expert
    products it computes (``dense*``: every expert on every token;
    dispatch: E × capacity rows) and the smallest router gap."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config("mixtral-8x7b")
    e, k, d, f = (cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model,
                  cfg.d_ff)
    t = LM_BATCH * LM_SEQ
    gen = torch.Generator(device=dev).manual_seed(81)
    params = layers.moe_init(gen, d, f, e, device=dev, dtype=cfg.param_dtype)
    x = torch.randn(LM_BATCH, LM_SEQ, d, generator=gen, device=dev).to(
        cfg.activation_dtype)
    runs = (("dense_scan", cfg.moe_capacity_factor),
            ("dense", cfg.moe_capacity_factor),
            ("dense_fused", cfg.moe_capacity_factor),
            ("dropping", e / k), ("dropping", cfg.moe_capacity_factor))
    with torch.no_grad():
        want = None
        for impl, cf in runs:
            def run():
                return layers.moe_apply(params, x, num_experts_per_tok=k,
                                        capacity_factor=cf, impl=impl)
            with layers.MoERecorder() as rec:
                y, aux = run()
            torch.cuda.synchronize()
            if want is None:
                want, scale = y, y.abs().max().item()
            err = (y.float() - want.float()).abs().max().item()
            rows = (e * layers.moe_capacity(t, k, e, cf)
                    if impl == "dropping" else e * t)
            ms = cuda_ms(run, 5, warmup=1)
            checked = not (impl == "dropping" and cf < e / k)
            row = dict(impl=impl, capacity_factor=cf, tokens=t, ms=ms,
                       tflops=3 * 2.0 * rows * d * f / ms / 1e9,
                       expert_rows=rows, assignments=t * k,
                       dropped=sum(rec.drops), max_abs_err=err,
                       rel_err=err / scale,
                       tol=MOE_IMPL_REL_TOL * scale if checked else None,
                       aux=aux.item(), min_router_gap=rec.min_gap)
            print("moe impl " + json.dumps(row))
            if not (bool(torch.isfinite(y).all()) and (
                    not checked or err <= MOE_IMPL_REL_TOL * scale)):
                fail(f"moe_apply {impl} differs from dense_scan: {row}")
            del y
    del params, x, want
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 14 (and phase 8's training row): LM training of mamba2-2.7b
# ---------------------------------------------------------------------------

#: phase 14's traffic: the reference's train_4k is 256 × 4096 tokens a
#: step, cut here to 4 × 1024 (the scoring request's shape) and 10 steps;
#: AdamW as the reference's ``train_lm`` (lr 1e-4, 5 warm-up steps)
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 10, 4, 1024
LM_TRAIN_LR = 1e-4
#: the first step's gradients of a 2-layer full-width float32 mamba2 on
#: the kernel path against the plain path (the chunked algorithm in
#: PyTorch) on the card, per leaf as a share of the leaf's max |plain
#: gradient|: the scan kernels differ from the plain chunked algorithm by
#: ~1e-5 of max (phase 3); a missing gradient path errs by ~1.
LM_GRAD_REL_TOL = 1e-3

#: a training step's kernel-name fragments -> category, first match wins
LM_TRAIN_CATEGORIES = (
    ("flash_attention_bwd_delta", "flash_attention_bwd Δ"),
    ("flash_attention_bwd_dkdv_wgmma", "flash_attention_bwd dK/dV kernel "
                                       "(wgmma)"),
    ("flash_attention_bwd_dq_wgmma", "flash_attention_bwd dQ kernel "
                                     "(wgmma)"),
    ("flash_attention_bwd_tile", "flash_attention_bwd tile kernel (dK, dV, "
                                 "the dQ shares)"),
    ("flash_attention_bwd_dq_sum", "flash_attention_bwd dQ sums"),
    ("flash_attention", "flash_attention (forward and recompute)"),
    ("ssd_scan_bwd_states", "ssd_scan_bwd first launch: the tiles' state "
                            "sums"),
    ("ssd_scan_bwd_carry", "ssd_scan_bwd first launch: the carry"),
    ("ssd_scan_bwd_main", "ssd_scan_bwd main launch (g, the head groups' "
                          "sums)"),
    ("ssd_scan_bwd_sums", "ssd_scan_bwd sums (dB, dC, ddt, dA)"),
    ("ssd_scan_prep", "ssd_scan prep (C·Bᵀ; forward, recompute, backward)"),
    ("ssd_scan", "ssd_scan (forward and recompute)"),
    ("gemm", "cuBLAS bf16 GEMM (projections, unembedding; forward, "
             "recompute, backward)"),
    ("nvjet", "cuBLAS bf16 GEMM (projections, unembedding; forward, "
              "recompute, backward)"),
    ("xmma", "cuBLAS bf16 GEMM (projections, unembedding; forward, "
             "recompute, backward)"),
    ("softmax", "log-softmax and its backward"),
    ("reduce", "reductions (RMSNorm, CE, global norm, bias-free sums)"),
    ("elementwise", "elementwise (mixer chain and its backward, AdamW)"),
    ("CatArrayBatchedCopy", "copies, stacks and concatenations"),
    ("Memcpy", "copies, stacks and concatenations"),
    ("index", "embedding gather and scatter-add"),
    ("scatter", "embedding gather and scatter-add"),
    ("Memset", "sets"),
)


def _plain_scan(x, dt, A, B, C, *, chunk=128, head_block=None):
    """``ops.ssd_scan`` as the plain chunked algorithm (the gradient
    check's reference path on the card)."""
    from repro_torch.models.mamba2 import ssd_chunked

    y, state = ssd_chunked(x.transpose(1, 2), dt.transpose(1, 2), A, B, C,
                           chunk=chunk)
    return y.transpose(1, 2), state


def _plain_attention(q, k, v, *, causal=True, window=0, softmax_scale=None,
                     prefix_len=0):
    """``ops.flash_attention`` as the plain version, kv heads repeated (the
    gradient check's reference path on the card, through autograd)."""
    from repro_torch.kernels import ref

    rep = q.shape[1] // k.shape[1]
    return ref.ref_flash_attention(q, k.repeat_interleave(rep, 1),
                                   v.repeat_interleave(rep, 1),
                                   causal=causal, window=window,
                                   softmax_scale=softmax_scale,
                                   prefix_len=prefix_len)


#: phases 14 and 17's path name of each LM family's training step
LM_TRAIN_PATHS = {"ssm": "lm_train", "dense": "lm_train_dense",
                  "hybrid": "lm_train_hybrid", "moe": "lm_train_moe",
                  "audio": "lm_train_audio", "vlm": "lm_train_vlm"}


def lm_train_launches(cfg) -> dict:
    """One training step's launches: a forward of every mixer's scan and
    every attention, again under remat, and one backward of each."""
    from repro_torch.models import hybrid

    fwd = 2 if cfg.remat else 1
    out = {}
    if cfg.arch_type in ("ssm", "hybrid"):
        out.update(ssd_scan=fwd * cfg.num_layers,
                   ssd_scan_bwd=cfg.num_layers)
    if cfg.arch_type in ("dense", "hybrid", "moe", "audio", "vlm"):
        attn = (hybrid.num_groups(cfg) if cfg.arch_type == "hybrid"
                else lm_forward_launches(cfg)["flash_attention"])
        out.update(flash_attention=fwd * attn, flash_attention_bwd=attn)
    return out


#: a gradient leaf whose plain largest |gradient| is at most this share of
#: the model's largest is rounding noise around an exact 0 (whisper's key
#: biases: each adds ``q·b`` to a query row's logits, which the softmax
#: cancels; 3e-9 of the model's largest at the reduced shapes on the CPU,
#: against 7.6e-3 for the smallest other leaf of any reduced LM): the
#: gradient checks hold such a leaf to the model's largest gradient, not
#: its own
ZERO_GRAD_SHARE = 2.0 ** -17


def grad_scales(want: list) -> tuple[list, int]:
    """The scale each plain gradient leaf of ``want`` is held to — its own
    largest |gradient|, or the model's largest where its own is rounding
    noise (``ZERO_GRAD_SHARE``) — and how many leaves are noise."""
    own = [w.abs().max().item() for w in want]
    top = max(own)
    scales = [top if o <= ZERO_GRAD_SHARE * top else o for o in own]
    return scales, sum(o <= ZERO_GRAD_SHARE * top for o in own)


def lm_train_batch(cfg, gen, batch: int, seq: int, seed: int) -> dict:
    """``lm_batch`` tokens from ``gen`` on its device; for the audio family
    also the stubbed frames ``audio_frame_embeddings(seed=seed)``, for the
    VLM the stubbed patches ``vision_patch_embeddings(seed=seed)``, as
    ``launch/train.py --mode lm`` draws them."""
    from repro_torch.data import lm_batch

    out = lm_batch(gen, batch, seq, cfg.vocab_size)
    out.update(stub_inputs(cfg, batch, seed, gen.device))
    return out


def stub_inputs(cfg, batch: int, seed: int, device) -> dict:
    """The stubbed frontend's inputs a batch of ``cfg``'s family carries:
    ``audio_embeds`` (whisper's frames) or ``vision_embeds`` (paligemma's
    patches), drawn from ``seed`` on ``device``; none for the others."""
    from repro_torch.models import frontend_stubs as stubs

    if cfg.arch_type == "audio":
        return {"audio_embeds": stubs.audio_frame_embeddings(
            cfg, batch, seed=seed, device=device)}
    if cfg.arch_type == "vlm":
        return {"vision_embeds": stubs.vision_patch_embeddings(
            cfg, batch, seed=seed, device=device)}
    return {}


def _lm_grad_check(ops, dev, cfg) -> None:
    """The first step's gradients of ``zoo.loss_fn`` through the kernels
    (scans, attention and their backward kernels) and through the plain
    versions (the chunked scan, the plain attention), both on the card,
    for 2 layers of ``cfg`` (one group — 6 mixers and the shared block —
    of the hybrid; one layer of an MoE model: 5.6 GB of float32 experts)
    at full width in float32 (remat and the 512-token CE chunks as
    configured), batch 4 × 1024 from ``lm_batch``: every leaf within
    ``LM_GRAD_REL_TOL`` of the plain one's max, and non-zero wherever the
    plain path's is; the kernel path's launches exact; an MoE model's
    smallest router gap printed (a near-tie there could route a token
    elsewhere on the other path).  Whisper: 2 encoder and 2 decoder
    layers over ``lm_train_batch``'s 1500 frames a row; its key biases,
    whose exact gradient is 0, against the model's largest gradient
    (``grad_scales``).  Paligemma: 2 layers after ``lm_train_batch``'s 256
    patches a row (the prefix-LM attention of D 256 and its backward on
    the FFMA route)."""
    from repro_torch.models import zoo
    from repro_torch.models.layers import MoERecorder
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree import tree_leaves

    layers = {"hybrid": cfg.attn_every, "moe": 1}.get(cfg.arch_type, 2)
    c2 = dataclasses.replace(cfg, num_layers=layers,
                             param_dtype=torch.float32,
                             activation_dtype=torch.float32)
    if cfg.num_encoder_layers:
        c2 = dataclasses.replace(c2, num_encoder_layers=layers)
    params = zoo.init(c2, torch.Generator(device=dev).manual_seed(64), dev)
    batch = lm_train_batch(c2, torch.Generator(device=dev).manual_seed(65),
                           LM_TRAIN_BATCH, LM_TRAIN_SEQ, 65)
    ops.reset_launches()
    with MoERecorder() as routed:
        (got_loss, _), got = value_and_grad(
            lambda p: zoo.loss_fn(c2, p, batch), params, has_aux=True)
    launches = {n: c for n, c in ops.LAUNCHES.items() if c}
    saved = ops.ssd_scan, ops.flash_attention
    try:
        ops.ssd_scan, ops.flash_attention = _plain_scan, _plain_attention
        (want_loss, _), want = value_and_grad(
            lambda p: zoo.loss_fn(c2, p, batch), params, has_aux=True)
    finally:
        ops.ssd_scan, ops.flash_attention = saved
    worst, dead = 0.0, []
    scales, noise = grad_scales(tree_leaves(want))
    for i, (g, w, top) in enumerate(zip(tree_leaves(got), tree_leaves(want),
                                        scales)):
        worst = max(worst, (g - w).abs().max().item() / top)
        if w.abs().max().item() > 0 and g.abs().max().item() == 0.0:
            dead.append(i)
    row = dict(arch=cfg.name, layers=layers,
               **({"encoder_layers": c2.num_encoder_layers}
                  if c2.num_encoder_layers else {}), d_model=c2.d_model,
               dtype="float32", batch=LM_TRAIN_BATCH, tokens=LM_TRAIN_SEQ,
               loss_kernels=got_loss.item(), loss_plain=want_loss.item(),
               leaves=len(tree_leaves(got)), worst_leaf_rel_err=worst,
               tol=LM_GRAD_REL_TOL, leaves_without_gradient=dead,
               noise_leaves=noise,
               launches=launches, min_router_gap=routed.min_gap)
    print("lm_train first-step gradients kernels vs plain "
          + json.dumps(row))
    if dead or not worst <= LM_GRAD_REL_TOL or launches != \
            lm_train_launches(c2):
        fail(f"LM kernel-path gradients differ from the plain path's: "
             f"{row}")


def train_lm_full_width(ops, dev, arch: str = "mamba2-2.7b", layers: int = 0,
                        batch: int = LM_TRAIN_BATCH,
                        seq: int = LM_TRAIN_SEQ) -> dict:
    """Phases 14, 17, 18 and 19: one LM expert of ``arch`` trained at full
    width and depth (``layers`` deep when given) through
    ``make_lm_train_step`` — mamba2-2.7b (64 layers, d 2560, 80 SSD heads,
    N 128, vocab 50280), zamba2-2.7b (54 mixers at N 64, the shared
    attention + SwiGLU block of 32 heads of D 80 after every 6),
    internlm2-1.8b (24 layers, d 2048, 16 query heads over 8 kv heads of
    D 128, vocab 92544), mixtral-8x7b (32 over 8 heads, window 4096, 8
    experts of F 14336 under ``dense_scan``, vocab 32000; 2 of its 32
    layers: its full depth does not fit one card), whisper-large-v3 (over
    1500 stubbed frames a row) or paligemma-3b (18 layers, d 2048, 8 over
    1 heads of D 256, vocab 257216, after 256 stubbed patches a row, its
    256-token CE chunks), bf16, remat, the config's CE chunks: random
    seeded weights built on the card, ``LM_TRAIN_STEPS`` steps of ``batch
    × seq`` tokens from ``lm_batch``.  Cuts (the
    reference trains at ``train_4k``): 256 × 4096 tokens a step cut to 4 ×
    1024 (mixtral 1 × 8192, past its window), 10 steps.  Each step's
    launches exact (``lm_train_launches``: every scan and attention
    forward twice under remat, each backward once); losses finite; the
    loss on one fixed batch falls; per-step seconds (synced), tokens/s,
    the peak device memory (under 80 GB) and the MoE aux loss printed;
    then one more step under the profiler.  First, ``_lm_grad_check``."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.training import AdamWConfig, adamw_init
    from repro_torch.training.trainer import make_lm_train_step
    from repro_torch.tree import tree_leaves

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers) if layers else full
    path = LM_TRAIN_PATHS[cfg.arch_type]
    _lm_grad_check(ops, dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    base = _peak_reset(dev)
    t0 = time.perf_counter()
    params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(61), dev)
    state = adamw_init(params)
    _sync(dev)
    t_init = time.perf_counter() - t0
    step = make_lm_train_step(cfg, AdamWConfig(learning_rate=LM_TRAIN_LR,
                                               warmup_steps=5))
    gen = torch.Generator(device=dev).manual_seed(62)
    fixed = lm_train_batch(cfg, torch.Generator(device=dev).manual_seed(63),
                           batch, seq, 63)

    def fixed_loss():
        with torch.no_grad():
            return zoo.loss_fn(cfg, params, fixed)[0].item()

    first_fixed = fixed_loss()
    want = lm_train_launches(cfg)
    total = dict.fromkeys(ops.LAUNCHES, 0)
    losses, secs, grad_norms, aux = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(LM_TRAIN_STEPS):
        tb = lm_train_batch(cfg, gen, batch, seq, 100 + i)
        _sync(dev)
        ops.reset_launches()
        t = time.perf_counter()
        params, state, loss, m = step(params, state, tb)
        _sync(dev)
        secs.append(time.perf_counter() - t)
        got = {n: c for n, c in ops.LAUNCHES.items() if c}
        if got != want:
            fail(f"{path} step {i} launched {got}, want {want}")
        for n, c in got.items():
            total[n] += c
        losses.append(loss.item())
        grad_norms.append(m["grad_norm"].item())
        if "moe_aux" in m:              # the transformer's loss_fn
            aux.append(m["moe_aux"].item())
    peak = torch.cuda.max_memory_allocated()
    last_fixed = fixed_loss()
    steady = secs[1:]
    leaves = tree_leaves(params)
    row = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               parameters=sum(a.numel() for a in leaves),
               param_dtype=str(cfg.param_dtype).replace("torch.", ""),
               remat=cfg.remat, logits_chunk=cfg.logits_chunk,
               steps=LM_TRAIN_STEPS, batch=batch, tokens=seq,
               init_s=t_init, first_step_s=secs[0], step_s=secs,
               step_s_median=float(np.median(steady)),
               step_s_min=min(steady),
               tokens_per_s=batch * seq / float(np.median(steady)),
               peak_bytes=peak, peak_bytes_net=peak - base,
               launches_per_step=want, losses=losses,
               grad_norms=grad_norms, moe_aux=aux,
               fixed_batch_loss=[first_fixed, last_fixed],
               reduced=dict(batch=f"256 -> {batch}",
                            seq_len=f"4096 -> {seq}", steps=LM_TRAIN_STEPS,
                            **({"layers": f"{full.num_layers} -> "
                                          f"{cfg.num_layers}"}
                               if layers else {})))
    print(f"{path} " + json.dumps(row))
    if not (all(math.isfinite(x) for x in losses)
            and last_fixed < first_fixed and peak < 80e9):
        fail(f"{path}: losses not finite or not falling, or the peak "
             f"is past 80 GB: {row}")
    # one more step, on the last batch, under the profiler
    profiled(lambda: step(params, state, tb), LM_TRAIN_CATEGORIES,
             path=path, arch=cfg.name, layers=cfg.num_layers, batch=batch,
             tokens=seq)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return {path: total}


def compare_lm_train_gpu_cpu(ops, dev, arch: str = "mamba2-2.7b",
                             over: dict | None = None) -> None:
    """Phase 8's and 16's training rows: one ``make_lm_train_step`` step of
    the reduced float32 ``arch`` (``LM_REDUCED``: internlm2 with 4 query
    heads over 2 kv heads) on the GPU (scan and attention kernels, their
    backward kernels) and on the CPU (plain versions), from the same
    parameters and batch: the loss, every gradient leaf, and the
    parameters after the step (``TRAIN_E2E``'s rule; a leaf whose exact
    gradient is 0 against the model's largest gradient, ``grad_scales``); the GPU step's launches exact (``lm_train_launches``).
    ``over``: more ``reduced()`` overrides (phase 16's MoE runs)."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.training import AdamWConfig, adamw_init
    from repro_torch.training.trainer import (make_lm_train_step,
                                              value_and_grad)
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(arch).reduced(**LM_REDUCED[arch], **(over or {}))
    params = zoo.init(cfg, torch.Generator().manual_seed(71), "cpu")
    batch = lm_train_batch(cfg, torch.Generator().manual_seed(72), 4, 64, 72)
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=2)
    out = {}
    for device in (torch.device("cpu"), dev):
        # copies: the step updates the parameters it is given in place
        p = tree_map(lambda a: a.to(device, copy=True), params)
        b = {k: v.to(device) for k, v in batch.items()}
        (loss, _), grads = value_and_grad(lambda q: zoo.loss_fn(cfg, q, b),
                                          p, has_aux=True)
        ops.reset_launches()
        p, _, _, _ = make_lm_train_step(cfg, opt)(p, adamw_init(p), b)
        launches = {n: c for n, c in ops.LAUNCHES.items() if c}
        out[device.type] = (loss.item(), [g.cpu() for g in tree_leaves(
            grads)], [q.cpu() for q in tree_leaves(p)], launches)
    (lc, gcpu, pc, _), (lg, gg, pg, launches) = out["cpu"], out["cuda"]
    lr = opt.learning_rate
    loss_err = abs(lg - lc) / abs(lc)
    grad_err = param_err = param_steps = 0.0
    scales, noise = grad_scales(gcpu)
    for g, w, p, q, top in zip(gg, gcpu, pg, pc, scales):
        grad_err = max(grad_err, (g - w).abs().max().item() / top)
        diff = (p - q).abs()
        clear = w.abs() > TRAIN_E2E["grad"] * top
        if bool(clear.any()):
            param_err = max(param_err, (diff[clear].max().item() - lr / 100)
                            / max(q.abs().max().item(), 1e-30))
        param_steps = max(param_steps, diff.max().item() / lr)
    row = dict(path=LM_TRAIN_PATHS[cfg.arch_type], arch=arch, **(over or {}),
               loss_rel_err=loss_err,
               grad_worst_leaf_rel_err=grad_err, noise_leaves=noise,
               param_worst_leaf_rel_err_past_lr_over_100=param_err,
               param_max_diff_in_steps=param_steps, tol=TRAIN_E2E,
               gpu_launches=launches)
    print("lm reduced gpu-vs-cpu " + json.dumps(row))
    if not (loss_err <= TRAIN_E2E["loss"] and grad_err <= TRAIN_E2E["grad"]
            and param_err <= TRAIN_E2E["param"] and param_steps <= 2.0
            and launches == lm_train_launches(cfg)):
        fail(f"GPU {arch} training step differs from the CPU's: {row}")


# ---------------------------------------------------------------------------
# Phases 16, 18 and 19: whisper-large-v3, the encoder-decoder, and
# paligemma-3b, the VLM prefix: the families with a stubbed frontend
# ---------------------------------------------------------------------------

WHISPER = "whisper-large-v3"
PALIGEMMA = "paligemma-3b"
#: whisper-large-v3's parameters (the reference's ``jax.eval_shape`` of
#: ``zoo.init``: 32 encoder and 32 decoder layers, d 1280, vocab 51866)
WHISPER_PARAMS = 1_614_382_080
#: paligemma-3b's (18 layers, d 2048, d_ff 16384, vocab 257216, the
#: (d, d) ``vision_proj``)
PALIGEMMA_PARAMS = 3_039_635_456

#: a whisper request's kernel-name fragments -> category, first match wins
WHISPER_CATEGORIES = (
    ("flash_attention", "flash_attention (encoder, causal self- and "
                        "cross-attention)"),
    ("gemm", "cuBLAS bf16 GEMM (projections, GELU MLPs, unembedding)"),
    ("nvjet", "cuBLAS bf16 GEMM (projections, GELU MLPs, unembedding)"),
    ("xmma", "cuBLAS bf16 GEMM (projections, GELU MLPs, unembedding)"),
    ("softmax", "log-softmax"),
    ("reduce", "reductions (LayerNorm statistics, logsumexp)"),
    ("elementwise", "elementwise (GELU, LayerNorm scale and shift, biases, "
                    "positions, residuals)"),
    ("CatArrayBatchedCopy", "copies and concatenations"),
    ("Memcpy", "copies and concatenations"),
    ("index", "embedding and position gathers"),
    ("Memset", "sets"),
)

#: a paligemma request's kernel-name fragments -> category
PALIGEMMA_CATEGORIES = (
    ("flash_attention", "flash_attention (prefix-LM attention, FFMA)"),
    ("gemm", "cuBLAS bf16 GEMM (projections, SwiGLU, vision_proj, "
             "unembedding)"),
    ("nvjet", "cuBLAS bf16 GEMM (projections, SwiGLU, vision_proj, "
              "unembedding)"),
    ("xmma", "cuBLAS bf16 GEMM (projections, SwiGLU, vision_proj, "
             "unembedding)"),
    ("softmax", "log-softmax"),
    ("reduce", "reductions (RMSNorm means, logsumexp)"),
    ("elementwise", "elementwise (RoPE, SiLU gating, RMSNorm scale, "
                    "residuals)"),
    ("CatArrayBatchedCopy", "copies and concatenations (the prefix)"),
    ("Memcpy", "copies and concatenations (the prefix)"),
    ("index", "embedding gather"),
    ("Memset", "sets"),
)

#: phases 18 and 19: arch -> its parameter count, its paths' labels
#: (scoring, prefill, greedy decode), its profile's categories, its
#: weights' seed and the name of its stubbed positions
STUBBED = {
    WHISPER: dict(params=WHISPER_PARAMS, seed=81, stub="frames",
                  paths=("lm_audio", "lm_audio_prefill", "lm_audio_decode"),
                  categories=WHISPER_CATEGORIES),
    PALIGEMMA: dict(params=PALIGEMMA_PARAMS, seed=181, stub="patches",
                    paths=("lm_vlm", "lm_vlm_prefill", "lm_vlm_decode"),
                    categories=PALIGEMMA_CATEGORIES),
}


def _stub_len(cfg) -> int:
    """The stubbed positions a request of ``cfg`` carries: whisper's
    encoder frames, paligemma's patches."""
    return (cfg.encoder_seq_len if cfg.arch_type == "audio"
            else cfg.vision_prefix_len)


def stub_greedy(ops, cfg, params, prompt, extra: dict, new: int):
    """Greedy decoding as a user drives it: ``launch.steps``'
    ``make_prefill_step`` over the prompt and the stubbed frontend's
    inputs ``extra`` (whisper's frames; paligemma's patches, which take the
    first P positions), its cache copied into room for ``new`` more
    positions (the prefill's own cache has the prompt's length and a decode
    ring of it, as the reference's: ROADMAP C), then ``make_serve_step``
    (decode_32k: the full cache) one token at a time at positions P + S,
    P + S + 1, ….  Returns the tokens ``(B, S + new)``, each new token's
    logits, the prefill's launches and the decode steps' own."""
    from repro_torch.configs import get_shape
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import zoo

    b, s = prompt.shape
    p = extra["vision_embeds"].shape[1] if "vision_embeds" in extra else 0
    ops.reset_launches()
    logits, cache = make_prefill_step(cfg)(params,
                                           {"tokens": prompt, **extra})
    prefill_launches = dict(ops.LAUNCHES)
    cache = _with_room(zoo, cfg, cache, b, p + s + new, prompt.device)
    serve = make_serve_step(cfg, get_shape("decode_32k"))
    ops.reset_launches()
    toks, seen = [prompt], [logits]
    for i in range(new):
        tok = torch.argmax(logits, dim=-1).to(prompt.dtype)[:, None]
        toks.append(tok)
        if i + 1 < new:
            pos = torch.full((b,), p + s + i, dtype=torch.int32,
                             device=prompt.device)
            logits, cache = serve(params, cache, tok, pos)
            seen.append(logits)
    return torch.cat(toks, dim=1), seen, prefill_launches, dict(ops.LAUNCHES)


def compare_stubbed_gpu_cpu(ops, dev, arch: str,
                            also: tuple = ()) -> None:
    """Phase 16's whisper and paligemma rows: the reduced float32 ``arch``
    (whisper: 2 encoder and 2 decoder layers, d 256, 16 frames; paligemma:
    2 layers, d 256, 4 query heads over 1 of D 64, 8 patches) from the
    same parameters, tokens and stubbed inputs on the GPU (attention
    kernel: the cross-attention at its own kv length, the prefix-LM mask)
    and on the CPU (plain versions): ``forward_train`` logits (4 × 64
    tokens), ``prefill`` logits and every cache leaf (4 × 48), within
    ``LM_REL_TOL · max|out|`` (slot positions equal); the greedy tokens of
    prefill and then ``decode_step`` (2 × 8 prompt, 8 new) equal (the
    smallest top-1/top-2 gap printed); exactly one forward's attention
    launches a forward or prefill on the GPU, none a decode step; on the
    GPU prefill followed by a decode step reproduces ``forward_train``'s
    logits.  ``also``: more ``reduced()`` overrides whose
    ``forward_train`` logits are held the same way (paligemma's D 256)."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.tree import tree_map

    cfg = get_config(arch).reduced(**LM_REDUCED[arch])
    cpu = zoo.init(cfg, torch.Generator().manual_seed(33), "cpu")
    card = tree_map(lambda a: a.to(dev), cpu)
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(lm_request(cfg.vocab_size, rng, 4, 64)[0])
    stub = stub_inputs(cfg, 4, 34, "cpu")
    p = cfg.vision_prefix_len if cfg.arch_type == "vlm" else 0
    failed, rows = [], {"arch": arch}
    per_forward = lm_forward_launches(cfg)["flash_attention"]

    def check(name, gpu, cpu_out, tol=LM_REL_TOL):
        err, scale = rel_err(gpu.cpu().float(), cpu_out.float())
        rows[name] = dict(max_abs_err=err, tol=tol * scale, max_abs=scale)
        if not (bool(torch.isfinite(gpu).all()) and err <= tol * scale):
            failed.append(f"{name}: {err} > {tol * scale}")

    def batch(d, n, b=4):
        return {"tokens": toks[:b, :n].to(d),
                **{k: v[:b].to(d) for k, v in stub.items()}}

    ops.reset_launches()
    full = {d: zoo.forward_train(cfg, q, batch(d, 64))[0]
            for d, q in (("cpu", cpu), (dev, card))}
    check("forward_logits", full[dev], full["cpu"])
    pre = {d: zoo.prefill(cfg, q, batch(d, 48))
           for d, q in (("cpu", cpu), (dev, card))}
    check("prefill_logits", pre[dev][0], pre["cpu"][0])
    for key, a in pre[dev][1].items():
        if key == "pos":
            if not torch.equal(a.cpu(), pre["cpu"][1][key]):
                failed.append("prefill cache positions differ")
        else:
            check(f"prefill_{key}_cache", a, pre["cpu"][1][key])
    rows["launches_forward_and_prefill"] = dict(ops.LAUNCHES)
    if ops.LAUNCHES["flash_attention"] != 2 * per_forward:
        failed.append(f"reduced GPU run launched {ops.LAUNCHES}")
    greedy = {d: stub_greedy(ops, cfg, q, toks[:2, :8].to(d),
                             {k: v[:2].to(d) for k, v in stub.items()}, 8)
              for d, q in (("cpu", cpu), (dev, card))}
    top2 = torch.topk(torch.stack(greedy["cpu"][1]), 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).min().item()
    rows["decode_greedy"] = dict(
        equal=torch.equal(greedy[dev][0].cpu(), greedy["cpu"][0]),
        min_top2_margin=margin, prefill_launches=greedy[dev][2],
        decode_launches=greedy[dev][3])
    if not rows["decode_greedy"]["equal"]:
        failed.append(f"greedy tokens differ (smallest margin {margin})")
    if (greedy[dev][2]["flash_attention"] != per_forward
            or any(greedy[dev][3].values())):
        failed.append(f"greedy decode launched {greedy[dev][2:]}")
    # prefill + one decode step == forward_train, on the GPU
    last, cache = zoo.prefill(cfg, card, batch(dev, 48))
    step, _ = zoo.decode_step(
        cfg, card, _with_room(zoo, cfg, cache, 4, p + 64, dev),
        toks[:, 48:49].to(dev),
        torch.full((4,), p + 48, dtype=torch.int32, device=dev))
    check("gpu_prefill_vs_forward", last, full[dev][:, 47].cpu())
    check("gpu_decode_vs_forward", step, full[dev][:, 48].cpu())
    for over in also:
        wide = get_config(arch).reduced(**LM_REDUCED[arch], **over)
        wcpu = zoo.init(wide, torch.Generator().manual_seed(35), "cpu")
        wcard = tree_map(lambda a: a.to(dev), wcpu)
        ops.reset_launches()
        got = zoo.forward_train(wide, wcard, batch(dev, 64))[0]
        tag = "forward_logits_" + "_".join(f"{k}_{v}"
                                           for k, v in over.items())
        check(tag, got, zoo.forward_train(wide, wcpu, batch("cpu", 64))[0])
        if ops.LAUNCHES["flash_attention"] != per_forward:
            failed.append(f"{tag} launched {ops.LAUNCHES}")
    print("lm reduced gpu-vs-cpu " + json.dumps(rows))
    if failed:
        fail(f"reduced {arch} GPU run differs from the CPU run: {failed}")


def serve_stubbed_full_width(ops, dev, arch: str) -> dict:
    """Phases 18 and 19: ``arch`` at full width and depth, one random
    seeded expert built on the card, bf16 — whisper-large-v3 (32 encoder
    and 32 decoder layers, d 1280, 20 heads of D 64, vocab 51866) or
    paligemma-3b (18 layers, d 2048, 8 query heads over 1 of D 256, d_ff
    16384, vocab 257216, a prefix of 256 patches): two scoring requests
    (``zoo.forward_train`` over 4 × 1024 tokens and the stubbed frontend's
    4 × 1500 frames or 4 × 256 patches, the token-mean CE of the next
    tokens; exactly one forward's ``flash_attention`` launches each:
    whisper 96 — 32 encoder, 32 causal self-, 32 cross-attentions —,
    paligemma 18 prefix-LM attentions), a prefill of 4 × 1024 tokens
    through ``make_prefill_step`` (the same launches; a cache of
    ``make_cache``'s leaves at the prompt's length, the patches included),
    a greedy decode of batch 2 (prompt 16, 16 new tokens:
    ``stub_greedy``, the prefill's launches and none a decode step) and
    one profiled scoring request; request seconds, tokens/s and device
    memory.  Returns the launches of its paths."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import zoo
    from repro_torch.models.transformer import cross_entropy
    from repro_torch.tree import tree_leaves

    spec = STUBBED[arch]
    scoring, prefilling, decoding = spec["paths"]
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(
        spec["seed"]), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(a.numel() for a in leaves)
    nbytes = sum(a.numel() * a.element_size() for a in leaves)
    depth = (f"{cfg.num_encoder_layers} encoder + {cfg.num_layers} decoder "
             f"layers" if cfg.num_encoder_layers
             else f"{cfg.num_layers} layers")
    print(f"full width: {arch}, one expert of {n_params} parameters "
          f"({nbytes} bytes; {depth}, the full depth), built on the card in "
          f"{t_init:.1f} s; resident "
          f"{torch.cuda.memory_allocated() - base} bytes")
    if n_params != spec["params"]:
        fail(f"{arch} has {n_params} parameters, not {spec['params']}")
    rng = np.random.default_rng(82)
    m = _stub_len(cfg)
    p = m if cfg.arch_type == "vlm" else 0
    launches = {}

    def request(b, s, seed):
        toks, labels = lm_request(cfg.vocab_size, rng, b, s)
        return ({"tokens": torch.from_numpy(toks).to(dev),
                 **stub_inputs(cfg, b, seed, dev)},
                torch.from_numpy(labels).to(dev))

    for i in range(LM_REQUESTS):
        batch, labels = request(LM_BATCH, LM_SEQ, 90 + i)
        _sync(dev)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, _ = zoo.forward_train(cfg, params, batch)
        ce = cross_entropy(logits, labels, chunk=cfg.logits_chunk).item()
        sec = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all()) and math.isfinite(ce)
        print("lm request " + json.dumps(dict(
            arch=arch, path="scoring", request=i, batch=LM_BATCH,
            tokens=LM_SEQ, **{spec["stub"]: m}, seconds=sec,
            tokens_per_s=LM_BATCH * LM_SEQ / sec,
            **{f"{spec['stub']}_per_s": LM_BATCH * m / sec},
            perplexity=math.exp(ce), logits=list(logits.shape),
            finite=finite, peak_bytes=torch.cuda.max_memory_allocated())))
        if not (finite and tuple(logits.shape) == (LM_BATCH, LM_SEQ,
                                                   cfg.vocab_size)):
            fail(f"{arch} scoring request {i}: logits {logits.shape}, "
                 f"finite {finite}")
        launches[scoring] = _check_launches(ops, scoring, 1, cfg)
        del logits

    batch, _ = request(LM_BATCH, LM_SEQ, 95)
    _sync(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(a).all()) for a in (logits, *(
        a for k, a in cache.items() if k != "pos")))
    shapes = {k: list(a.shape) for k, a in cache.items()}
    want = {k: list(a.shape) for k, a in zoo.make_cache(
        cfg, LM_BATCH, p + LM_SEQ, torch.device("meta")).items()}
    print("lm request " + json.dumps(dict(
        arch=arch, path="prefill", batch=LM_BATCH, tokens=LM_SEQ,
        **{spec["stub"]: m}, seconds=sec,
        tokens_per_s=LM_BATCH * LM_SEQ / sec, finite=finite,
        logits=list(logits.shape), cache=shapes)))
    if not (finite and tuple(logits.shape) == (LM_BATCH, cfg.vocab_size)
            and shapes == want and torch.equal(
                cache["pos"], torch.arange(p + LM_SEQ, device=dev,
                                           dtype=torch.int32)
                .expand(LM_BATCH, -1))):
        fail(f"{arch} prefill output is not finite logits (B, V) and a "
             f"full cache {want}")
    launches[prefilling] = _check_launches(ops, prefilling, 1, cfg)
    del logits, cache

    batch, _ = request(DECODE_BATCH, DECODE_PROMPT, 96)
    prompt = batch.pop("tokens")
    _sync(dev)
    t0 = time.perf_counter()
    out, _, pre_launches, _ = stub_greedy(ops, cfg, params, prompt, batch,
                                          DECODE_NEW)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    new = out[:, DECODE_PROMPT:]
    print("lm request " + json.dumps(dict(
        arch=arch, path="decode_greedy", batch=DECODE_BATCH,
        prompt=DECODE_PROMPT, new_tokens=DECODE_NEW, seconds=sec,
        new_tokens_per_s=DECODE_BATCH * DECODE_NEW / sec,
        shape=list(out.shape), tokens=new.tolist(),
        prefill_launches=pre_launches)))
    if (tuple(out.shape) != (DECODE_BATCH, DECODE_PROMPT + DECODE_NEW)
            or not torch.equal(out[:, :DECODE_PROMPT], prompt)
            or bool(((new < 0) | (new >= cfg.vocab_size)).any())
            or pre_launches["flash_attention"]
            != lm_forward_launches(cfg)["flash_attention"]):
        fail(f"{arch} greedy decode output is not the prompt and "
             f"in-vocabulary tokens, or its prefill launched "
             f"{pre_launches}")
    # the counts since the decode steps began (stub_greedy's last reset)
    launches[decoding] = _check_launches(ops, decoding, 0, cfg)

    batch, _ = request(LM_BATCH, LM_SEQ, 97)
    profiled(lambda: zoo.forward_train(cfg, params, batch),
             spec["categories"], path=scoring, arch=arch, batch=LM_BATCH,
             tokens=LM_SEQ, **{spec["stub"]: m})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 22: FSDP training and the dry-run (ROADMAP A.8b's LM half, A.11)
# ---------------------------------------------------------------------------

#: phase 22's step: deepseek-coder-33b at full width, its first 2 layers, one
#: AdamW step (lr 1e-3 after a warm-up of one step) of a global 2 × 1024
#: batch drawn from the seed
FSDP_JOB = dict(arch="deepseek-coder-33b", full=True, layers=2, batch=2,
                seq=1024, seed=22, device="cuda")
#: the bf16 gradients (and first moment, and global norm) of the ``(2, 1)``
#: step against the unsharded one, of each leaf's largest |value|: each
#: rank's partial weight gradient rounds to bf16, their sum rounds again
#: and the unsharded gradient once — two bf16 ulps (2⁻⁶), the port's bf16
#: model bound.  Two witnesses of the phase show that the distance is
#: rounding: the unsharded step in two microbatches (its bf16 partial
#: gradients summed, no collective) lies about as far from the unsharded
#: step, and the same ``(2, 1)`` step in float32 (``FSDP_F32_JOB``) meets
#: the float32 checks' 1e-3 (on an H100: 7.6e-3 for ``(2, 1)``, 5.6e-3 for
#: the microbatches, 6.2e-6 in float32)
FSDP_GRAD_REL = 2.0 ** -6
#: the float32 witness: ``FSDP_JOB`` at the same width and batch in
#: float32, 1 layer (two ranks' float32 state and unsharded references
#: share the card)
FSDP_F32_JOB = dict(FSDP_JOB, layers=1,
                    overrides={"param_dtype": "float32",
                               "activation_dtype": "float32"})
#: the dry-runs of part (c): (arch, shape, multi_pod)
FSDP_DRYRUNS = (("deepseek-coder-33b", "train_4k", False),
                ("mixtral-8x7b", "train_4k", True))


def _fsdp_step_row(label, row, unsharded_s) -> None:
    c, ln = row["collectives"], row["launches"]
    print(f"fsdp {label}: step {row['seconds']:.4f} s (unsharded "
          f"{unsharded_s:.4f} s), peak {row['peak_bytes']} B, loss "
          f"{row['loss']:.6f} (rel {row['loss_rel']:.3e}), grads "
          f"{row['grad_rel']:.3e} of max, first moment {row['mu_rel']:.3e}"
          f" of max, grad norm {row['grad_norm']:.6f} (rel "
          f"{row['grad_norm_rel']:.3e}), params {row['param_ratio']:.3f} "
          f"of bound, bitwise {row['bitwise']}; a step: "
          f"{c['all_gather']} gathers, {c['reduce_scatter']} "
          f"reduce-scatters, {c['all_reduce']} all-reduces, "
          f"{ln.get('flash_attention', 0)} flash_attention, "
          f"{ln.get('flash_attention_bwd', 0)} flash_attention_bwd")


def _fsdp_dryrun_line(label, r, measured_s=None) -> None:
    from repro_torch.launch.dryrun import roofline_line

    roof = r["roofline"]
    bound = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    extra = ("" if measured_s is None else
             f"; measured {measured_s:.4f} s, the bound {bound / measured_s:.3f}"
             f" of it")
    print(f"fsdp dryrun {label}: {roofline_line(r)} bound {bound:.4e} s, "
          f"collectives {json.dumps(r['collectives']['count_by_type'])}, "
          f"reckoned tp all-reduces {r['collectives']['reckoned']['count']}"
          f"{extra}")


def train_fsdp(ops, dev) -> dict:
    """Phase 22 (a)–(c).  (a) ``FSDP_JOB``'s step unsharded in this
    process (twice: the second is timed), then on a one-rank NCCL ``(1,
    1)`` mesh with the FSDP policy installed (twice; the second timed, its
    launches counted from 0: 2 layers × 2 forward — remat — and 2
    backward attention launches; every gathered layer a gather, its
    gradient a reduce-scatter), which must be bitwise the unsharded step;
    then two gloo ranks sharing ``cuda:0`` on ``(2, 1)``
    (``fsdp_parity.parity_rank``: each rank runs the unsharded step, then
    its FSDP step, and holds its cut to the unsharded one: loss within
    ``LOSS_REL`` 1e-4; every gradient and first-moment leaf within
    ``FSDP_GRAD_REL`` of its max and the global norm within it relative;
    every updated parameter within ``fsdp_parity.update_bound``).  The
    witnesses of that bf16 bound: the unsharded step in two microbatches
    against the unsharded step, and ``FSDP_F32_JOB`` on the same two
    ranks (same spawn), held to ``GRAD_REL`` 1e-3.
    (b) The seconds, peaks, collectives and launches a step of each run,
    and the dry-run of the same step on the same meshes (``dryrun_one``
    with the 2-layer config, a 2 × 1024 train shape, ``{"data": D,
    "model": 1}``) beside the measured seconds.  (c) The production
    dry-runs of ``FSDP_DRYRUNS``.  Returns the ``(1, 1)`` step's
    launches under ``lm_train_fsdp``."""
    import torch.distributed as dist

    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun, fsdp_parity
    from repro_torch.launch.mesh import make_lm_mesh, spawn
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.tree import tree_leaves, tree_map

    cfg = fsdp_parity.resolve_config(FSDP_JOB)
    opt = fsdp_parity.AdamWConfig(learning_rate=fsdp_parity.LR,
                                  warmup_steps=1)
    params, batch = fsdp_parity.make_inputs(
        cfg, FSDP_JOB["batch"], FSDP_JOB["seq"], FSDP_JOB["seed"], dev)
    print(f"fsdp {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
          f"{sum(p.numel() for p in tree_leaves(params))} parameters, "
          f"batch {FSDP_JOB['batch']} x {FSDP_JOB['seq']}")
    for _ in range(2):
        want = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fsdp_parity.step_outputs(cfg, params, batch, opt)
        torch.cuda.synchronize()
        unsharded_s = time.perf_counter() - t0
    if not math.isfinite(float(want["loss"])):
        fail(f"fsdp unsharded loss {float(want['loss'])}")
    _, mb_grads = make_grad_step(cfg, microbatches=2)(
        tree_map(torch.clone, params), batch)
    mb_rel = max(fsdp_parity.leaf_rel(tree_leaves(mb_grads),
                                      tree_leaves(want["grads"])))
    del mb_grads
    print(f"fsdp witness: the unsharded step in 2 microbatches (bf16 "
          f"partial gradients summed, no collective): grads within "
          f"{mb_rel:.3e} of max")

    mesh = make_lm_mesh(1, 1, device=dev, backend="nccl")
    try:
        for _ in range(2):
            got = fsdp_parity.fsdp_outputs(cfg, params, batch, opt, mesh)
        launches = dict(got["launches"])
        row = {"collectives": got["collectives"], "launches": launches,
               "seconds": got["seconds"], "peak_bytes": got["peak_bytes"],
               **fsdp_parity.compare(got, want, opt)}
    finally:
        dist.destroy_process_group()
    _fsdp_step_row("(1, 1) nccl", row, unsharded_s)
    if not row["bitwise"]:
        fail(f"fsdp (1, 1): not bitwise the unsharded step: {row}")
    want_attn = {"flash_attention": 2 * cfg.num_layers,
                 "flash_attention_bwd": cfg.num_layers}
    for name, n in want_attn.items():
        if launches.get(name, 0) != n:
            fail(f"fsdp (1, 1): {name} launched {launches.get(name, 0)} "
                 f"times a step, not {n}")
    cut_leaves = 7 * cfg.num_layers        # wq wk wv wo, gate up down
    if (row["collectives"]["all_gather"] != 2 * cut_leaves
            or row["collectives"]["reduce_scatter"] != cut_leaves):
        fail(f"fsdp (1, 1): collectives {row['collectives']}")
    one_s = row["seconds"]
    del got, want, params, batch
    gc.collect()
    torch.cuda.empty_cache()

    dirs = {}
    for key in ("bf16", "f32"):
        dirs[key] = os.path.join(WORK, "fsdp", key)
        shutil.rmtree(dirs[key], ignore_errors=True)
        os.makedirs(dirs[key])
    t0 = time.perf_counter()
    spawn(fsdp_parity.parity_rank, 2,
          [dict(FSDP_JOB, out_dir=dirs["bf16"]),
           dict(FSDP_F32_JOB, out_dir=dirs["f32"])],
          backend="gloo", device="cuda")
    print(f"fsdp (2, 1) gloo: two ranks, bf16 and float32 jobs, in "
          f"{time.perf_counter() - t0:.1f} s")
    f32_layers = FSDP_F32_JOB["layers"]
    checks = (("bf16", FSDP_GRAD_REL, launches),
              ("f32", fsdp_parity.GRAD_REL,
               {"flash_attention": 2 * f32_layers,
                "flash_attention_bwd": f32_layers}))
    results = {}
    for key, bound, want_launches in checks:
        rows = results[key] = fsdp_parity.read_rows(dirs[key], 2)
        for r in rows:
            _fsdp_step_row(f"(2, 1) gloo {key} rank {r['rank']}", r,
                           unsharded_s)
            if (not fsdp_parity.within(r, bound)
                    or not math.isfinite(r["loss"])):
                fail(f"fsdp (2, 1) {key} rank {r['rank']} off the "
                     f"unsharded step (gradient bound {bound:.3e}): {r}")
            if r["launches"] != want_launches:
                fail(f"fsdp (2, 1) {key} rank {r['rank']} launches "
                     f"{r['launches']} != {want_launches}")
        if (rows[0]["loss"] != rows[1]["loss"]
                or rows[0]["grad_norm"] != rows[1]["grad_norm"]):
            fail(f"fsdp (2, 1) {key}: the ranks' losses or norms differ: "
                 f"{rows}")
    rows = results["bf16"]
    worst = {k: max(r["grad_rel"] for r in v) for k, v in results.items()}
    print(f"fsdp (2, 1): bf16 grads within {worst['bf16']:.3e} of max "
          f"(bound {FSDP_GRAD_REL:.3e}; 2 microbatches unsharded "
          f"{mb_rel:.3e}); float32 at 1 layer {worst['f32']:.3e} (bound "
          f"{fsdp_parity.GRAD_REL:.0e})")

    shape = InputShape("train_2x1024", FSDP_JOB["seq"], FSDP_JOB["batch"],
                       "train")
    for d, measured in ((1, one_s), (2, max(r["seconds"] for r in rows))):
        r = dryrun.dryrun_one(cfg.name, shape.name, save=False,
                              cfg_override=cfg, shape=shape,
                              mesh_shape={"data": d, "model": 1})
        _fsdp_dryrun_line(f"({d}, 1)", r, measured)
    for arch, name, multi in FSDP_DRYRUNS:
        r = dryrun.dryrun_one(arch, name, multi_pod=multi, save=False)
        _fsdp_dryrun_line(r["mesh"], r)
        print(f"    memory_analysis: {r['memory_analysis']}")
    return {"lm_train_fsdp": launches}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.config import dit_b2, router_b2

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
        "ssd_scan_bwd": check_ssd_scan_bwd(ops, ref, dev),
        "adaln_fuse_bwd": check_adaln_bwd(ops, ref, dev),
        "flash_attention_bwd": check_flash_bwd(ops, ref, dev),
    }
    # the flag-form fuse kernel's path is its entry point, driven above
    launches_fuse = summary["hetero_fuse"].pop("launches")
    phase_done("3 (kernels against plain versions)")

    launches, engines = serve_full_width(ops, dev)
    launches.update(serve_options(ops, engines["native"]))
    launches.update(serve_strategies(ops, engines, dev))
    phase_done("4 (DiT serving)")
    profile_request(engines["native"], "native")
    profile_request(engines["native"], "native", plan_refresh_every=2)
    profile_request(engines["int8"], "int8")
    profile_request(engines["fp8"], "fp8")
    profile_request(engines["native"], "full", strategy="full")
    profile_request(engines["native"], "threshold", strategy="threshold")
    phase_done("5 (DiT profiles)")
    dit_cfg, router_cfg = dit_b2(), router_b2(num_clusters=len(MIX))
    launches.update(serve_elastic(ops, engines, dev, DIT_PATH, dit_cfg,
                                  router_cfg))
    gc.collect()
    phase_done("10 (elastic membership)")
    launches.update(serve_continuous(ops, engines, dev, dit_cfg))
    phase_done("11 (continuous batching)")
    launches.update(serve_resilience(ops, engines, dev, DIT_PATH, dit_cfg,
                                     router_cfg))
    phase_done("12 (resilience)")
    launches.update(serve_mesh(ops, engines, dev, DIT_PATH, dit_cfg))
    phase_done("21 (the expert/data mesh)")
    del engines
    shutil.rmtree(DIT_PATH)
    gc.collect()
    torch.cuda.empty_cache()
    compare_gpu_cpu(ops, dev)
    compare_train_gpu_cpu(dev)
    phase_done("6 (DiT reduced GPU vs CPU)")
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(train_full_width(ops, ref, dev))
    phase_done("13 (training)")
    gc.collect()
    torch.cuda.empty_cache()

    lm_launches, ens = serve_lm_full_width(ops, dev, "mamba2-2.7b")
    launches.update(lm_launches)
    profile_lm_request(ens)
    del ens
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("7 (LM serving and profile)")
    compare_lm_gpu_cpu(ops, dev)
    compare_lm_train_gpu_cpu(ops, dev)
    phase_done("8 (LM reduced GPU vs CPU)")
    for arch in ("mamba2-2.7b", "internlm2-1.8b", "zamba2-2.7b"):
        gc.collect()
        torch.cuda.empty_cache()
        launches.update(train_lm_full_width(ops, dev, arch))
    phase_done("14 (LM training)")
    for arch in ("zamba2-2.7b", "internlm2-1.8b"):
        gc.collect()
        torch.cuda.empty_cache()
        lm_launches, ens = serve_lm_full_width(ops, dev, arch)
        launches.update(lm_launches)
        profile_lm_request(ens)
        del ens
    for arch in ("zamba2-2.7b", "internlm2-1.8b"):
        gc.collect()
        torch.cuda.empty_cache()
        compare_lm_attention_bf16(ops, ref, dev, arch)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("15 (hybrid and dense LM serving and profiles)")
    for arch in ("zamba2-2.7b", "internlm2-1.8b"):
        compare_lm_gpu_cpu(ops, dev, arch)
        compare_lm_train_gpu_cpu(ops, dev, arch)
    for over in MOE_RUNS:
        compare_lm_gpu_cpu(ops, dev, "mixtral-8x7b", over)
        compare_lm_train_gpu_cpu(ops, dev, "mixtral-8x7b", over)
    compare_stubbed_gpu_cpu(ops, dev, WHISPER)
    compare_lm_train_gpu_cpu(ops, dev, WHISPER)
    compare_stubbed_gpu_cpu(ops, dev, PALIGEMMA, also=(dict(head_dim=256),))
    compare_lm_train_gpu_cpu(ops, dev, PALIGEMMA)
    phase_done("16 (hybrid, dense, MoE, whisper and paligemma LM reduced "
               "GPU vs CPU)")
    for arch, layers in MOE_SERVE_LAYERS.items():
        gc.collect()
        torch.cuda.empty_cache()
        lm_launches, ens = serve_lm_full_width(ops, dev, arch, layers)
        launches.update(lm_launches)
        if arch == "mixtral-8x7b":
            profile_lm_request(ens)
        del ens
    gc.collect()
    torch.cuda.empty_cache()
    compare_moe_impls(dev)
    launches.update(train_lm_full_width(ops, dev, "mixtral-8x7b", layers=2,
                                        batch=1, seq=LONG_SEQ))
    for arch in ("deepseek-67b", "deepseek-coder-33b"):
        gc.collect()
        torch.cuda.empty_cache()
        compare_lm_attention_bf16(ops, ref, dev, arch)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("17 (MoE and deepseek LM experts)")
    launches.update(serve_stubbed_full_width(ops, dev, WHISPER))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(train_lm_full_width(ops, dev, WHISPER))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("18 (whisper-large-v3 serving and training)")
    launches.update(serve_stubbed_full_width(ops, dev, PALIGEMMA))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(train_lm_full_width(ops, dev, PALIGEMMA))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("19 (paligemma-3b serving and training)")
    run_cli(dev)
    phase_done("9 (serving CLI)")
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(run_examples(ops, dev))
    phase_done("20 (the four DiT examples)")
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(train_fsdp(ops, dev))
    phase_done("22 (FSDP training and the dry-run)")

    # each kernel's launches on the served path that exercises it
    where = {"ragged_gemm": "native", "ragged_gemm_int8": "int8",
             "ragged_gemm_fp8": "fp8", "hetero_fuse_step": "native",
             "hetero_fuse_coeffs": "unfused", "hetero_fuse_dequant": "int8",
             "adaln_fuse": "native", "flash_attention": "native",
             "hetero_fuse": "fused_convert_and_fuse",
             "ssd_scan": "lm_scoring", "adaln_fuse_bwd": "train",
             "flash_attention_bwd": "train", "ssd_scan_bwd": "lm_train"}
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
        # the backward kernels differentiate these TPU kernels' functions
        "adaln_fuse_bwd": ("adaln_fuse.cu", "adaln_fuse.py:34"),
        "flash_attention_bwd": ("flash_attention_bwd.cu",
                                "flash_attention.py:82"),
        "ssd_scan_bwd": ("ssd_scan.cu", "ssd_scan.py:86"),
    }
    # the LM serving paths of phase 15, each with its own shape's numbers
    entries = [(name, where[name], summary[name]) for name in sources]
    for name in ("flash_attention", "ssd_scan", "flash_attention_bwd"):
        by_path = summary[name].pop("by_path")
        entries += [(name, path, by_path[path]) for path in by_path]
    kernels = []
    for name, path, numbers in entries:
        src, tpu = sources[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/{tpu}",
            launches=launches[path][name], path=path,
            launches_by_path={p: n[name] for p, n in launches.items()
                              if n.get(name)},
            **numbers))
    for kern in kernels:
        if kern["launches"] <= 0:
            fail(f"{kern['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
