"""Time the SSD scan's backward kernels and the mamba2-2.7b training step
of several trees of this repository, in turns, on one card — or their
attention kernels, their zamba2-2.7b and internlm2-1.8b scoring, or
those two models' training steps.

    python3 tools/compare_trees.py [--only MEASUREMENT] TREE [TREE ...]

MEASUREMENT is one of kernel, step, breakdown, flash, flash_bwd, lm and
lm_train; without it, kernel and step.

Each TREE is the root of a checkout (this one, or an older commit unpacked
with ``git archive`` into a directory ``.gitignore`` lists).  For each, in
the order given, a fresh process imports that tree's ``chip_smoke.py`` and
its ``repro_torch``, builds its kernels, and runs its
``check_ssd_scan_bwd`` (phase 3's backward cases at the mixer shape) and
``train_lm_full_width`` (phase 14), as that tree's ``chip_smoke.py`` would;
the lines each prints are prefixed with the tree's position and name.
``--only breakdown`` instead profiles 20 backward calls at the mixer
shape in bf16 and reports each kernel's device milliseconds a call.
``--only flash`` runs the tree's ``check_flash`` (phase 3's attention
cases), ``--only flash_bwd`` its ``check_flash_bwd`` (the attention
backward cases), ``--only lm`` its phase-15 serving of zamba2-2.7b and
internlm2-1.8b (``serve_lm_full_width`` and ``profile_lm_request``), and
``--only lm_train`` its phase-14 training of internlm2-1.8b and
zamba2-2.7b (``train_lm_full_width``: steps and a profiled step).  The
last line is one JSON object: per run, the tree, its mixer-shape backward
row (or breakdown) and its training step's seconds and tokens/s, or its
attention (or attention backward) cases, or its scoring requests and
profiles, or its dense and hybrid training steps and their profiles.
Give the trees in
turns (parent, change, change, parent) to see the spread.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import builtins
import json
import os
import subprocess
import sys


def one(tree: str, only: str | None) -> dict:
    """Run the measurements of ``tree`` in this process."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_trees: no CUDA device")
    tree = os.path.abspath(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import chip_smoke
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    out = {"tree": tree}
    if only == "breakdown":
        out["ssd_scan_bwd_breakdown"] = breakdown(chip_smoke, dev)
    if only in (None, "kernel"):
        out["ssd_scan_bwd"] = chip_smoke.check_ssd_scan_bwd(ops, ref, dev)
    if only in (None, "step"):
        rows = grab(chip_smoke, "lm_train ")
        chip_smoke.train_lm_full_width(ops, dev)
        row = rows[-1]
        out["lm_train"] = {k: row[k] for k in (
            "step_s_median", "step_s_min", "tokens_per_s", "peak_bytes")}
    if only == "flash":
        rows = grab(chip_smoke, "flash_attention case ")
        chip_smoke.check_flash(ops, ref, dev)
        out["flash_attention"] = [{k: r[k] for k in (
            "case", "design", "ms", "library_ms", "bound_ms",
            "share_of_bound", "max_abs_err", "tol") if k in r} for r in rows]
    if only == "flash_bwd":
        rows = grab(chip_smoke, "flash_attention_bwd case ")
        chip_smoke.check_flash_bwd(ops, ref, dev)
        out["flash_attention_bwd"] = [{k: r[k] for k in (
            "case", "design", "ms", "kernel_ms", "library_ms", "bound_ms",
            "share_of_bound", "max_abs_err", "scratch_mbytes") if k in r}
            for r in rows]
    if only == "lm_train":
        steps = {p: grab(chip_smoke, p + " ")
                 for p in ("lm_train_dense", "lm_train_hybrid")}
        profiles = grab(chip_smoke, "profile ")
        for arch in ("internlm2-1.8b", "zamba2-2.7b"):
            chip_smoke.train_lm_full_width(ops, dev, arch)
            torch.cuda.empty_cache()
        out["lm_train"] = {path: {k: rows[-1][k] for k in (
            "arch", "step_s_median", "step_s_min", "tokens_per_s",
            "peak_bytes")} for path, rows in steps.items()}
        out["profiles"] = [{k: p[k] for k in (
            "path", "device_busy_ms", "device_idle_share",
            "ms_by_category")} for p in profiles]
    if only == "lm":
        requests = grab(chip_smoke, "lm request ")
        profiles = grab(chip_smoke, "profile ")
        for arch in ("zamba2-2.7b", "internlm2-1.8b"):
            _, ens = chip_smoke.serve_lm_full_width(ops, dev, arch)
            chip_smoke.profile_lm_request(ens)
            del ens
            torch.cuda.empty_cache()
        out["lm"] = {
            "scoring_s": {r["arch"]: [q["seconds"] for q in requests
                                      if q["arch"] == r["arch"]
                                      and q["path"] == "scoring"]
                          for r in requests},
            "profiles": [{k: p[k] for k in (
                "arch", "profiled_request_s", "device_busy_ms",
                "device_idle_share", "ms_by_category")} for p in profiles]}
    return out


def grab(chip_smoke, prefix: str) -> list:
    """The rows ``chip_smoke`` prints after ``prefix`` from now on, as
    parsed JSON (its lines still print)."""
    rows = []
    inner = getattr(chip_smoke, "print", builtins.print)

    def catch(*args, **kw):
        line = " ".join(str(a) for a in args)
        if line.startswith(prefix + "{"):
            rows.append(json.loads(line[len(prefix):]))
        inner(*args, **kw)

    chip_smoke.print = catch
    return rows


def breakdown(chip_smoke, dev, calls: int = 20) -> dict:
    """Device ms a call of each kernel of the SSD scan's backward at the
    tree's mixer shape (``chip_smoke.SSD_SHAPE``) in bf16, from
    ``torch.profiler`` over ``calls`` calls after a warm-up."""
    import re

    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

    b, h, s, p, n, chunk = chip_smoke.SSD_SHAPE
    x, dt, A, B, C = chip_smoke._ssd_inputs(dev, b, h, s, p, n,
                                            torch.bfloat16, seed=17)
    dy = torch.randn(b, s, h, p, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(18)
                     ).to(torch.bfloat16).transpose(1, 2)
    _, _, starts = ssd_scan(x, dt, A, B, C, chunk=chunk, with_starts=True)
    for _ in range(3):
        ssd_scan_bwd(x, dt, A, B, C, starts, dy, chunk=chunk)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            ssd_scan_bwd(x, dt, A, B, C, starts, dy, chunk=chunk)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(ssd_scan\w*)", e.key)
        if m:
            out[m.group(1)] = e.device_time_total / calls / 1000
    out["total"] = sum(out.values())
    print("ssd_scan_bwd breakdown " + json.dumps(out))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernel", "step", "breakdown",
                                       "flash", "flash_bwd", "lm",
                                       "lm_train"))
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    if args.one:
        print("compare_trees result " + json.dumps(one(args.trees[0],
                                                       args.only)))
        return
    results = []
    for i, tree in enumerate(map(os.path.abspath, args.trees)):
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree]
        if args.only:
            cmd[2:2] = ["--only", args.only]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=tree)
        for line in proc.stdout:
            print(f"[{i} {os.path.basename(tree)}] "
                  + line.rstrip(), flush=True)
            if line.startswith("compare_trees result "):
                results.append(json.loads(line[len("compare_trees result "):]))
        if proc.wait() != 0:
            raise SystemExit(f"compare_trees: {tree} failed")
    print(json.dumps({"runs": results}))


if __name__ == "__main__":
    main()
