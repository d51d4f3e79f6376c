"""Dry-run of every (arch × input shape × production mesh) without a card
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each step for 256 or 512 placeholder
devices.  The port has no compiler to ask; it runs the step itself, on a
fake world:

* a ``torch.distributed`` world of the mesh's size on the ``fake``
  backend (``FakeStore``), this process its rank 0, and the production
  mesh on it (``launch.mesh.make_production_mesh``);
* the step of ``launch.steps`` (train, prefill or decode) under
  ``FakeTensorMode`` — nothing is allocated or computed — with rank 0's
  cut of the parameters (``launch.fsdp`` installed where
  ``cfg.fsdp_params``, as the reference does) and its block of the batch
  or cache (``launch.sharding.batch_specs``, ``cache_specs``), counted
  by ``launch.op_cost``: its FSDP collectives run over the fake data
  group and are seen as ``_c10d_functional`` ops.

The port does not execute the "model" (tensor-parallel) axis, so:

* the FLOPs, HBM bytes and FSDP collective bytes per device are rank 0's
  counts divided by the "model" size;
* the parameter and optimizer bytes per device come from the specs, on
  every axis;
* the tensor-parallel activation all-reduces are *reckoned* by the
  Megatron rule — one all-reduce of the block output (a rank's rows ×
  tokens × d_model in the activation dtype) for each column→row product
  pair in the forward, as many in the backward and again for the remat
  recompute — and marked ``"reckoned"``; embedding and unembedding
  tensor-parallel traffic is left out, and the artifact says so.

The roofline's denominators are the H100 SXM's (``launch.mesh``).
Results go to ``ART_DIR`` (``build/dryrun/``, which ``.gitignore``
lists), one JSON file a (arch, shape, mesh).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 40 pairs
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.launch import fsdp
from repro_torch.launch import steps as S
from repro_torch.launch.hlo_analysis import Roofline, model_flops, wire_factor
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                     PRODUCTION_MESHES, _lm_mesh, data_axes,
                                     mesh_devices)
from repro_torch.launch.op_cost import counting
from repro_torch.launch.sharding import (_axis_size, batch_specs,
                                         cache_specs, param_specs)
from repro_torch.tree import tree_leaves, tree_map

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")

#: what the reckoned tensor-parallel term counts, and leaves out
TP_RULE = ("Megatron: one all-reduce of a block output (a rank's rows x "
           "tokens x d_model, activation dtype) per column->row product "
           "pair, forward, backward and remat recompute")
TP_LEFT_OUT = "embedding and unembedding tensor-parallel traffic"


def _active_params(cfg, total: int) -> int:
    """Active params per token (MoE uses top-k of E experts)."""
    if not cfg.num_experts:
        return total
    expert = 3 * cfg.d_model * cfg.d_ff * cfg.num_layers
    inactive = expert * (cfg.num_experts - cfg.num_experts_per_tok)
    return total - inactive


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake``-backend world of ``size`` ranks, this process rank 0,
    torn down on exit; refuses where a default process group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "the dry-run builds a fake world of its own; a default process "
            "group already exists in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _spec_bytes(tree, specs, mesh, itemsize=None) -> float:
    """Bytes a device holds of a tree under its specs (every axis)."""
    total = 0.0
    for x, spec in zip(tree_leaves(tree), _spec_leaves(specs)):
        n = x.numel() * (itemsize or x.element_size())
        for a in spec:
            n /= _axis_size(mesh, a)
        total += n
    return total


def _spec_leaves(specs) -> list:
    """A spec tree's tuples in ``tree_leaves`` order."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def _block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """Rank 0's block of ``x`` under the data entries of ``spec`` (the
    "model" entries are not executed)."""
    drop = set(data_axes(mesh))
    for d, a in enumerate(spec):
        axes = set(a) if isinstance(a, tuple) else {a}
        if a is not None and axes <= drop:
            x = x.narrow(d, 0, x.shape[d] // _axis_size(mesh, a))
    return x


def _fake_like(tree):
    """Fake tensors (the active ``FakeTensorMode``) of a meta tree."""
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype), tree)


def tp_pairs(cfg, shape: InputShape) -> list[tuple[int, int]]:
    """The column→row product pairs of a forward, as ``(pairs, tokens a
    row)``: attention and FFN a dense, MoE or VLM block; a mamba2 mixer;
    the hybrid's shared block twice a group; whisper's encoder blocks
    (over its frames) twice, its decoder blocks three times."""
    seq = 1 if shape.kind == "decode" else shape.seq_len
    if cfg.arch_type == "ssm":
        return [(cfg.num_layers, seq)]
    if cfg.arch_type == "hybrid":
        return [(cfg.num_layers + 2 * (cfg.num_layers // cfg.attn_every),
                 seq)]
    if cfg.arch_type == "audio":
        enc = [] if shape.kind == "decode" else [
            (2 * (cfg.num_encoder_layers or cfg.num_layers),
             cfg.encoder_seq_len)]
        return enc + [(3 * cfg.num_layers, seq)]
    if cfg.arch_type == "vlm" and shape.kind != "decode":
        seq += cfg.vision_prefix_len
    return [(2 * cfg.num_layers, seq)]


def tp_reckoned(cfg, shape: InputShape, rows: int, model: int) -> dict:
    """The reckoned tensor-parallel all-reduces of a device: their count
    and wire bytes over a "model" group of ``model`` ranks."""
    passes = 1
    if shape.kind == "train":
        passes = 3 if cfg.remat else 2
    elt = torch.empty((), dtype=cfg.activation_dtype).element_size()
    count, nbytes = 0, 0.0
    if model > 1:
        for pairs, tokens in tp_pairs(cfg, shape):
            count += passes * pairs
            nbytes += (passes * pairs * rows * tokens * cfg.d_model * elt
                       * wire_factor("all-reduce", model))
    return {"all-reduce": nbytes, "count": count, "rule": TP_RULE,
            "left_out": TP_LEFT_OUT}


def _run_step(cfg, shape: InputShape, mesh, p_shapes, fsdp_on: bool):
    """Rank 0's step under ``FakeTensorMode`` and the op counter (its cut
    of the parameters where ``fsdp_on``: the policy is installed); returns
    the counter's totals and rank 0's batch rows."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    inputs = S.input_specs(cfg, shape)
    with FakeTensorMode():
        params = _fake_like(p_shapes)
        if fsdp_on:
            params = fsdp.shard_params(params)
        if shape.kind == "decode":
            rcfg, _ = S.cfg_for_shape(cfg, shape)
            c_spec = cache_specs(rcfg, mesh, inputs["cache"],
                                 shape.global_batch)
            cache = {k: _block(v, c_spec[k], mesh) for k, v in
                     _fake_like(inputs["cache"]).items()}
            t_spec = batch_specs(cfg, mesh, {"token": inputs["token"],
                                             "pos": inputs["pos"]})
            token = _block(_fake_like(inputs["token"]), t_spec["token"],
                           mesh)
            pos = _block(_fake_like(inputs["pos"]), t_spec["pos"], mesh)
            rows = token.shape[0]
            with counting() as cost:
                S.make_serve_step(cfg, shape)(params, cache, token, pos)
        else:
            b_spec = batch_specs(cfg, mesh, inputs["batch"])
            batch = {k: _block(v, b_spec[k], mesh) for k, v in
                     _fake_like(inputs["batch"]).items()}
            rows = batch["tokens"].shape[0]
            if shape.kind == "train":
                from repro_torch.training.optimizer import adamw_init

                opt = adamw_init(params)
                with counting() as cost:
                    S.make_train_step(cfg)(params, opt, batch)
            else:
                with counting() as cost:
                    S.make_prefill_step(cfg)(params, batch)
    return cost.totals, rows


def dryrun_one(
    arch: str, shape_name: str, *, multi_pod: bool = False,
    save: bool = True, cfg_override=None, tag: str = "",
    shape: InputShape | None = None, mesh_shape: dict | None = None,
) -> dict:
    """One (arch, shape, mesh) dry-run: the reference's result keys.
    ``shape`` replaces ``SHAPES[shape_name]`` and ``mesh_shape`` (axis →
    size, in order) the production mesh, for a cut step."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    if mesh_shape is None:
        dims, axes = PRODUCTION_MESHES[bool(multi_pod)]
    else:
        axes, dims = tuple(mesh_shape), tuple(mesh_shape.values())
    n_world = 1
    for d in dims:
        n_world *= d
    t0 = time.time()
    fsdp_on = bool(cfg.fsdp_params)
    p_shapes = S.param_shapes(cfg)
    n_params = sum(x.numel() for x in tree_leaves(p_shapes))
    with fake_world(n_world):
        mesh = _lm_mesh(dims, axes, torch.device("cpu"))
        ndev = mesh_devices(mesh)
        ps = param_specs(p_shapes, mesh, fsdp=fsdp_on)
        if fsdp_on:
            fsdp.install(mesh, ps, data_axes(mesh))
        else:
            fsdp.clear()
        try:
            totals, rows = _run_step(cfg, shape, mesh, p_shapes, fsdp_on)
        finally:
            fsdp.clear()
    trace_s = time.time() - t0

    model = mesh.shape.get("model", 1)
    dev = totals.scaled(1.0 / model)
    tp = tp_reckoned(cfg, shape, rows, model)
    coll_total = dev.collective_bytes + tp["all-reduce"]
    roof = Roofline(
        flops_per_device=dev.flops,
        bytes_per_device=dev.hbm_bytes,
        collective_bytes_per_device=coll_total,
        peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW, ici_bw=LINK_BW,
    )
    active = _active_params(cfg, n_params)
    mflops = model_flops(cfg, shape, n_params, active)
    mflops_dev = mflops / ndev
    useful = mflops_dev / dev.flops if dev.flops else 0.0

    pbytes = sum(x.numel() * x.element_size()
                 for x in tree_leaves(p_shapes))
    param_dev = _spec_bytes(p_shapes, ps, mesh)
    opt_dev = (2 * _spec_bytes(p_shapes, ps, mesh, itemsize=4)
               if shape.kind == "train" else 0.0)
    mem_info = {"argument_size_in_bytes": param_dev + opt_dev,
                "output_size_in_bytes": (param_dev + opt_dev
                                         if shape.kind == "train" else 0.0),
                "param_bytes_per_device": param_dev,
                "opt_bytes_per_device": opt_dev}
    mesh_name = "x".join(str(d) for d in dims)
    result = {
        "arch": arch, "shape": shape.name,
        "mesh": mesh_name,
        "devices": ndev,
        "params_total": n_params,
        "params_active": active,
        "compile_s": round(trace_s, 1),
        "cost_analysis": {"flops": dev.flops,
                          "bytes accessed": dev.hbm_bytes},
        "memory_analysis": mem_info,
        "collectives": {
            "bytes_by_type": dev.collective_by_type,
            "count_by_type": dev.collective_count,
            "total_wire_bytes": coll_total,
            "flat_wire_bytes": dev.collective_bytes,
            "reckoned": tp,
        },
        "roofline": roof.as_dict(),
        "model_flops_total": mflops,
        "model_flops_per_device": mflops_dev,
        "useful_flops_ratio": useful,
        "param_bytes_global": pbytes,
        "param_bytes_per_device_est": pbytes / ndev,
        "kernels": dev.kernels,
        "ops": dev.ops,
        "tag": tag,
    }
    if save:
        os.makedirs(ART_DIR, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fn = os.path.join(ART_DIR,
                          f"{arch}_{shape.name}_{mesh_name}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=1)
    return result


def roofline_line(r: dict) -> str:
    roof = r["roofline"]
    return (f"OK  {r['arch']:20s} {r['shape']:12s} {r['mesh']:8s} "
            f"trace={r['compile_s']:6.1f}s "
            f"compute={roof['compute_s']:9.3e}s "
            f"memory={roof['memory_s']:9.3e}s "
            f"coll={roof['collective_s']:9.3e}s "
            f"dominant={roof['dominant']:10s} "
            f"useful={r['useful_flops_ratio']:.2f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        pairs = [(args.arch, args.shape)]

    failures = []
    for arch, shape in pairs:
        try:
            r = dryrun_one(arch, shape, multi_pod=args.multi_pod)
            print(roofline_line(r))
            print(f"    memory_analysis: {r['memory_analysis']}")
        except Exception as e:
            failures.append((arch, shape, repr(e)))
            print(f"FAIL {arch} {shape}: {e}")
            if not args.continue_on_error:
                traceback.print_exc()
                raise
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
