"""The port's dry-run (``repro_torch.launch.dryrun``) and its op counter
(``launch.op_cost``), on the CPU without a card.

The counter is held to exact numbers: one matrix product's ``2·M·N·K``
FLOPs and its operands' and result's bytes; an L-layer loop counting L
times one layer (the Python loop is the trip count); a port kernel —
the attention, forward and backward, and the SSD scan — as one
operation of its own FLOP and byte formula (``KERNEL_COSTS``, the
reckoning of ``PERF.md``'s kernel table), never as its plain version's
S×S intermediates; a fake all-gather and reduce-scatter at their wire
bytes.  ``dryrun_one`` on reduced configs and the production meshes
returns the reference's result keys, marks its tensor-parallel term
reckoned, and leaves no process group behind (it also refuses to start
beside one); the CLI writes its artifact.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, fsdp, op_cost
from repro_torch.launch.hlo_analysis import wire_factor
from repro_torch.models import transformer
from repro_torch.tree import tree_map

#: the reference's ``dryrun_one`` result keys (``repro/launch/dryrun.py``)
REF_KEYS = {"arch", "shape", "mesh", "devices", "params_total",
            "params_active", "compile_s", "cost_analysis",
            "memory_analysis", "collectives", "roofline",
            "model_flops_total", "model_flops_per_device",
            "useful_flops_ratio", "param_bytes_global",
            "param_bytes_per_device_est", "tag"}
REF_COLLECTIVE_KEYS = {"bytes_by_type", "count_by_type", "total_wire_bytes",
                       "flat_wire_bytes"}
REF_ROOFLINE_KEYS = {"flops_per_device", "bytes_per_device",
                     "collective_bytes_per_device", "compute_s", "memory_s",
                     "collective_s", "dominant"}


def test_one_matmul_counts_exactly():
    """``(64, 32) @ (32, 16)`` float32: 2·64·16·32 FLOPs, its operands
    read and result written once (bytes), one op; a view is free."""
    with FakeTensorMode():
        a, b = torch.empty(64, 32), torch.empty(32, 16)
        with op_cost.counting() as cost:
            y = a @ b
            y.t()
    t = cost.totals
    assert t.flops == 2 * 64 * 16 * 32
    assert t.hbm_bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert t.ops == 1


def _layer_loop(x, w, layers):
    for _ in range(layers):
        x = torch.tanh(x @ w) + x
    return x


def test_layer_loop_counts_layers_times_one():
    """A loop of L layers counts L times one layer's FLOPs, bytes and ops;
    a reduced transformer's forward grows by the same amount a layer."""
    with FakeTensorMode():
        x, w = torch.empty(8, 48), torch.empty(48, 48)
        totals = []
        for layers in (1, 5):
            with op_cost.counting() as cost:
                _layer_loop(x, w, layers)
            totals.append(cost.totals)
        one, five = totals
        assert (five.flops, five.hbm_bytes, five.ops) == (
            5 * one.flops, 5 * one.hbm_bytes, 5 * one.ops)

        base = dataclasses.replace(get_config("internlm2-1.8b").reduced(),
                                   num_kv_heads=2)
        runs = []
        for layers in (1, 2, 3):
            cfg = dataclasses.replace(base, num_layers=layers)
            meta = transformer.init(cfg, None, "meta")
            params = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype),
                              meta)
            tokens = torch.zeros((2, 16), dtype=torch.int32)
            with op_cost.counting() as cost:
                transformer.forward_train(cfg, params, tokens)
            runs.append(cost.totals)
    assert runs[2].flops - runs[1].flops == runs[1].flops - runs[0].flops > 0
    assert runs[2].hbm_bytes - runs[1].hbm_bytes == \
        runs[1].hbm_bytes - runs[0].hbm_bytes
    assert [r.kernels["flash_attention"] for r in runs] == [1, 2, 3]


def test_port_kernels_count_as_one_op_by_their_formula():
    """The attention (causal GQA 8/2, bf16) forward and backward, and the
    SSD scan forward and backward: each exactly its ``KERNEL_COSTS``
    formula and one op — no S×S scores of the plain version."""
    b, hq, hkv, s, d = 2, 8, 2, 128, 64
    with FakeTensorMode():
        q = torch.empty(b, hq, s, d, dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.empty(b, hkv, s, d, dtype=torch.bfloat16,
                        requires_grad=True)
        v = torch.empty(b, hkv, s, d, dtype=torch.bfloat16,
                        requires_grad=True)
        with op_cost.counting() as cost:
            out = ops.flash_attention_gqa(q, k, v, causal=True)
        assert out.shape == q.shape and out.dtype == q.dtype
        fwd = cost.totals
        shape = dict(b=b, hq=hq, hkv=hkv, s=s, skv=s, d=d, elt=2,
                     causal=True, window=0, prefix=0)
        f_flops, f_bytes = op_cost.flash_attention_cost(**shape)
        assert (fwd.flops, fwd.hbm_bytes, fwd.ops) == (f_flops, f_bytes, 1)
        assert f_flops == 4 * d * b * hq * s * (s + 1) / 2
        with op_cost.counting() as cost:
            torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        bw = cost.totals
        b_flops, b_bytes = op_cost.flash_attention_bwd_cost(**shape)
        assert bw.kernels == {"flash_attention_bwd": 1}
        assert bw.flops == b_flops and bw.hbm_bytes >= b_bytes

        x = torch.empty(2, 4, 64, 16, requires_grad=True)
        dt, A = torch.empty(2, 4, 64), torch.empty(4)
        B_, C_ = torch.empty(2, 64, 8), torch.empty(2, 64, 8)
        with op_cost.counting() as cost:
            y, state = ops.ssd_scan(x, dt, A, B_, C_, chunk=16)
            y.sum().backward()
        assert y.shape == x.shape and state.shape == (2, 4, 16, 8)
    sf, _ = op_cost.ssd_scan_cost(b=2, h=4, s=64, p=16, n=8, q=16, elt=4)
    sb, _ = op_cost.ssd_scan_bwd_cost(b=2, h=4, s=64, p=16, n=8, q=16,
                                      elt=4)
    assert cost.totals.kernels == {"ssd_scan": 1, "ssd_scan_bwd": 1}
    assert cost.totals.flops == sf + sb
    assert ops.COUNTER is None


def test_real_tensors_compute_while_counting():
    """Under ``counting()`` real CPU tensors take the plain versions as
    without it: the attention's and the SSD scan's outputs are bitwise
    those of an uncounted call, and no kernel is reported."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, h, 32, 16, generator=g) for h in (4, 2, 2))
    x = torch.randn(1, 2, 32, 8, generator=g)
    dt, A = torch.rand(1, 2, 32, generator=g), -torch.rand(2, generator=g)
    B_, C_ = (torch.randn(1, 32, 4, generator=g) for _ in range(2))
    want = (ops.flash_attention_gqa(q, k, v, causal=True),
            *ops.ssd_scan(x, dt, A, B_, C_, chunk=8))
    with op_cost.counting() as cost:
        got = (ops.flash_attention_gqa(q, k, v, causal=True),
               *ops.ssd_scan(x, dt, A, B_, C_, chunk=8))
    assert cost.totals.kernels == {}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fake_collectives_count_wire_bytes():
    """On a fake world of 4: an all-gather of a (8, 16) float32 cut counts
    its (32, 16) result times 3/4, a reduce-scatter its (32, 16) operand
    times 3/4, an all-reduce 2·3/4 of its bytes; the world is gone
    after."""
    with dryrun.fake_world(4):
        name = dist.group.WORLD.group_name
        with FakeTensorMode():
            x = torch.empty(8, 16)
            with op_cost.counting() as cost:
                c = torch.ops._c10d_functional
                y = c.wait_tensor(c.all_gather_into_tensor(x, 4, name))
                c.wait_tensor(c.reduce_scatter_tensor(y, "sum", 4, name))
                c.wait_tensor(c.all_reduce(x, "sum", name))
    assert not dist.is_initialized()
    t = cost.totals
    full = 32 * 16 * 4
    assert t.collective_by_type == {
        "all-gather": full * wire_factor("all-gather", 4),
        "reduce-scatter": full * wire_factor("reduce-scatter", 4),
        "all-reduce": full / 4 * wire_factor("all-reduce", 4)}
    assert t.collective_count == {"all-gather": 1, "reduce-scatter": 1,
                                  "all-reduce": 1}
    assert t.collective_bytes == pytest.approx(0.75 * full * 2
                                               + 1.5 * full / 4)


TINY = {"train": InputShape("train_4k", 64, 256, "train"),
        "prefill": InputShape("prefill_32k", 128, 32, "prefill"),
        "decode": InputShape("decode_32k", 128, 128, "decode"),
        "long": InputShape("long_500k", 256, 1, "decode")}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("kind", list(TINY))
def test_dryrun_one_reduced_on_production_meshes(tmp_path, monkeypatch,
                                                 kind, multi_pod):
    """``dryrun_one`` of the reduced deepseek-coder-33b (FSDP, remat as the
    full config) at each step kind, cut in length, on both production meshes: the reference's
    result keys, the H100 denominators, FSDP gathers where it trains,
    the reckoned tensor-parallel term, the specs' bytes per device, the
    JSON artifact, and no process group left."""
    monkeypatch.setattr(dryrun, "ART_DIR", str(tmp_path))
    cfg = dataclasses.replace(get_config("deepseek-coder-33b").reduced(),
                              num_heads=4, num_kv_heads=1, remat=True)
    assert cfg.fsdp_params and cfg.decode_window
    shape = TINY[kind]
    r = dryrun.dryrun_one("deepseek-coder-33b", shape.name,
                          multi_pod=multi_pod, cfg_override=cfg,
                          shape=shape, tag="reduced")
    assert not dist.is_initialized() and fsdp.installed_mesh() is None
    assert REF_KEYS <= set(r)
    assert REF_COLLECTIVE_KEYS <= set(r["collectives"])
    assert set(r["roofline"]) == REF_ROOFLINE_KEYS
    assert r["devices"] == (512 if multi_pod else 256)
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    roof = r["roofline"]
    assert roof["compute_s"] == pytest.approx(
        roof["flops_per_device"] / 989e12)
    assert roof["memory_s"] == pytest.approx(
        roof["bytes_per_device"] / 3.35e12)
    assert roof["collective_s"] == pytest.approx(
        roof["collective_bytes_per_device"] / 450e9)
    tp = r["collectives"]["reckoned"]
    assert tp["count"] > 0 and tp["all-reduce"] > 0
    assert "embedding" in tp["left_out"]
    assert r["collectives"]["total_wire_bytes"] == pytest.approx(
        r["collectives"]["flat_wire_bytes"] + tp["all-reduce"])
    if kind == "train":
        counts = r["collectives"]["count_by_type"]
        # remat: each layer gathered twice, its gradients scattered once
        assert counts["all-gather"] == 2 * counts["reduce-scatter"] > 0
        # float32 moments mu and nu beside float32 parameters
        assert r["memory_analysis"]["opt_bytes_per_device"] == \
            pytest.approx(2 * r["memory_analysis"]["param_bytes_per_device"])
        assert r["kernels"] == {"flash_attention": 4,
                                "flash_attention_bwd": 2}
    assert r["cost_analysis"]["flops"] > 0
    path = tmp_path / f"deepseek-coder-33b_{shape.name}_{r['mesh']}_reduced.json"
    assert json.loads(path.read_text())["roofline"] == r["roofline"]


def test_dryrun_refuses_beside_a_process_group_and_cli(tmp_path, monkeypatch,
                                                       capsys):
    """With a default process group already running the dry-run raises and
    leaves it be; the CLI (``--arch paligemma-3b --shape decode_32k``,
    full size) prints its roofline line and writes its artifact."""
    monkeypatch.setattr(dryrun, "ART_DIR", str(tmp_path))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            dryrun.dryrun_one("internlm2-1.8b", "decode_32k", save=False)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    dryrun.main(["--arch", "paligemma-3b", "--shape", "decode_32k"])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("OK  paligemma-3b") and "dominant=" in line
    r = json.loads(
        (tmp_path / "paligemma-3b_decode_32k_16x16.json").read_text())
    assert REF_KEYS <= set(r) and r["shape"] == "decode_32k"
    assert r["params_total"] > 2.9e9 and not dist.is_initialized()
