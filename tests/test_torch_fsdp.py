"""FSDP training of the port (``repro_torch.launch.fsdp``: the cut, the
gather before use, the gradients' reduce-scatter, the averaged
replicated gradients and MoE batch means) on the CPU, against the port's
unsharded step and the JAX package's ``make_train_step``.

Reduced float32 configs of every family with ``fsdp_params=True`` —
dense (internlm2, GQA 4/2), MoE (mixtral, ``dense_scan`` with its
load-balance loss), SSM (mamba2), hybrid (zamba2), audio (whisper), VLM
(paligemma) and the deepseek-coder group of 7 under remat — take one
step on a ``(2, 1)`` mesh of two gloo ranks (``launch.mesh.spawn``, one
spawn for them all), each rank on its half of the batch.  The ranks'
cuts, joined, are held to

* the port's unsharded step, by ``fsdp_parity.compare``: the loss
  within ``LOSS_REL = 1e-4`` relative; every gradient leaf and every
  first-moment leaf within ``GRAD_REL = 1e-3`` of its largest |value|
  (the port's first-step gradient checks); the global gradient norm
  (summed over the ranks' cuts) within ``GRAD_REL`` relative; every
  updated parameter within ``fsdp_parity.update_bound`` — float32
  rounding plus ``lr·ε/(|u| + ε)`` where the gradient's sign is sure,
  ``2·lr`` only where the unsharded gradient is below the leaf's
  gradient difference — so a skipped, sign-flipped or wrongly clipped
  update fails;
* the reference's jitted ``make_train_step`` (its updated parameters and
  first moment), ``jax.value_and_grad`` of its ``zoo.loss_fn`` and its
  ``global_norm`` on the same numpy weights and batch, to the same
  bounds (float32 sums in another order, as
  ``tests/test_torch_lm_training.py``'s ``1e-5``/``1e-4``, well inside).

The ``(1, 1)`` mesh (a world of one, in this process, torn down after)
must be bitwise the unsharded step, and the capacity dispatch raises
under data sharding (on the dry-run's fake world, which the test also
sees torn down).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.launch import steps as JS
from repro.models import zoo as jzoo
from repro.training import optimizer as JOpt
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun, fsdp, fsdp_parity
from repro_torch.launch.mesh import make_lm_mesh, spawn
from repro_torch.launch.sharding import param_specs
from repro_torch.tree import tree_leaves
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

GRAD_REL = fsdp_parity.GRAD_REL
LR = fsdp_parity.LR

#: the families' reduced configs (overrides of ``reduced()``)
FAMILIES = {
    "internlm2-1.8b": dict(num_kv_heads=2),
    "mixtral-8x7b": {},
    "mamba2-2.7b": {},
    "zamba2-2.7b": {},
    "whisper-large-v3": {},
    "paligemma-3b": {},
    "deepseek-coder-33b": dict(num_heads=7, num_kv_heads=1, head_dim=32,
                               remat=True, logits_chunk=16),
}
BATCH, SEQ, SEED = 4, 32, 3


def _job(arch, out_dir):
    return dict(arch=arch, overrides=FAMILIES[arch], batch=BATCH, seq=SEQ,
                seed=SEED, device="cpu", out_dir=out_dir, save=True,
                threads=1)


@pytest.fixture(scope="module")
def two_ranks():
    """One spawn of two gloo ranks running every family's job; each
    family's directory holds the ranks' rows and cut outputs."""
    with tempfile.TemporaryDirectory(prefix="fsdp_test_") as root:
        jobs = []
        for arch in FAMILIES:
            d = os.path.join(root, arch)
            os.makedirs(d)
            jobs.append(_job(arch, d))
        spawn(fsdp_parity.parity_rank, 2, jobs)
        out = {}
        for job in jobs:
            rows = fsdp_parity.read_rows(job["out_dir"], 2)
            cuts = [torch.load(os.path.join(job["out_dir"], f"rank{r}.pt"))
                    for r in range(2)]
            out[job["arch"]] = (rows, cuts)
        yield out


def _inputs(arch):
    cfg = fsdp_parity.resolve_config(_job(arch, None))
    params, batch = fsdp_parity.make_inputs(cfg, BATCH, SEQ, SEED, "cpu")
    return cfg, params, batch


def _joined(cuts, params):
    """The two ranks' outputs joined: each tree's cuts along each leaf's
    cut dim (a whole leaf: rank 0's, which must equal rank 1's), the loss
    and the global gradient norm rank 0's (rank 1's are equal)."""
    mesh = type("Mesh", (), {"shape": {"data": 2, "model": 1},
                             "axis_names": ("data", "model")})()
    dims = tree_leaves(fsdp._cut_dims(param_specs(params, mesh, fsdp=True),
                                      fsdp.BLOCK_KEYS, {"data"}))
    out = {}
    for key in ("grads", "params", "mu"):
        leaves = []
        for d, a, b in zip(dims, tree_leaves(cuts[0][key]),
                           tree_leaves(cuts[1][key])):
            if d is None:
                assert torch.equal(a, b)
                leaves.append(a)
            else:
                leaves.append(torch.cat([a, b], dim=d))
        out[key] = leaves
    assert any(d is not None for d in dims)
    for key in ("loss", "grad_norm"):
        assert torch.equal(cuts[0][key], cuts[1][key])
        out[key] = cuts[0][key]
    return out


def _jax_step(cfg, params, batch):
    """The reference's loss, gradients, global gradient norm, updated
    parameters and first moment on the same numpy weights and batch
    (``tree_leaves`` order: sorted keys, as the port's), as ``compare``
    takes them."""
    jcfg = dataclasses.replace(j_get_config(cfg.name).reduced(),
                               **FAMILIES[cfg.name], fsdp_params=True)
    jp = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), params)
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    step = JS.make_train_step(jcfg, JOpt.AdamWConfig(learning_rate=LR,
                                                     warmup_steps=1))

    def both(p):
        # one program: the step, and the gradients it takes
        grads = jax.grad(lambda q: jzoo.loss_fn(jcfg, q, jb)[0])(p)
        new_p, state, loss = step(p, JOpt.adamw_init(p), jb)
        return loss, grads, JOpt.global_norm(grads), new_p, state.mu

    out = jax.jit(both)(jp)

    def leaves(tree):
        return [torch.from_numpy(np.array(x)) for x in jax.tree.leaves(tree)]

    return {"loss": torch.tensor(float(out[0])), "grads": leaves(out[1]),
            "grad_norm": torch.tensor(float(out[2])),
            "params": leaves(out[3]), "mu": leaves(out[4])}


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_fsdp_two_ranks_match_unsharded_and_jax(one_torch_thread, two_ranks,
                                               arch):
    """The ``(2, 1)`` step of each family: each rank's cut within the
    bounds of the port's unsharded step (checked on the rank), the ranks
    agreeing on the loss, and the joined cuts within the bounds of the
    port's unsharded step and of the reference's step."""
    rows, cuts = two_ranks[arch]
    for row in rows:
        assert fsdp_parity.within(row, GRAD_REL), row
    assert rows[0]["loss"] == rows[1]["loss"]
    assert rows[0]["grad_norm"] == rows[1]["grad_norm"]
    c = rows[0]["collectives"]
    assert c["all_gather"] > 0 and c["reduce_scatter"] > 0
    # remat gathers each layer again in the backward
    factor = 2 if FAMILIES[arch].get("remat") else 1
    assert c["all_gather"] == factor * c["reduce_scatter"]

    cfg, params, batch = _inputs(arch)
    got = _joined(cuts, params)
    opt = fsdp_parity.AdamWConfig(learning_rate=LR, warmup_steps=1)
    row = fsdp_parity.compare(got, fsdp_parity.step_outputs(
        cfg, params, batch, opt), opt)
    assert fsdp_parity.within(row, GRAD_REL), row
    row = fsdp_parity.compare(got, _jax_step(cfg, params, batch), opt)
    assert fsdp_parity.within(row, GRAD_REL), row


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-coder-33b",
                                  "whisper-large-v3"])
def test_fsdp_one_rank_mesh_is_bitwise_unsharded(one_torch_thread, arch):
    """On the ``(1, 1)`` mesh (a world of one in this process) the step —
    gathers and reduce-scatters over a group of one — is bitwise the
    unsharded step: loss, every gradient and updated parameter.  The
    process group is torn down after, and ``clear()`` leaves the models'
    ``maybe_unshard`` the identity."""
    assert not dist.is_initialized()
    try:
        cfg, params, batch = _inputs(arch)
        opt = fsdp_parity.AdamWConfig(learning_rate=LR, warmup_steps=1)
        mesh = make_lm_mesh(1, 1, device="cpu", backend="gloo")
        assert mesh.shape == {"data": 1, "model": 1} and mesh.data_size == 1
        want = fsdp_parity.step_outputs(cfg, params, batch, opt)
        got = fsdp_parity.fsdp_outputs(cfg, params, batch, opt, mesh)
        row = fsdp_parity.compare(got, want, opt)
        assert row["bitwise"], row
        assert got["collectives"]["all_gather"] > 0
        # the policy is process-wide: autograd's device threads (a CUDA
        # backward, its remat recompute) see it too
        fsdp.install(mesh, param_specs(params, mesh, fsdp=True), ("data",))
        seen = []
        worker = threading.Thread(target=lambda: seen.append(
            fsdp.installed_mesh()))
        worker.start()
        worker.join()
        assert seen == [mesh]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        fsdp.clear()
    assert not dist.is_initialized()
    blocks = params["blocks"] if "blocks" in params else params["dec_blocks"]
    assert fsdp.maybe_unshard(blocks) is blocks


def test_capacity_dispatch_raises_under_data_sharding():
    """``moe_impl="dropping"`` on a data size of 2 raises (its capacity
    is per batch, ROADMAP A.19) — on the dry-run's fake world, torn down
    after; a model axis over 1 on a real world raises too (A.18)."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              moe_impl="dropping", fsdp_params=True)
    shape = InputShape("train_tiny", 16, 4, "train")
    with pytest.raises(NotImplementedError, match="A.19"):
        dryrun.dryrun_one("mixtral-8x7b", "train_tiny", save=False,
                          cfg_override=cfg, shape=shape,
                          mesh_shape={"data": 2, "model": 1})
    assert not dist.is_initialized()
    mesh = type("Mesh", (), {"shape": {"data": 1, "model": 2},
                             "axis_names": ("data", "model"),
                             "backend": "gloo"})()
    with pytest.raises(NotImplementedError, match="A.18"):
        fsdp.install(mesh, {}, ("data",))
    fsdp.clear()
