"""The port's four DiT examples (``repro_torch.examples``) on the CPU.

* every example runs through ``main([... "--device", "cpu"])`` at a tiny
  size and prints the reference example's lines, in its order, with
  finite numbers (the line patterns below are the reference's f-strings;
  the elastic walkthrough's lines less ``traces=``, which the port does
  not compile);
* the checkpoints ``train_decentralized`` writes cross both packages: the
  JAX package's ``load_checkpoint`` reads each with the metadata its own
  ``expert_metadata`` gives for the same arguments, and the JAX engine
  and the port's serve that directory from the same text and the JAX
  engine's noise within ``1e-4 · max|latent|`` (as
  ``tests/test_torch_serve.py``);
* ``convert_checkpoint``'s Eq. 20 report and Eq. 21 table equal the
  reference example's lines (run through ``runpy``), and both hold the
  linear path's identity within 1e-5;
* ``serve_heterogeneous`` on an empty directory starts the port's trainer
  (``-m repro_torch.examples.train_decentralized``), never a file under
  ``examples/``.
"""

from __future__ import annotations

import contextlib
import io
import math
import os
import re
import runpy
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro.training import expert_metadata as j_expert_metadata
from repro.training import load_checkpoint as j_load_checkpoint
from repro_torch.core.sampling import SamplerConfig
from repro_torch.data import SyntheticSpec
from repro_torch.examples import (convert_checkpoint, quickstart,
                                  serve_heterogeneous, train_decentralized)
from repro_torch.launch.serve import ServingEngine
from repro_torch.models.config import dit_b2, router_b2
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = r"(-?[0-9.]+(?:e[-+][0-9]+)?|nan|inf)"
#: the tiny ensemble of the shared run: the reference's 4 experts
#: (2 DDPM : 2 FM, the default recipe; serve_heterogeneous's router has
#: 4 classes), 2 steps of batch 4
EXPERTS, DDPM, STEPS, BATCH = 4, 2, 2, 4
SERVE_REL = 1e-4


def _run(main, argv) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def _match(lines: list[str], patterns: list[str]) -> list[re.Match]:
    """Each line against its pattern, in order; every number finite."""
    assert len(lines) == len(patterns), "\n".join(lines)
    found = []
    for line, pat in zip(lines, patterns):
        m = re.fullmatch(pat, line)
        assert m, f"{line!r} does not match {pat!r}"
        for g in m.groups():
            if g is not None and re.fullmatch(NUM, g):
                assert math.isfinite(float(g)), line
        found.append(m)
    return found


def _train_patterns(k: int, ddpm: int, out: str) -> list[str]:
    objs = ["ddpm" if c < ddpm else "fm" for c in range(k)]
    return ([rf"\[1/4\] clustering corpus into {k} partitions \.\.\.",
             r"      cluster sizes: \[[0-9 ]+\]",
             rf"\[2/4\] training {k} isolated experts \({ddpm} DDPM : "
             rf"{k - ddpm} FM\) \.\.\.",
             rf"      expert size: {NUM}M params"]
            + [rf"      expert {c} \[{o}\] loss {NUM} \({NUM}s\)"
               for c, o in enumerate(objs)]
            + [r"\[3/4\] training router \(independent, all clusters\) "
               r"\.\.\.",
               rf"      router acc {NUM}",
               r"\[4/4\] sampling with heterogeneous fusion \.\.\.",
               rf"done: \(64, 8, 8, 4\) samples, FID-proxy {NUM}, "
               rf"checkpoints in {re.escape(out)}"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One tiny ``train_decentralized`` run: its directory and lines."""
    out = str(tmp_path_factory.mktemp("hddm"))
    lines = _run(train_decentralized.main, [
        "--experts", str(EXPERTS), "--ddpm-experts", str(DDPM),
        "--steps", str(STEPS), "--batch", str(BATCH), "--out", out,
        "--device", "cpu"])
    return dict(out=out, lines=lines)


def test_train_decentralized_prints_the_reference_lines(trained):
    _match(trained["lines"], _train_patterns(EXPERTS, DDPM, trained["out"]))
    assert sorted(os.listdir(trained["out"])) == sorted(
        [f"expert{c}.npz" for c in range(EXPERTS)] + ["router.npz"])


def test_corpus_captions_take_the_config_widths():
    """The reduced corpus is the reference example's (captions 8 × 32);
    under ``--full`` the captions take DiT-B/2's 77 × 768, which its text
    projection reads (the reference keeps 8 × 32 there, ROADMAP C)."""
    reduced = dit_b2().reduced(latent_size=8)
    assert train_decentralized.corpus_spec(reduced, 4) == SyntheticSpec(
        num_categories=4, latent_size=8, separation=3.0)
    full = train_decentralized.corpus_spec(dit_b2(), 8)
    assert (full.latent_size, full.text_len, full.text_dim) == (32, 77, 768)


def test_checkpoints_load_in_the_jax_package(trained):
    cfg = dit_b2().reduced(latent_size=8)
    for cid in range(EXPERTS):
        obj = "ddpm" if cid < DDPM else "fm"
        params, meta = j_load_checkpoint(
            os.path.join(trained["out"], f"expert{cid}.npz"))
        assert meta == j_expert_metadata(
            name=f"expert{cid}", objective=obj,
            schedule="cosine" if obj == "ddpm" else "linear",
            cluster_id=cid, arch=cfg.name, step=STEPS)
        assert all(np.isfinite(np.asarray(a)).all()
                   for a in jax.tree.leaves(params))
    _, meta = j_load_checkpoint(os.path.join(trained["out"], "router.npz"))
    assert meta == {"num_clusters": EXPERTS}


def test_both_engines_serve_the_port_checkpoints(trained):
    """Top-2, CFG 7.5, 3 steps, batch 2: the JAX engine's noise handed to
    the port (``noise=``), the same text."""
    sampler = dict(num_steps=3, cfg_scale=7.5, top_k=2)
    jeng = JServingEngine.from_checkpoint_dir(
        trained["out"], dit_cfg=j_dit_b2().reduced(latent_size=8),
        router_cfg=j_router_b2(num_clusters=EXPERTS).reduced(latent_size=8),
        sampler=JSamplerConfig(**sampler))
    eng = ServingEngine.from_checkpoint_dir(
        trained["out"], dit_cfg=dit_b2().reduced(latent_size=8),
        router_cfg=router_b2(num_clusters=EXPERTS).reduced(latent_size=8),
        sampler=SamplerConfig(**sampler), device="cpu")
    cfg = dit_b2().reduced(latent_size=8)
    text = np.random.default_rng(3).standard_normal(
        (2, cfg.text_len, cfg.text_dim)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (2, 8, 8, 4),
                                         dtype=jnp.float32))
    want = np.asarray(jeng.generate(key, text, 2))
    got = eng.generate(0, text, 2, noise=noise).numpy()
    assert np.isfinite(got).all()
    tol = SERVE_REL * np.abs(want).max()
    assert np.abs(want - noise).max() > 100 * tol    # the experts act
    assert np.abs(got - want).max() <= tol


def _serve_patterns(objs: list[str], requests: int) -> list[str]:
    experts = re.escape(str(objs))
    lines = []
    for strategy, dispatch, params in (("top1", "gathered", "native"),
                                       ("topk", "gathered", "native"),
                                       ("full", "auto", "native")):
        lines.append(
            rf"strategy={strategy:5s} dispatch={dispatch:8s} "
            rf"params={params:6s} experts={experts} first={NUM}s "
            rf"steady={NUM}s \({NUM} img/s\) cond_cache=0h/{requests}m "
            rf"plan_refreshes={NUM}")
    membership = (r"elastic: membership: live=6/8 added=0 evicted=0 .*",
                  r"elastic: hot-added slot 6, evicted slot 2 between "
                  r"submit\(\) and flush\(\) — 2 dispatches",
                  r"elastic: membership: live=6/8 added=1 evicted=1 .*")
    return lines + list(membership)


def test_serve_heterogeneous_prints_the_reference_lines(trained):
    lines = _run(serve_heterogeneous.main, [
        "--ckpt", trained["out"], "--batch", "2", "--requests", "2",
        "--steps", "2", "--device", "cpu"])
    objs = ["ddpm"] * DDPM + ["fm"] * (EXPERTS - DDPM)
    _match(lines, _serve_patterns(objs, 2))


def test_serve_on_an_empty_directory_runs_the_port_trainer(
        trained, tmp_path, monkeypatch):
    """The subprocess is the port's module on the same device; the fake
    run copies the shared run's checkpoints where the trainer would have
    written them, and serving goes on from there."""
    calls = []

    def fake_run(cmd, check, env):
        calls.append((cmd, env))
        out = cmd[cmd.index("--out") + 1]
        shutil.copytree(trained["out"], out, dirs_exist_ok=True)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(serve_heterogeneous.subprocess, "run", fake_run)
    ckpt = str(tmp_path / "empty")
    lines = _run(serve_heterogeneous.main, [
        "--ckpt", ckpt, "--batch", "2", "--requests", "1", "--steps", "2",
        "--device", "cpu"])
    (cmd, env), = calls
    assert cmd == [sys.executable, "-m",
                   "repro_torch.examples.train_decentralized", "--out", ckpt,
                   "--steps", "40", "--device", "cpu"]
    assert not any("examples" + os.sep in part or part.endswith(".py")
                   for part in cmd)
    assert env["PYTHONPATH"].split(os.pathsep)[0] == os.path.join(REPO,
                                                                  "src")
    assert lines[0] == (f"no checkpoints under {ckpt} — training a tiny "
                        "ensemble first ...")
    objs = ["ddpm"] * DDPM + ["fm"] * (EXPERTS - DDPM)
    _match(lines[1:], _serve_patterns(objs, 1))


def _convert_sections(lines: list[str]) -> tuple[list[str], list[str],
                                                 float]:
    """The Eq. 20 report lines, the Eq. 21 table and the linear path's
    identity error of a convert_checkpoint run."""
    report = [ln for ln in lines if re.fullmatch(r"  \w+ +-> \w+", ln)]
    table = [ln for ln in lines if ln.startswith("  t=")]
    err, = (float(re.search(r"= (\S+)", ln).group(1)) for ln in lines
            if ln.startswith("  linear: |v - (eps - x0)|"))
    return report, table, err


def test_convert_checkpoint_matches_the_reference_example():
    got = _run(convert_checkpoint.main, ["--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(REPO, "examples", "convert_checkpoint.py"),
                       run_name="__main__")
    want = out.getvalue().splitlines()
    g_report, g_table, g_err = _convert_sections(got)
    w_report, w_table, w_err = _convert_sections(want)
    assert len(w_report) == 9 and len(w_table) == 4
    assert g_report == w_report
    assert g_table == w_table
    assert g_err <= 1e-5 and w_err <= 1e-5
    # the other lines, numbers aside
    def shape(lines):
        return [re.sub(NUM, "#", ln) for ln in lines]
    assert shape(got) == shape(want)


def test_quickstart_prints_the_reference_lines(monkeypatch):
    monkeypatch.setattr(quickstart, "STEPS", 2)
    monkeypatch.setattr(quickstart, "BATCH", 4)
    lines = _run(quickstart.main, ["--device", "cpu"])
    _match(lines, [rf"expert 0 \(ddpm/cosine\) final loss {NUM}",
                   rf"expert 1 \(fm/linear\) final loss {NUM}",
                   rf"router acc {NUM}",
                   rf"samples \(64, 8, 8, 4\), FID-proxy {NUM}, "
                   r"finite=True"])


@pytest.mark.parametrize("module", [train_decentralized, serve_heterogeneous,
                                    convert_checkpoint, quickstart],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_run_on_the_card_by_default(module):
    """Without ``--device`` an example resolves the card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
