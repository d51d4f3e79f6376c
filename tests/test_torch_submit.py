"""``submit``/``flush``, ``padding_stats`` and the CLI of the port's serving
engine, on the CPU, against the JAX package's.

The engines load the ensemble of ``tests/test_torch_serve.py`` (eight
jittered reduced DiT experts, 2 DDPM + 6 FM, and a router, written by the
JAX package's ``save_checkpoint``).  A flushed group gets the exact noise
the JAX engine draws from each request's key; top-2, CFG 7.5, 4 steps.

Tolerance: latents ``max |Δ| ≤ 1e-4 · max |latent|``, as in
``test_torch_serve.py`` (float32 GEMMs summed in another order than XLA,
amplified by CFG 7.5 and compounded over four steps).  A coalesced request
against ``generate`` from the same seed in the same package: the same
tolerance (the router's and cross-attention's GEMMs run at another batch,
which may sum in another order); the latents of the two paths are
otherwise the same function of the same noise.
"""

from __future__ import annotations

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.launch import serve as jserve
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch import serve
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.serving.resilience import (DeadlineExceeded, RequestError,
                                            RequestFailed, RequestTimeout)
from test_torch_serve import (  # noqa: F401  (one_torch_thread: a fixture)
    SLICE_REL, STEPS, _write_ensemble, one_torch_thread)

LATENT = (8, 8, 4)


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("submit"))
    cfg = dit_b2().reduced(latent_size=8)
    _write_ensemble(path, cfg, router_b2(num_clusters=8).reduced(
        latent_size=8))
    rng = np.random.default_rng(2)
    texts = [rng.standard_normal((b, cfg.text_len, cfg.text_dim)).astype(
        np.float32) for b in (1, 3, 2)]
    return dict(path=path, texts=texts)


def _sampler(**kw):
    return dict(num_steps=STEPS, cfg_scale=7.5, top_k=2, **kw)


def _engine(path, **kw):
    return serve.ServingEngine.from_checkpoint_dir(
        path, dit_cfg=dit_b2().reduced(latent_size=8),
        router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=SamplerConfig(**_sampler()), device="cpu", **kw)


def _jengine(path, **kw):
    return jserve.ServingEngine.from_checkpoint_dir(
        path, dit_cfg=j_dit_b2().reduced(latent_size=8),
        router_cfg=j_router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=JSamplerConfig(**_sampler()), **kw)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= SLICE_REL * np.abs(want).max(), (err, np.abs(want).max())


def test_flush_matches_jax_flush(ensemble):
    """Three requests of batch 1, 3 and 2 with text: one dispatch padded to
    a batch of 8 on both sides, each request's rows as the JAX engine's."""
    jeng = _jengine(ensemble["path"])
    eng = _engine(ensemble["path"])
    keys = [jax.random.PRNGKey(20 + i) for i in range(3)]
    jh = [jeng.submit(k, t) for k, t in zip(keys, ensemble["texts"])]
    ph = [eng.submit(0, t, noise=np.asarray(jax.random.normal(
        k, (t.shape[0],) + LATENT, dtype=jnp.float32)))
        for k, t in zip(keys, ensemble["texts"])]
    assert jeng.flush() == eng.flush() == 1
    for j, p in zip(jh, ph):
        assert p.state == "DONE" and p.done
        _close(p.result(), j.result())
    for key in ("merged_batches", "batched_requests", "requests",
                "plan_refreshes"):
        assert eng.stats[key] == jeng.stats[key], key
    assert [p.seq for p in ph] == [0, 1, 2]


def test_flush_groups_by_text_and_pads_to_a_power_of_two(ensemble):
    """Text and no-text requests form two groups; each pads with zero noise
    (and zero text) to the next power of two; each request's rows are what
    ``generate`` gives for its seed."""
    eng = _engine(ensemble["path"])
    calls = []
    sample = eng._sample

    def recording(noise, text):
        calls.append((noise.clone(), None if text is None else text.clone()))
        return sample(noise, text)

    eng._sample = recording
    t1, t3, t2 = ensemble["texts"]
    a = eng.submit(1, t1)
    b = eng.submit(2, None, batch_size=3)
    c = eng.submit(3, t2)
    assert eng.flush() == 2
    assert eng.stats["merged_batches"] == 2
    assert eng.stats["batched_requests"] == 3
    (n_text, text), (n_none, none) = calls
    assert n_text.shape[0] == text.shape[0] == n_none.shape[0] == 4
    assert none is None
    assert not n_text[3:].any() and not text[3:].any()
    assert not n_none[3:].any()
    assert [r.result().shape[0] for r in (a, b, c)] == [1, 3, 2]
    ref = _engine(ensemble["path"])
    _close(a.result(), ref.generate(1, t1, 1))
    _close(b.result(), ref.generate(2, None, 3))
    _close(c.result(), ref.generate(3, t2, 2))

    calls.clear()
    eng.submit(4, t1)
    eng.submit(5, t3)
    eng.submit(6, t1)
    eng.flush()
    (noise, text), = calls
    assert noise.shape[0] == 8 and not noise[5:].any()
    assert text.shape[0] == 8 and not text[5:].any()


def test_deadline_expires_before_dispatch(ensemble):
    eng = _engine(ensemble["path"])
    t1 = ensemble["texts"][0]
    late = eng.submit(1, t1, deadline_s=0)
    ok = eng.submit(2, t1, deadline_s=3600)
    assert eng.flush() == 1
    assert late.state == "DEADLINE_EXCEEDED" and not late.done
    with pytest.raises(DeadlineExceeded) as err:
        late.result()
    assert err.value.seq == late.seq == 0 and err.value.requeues == 0
    assert ok.state == "DONE" and ok.result().shape == (1,) + LATENT
    assert eng.stats["deadline_exceeded"] == 1
    assert eng.stats["batched_requests"] == 1


def test_failed_group_is_requeued_then_failed(ensemble):
    """Only the failing group re-queues; the other dispatches.  After
    ``max_request_requeues`` (1) re-queues its requests are FAILED and
    ``result()`` raises ``RequestFailed`` from the dispatch's error."""
    eng = _engine(ensemble["path"])
    sample = eng._sample

    def poisoned(noise, text):
        if text is not None:
            raise RuntimeError("poisoned text group")
        return sample(noise, text)

    eng._sample = poisoned
    t1 = ensemble["texts"][0]
    reqs = [eng.submit(0, t1), eng.submit(1, None), eng.submit(2, t1),
            eng.submit(3, None)]
    assert eng.flush() == 1
    assert [r.state for r in reqs] == ["QUEUED", "DONE", "QUEUED", "DONE"]
    assert [r.seq for r in eng._queue] == [0, 2]
    assert eng.stats["request_requeues"] == 2
    assert eng.flush() == 0
    assert [r.state for r in reqs] == ["FAILED", "DONE", "FAILED", "DONE"]
    assert eng._queue == [] and eng.stats["failed_requests"] == 2
    with pytest.raises(RequestFailed) as err:
        reqs[0].result()
    assert isinstance(err.value, RequestError)
    assert err.value.requeues == 2
    assert isinstance(err.value.__cause__, RuntimeError)


def test_requeues_keep_fifo_order(ensemble):
    """Every group fails: the re-queued requests come back in submission
    order, not in group order."""
    eng = _engine(ensemble["path"])

    def broken(noise, text):
        raise RuntimeError("down")

    eng._sample = broken
    t1 = ensemble["texts"][0]
    for i, text in enumerate((None, t1, None, t1)):
        eng.submit(i, text, batch_size=1)
    assert eng.flush() == 0
    assert [r.seq for r in eng._queue] == [0, 1, 2, 3]
    assert all(r.requeues == 1 for r in eng._queue)


def test_result_of_a_queued_request(ensemble):
    eng = _engine(ensemble["path"])
    req = eng.submit(0, ensemble["texts"][0])
    with pytest.raises(RequestTimeout) as err:
        req.result(timeout=0)
    assert err.value.seq == 0
    with pytest.raises(RuntimeError, match="not yet flushed"):
        req.result()
    with pytest.raises(ValueError, match="batch"):
        eng.submit(0, ensemble["texts"][1], batch_size=2)


def test_padding_stats_match_jax_under_ragged_dispatch(ensemble):
    """Executed rows equal routed rows, ``B·k·g`` a step: overhead 0.0, as
    the JAX engine's runtime counter reads under ``dispatch='ragged'``."""
    jeng = _jengine(ensemble["path"], track_padding=True)
    eng = _engine(ensemble["path"], track_padding=True)
    t3 = ensemble["texts"][1]
    jeng.generate(jax.random.PRNGKey(0), t3, 3)
    eng.generate(0, t3, 3)
    eng.generate(1, None, 2)
    jeng.generate(jax.random.PRNGKey(1), None, 2)
    got = eng.padding_stats()
    assert got == jeng.padding_stats()
    assert got["padding_overhead"] == 0.0
    assert got["padded_rows_per_step"] == (3 * 2 * 2 + 2 * 2 * 1) / 2
    with pytest.raises(ValueError, match="track_padding"):
        _engine(ensemble["path"]).padding_stats()


def _lines(text: str) -> list[str]:
    """Output lines with timings blanked and the reference's ``traces=``
    count dropped."""
    out = []
    for line in text.strip().splitlines():
        line = re.sub(r" traces=\d+", "", line)
        line = re.sub(r"in [0-9.]+s \([0-9.]+ img/s\)", "in Ts (R img/s)",
                      line)
        out.append(line)
    return out


@pytest.mark.parametrize("mode", [
    ["--track-padding"], ["--track-padding", "--coalesce"],
    ["--coalesce", "--deadline-s", "0"], ["--strategy", "full"],
    ["--strategy", "threshold"], ["--engine", "reference"],
    ["--dispatch", "grouped"],
], ids=["plain", "coalesce", "coalesce_deadline0", "full", "threshold",
        "reference", "grouped"])
def test_cli_prints_the_reference_lines(ensemble, capsys, monkeypatch,
                                        mode):
    """The reference CLI's lines, less ``traces=``.  ``--deadline-s`` acts
    under ``--continuous`` only, so ``--coalesce --deadline-s 0`` serves
    every request, as the reference does."""
    # the reference engine recomputes routing every step
    refresh = [] if "--engine" in mode else ["--plan-refresh", "2"]
    argv = ["--ckpt-dir", ensemble["path"], "--batch", "2", "--requests",
            "2", "--steps", "2"] + refresh + mode
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    want = _lines(capsys.readouterr().out)
    serve.main(argv + ["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got == want
    if "--coalesce" in mode:
        assert got[1] == ("coalesced 2 requests -> 1 dispatch(es): 4 imgs "
                          "in Ts (R img/s)")
    else:
        assert got[1] == "request 0: (2, 8, 8, 4) in Ts (R img/s) " \
                         "finite=True"
    if mode == ["--track-padding"]:
        assert got[-1] == ("padding: padded_rows/step=8.00 "
                           "routed_rows/step=8.00 overhead=0.000")


@pytest.mark.parametrize("flag,item", [
    (["--expert-shards", "2"], "A.8"), (["--data-shards", "1"], "A.8"),
], ids=lambda v: v[0] if isinstance(v, list) else v)
def test_cli_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError,
                       match=rf"--{flag[0][2:]} .*queue {item}"):
        serve.main(["--ckpt-dir", "unused", "--device", "cpu"] + flag)
