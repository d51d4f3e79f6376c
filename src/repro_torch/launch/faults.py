"""Deterministic fault injection for elastic serving.

The paper's deployment (decentralized, unreliable contributors) makes
three fault classes routine:

1. **Bad artifacts** — checkpoints arrive truncated, scrambled, shaped
   for another architecture, or with non-finite parameters.  The writers
   below make each class from a good checkpoint, byte-deterministically
   (no RNG), so tests can check the exact quarantine records.
2. **Membership churn mid-traffic** — an expert is evicted or hot-added
   between a request's ``submit()`` and its ``flush()``; the request must
   be served as its admission-time snapshot says.
3. **Dispatch failures** — one coalesced group fails at flush time; the
   failure must stay inside that group.

``poison_expert_runtime`` / ``heal_expert_runtime`` model silent
corruption of a resident expert, the fault the circuit breaker must
catch from non-finite outputs.  ``toy_ensemble`` is a closed-form
stackable ensemble for these scenarios.

Run the liveness-under-faults scenario on one device (the GPU; ``--device
cpu`` for the CPU); it prints a one-line JSON verdict::

    PYTHONPATH=src python -m repro_torch.launch.faults [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.core.fusion import ExpertSpec
from repro_torch.tree import tree_map

__all__ = [
    "truncate_checkpoint",
    "scramble_checkpoint",
    "poison_checkpoint_nonfinite",
    "mismatch_checkpoint_shapes",
    "poison_expert_runtime",
    "heal_expert_runtime",
    "FlushFaultInjector",
    "toy_ensemble",
    "main",
]


# --- checkpoint corruption writers (byte-deterministic, in place) -----------


def truncate_checkpoint(path: str, frac: float = 0.5) -> str:
    """Cut the artifact off mid-archive, as a dropped transfer would."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with open(path, "rb") as f:
        blob = f.read()
    keep = max(1, int(len(blob) * frac))
    with open(path, "wb") as f:
        f.write(blob[:keep])
    return path


def scramble_checkpoint(path: str) -> str:
    """Replace the artifact with deterministic non-zip bytes."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    size = os.path.getsize(path)
    junk = (b"\xde\xad\xbe\xef" * (size // 4 + 1))[:size]
    with open(path, "wb") as f:
        f.write(junk)
    return path


def _rewrite_npz(path, mutate):
    """Load the flat members, apply ``mutate(flat)``, save in place."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        flat = {k: np.asarray(z[k]) for k in z.files}
    mutate(flat)
    np.savez(path, **flat)
    return path


def poison_checkpoint_nonfinite(path: str, leaf: int = 0) -> str:
    """Set one element of one float leaf to NaN (bit rot, or training
    that diverged); the archive itself stays well formed."""

    def mutate(flat):
        keys = [k for k in sorted(flat) if k != "__metadata__"
                and np.issubdtype(flat[k].dtype, np.floating)]
        k = keys[leaf % len(keys)]
        arr = flat[k].copy()
        arr.reshape(-1)[0] = np.nan
        flat[k] = arr

    return _rewrite_npz(path, mutate)


def mismatch_checkpoint_shapes(path: str) -> str:
    """Double one leaf's length — a checkpoint of another architecture
    than the ensemble it claims to join."""

    def mutate(flat):
        k = sorted(k for k in flat if k != "__metadata__")[0]
        flat[k] = np.concatenate(
            [flat[k].reshape(-1), flat[k].reshape(-1)])

    return _rewrite_npz(path, mutate)


# --- runtime store corruption (silent bit rot on a resident expert) ---------


def poison_expert_runtime(engine, slot: int):
    """NaN-fill one resident expert's float leaves in the live store.

    The checkpoint passed every load-time check, then device memory went
    bad: this bypasses ``add_expert``'s checks and does not bump the
    membership epoch, so nothing tells the engine — the circuit breaker
    must catch it from non-finite outputs.  The store is replaced
    functionally (``set_expert``), so snapshots taken before keep the
    clean bytes.  Returns the clean parameters (expanded to float32 for a
    quantized store) for :func:`heal_expert_runtime`.
    """
    store = engine.param_store
    clean = tree_map(torch.clone, store.expert(slot))
    poisoned = tree_map(
        lambda p: torch.full_like(p, float("nan"))
        if p.is_floating_point() else p, clean)
    engine.param_store = store.set_expert(slot, poisoned)
    return clean


def heal_expert_runtime(engine, slot: int, clean_params) -> None:
    """Write clean parameters back into ``slot`` (the inverse of
    :func:`poison_expert_runtime`).  The liveness mask and health are left
    as they are: if the breaker put the slot in PROBATION, a passing
    canary probe is what restores it."""
    engine.param_store = engine.param_store.set_expert(slot, clean_params)


# --- flush-failure injection ------------------------------------------------


class FlushFaultInjector:
    """Raise inside ``_dispatch_group`` on chosen call numbers.

    Counts dispatch-group calls (from 1) on the wrapped engine and raises
    ``exc_type`` when the count is in ``fail_on``; every other call
    passes through.  A context manager::

        with FlushFaultInjector(engine, fail_on={1}):
            engine.flush()          # first group fails, the rest dispatch
    """

    def __init__(self, engine, fail_on=(1,), exc_type=RuntimeError):
        self.engine = engine
        self.fail_on = set(fail_on)
        self.exc_type = exc_type
        self.calls = 0
        self._orig = None

    def _wrapped(self, has_text, text_tail, reqs):
        self.calls += 1
        if self.calls in self.fail_on:
            raise self.exc_type(
                f"injected dispatch failure (call {self.calls})")
        return self._orig(has_text, text_tail, reqs)

    def __enter__(self):
        self._orig = self.engine._dispatch_group
        self.engine._dispatch_group = self._wrapped
        return self

    def __exit__(self, *exc):
        self.engine._dispatch_group = self._orig
        self._orig = None
        return False


# --- a closed-form ensemble -------------------------------------------------


def toy_apply(params, x, t, *, text_emb=None, drop_mask=None, **_):
    """Closed-form expert ``x·a + b + c``, ``c`` the mean of the text
    embedding (0.07 without text or where ``drop_mask`` drops it)."""
    null = torch.tensor(0.07, dtype=torch.float32, device=x.device)
    if text_emb is None:
        cond_term = null
    else:
        ct = text_emb.mean(dim=(1, 2))[:, None, None, None]
        if drop_mask is not None:
            ct = torch.where(drop_mask[:, None, None, None], null, ct)
        cond_term = ct
    return x * params["a"] + params["b"] + cond_term


def toy_ensemble(k: int = 4, device=None):
    """``(experts, params, router_fn, latent_shape)`` of ``k`` closed-form
    stackable experts (DDPM/cosine and FM/linear alternating) and a router
    whose logits grow with the slot index, on ``device``."""
    params = [
        {"a": torch.tensor(0.7 + 0.06 * i, dtype=torch.float32,
                           device=device),
         "b": torch.tensor(0.01 * i, dtype=torch.float32, device=device)}
        for i in range(k)
    ]
    experts = [
        ExpertSpec(f"e{i}", "ddpm" if i % 2 == 0 else "fm",
                   "cosine" if i % 2 == 0 else "linear", toy_apply, i)
        for i in range(k)
    ]

    def router_fn(x, t):
        logits = (torch.arange(float(k), device=x.device)[None]
                  .expand(x.shape[0], k)
                  + x.mean(dim=(1, 2, 3))[:, None])
        return torch.softmax(logits, dim=-1)

    return experts, params, router_fn, (4, 4, 2)


# --- liveness-under-faults scenario -----------------------------------------


def _save_toy(path, params, i, cid, objective="fm", schedule="linear"):
    from repro_torch.training.checkpoint import (expert_metadata,
                                                 save_checkpoint)

    save_checkpoint(path, tree_map(lambda a: a.cpu().numpy(), params),
                    metadata=expert_metadata(
                        name=f"e{i}", objective=objective,
                        schedule=schedule, cluster_id=cid, arch="toy"))


def main(argv=None) -> None:
    from repro_torch.core.sampling import SamplerConfig
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import dit as D
    from repro_torch.models.config import dit_b2, router_b2
    from repro_torch.training.checkpoint import (expert_metadata,
                                                 save_checkpoint)
    from repro_torch.weights import resolve_device

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.faults")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    verdict = {"device": str(dev)}

    # --- A. quarantine at assembly: a directory with corrupt artifacts
    # still serves, its hole masked.
    cfg = dit_b2().reduced(latent_size=8)
    rcfg = router_b2(num_clusters=4).reduced(latent_size=8)
    gen = torch.Generator().manual_seed(10)
    with tempfile.TemporaryDirectory() as d:
        for cid in (0, 1, 2, 3):
            save_checkpoint(
                os.path.join(d, f"expert{cid}.npz"), D.init(cfg, gen),
                metadata=expert_metadata(
                    name=f"e{cid}", objective="fm", schedule="linear",
                    cluster_id=cid, arch=cfg.name))
        # cid 2 truncated (a hole → masked EMPTY slot), plus one pure
        # garbage artifact that never yields a cluster id at all
        truncate_checkpoint(os.path.join(d, "expert2.npz"), 0.5)
        with open(os.path.join(d, "expert9.npz"), "wb") as f:
            f.write(b"not an archive")
        save_checkpoint(os.path.join(d, "router.npz"), D.init(rcfg, gen))
        eng = ServingEngine.from_checkpoint_dir(
            d, dit_cfg=cfg, router_cfg=rcfg,
            sampler=SamplerConfig(num_steps=2, cfg_scale=3.0,
                                  strategy="topk", top_k=2),
            on_bad_checkpoint="skip", device=dev)
        assert eng.elastic and eng.num_live_experts == 3
        assert len(eng.quarantine) == 2, eng.quarantine
        assert eng.expert_health[2] == "EMPTY"
        text = np.random.default_rng(0).standard_normal(
            (2, cfg.text_len, cfg.text_dim)).astype(np.float32)
        assert bool(torch.isfinite(eng.generate(0, text, 2)).all())
        assert "quarantined=2" in eng.membership_line()
    verdict["assembly_quarantine"] = "ok"

    # --- B. membership churn mid-traffic on the toy elastic engine:
    # hot-add and evict between submit() and flush(); the queued request
    # must equal its admission-time snapshot bitwise.
    experts, params, router_fn, latent = toy_ensemble(8, dev)
    sampler = SamplerConfig(num_steps=4, cfg_scale=3.0, strategy="topk",
                            top_k=2)
    eng = ServingEngine(
        experts=experts[:6], expert_params=params[:6], router_fn=router_fn,
        latent_shape=latent, sampler=sampler, capacity=8, device=dev)
    text = np.random.default_rng(3).standard_normal((2, 5, 6)).astype(
        np.float32)
    admitted = eng.generate(0, text, 2)
    h_old = eng.submit(0, text, 2)              # admitted under epoch 0
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "expert6.npz")
        _save_toy(ck, params[6], 6, 6, experts[6].objective,
                  experts[6].schedule)
        slot = eng.add_expert(ck)
    assert slot == 6
    eng.evict_expert(2)
    h_new = eng.submit(0, text, 2)              # admitted under epoch 2
    assert eng.flush() == 2                     # one dispatch per epoch
    old, new = h_old.result(), h_new.result()
    assert torch.equal(old, admitted), \
        "in-flight request must be bit-identical to its admission plan"
    assert not torch.equal(new, old), \
        "post-churn request must see the new membership"
    assert bool(torch.isfinite(new).all())
    assert eng.num_live_experts == 6
    verdict["inflight_snapshot"] = "ok"

    # Graceful retire: masked at once, DRAINING until the next flush
    # completes, then the slot is reusable.
    h = eng.submit(5, text, 2)
    eng.retire_expert(5)
    assert eng.expert_health[5] == "DRAINING"
    eng.flush()
    assert bool(torch.isfinite(h.result()).all())
    assert eng.expert_health[5] == "EVICTED"
    verdict["retire_drain"] = "ok"

    # --- C. bad artifacts at add_expert: every corruption class is
    # rejected with a named error, quarantined, and the slot stays dead.
    q0 = eng.stats["quarantined_checkpoints"]
    with tempfile.TemporaryDirectory() as d:
        bad = []
        for i, corrupt in enumerate((
                truncate_checkpoint, scramble_checkpoint,
                poison_checkpoint_nonfinite, mismatch_checkpoint_shapes)):
            p = os.path.join(d, f"bad{i}.npz")
            _save_toy(p, params[7], i, 7)
            bad.append(corrupt(p))
        for p in bad:
            try:
                eng.add_expert(p)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{p}: corrupt artifact was admitted")
    assert eng.stats["quarantined_checkpoints"] == q0 + 4
    assert eng.expert_health[2] == "EVICTED"    # slot untouched by failures
    verdict["add_expert_quarantine"] = "ok"

    # --- D. flush-failure isolation: the injected failure takes down only
    # its own group; the healthy group dispatches in the same flush.
    h_text = eng.submit(6, text, 2)
    h_uncond = eng.submit(7, None, 2)
    with FlushFaultInjector(eng, fail_on={1}) as inj:
        ok = eng.flush()
    assert ok == 1 and inj.calls == 2, (ok, inj.calls)
    done = [h for h in (h_text, h_uncond) if h.state == "DONE"]
    queued = [h for h in (h_text, h_uncond) if h.state == "QUEUED"]
    assert len(done) == 1 and len(queued) == 1
    assert bool(torch.isfinite(done[0].result()).all())
    assert eng.flush() == 1                     # the re-queued group recovers
    assert queued[0].state == "DONE"
    # and a persistent failure exhausts the cap onto the handle
    h_poison = eng.submit(8, text, 2)
    with FlushFaultInjector(eng, fail_on={1, 2}):
        eng.flush()
        eng.flush()
    assert h_poison.state == "FAILED"
    try:
        h_poison.result()
    except RuntimeError as e:
        assert "injected dispatch failure" in str(e)
    else:
        raise AssertionError("FAILED handle must raise from result()")
    verdict["flush_isolation"] = "ok"

    verdict["membership"] = eng.membership_line()
    print(json.dumps(verdict))


if __name__ == "__main__":
    main()
