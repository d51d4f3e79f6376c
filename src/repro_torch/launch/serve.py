"""Serving engine of the port: a directory of expert checkpoints in, latents
out, on one GPU.

``ServingEngine.from_checkpoint_dir`` assembles the heterogeneous
ensemble from ``expert*.npz`` (plus ``router.npz``) written by either
package's ``save_checkpoint``; ``generate`` draws the noise, resolves the
conditioning through a content-hash LRU and runs the fused sampler
(``core.sampling.sample_ensemble``): per step a router forward, the
routed experts through the ragged grouped-GEMM kernel, and one step-fused
kernel (``step_fused=False``: the velocity kernel, then the CFG combine
and the Euler update as separate ops).

``sampler.param_dtype`` (or ``from_checkpoint_dir(param_dtype=...)``)
picks the stacked expert store: ``native``, ``fp32``/``bf16`` casts, or
``int8``/``fp8`` quantized with per-expert scales, whose weights
contract in the int8/fp8 GEMM kernels.  A quantized store replaces the
float32 per-expert list (about 4x fewer resident expert bytes).

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when no GPU is present.  Only an explicit ``device="cpu"`` runs on the
CPU (the kernels' plain versions), as the tests do.  Elastic membership,
``submit``/``flush``, sharding and the CLI are not ported yet.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import os
import re
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.fusion import ExpertSpec
from repro_torch.core.param_store import make_store
from repro_torch.core.sampling import SamplerConfig, sample_ensemble
from repro_torch.models import dit as D
from repro_torch.models.config import DiTConfig
from repro_torch.training.checkpoint import load_checkpoint
from repro_torch.weights import resolve_device

#: ``expert7.npz`` / ``expert_07.npz`` → checkpoint index 7 (ordering
#: fallback when the metadata carries no ``cluster_id``).
_EXPERT_IDX_RE = re.compile(r"expert[_-]?(\d+)")


def _as_device_tensor(a, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or a (possibly
    read-only) array, copied off the caller's buffer."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32)


@dataclasses.dataclass
class ServingEngine:
    experts: list[ExpertSpec]
    expert_params: list
    router_fn: object | None
    latent_shape: tuple[int, int, int]
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    engine: str = "auto"
    #: cross-request conditioning cache: max distinct text embeddings kept
    #: resident, keyed by content hash and evicted LRU.  0 disables.
    cond_cache_size: int = 64
    device: torch.device = torch.device("cuda")

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self._cond_cache: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self.stats = {"requests": 0, "cond_cache_hits": 0,
                      "cond_cache_misses": 0, "plan_refreshes": 0}
        pd = self.sampler.param_dtype
        if pd != "native":
            # The store serves routed execution only; reject at
            # construction, where strategy and engine are known.
            routed_capable = (
                len(self.experts) > 1
                and all(e.apply_fn is self.experts[0].apply_fn
                        for e in self.experts)
                and self.sampler.strategy in ("top1", "topk", "threshold")
                and self.engine in ("auto", "routed")
            )
            if not routed_capable:
                raise ValueError(
                    f"param_dtype={pd!r} changes the stacked expert store's "
                    f"storage, which only routed execution uses: it needs a "
                    f"homogeneous ensemble of >= 2 experts, strategy in "
                    f"top1/topk/threshold, and engine auto/routed — got "
                    f"{len(self.experts)} expert(s), strategy="
                    f"{self.sampler.strategy!r}, engine={self.engine!r}")
        # The routed engine's dispatch substrate: every expert's leaves
        # stacked once, ``(K, ...)``, on the device, in the storage dtype.
        self.param_store = make_store(
            D.stack_expert_params(self.expert_params), dtype=pd)
        if pd in ("int8", "fp8"):
            # The quantized store is the resident representation: drop the
            # float32 per-expert list so the byte saving is real.
            self.expert_params = None

    @classmethod
    def from_checkpoint_dir(
        cls, ckpt_dir: str, *, dit_cfg: DiTConfig,
        router_cfg: DiTConfig | None = None,
        sampler: SamplerConfig | None = None,
        engine: str = "auto",
        param_dtype: str | None = None,
        cond_cache_size: int = 64,
        device=None,
    ) -> "ServingEngine":
        """Assemble an engine from a directory of expert checkpoints.

        Experts are ordered numerically by cluster id (from each
        checkpoint's metadata, falling back to the ``expert<N>.npz``
        filename index).  Duplicate cluster ids and holes in ``0..K-1``
        raise ``ValueError``; so does a checkpoint without
        ``objective``/``schedule`` metadata.  Parameters load onto
        ``device`` (``None`` → ``"cuda"``).  ``param_dtype``, when given,
        overrides ``sampler.param_dtype``.
        """
        dev = resolve_device(device)
        apply_fn = D.make_expert_apply(dit_cfg)
        ragged_fn = D.make_ragged_expert_apply(dit_cfg)
        paths = glob.glob(os.path.join(ckpt_dir, "expert*.npz"))
        if not paths:
            raise FileNotFoundError(f"no expert*.npz under {ckpt_dir}")
        loaded = []
        for path in sorted(paths):
            p, meta = load_checkpoint(path, device=dev)
            for field in ("objective", "schedule"):
                if field not in meta:
                    raise ValueError(
                        f"{path}: missing '{field}' metadata — not a "
                        f"self-describing expert checkpoint"
                    )
            cid = int(meta.get("cluster_id", -1))
            if cid < 0:
                m = _EXPERT_IDX_RE.search(os.path.basename(path))
                if m is None:
                    raise ValueError(
                        f"{path}: no cluster_id metadata and no numeric "
                        f"index in the filename — cannot place this expert"
                    )
                cid = int(m.group(1))
            loaded.append((cid, path, p, meta))
        seen: dict[int, str] = {}
        for cid, path, _, _ in loaded:
            if cid in seen:
                raise ValueError(
                    f"duplicate cluster_id {cid}: {seen[cid]} and {path}"
                )
            seen[cid] = path
        n_slots = max(seen) + 1
        holes = sorted(set(range(n_slots)) - set(seen))
        if holes:
            raise ValueError(
                f"expert checkpoints must cover cluster ids 0..{n_slots - 1} "
                f"exactly (the router posterior's columns are positional); "
                f"got {sorted(seen)} — missing {holes}"
            )
        loaded.sort(key=lambda item: item[0])
        experts, params = [], []
        for cid, path, p, meta in loaded:
            experts.append(ExpertSpec(
                name=meta.get("name", os.path.basename(path)),
                objective=meta["objective"],
                schedule=meta["schedule"],
                apply_fn=apply_fn,
                cluster_id=cid,
                ragged_apply_fn=ragged_fn,
            ))
            params.append(p)
        router_fn = None
        router_path = os.path.join(ckpt_dir, "router.npz")
        if router_cfg is not None and os.path.exists(router_path):
            rp, _ = load_checkpoint(router_path, device=dev)
            router_fn = D.make_router_fn(router_cfg, rp)
        sampler = sampler if sampler is not None else SamplerConfig()
        if param_dtype is not None:
            sampler = dataclasses.replace(sampler, param_dtype=param_dtype)
        return cls(
            experts=experts, expert_params=params, router_fn=router_fn,
            latent_shape=(dit_cfg.latent_size, dit_cfg.latent_size,
                          dit_cfg.latent_channels),
            sampler=sampler,
            engine=engine, cond_cache_size=cond_cache_size, device=dev,
        )

    # -- cross-request conditioning cache -----------------------------------

    def _cached_cond(self, text_emb):
        """Content-hash-keyed LRU over host conditioning arrays.

        Requests carrying byte-identical embeddings (one prompt, many
        seeds) resolve to one resident device tensor.  Tensors pass
        through unhashed (moved to the engine's device): hashing a device
        tensor would force a device→host copy per request.
        """
        if text_emb is None:
            return None
        if isinstance(text_emb, torch.Tensor) or self.cond_cache_size <= 0:
            return _as_device_tensor(text_emb, self.device)
        arr = np.ascontiguousarray(text_emb)
        key = (arr.shape, str(arr.dtype),
               hashlib.sha1(arr.tobytes()).hexdigest())
        cached = self._cond_cache.get(key)
        if cached is not None:
            self._cond_cache.move_to_end(key)
            self.stats["cond_cache_hits"] += 1
            return cached
        self.stats["cond_cache_misses"] += 1
        val = _as_device_tensor(arr, self.device)
        self._cond_cache[key] = val
        while len(self._cond_cache) > self.cond_cache_size:
            self._cond_cache.popitem(last=False)
        return val

    def generate(self, seed_or_generator, batch_text_emb, batch_size: int,
                 *, noise=None) -> torch.Tensor:
        """Sample ``batch_size`` latents ``(B, H, W, C)``.

        The starting noise is drawn from ``seed_or_generator`` (an int
        seed or a ``torch.Generator`` on the engine's device) unless
        ``noise`` hands in the exact array to start from.  With text the
        sampler runs batched classifier-free guidance against the learned
        null embedding.
        """
        self.stats["requests"] += 1
        shape = (batch_size,) + tuple(self.latent_shape)
        if noise is None:
            gen = seed_or_generator
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(int(seed_or_generator))
            noise = torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=self.device)
        else:
            noise = _as_device_tensor(noise, self.device)
        has_text = batch_text_emb is not None
        text = self._cached_cond(batch_text_emb)
        r = max(1, self.sampler.plan_refresh_every)
        self.stats["plan_refreshes"] += -(-self.sampler.num_steps // r)
        return sample_ensemble(
            self.experts, self.expert_params, self.router_fn, shape,
            cond={"text_emb": text} if has_text else None,
            null_cond={"text_emb": None} if has_text else None,
            config=self.sampler, engine=self.engine, init_noise=noise,
            stacked_params=self.param_store,
        )
