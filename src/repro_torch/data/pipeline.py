"""Data pipeline: clustering-driven partitions + per-expert iterators.

Port of ``repro.data.pipeline`` (the paper's Fig. 6 training pipeline):

  corpus -> (stub) DINOv2 features -> hierarchical k-means -> K disjoint
  partitions S_1..S_K -> one isolated iterator per expert.

Expert iterators are *rejection-sampled* streams over the synthetic corpus
conditioned on the expert's cluster — each expert only ever sees its own
partition.  The router iterator streams all clusters with their labels.

Batches are drawn on ``device`` (``None`` → ``"cuda"``, raising without a
GPU) from ``torch.Generator``s seeded per (seed, step, attempt) through
numpy's ``SeedSequence`` — the role of the reference's ``fold_in`` keys,
with other numbers.  ``lm_batch`` draws the token batches of LM
training from an explicit generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core.clustering import ClusterModel, hierarchical_kmeans
from repro_torch.data.features import extract_features
from repro_torch.data.synthetic import SyntheticSpec, sample_batch
from repro_torch.weights import resolve_device


def _generator(device: torch.device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``words`` (one stream per
    distinct tuple)."""
    state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) & (2 ** 63 - 1))


def fit_clusters(
    spec: SyntheticSpec, *, corpus_size: int = 4096, num_clusters: int = 8,
    num_fine: int = 256, seed: int = 0, device=None,
) -> tuple[ClusterModel, np.ndarray]:
    """Fit the two-stage clustering on a corpus sample (paper §6.1);
    returns the model and the corpus' assignment (host array)."""
    dev = resolve_device(device)
    batch = sample_batch(spec, _generator(dev, seed), corpus_size)
    feats = extract_features(batch["latents"])
    model = hierarchical_kmeans(feats, num_coarse=num_clusters,
                                num_fine=num_fine)
    return model, model.assign(feats).cpu().numpy()


@dataclasses.dataclass
class ExpertDataStream:
    """Isolated per-expert stream: only samples assigned to cluster_id."""

    spec: SyntheticSpec
    cluster_model: ClusterModel
    cluster_id: int
    batch_size: int
    seed: int = 0
    oversample: int = 4
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.next_batch(step)
            step += 1

    def next_batch(self, step: int) -> dict:
        """Rejection-sample a batch belonging to this expert's cluster.

        Draws further pools until ``batch_size`` matching samples are
        found (at most 8); a short batch is topped up by repeating
        *matching* samples, never by leaking other clusters' data.
        """
        need = self.batch_size
        pools: list[dict] = []
        matched: list[torch.Tensor] = []
        total = 0
        for attempt in range(8):
            gen = _generator(self.device, self.seed, step, attempt)
            pool = sample_batch(self.spec, gen, need * self.oversample)
            assign = self.cluster_model.assign(
                extract_features(pool["latents"]))
            idx = torch.nonzero(assign == self.cluster_id)[:, 0]
            pools.append(pool)
            matched.append(idx)
            total += int(idx.numel())
            if total >= need:
                break
        if total == 0:
            raise RuntimeError(
                f"cluster {self.cluster_id} produced no samples in "
                f"{8 * need * self.oversample} draws — clustering "
                f"degenerate?")
        out = {name: torch.cat([p[name][i] for p, i in zip(pools, matched)])
               for name in ("latents", "text_emb", "category")}
        sel = torch.arange(need, device=self.device) % total  # wraparound
        return {name: a[sel] for name, a in out.items()}


@dataclasses.dataclass
class RouterDataStream:
    """Full-corpus stream with cluster labels (the router trains on all
    data)."""

    spec: SyntheticSpec
    cluster_model: ClusterModel
    batch_size: int
    seed: int = 100
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def next_batch(self, step: int) -> dict:
        batch = sample_batch(self.spec, _generator(self.device, self.seed,
                                                   step), self.batch_size)
        labels = self.cluster_model.assign(
            extract_features(batch["latents"]))
        return {**batch, "cluster": labels}


# ---------------------------------------------------------------------------
# Token batches for the LM architectures
# ---------------------------------------------------------------------------


def lm_batch(gen: torch.Generator, batch: int, seq_len: int,
             vocab: int) -> dict:
    """Zipf-ish synthetic token batch with next-token labels, drawn from
    ``gen`` on its device: ranks of a truncated Zipf(1.1) by inverse CDF,
    ``floor(exp(u·log V)) − 1`` for ``u ~ U[1e-6, 1)``, clipped to
    ``[0, V)``, then each token replaced by a uniform one with probability
    0.1 (the reference's distribution, ``repro.data.pipeline.lm_batch``;
    other numbers).  Returns int32 ``tokens`` and ``labels``
    ``(batch, seq_len)``, the labels shifted one position."""
    dev = gen.device
    shape = (batch, seq_len + 1)
    u = torch.rand(shape, generator=gen, device=dev) * (1.0 - 1e-6) + 1e-6
    ranks = torch.floor(torch.exp(u * math.log(float(vocab)))) - 1.0
    tokens = torch.clamp(ranks.to(torch.int32), 0, vocab - 1)
    mix = torch.randint(0, vocab, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    flip = torch.rand(shape, generator=gen, device=dev) < 0.1
    tokens = torch.where(flip, mix, tokens)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
