"""Two-stage hierarchical k-means on semantic features (paper §6.1).

Port of ``repro.core.clustering``.  The paper extracts 1024-d DINOv2
[CLS] features and clusters in two stages: first into 1024 fine-grained
groups with spherical k-means, then the fine centroids into K=8 coarse
clusters; every image is assigned to its nearest coarse cluster by cosine
distance.  The DINOv2 extractor is a stub (``repro_torch.data.features``).

Seeding is the reference's deterministic farthest-point scheme, so given
the same features the assignments are the same on every host and device
(the reference's unused ``key`` arguments are dropped).  The arithmetic
runs in float32 on the features' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=eps)


def cosine_assign(feats: torch.Tensor,
                  centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment under cosine distance."""
    sims = _normalize(feats) @ _normalize(centroids).T
    return torch.argmax(sims, dim=-1)


def _farthest_point_init(feats_n: torch.Tensor,
                         num_clusters: int) -> torch.Tensor:
    """Deterministic greedy farthest-point (k-means++-style) seeding:
    start from the point least aligned with the mean direction, then
    repeatedly take the point with the smallest maximum cosine similarity
    to any chosen seed."""
    d = feats_n.shape[1]
    mean_dir = _normalize(torch.mean(feats_n, dim=0, keepdim=True))
    first = torch.argmin((feats_n @ mean_dir.T)[:, 0])
    centroids = torch.zeros((num_clusters, d), dtype=feats_n.dtype,
                            device=feats_n.device)
    centroids[0] = feats_n[first]
    max_sim = feats_n @ feats_n[first]
    for i in range(1, num_clusters):
        c = feats_n[torch.argmin(max_sim)]
        centroids[i] = c
        max_sim = torch.maximum(max_sim, feats_n @ c)
    return centroids


@torch.no_grad()
def kmeans(feats: torch.Tensor, *, num_clusters: int,
           iters: int = 25) -> tuple[torch.Tensor, torch.Tensor]:
    """Spherical (cosine) k-means.  Returns ``(centroids, assignment)``.

    Seeding is the deterministic farthest-point scheme
    (:func:`_farthest_point_init`).
    """
    feats_n = _normalize(feats.to(torch.float32))
    centroids = _farthest_point_init(feats_n, num_clusters)
    for _ in range(iters):
        assign = cosine_assign(feats_n, centroids)
        onehot = torch.nn.functional.one_hot(
            assign, num_clusters).to(torch.float32)
        sums = onehot.T @ feats_n                          # (K, D)
        counts = onehot.sum(dim=0)[:, None]
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                          centroids)
        centroids = _normalize(new)
    return centroids, cosine_assign(feats_n, centroids)


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """Fitted two-stage clustering: fine centroids + fine->coarse map
    (host arrays; ``assign`` moves them to the features' device)."""

    # lint: allow-mutable-config (host arrays, never a cache key)
    fine_centroids: np.ndarray      # (F, D)
    # lint: allow-mutable-config
    coarse_centroids: np.ndarray    # (K, D)
    # lint: allow-mutable-config
    fine_to_coarse: np.ndarray      # (F,)

    @property
    def num_clusters(self) -> int:
        return self.coarse_centroids.shape[0]

    def assign(self, feats: torch.Tensor) -> torch.Tensor:
        """Assign features to coarse clusters via their nearest fine
        centroid."""
        dev = feats.device
        fine = cosine_assign(feats, torch.as_tensor(self.fine_centroids,
                                                    device=dev))
        return torch.as_tensor(self.fine_to_coarse, device=dev)[fine]

    def assign_direct(self, feats: torch.Tensor) -> torch.Tensor:
        """Direct nearest-coarse-centroid assignment (§6.1 last step)."""
        return cosine_assign(feats, torch.as_tensor(
            self.coarse_centroids, device=feats.device))


def hierarchical_kmeans(
    feats: torch.Tensor,
    *,
    num_coarse: int = 8,
    num_fine: int = 1024,
    fine_iters: int = 25,
    coarse_iters: int = 50,
) -> ClusterModel:
    """Paper §6.1 two-stage clustering.

    ``num_fine`` is clipped to the dataset size for small (test) corpora.
    """
    n = feats.shape[0]
    num_fine = int(min(num_fine, max(num_coarse, n // 4), n))
    fine_centroids, _ = kmeans(feats, num_clusters=num_fine,
                               iters=fine_iters)
    coarse_centroids, fine_to_coarse = kmeans(
        fine_centroids, num_clusters=num_coarse, iters=coarse_iters)
    return ClusterModel(
        fine_centroids=fine_centroids.cpu().numpy(),
        coarse_centroids=coarse_centroids.cpu().numpy(),
        fine_to_coarse=fine_to_coarse.cpu().numpy(),
    )


def partition_indices(assignment, num_clusters: int) -> list[np.ndarray]:
    """Disjoint per-cluster index lists ``S_1..S_K`` (Fig. 6 partition)."""
    assignment = _host(assignment)
    return [np.nonzero(assignment == k)[0] for k in range(num_clusters)]


def cluster_balance(assignment, num_clusters: int) -> np.ndarray:
    counts = np.bincount(_host(assignment), minlength=num_clusters)
    return counts / max(counts.sum(), 1)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)
