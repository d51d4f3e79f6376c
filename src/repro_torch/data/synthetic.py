"""Synthetic latent-space dataset standing in for LAION-Aesthetics.

Port of ``repro.data.synthetic``: a *structured* synthetic corpus that
exercises the paper's pipeline end to end —

* latents: a K-component Gaussian mixture in (H, W, C) latent space, each
  component a semantic category, so the clustering stage has structure to
  find;
* captions: pseudo-CLIP embeddings (text_len, text_dim) correlated with
  the latent's component (routing and text conditioning are learnable);
* an exact Fréchet distance against the generating mixture (the FID
  analogue of the benchmarks).

The port draws the same distributions from seeded ``torch.Generator``s
(the component means and caption basis from ``spec.seed`` and
``spec.seed + 1``, a batch from the caller's generator); the reference
draws them with JAX's threefry, so the two corpora are different draws of
one distribution.  Every random array can be handed in instead
(``sample_batch(draws=...)``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_categories: int = 8
    latent_size: int = 8
    latent_channels: int = 4
    text_len: int = 8
    text_dim: int = 32
    #: distance between mixture-component means (higher = more separable)
    separation: float = 2.5
    #: per-component covariance scale
    scale: float = 0.5
    seed: int = 1234


@functools.lru_cache(maxsize=16)
def _component_means(spec: SyntheticSpec) -> torch.Tensor:
    """(num_categories, H·W·C) float32 means of norm ``separation``, on
    the CPU."""
    gen = torch.Generator().manual_seed(spec.seed)
    d = spec.latent_size * spec.latent_size * spec.latent_channels
    means = torch.randn((spec.num_categories, d), generator=gen)
    means = means / torch.linalg.norm(means, dim=-1, keepdim=True)
    return means * spec.separation


@functools.lru_cache(maxsize=16)
def _caption_basis(spec: SyntheticSpec) -> torch.Tensor:
    gen = torch.Generator().manual_seed(spec.seed + 1)
    return torch.randn((spec.num_categories, spec.text_len, spec.text_dim),
                       generator=gen)


def sample_batch(spec: SyntheticSpec, gen: torch.Generator | None,
                 batch: int, *, category: int | None = None,
                 draws: dict | None = None) -> dict:
    """``{'latents', 'text_emb', 'category'}`` for a random batch, on
    ``gen``'s device.

    ``draws`` may hand in any of ``category`` (B,), ``noise`` (B, H·W·C)
    standard normal, ``text_noise`` (B, text_len, text_dim) standard
    normal, ``means`` and ``basis`` (the spec's mixture); the rest come
    from ``gen``.
    """
    draws = dict(draws or {})
    dev = gen.device if gen is not None else torch.device("cpu")
    d = spec.latent_size * spec.latent_size * spec.latent_channels

    def get(name, make):
        a = draws.get(name)
        return torch.as_tensor(make() if a is None else a, device=dev)

    if category is None:
        cats = get("category", lambda: torch.randint(
            0, spec.num_categories, (batch,), generator=gen, device=dev))
    else:
        cats = torch.full((batch,), category, dtype=torch.int64, device=dev)
    cats = cats.to(torch.int64)
    means = get("means", lambda: _component_means(spec)).to(
        torch.float32)[cats]
    noise = get("noise", lambda: torch.randn(
        (batch, d), generator=gen, device=dev)).to(torch.float32)
    latents = (means + noise * spec.scale).reshape(
        batch, spec.latent_size, spec.latent_size, spec.latent_channels)
    text = get("basis", lambda: _caption_basis(spec)).to(torch.float32)[cats]
    text_noise = get("text_noise", lambda: torch.randn(
        tuple(text.shape), generator=gen, device=dev)).to(torch.float32)
    text = text + 0.1 * text_noise
    return {"latents": latents, "text_emb": text, "category": cats}


def category_stats(spec: SyntheticSpec, means=None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Exact (mean, cov) of the full generating mixture — the Fréchet
    benchmark's 'real data' statistics (``means`` replaces the spec's)."""
    means = np.asarray(_component_means(spec) if means is None else means,
                       dtype=np.float32)
    d = means.shape[1]
    mu = means.mean(axis=0)
    centered = means - mu
    cov_means = centered.T @ centered / means.shape[0]
    cov = cov_means + (spec.scale ** 2) * np.eye(d)
    return mu, cov


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray,
                     cov2: np.ndarray) -> float:
    """Exact Fréchet distance between Gaussians (the FID formula)."""
    diff = mu1 - mu2
    c1h = _sqrtm_psd(cov1)
    inner = c1h @ cov2 @ c1h
    tr_sqrt = np.trace(_sqrtm_psd(inner))
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * tr_sqrt)


def _sqrtm_psd(m: np.ndarray) -> np.ndarray:
    m = (m + m.T) / 2.0
    w, v = np.linalg.eigh(m)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def fit_gaussian(samples) -> tuple[np.ndarray, np.ndarray]:
    x = _host(samples).reshape(samples.shape[0], -1).astype(np.float64)
    mu = x.mean(axis=0)
    xc = x - mu
    cov = xc.T @ xc / max(x.shape[0] - 1, 1)
    return mu, cov


def sample_fid(spec: SyntheticSpec, samples, means=None) -> float:
    """FID analogue: Fréchet distance between generated samples and the
    exact generating-mixture statistics."""
    mu_r, cov_r = category_stats(spec, means)
    mu_g, cov_g = fit_gaussian(samples)
    return frechet_distance(mu_r, cov_r, mu_g, cov_g)


def pairwise_diversity(samples) -> float:
    """Mean pairwise L2 distance — the LPIPS↑ diversity analogue."""
    x = _host(samples).reshape(samples.shape[0], -1)
    diffs = x[:, None] - x[None]
    d = np.sqrt((diffs ** 2).sum(-1))
    n = x.shape[0]
    return float(d.sum() / (n * (n - 1)))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
