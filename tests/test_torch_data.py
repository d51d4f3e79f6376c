"""Parity of the port's data side with the JAX package, on the CPU: the
stub feature extractor, the synthetic corpus, the Fréchet and diversity
metrics, two-stage clustering, the per-expert and router streams, and
the Eq. 20 checkpoint conversion.

The port draws its corpus, frozen weights and re-initializations from
``torch.Generator``s, the reference from JAX keys: different numbers of
the same distributions.  Each parity test hands the reference's draws to
the port (the frozen weights, the mixture, the batch noise, the REINIT
normals) through the functions' optional inputs.

Tolerances: features and batches elementwise float32 (``rtol = 1e-5``,
``atol = 1e-6``: a 4096 → 512 → 1024 projection summed in another
order); the numpy metrics to ``1e-10`` relative (the same numpy code);
cluster assignments, the conversion's report and its transferred and
REINIT leaves equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as JC
from repro.core import conversion as JConv
from repro.data import features as JF
from repro.data import synthetic as JS
from repro.models import dit as JD
from repro.models.config import dit_b2 as j_dit_b2
from repro_torch.core import clustering as C
from repro_torch.core import conversion as Conv
from repro_torch.data import features as F
from repro_torch.data import pipeline as P
from repro_torch.data import synthetic as S
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

ELEM = dict(rtol=1e-5, atol=1e-6)
SPEC = dict(num_categories=4, latent_size=8)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _ref_batch_draws(spec, key, batch):
    """The reference ``sample_batch``'s draws from ``key``."""
    k1, k2, k3 = jax.random.split(key, 3)
    d = spec.latent_size * spec.latent_size * spec.latent_channels
    return {
        "category": np.array(jax.random.randint(k1, (batch,), 0,
                                                spec.num_categories)),
        "noise": np.array(jax.random.normal(k2, (batch, d))),
        "text_noise": np.array(jax.random.normal(
            k3, (batch, spec.text_len, spec.text_dim))),
        "means": np.array(JS._component_means(spec)),
        "basis": np.array(JS._caption_basis(spec)),
    }


@pytest.fixture(scope="module")
def corpus():
    """A reference corpus of 512 and its reference features."""
    spec = JS.SyntheticSpec(**SPEC)
    batch = JS.sample_batch(spec, jax.random.PRNGKey(0), 512)
    feats = JF.extract_features(batch["latents"])
    return dict(spec=spec, latents=np.array(batch["latents"]),
                feats=np.array(feats))


def test_sample_batch_matches_reference_on_its_draws():
    spec, pspec = JS.SyntheticSpec(**SPEC), S.SyntheticSpec(**SPEC)
    key = jax.random.PRNGKey(3)
    want = JS.sample_batch(spec, key, 16)
    got = S.sample_batch(pspec, None, 16,
                         draws=_ref_batch_draws(spec, key, 16))
    for name in ("latents", "text_emb"):
        np.testing.assert_allclose(_np(got[name]), np.asarray(want[name]),
                                   **ELEM)
    assert np.array_equal(_np(got["category"]), np.asarray(want["category"]))
    fixed = S.sample_batch(pspec, torch.Generator().manual_seed(0), 8,
                           category=2)
    assert (fixed["category"] == 2).all()
    assert fixed["latents"].shape == (8, 8, 8, 4)
    assert fixed["text_emb"].shape == (8, 8, 32)


def test_port_mixture_is_a_seeded_draw_of_the_same_distribution():
    """The port's own means: norm ``separation``, deterministic per seed,
    another draw than the reference's."""
    pspec = S.SyntheticSpec(**SPEC)
    means = S._component_means(pspec)
    np.testing.assert_allclose(_np(torch.linalg.norm(means, dim=-1)),
                               pspec.separation, rtol=1e-6)
    assert torch.equal(means, S._component_means(S.SyntheticSpec(**SPEC)))
    other = S._component_means(S.SyntheticSpec(**SPEC, seed=7))
    assert not torch.equal(means, other)
    a = S.sample_batch(pspec, torch.Generator().manual_seed(5), 4)
    b = S.sample_batch(pspec, torch.Generator().manual_seed(5), 4)
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_metrics_match_reference():
    spec, pspec = JS.SyntheticSpec(**SPEC), S.SyntheticSpec(**SPEC)
    means = np.asarray(JS._component_means(spec))
    for got, want in zip(S.category_stats(pspec, means),
                         JS.category_stats(spec)):
        np.testing.assert_allclose(got, want, rtol=1e-10)
    rng = np.random.default_rng(0)
    samples = rng.standard_normal((64, 8, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(
        S.sample_fid(pspec, torch.from_numpy(samples), means),
        JS.sample_fid(spec, samples), rtol=1e-10)
    np.testing.assert_allclose(S.pairwise_diversity(samples),
                               JS.pairwise_diversity(samples), rtol=1e-10)
    mu, cov = S.fit_gaussian(samples)
    jmu, jcov = JS.fit_gaussian(samples)
    np.testing.assert_allclose(mu, jmu, rtol=1e-10)
    np.testing.assert_allclose(
        S.frechet_distance(mu, cov, mu + 1, cov),
        JS.frechet_distance(jmu, jcov, jmu + 1, jcov), rtol=1e-10)


def test_extract_features_matches_reference_with_its_weights(corpus):
    lat = corpus["latents"][:64]
    weights = [np.array(w) for w in JF._frozen_weights(8 * 8 * 4, 4, 7)]
    got = F.extract_features(torch.from_numpy(lat), weights=weights)
    np.testing.assert_allclose(_np(got), corpus["feats"][:64], **ELEM)
    own = F.extract_features(torch.from_numpy(lat))
    assert own.shape == (64, F.FEATURE_DIM)
    np.testing.assert_allclose(_np(torch.linalg.norm(own, dim=-1)), 1.0,
                               rtol=1e-5)


def test_kmeans_assignments_equal_reference(corpus):
    feats = corpus["feats"]
    jc, ja = JC.kmeans(jax.random.PRNGKey(0), jnp.asarray(feats),
                       num_clusters=6, iters=10)
    pc, pa = C.kmeans(torch.from_numpy(feats), num_clusters=6, iters=10)
    assert np.array_equal(_np(pa), np.asarray(ja))
    np.testing.assert_allclose(_np(pc), np.asarray(jc), **ELEM)
    np.testing.assert_array_equal(
        _np(C.cosine_assign(torch.from_numpy(feats), pc)), np.asarray(ja))


def test_hierarchical_kmeans_equals_reference(corpus):
    feats = corpus["feats"]
    jm = JC.hierarchical_kmeans(jax.random.PRNGKey(1), jnp.asarray(feats),
                                num_coarse=4, num_fine=64)
    pm = C.hierarchical_kmeans(torch.from_numpy(feats), num_coarse=4,
                               num_fine=64)
    assert np.array_equal(pm.fine_to_coarse, jm.fine_to_coarse)
    np.testing.assert_allclose(pm.coarse_centroids, jm.coarse_centroids,
                               **ELEM)
    tf = torch.from_numpy(feats)
    ja = np.asarray(jm.assign(jnp.asarray(feats)))
    assert np.array_equal(_np(pm.assign(tf)), ja)
    assert np.array_equal(_np(pm.assign_direct(tf)),
                          np.asarray(jm.assign_direct(jnp.asarray(feats))))
    assert pm.num_clusters == 4
    for got, want in zip(C.partition_indices(pm.assign(tf), 4),
                         JC.partition_indices(ja, 4)):
        assert np.array_equal(got, want)
    np.testing.assert_array_equal(C.cluster_balance(pm.assign(tf), 4),
                                  JC.cluster_balance(ja, 4))


@pytest.fixture(scope="module")
def fitted():
    spec = S.SyntheticSpec(**SPEC)
    model, assign = P.fit_clusters(spec, corpus_size=512, num_clusters=4,
                                   num_fine=64, device="cpu")
    return spec, model, assign


def test_fit_clusters_is_deterministic_and_balanced(fitted):
    spec, model, assign = fitted
    again, assign2 = P.fit_clusters(spec, corpus_size=512, num_clusters=4,
                                    num_fine=64, device="cpu")
    assert np.array_equal(assign, assign2)
    bal = C.cluster_balance(assign, 4)
    assert bal.min() > 0.05, bal


def test_expert_streams_are_disjoint(fitted):
    """Every sample of cluster k's stream is assigned to cluster k, so the
    per-expert streams share no sample; a stream is a function of (seed,
    step)."""
    spec, model, _ = fitted
    seen = []
    for k in range(4):
        stream = P.ExpertDataStream(spec, model, cluster_id=k, batch_size=16,
                                    seed=0, device="cpu")
        b0, b1 = stream.next_batch(0), stream.next_batch(1)
        for b in (b0, b1):
            assert b["latents"].shape == (16, 8, 8, 4)
            assert b["text_emb"].shape == (16, 8, 32)
            a = model.assign(F.extract_features(b["latents"]))
            assert (a == k).all()
        again = P.ExpertDataStream(spec, model, cluster_id=k, batch_size=16,
                                   seed=0, device="cpu").next_batch(0)
        assert torch.equal(again["latents"], b0["latents"])
        assert not torch.equal(b0["latents"], b1["latents"])
        seen.append({tuple(_np(r).round(6).ravel()[:8])
                     for r in b0["latents"]})
    for i in range(4):
        for j in range(i + 1, 4):
            assert not seen[i] & seen[j]


def test_router_stream_labels_are_cluster_assignments(fitted):
    spec, model, _ = fitted
    stream = P.RouterDataStream(spec, model, batch_size=32, device="cpu")
    b = stream.next_batch(2)
    assert torch.equal(b["cluster"],
                       model.assign(F.extract_features(b["latents"])))
    assert len(torch.unique(b["cluster"])) > 1
    assert torch.equal(b["latents"], stream.next_batch(2)["latents"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.RouterDataStream(spec, model, batch_size=4)


def _reinit_draws(rng, template):
    """The reference's REINIT normals: one key per group in sorted order,
    one per leaf of a REINIT group."""
    keys = jax.random.split(rng, max(len(template), 1))
    out = {}
    for i, (group, tree) in enumerate(sorted(template.items())):
        leaves = jax.tree.leaves(tree)
        sub = jax.random.split(keys[i], max(len(leaves), 1))
        out[group] = [np.array(jax.random.normal(k, l.shape))
                      for k, l in zip(sub, leaves)]
    return out


def test_convert_checkpoint_matches_reference():
    """A class-conditional, text-free DiT (the 'ImageNet DiT', plus a
    class embedding) into the text-conditioned template: the same report,
    transferred leaves equal to the source's, NEW leaves the template's,
    REINIT leaves from the reference's draws equal to its own."""
    src_cfg = j_dit_b2(use_text=False).reduced(latent_size=8)
    dst_cfg = j_dit_b2().reduced(latent_size=8)
    src = jax.tree.map(np.asarray, JD.init(src_cfg, jax.random.PRNGKey(1)))
    src["class_embed"] = {"emb": np.ones((10, 128), np.float32)}
    dst = jax.tree.map(np.asarray, JD.init(dst_cfg, jax.random.PRNGKey(2)))
    rng = jax.random.PRNGKey(3)
    want, want_report = JConv.convert_checkpoint(
        jax.tree.map(jnp.asarray, src), jax.tree.map(jnp.asarray, dst),
        rng=rng)
    got, report = Conv.convert_checkpoint(
        params_from_numpy(src, "cpu"), params_from_numpy(dst, "cpu"),
        draws={g: d for g, d in _reinit_draws(rng, dst).items()
               if want_report.get(g) == JConv.REINIT})
    assert report == want_report
    assert report["class_embed"] == Conv.DROP
    assert report["final_layer"] == Conv.REINIT
    assert report["blocks"] == Conv.TRANSFER
    assert report["cross_attn"] == Conv.NEW
    assert set(got) == set(want)
    for group in got:
        for g, w in zip(tree_leaves(got[group]), jax.tree.leaves(want[group])):
            assert np.array_equal(_np(g), np.asarray(w)), group
    # from a generator: N(0, 0.02) leaves, deterministic per seed
    a, _ = Conv.convert_checkpoint(params_from_numpy(src, "cpu"),
                                   params_from_numpy(dst, "cpu"),
                                   gen=torch.Generator().manual_seed(0))
    b, _ = Conv.convert_checkpoint(params_from_numpy(src, "cpu"),
                                   params_from_numpy(dst, "cpu"),
                                   gen=torch.Generator().manual_seed(0))
    w = a["final_layer"]["out"]["w"]
    assert torch.equal(w, b["final_layer"]["out"]["w"])
    assert 0.015 < w.std().item() < 0.025


def test_convert_checkpoint_policy_defaults_and_shape_miss():
    """Groups missing from the policy transfer when their shapes match
    and keep the template otherwise; a TRANSFER group whose shapes differ
    keeps the template (as the reference)."""
    pre = {"a": {"w": torch.ones(2, 3)}, "b": {"w": torch.ones(4)},
           "blocks": {"w": torch.ones(5)}}
    tmpl = {"a": {"w": torch.zeros(2, 3)}, "b": {"w": torch.zeros(3)},
            "blocks": {"w": torch.zeros(6)}, "c": {"w": torch.zeros(1)}}
    jpre = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pre)
    jtmpl = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tmpl)
    want, want_report = JConv.convert_checkpoint(jpre, jtmpl,
                                                 rng=jax.random.PRNGKey(0))
    got, report = Conv.convert_checkpoint(pre, tmpl)
    assert report == want_report
    for group in got:
        for g, w in zip(tree_leaves(got[group]), jax.tree.leaves(want[group])):
            assert np.array_equal(_np(g), np.asarray(w))
