"""The port's LM-expert ensemble (``core/lm_ensemble.py``) against the JAX
package's, on the CPU.

Two random-init reduced mamba2-2.7b experts (float32; JAX init, carried to
the port through ``np.asarray``) and a prototype router fitted on two
seeded numpy corpora from disjoint halves of the vocabulary.  Nothing is
trained (the reference's own ``tests/test_lm_ensemble.py`` trains experts
and is marked slow): the comparison is of the same function on the same
weights.

Tolerances, relative to ``max|want|``: the router's histograms and
posterior ``1e-6`` (float32 sums of ≤ 1024 terms in another order);
fused log-probabilities and perplexities ``1e-5`` (the backbone's
``MODEL_REL`` of ``tests/test_torch_mamba2.py`` through a log-softmax and
a logsumexp); greedy tokens exactly equal (the smallest top-1/top-2 gap
of the fused log-probabilities is printed, so a flipped argmax can be
told from a real fault).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.lm_ensemble import LMExpertEnsemble as JEnsemble
from repro.core.lm_ensemble import TokenPrototypeRouter as JRouter
from repro.core.lm_ensemble import expert_perplexity as j_expert_perplexity
from repro.models import zoo as jzoo
from repro_torch.configs import get_config
from repro_torch.core.lm_ensemble import (LMExpertEnsemble,
                                          TokenPrototypeRouter,
                                          expert_perplexity)
from repro_torch.kernels import ops
from repro_torch.weights import params_from_numpy

ROUTER_REL = 1e-6
LM_REL = 1e-5


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cluster_tokens(rng, shape, vocab, cluster):
    """Tokens of corpus cluster ``cluster``: its half of the vocabulary."""
    half = vocab // 2
    return rng.integers(cluster * half, (cluster + 1) * half, shape,
                        dtype=np.int32)


@pytest.fixture(scope="module")
def pair():
    """(JAX ensemble pieces, port ensemble pieces) on the same weights."""
    jcfg = j_get_config("mamba2-2.7b").reduced()
    cfg = get_config("mamba2-2.7b").reduced()
    jexperts = [jzoo.init(jcfg, jax.random.PRNGKey(10 + k)) for k in (0, 1)]
    experts = [params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
               for p in jexperts]
    rng = np.random.default_rng(0)
    corpora = [_cluster_tokens(rng, (8, 128), cfg.vocab_size, c)
               for c in (0, 1)]
    jrouter = JRouter.fit([jnp.asarray(c) for c in corpora],
                          vocab=cfg.vocab_size)
    router = TokenPrototypeRouter.fit(corpora, vocab=cfg.vocab_size)
    return (jcfg, jexperts, jrouter), (cfg, experts, router)


def _batch(vocab, seed):
    """Rows 0–1 from cluster 0, rows 2–3 from cluster 1, 33 tokens each."""
    rng = np.random.default_rng(seed)
    toks = np.concatenate([_cluster_tokens(rng, (2, 33), vocab, c)
                           for c in (0, 1)])
    return toks[:, :-1], toks[:, 1:]


def test_router_fit_and_posterior_match_jax(pair):
    (_, _, jrouter), (cfg, _, router) = pair
    assert router.prototypes.dtype == np.float32
    assert _rel(router.prototypes, jrouter.prototypes) <= ROUTER_REL
    tokens, _ = _batch(cfg.vocab_size, 1)
    jpost = np.asarray(jrouter.posterior(jnp.asarray(tokens)))
    post = router.posterior(torch.from_numpy(tokens))
    assert _rel(post, jpost) <= ROUTER_REL
    assert post.argmax(-1).tolist() == [0, 0, 1, 1]


@pytest.mark.parametrize("strategy,top_k", [("topk", 1), ("full", 2)])
def test_fused_logprobs_and_perplexity_match_jax(pair, strategy, top_k):
    (jcfg, jexperts, jrouter), (cfg, experts, router) = pair
    jens = JEnsemble(cfg=jcfg, expert_params=jexperts, router=jrouter,
                     strategy=strategy, top_k=top_k)
    ens = LMExpertEnsemble(cfg=cfg, expert_params=experts, router=router,
                           strategy=strategy, top_k=top_k)
    tokens, labels = _batch(cfg.vocab_size, 2)
    tt, tl = torch.from_numpy(tokens), torch.from_numpy(labels)
    ops.reset_launches()
    lp = ens.fused_logprobs(tt)
    assert not any(ops.LAUNCHES.values())          # plain versions on CPU
    assert _rel(lp, jens.fused_logprobs(jnp.asarray(tokens))) <= LM_REL
    total = torch.logsumexp(lp, dim=-1)
    torch.testing.assert_close(total, torch.zeros_like(total), rtol=0,
                               atol=1e-5)
    ppl = ens.perplexity(tt, tl)
    jppl = jens.perplexity(jnp.asarray(tokens), jnp.asarray(labels))
    assert isinstance(ppl, float)
    assert abs(ppl - jppl) <= LM_REL * jppl


def test_expert_perplexity_matches_jax(pair):
    (jcfg, jexperts, _), (cfg, experts, _) = pair
    tokens, labels = _batch(cfg.vocab_size, 3)
    ppl = expert_perplexity(cfg, experts[1], torch.from_numpy(tokens),
                            torch.from_numpy(labels))
    jppl = j_expert_perplexity(jcfg, jexperts[1], jnp.asarray(tokens),
                               jnp.asarray(labels))
    assert abs(ppl - jppl) <= LM_REL * jppl


def test_decode_greedy_matches_jax(pair):
    """Token-by-token prompt replay, then 6 greedy tokens: equal to the
    reference's."""
    (jcfg, jexperts, jrouter), (cfg, experts, router) = pair
    kw = dict(strategy="topk", top_k=1)
    jens = JEnsemble(cfg=jcfg, expert_params=jexperts, router=jrouter, **kw)
    ens = LMExpertEnsemble(cfg=cfg, expert_params=experts, router=router,
                           **kw)
    prompt, _ = _batch(cfg.vocab_size, 4)
    prompt = prompt[1:3, :8]                   # one prompt of each cluster
    steps = 6
    want = np.asarray(jens.decode_greedy(jnp.asarray(prompt), steps))
    got = ens.decode_greedy(torch.from_numpy(prompt), steps)
    assert got.dtype == torch.int32 and got.shape == (2, 8 + steps)
    # the fused distributions each greedy token was taken from
    lp = ens.fused_logprobs(got[:, :-1])[:, 7:]
    top2 = torch.topk(lp, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).min().item()
    print(f"smallest top-1/top-2 fused log-prob margin: {margin:.3g}")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 8:] == lp.argmax(-1)).all()
