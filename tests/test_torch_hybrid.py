"""The port's Zamba2-style hybrid backbone (``models/hybrid.py``) against
the JAX package's, on the CPU: reduced zamba2-2.7b (2 mamba layers, the
shared attention block after each, 4 heads of 64) and the same with
zamba2's own head width, ``reduced(head_dim=80)``.

The checks and their tolerances are the dense backbone's
(``tests/test_torch_transformer.py``, whose docstring states them): the
mixers' scans run ``ssd_sequential`` and the shared block's attention the
attention kernel's plain version here (CPU tensors); both kernels are
held to those plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.models import hybrid as JH
from repro_torch.kernels import ops
from repro_torch.models import hybrid as H
from repro_torch.models import zoo
from repro_torch.tree import tree_leaves
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_transformer import (assert_cache_close, carried,
                                    check_bf16_matches_unjitted_jax,
                                    check_ensemble,
                                    check_forward_prefill_decode,
                                    check_loss_and_gradients, reduced_pair)

ARCH = "zamba2-2.7b"
HEADS = [{}, dict(head_dim=80)]
IDS = ["D64", "D80"]


@pytest.mark.parametrize("over", HEADS, ids=IDS)
def test_hybrid_forward_prefill_decode_match_jax(over):
    check_forward_prefill_decode(ARCH, over, seed=1)


@pytest.mark.parametrize("over", HEADS, ids=IDS)
def test_hybrid_bf16_matches_unjitted_jax(over):
    check_bf16_matches_unjitted_jax(ARCH, over, seed=2)


@pytest.mark.parametrize("over", HEADS, ids=IDS)
def test_hybrid_loss_and_gradients_match_jax(over):
    check_loss_and_gradients(ARCH, over, seed=3)


def test_hybrid_ensemble_matches_jax():
    check_ensemble(ARCH, {})


def test_hybrid_params_and_cache_have_the_reference_layout():
    """Mamba blocks stacked ``(groups, per_group, ...)`` and one shared
    block, as the reference's tree (keys, shapes, dtypes), at zamba2's
    grouping (6 layers a group) on a narrow width; ``make_cache``'s SSM
    states and one KV cache per application of the shared block."""
    jcfg, cfg = reduced_pair(ARCH, num_layers=12, attn_every=6)
    assert H.num_groups(cfg) == JH.num_groups(jcfg) == 2
    jp = JH.init(jcfg, jax.random.PRNGKey(0))
    tp = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tuple(tp["blocks"]["mixer"]["in_proj"]["w"].shape[:2]) == (2, 6)
    assert [tuple(a.shape) for a in tree_leaves(tp)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jp)]
    jc, c = JH.make_cache(jcfg, 3, 24), zoo.make_cache(cfg, 3, 24, "cpu")
    assert_cache_close(c, jc, 0.0)
    with pytest.raises(ValueError, match="attn_every"):
        H.num_groups(cfg.reduced(num_layers=5, attn_every=2))


def test_hybrid_grouped_forward_matches_jax():
    """Two groups of three mamba layers (the shared block applied twice,
    after layers 3 and 6): ``forward_train`` logits within ``1e-5``."""
    jcfg, cfg = reduced_pair(ARCH, num_layers=6, attn_every=3)
    jp, tp = carried(jcfg, seed=5)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 32),
                                             dtype=np.int32)
    want, _ = JH.forward_train(jcfg, jp, toks)
    ops.reset_launches()
    got, _ = zoo.forward_train(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert not any(ops.LAUNCHES.values())
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= 1e-5 * np.abs(np.asarray(want)).max()


def test_lm_example_trains_hybrid_experts_on_the_cpu(one_torch_thread,
                                                     capsys):
    """The LM example with ``--arch zamba2-2.7b --device cpu``: two experts
    train, and each cluster's right expert scores below its wrong one,
    the routed ensemble with it."""
    from repro_torch.examples import decentralized_lm_experts as ex

    ex.main(["--arch", ARCH, "--steps", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"training 2 isolated {ARCH} experts")
    for line in lines[3:5]:
        words = line.split()
        right, wrong, routed = (float(words[i]) for i in (4, 7, 10))
        assert right < wrong and routed == right
