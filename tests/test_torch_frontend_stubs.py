"""The port's frontend stubs (``models/frontend_stubs.py``) against the
JAX package's: the same shapes and dtypes, the specs on the ``meta``
device, and the draws a deterministic function of the seed from a
``torch.Generator`` — standard normal, as the reference's
``jax.random.normal`` (other numbers: a test that compares the two
packages hands both the same numpy frames).
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import frontend_stubs as jstubs
from repro_torch.configs import get_config
from repro_torch.models import frontend_stubs as stubs


def _same(got: torch.Tensor, want) -> None:
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_audio_specs_and_frames_match_jax(reduced):
    """whisper-large-v3 (full: 1500 frames of d 1280 in bf16; reduced: 16
    of 256 in float32): ``audio_spec`` is a meta tensor of the reference's
    shape and dtype, and ``audio_frame_embeddings`` draws one of them."""
    jcfg, cfg = j_get_config("whisper-large-v3"), get_config(
        "whisper-large-v3")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    spec = stubs.audio_spec(cfg, 3)
    assert spec.device.type == "meta"
    _same(spec, jstubs.audio_spec(jcfg, 3))
    small = dataclasses.replace(cfg, encoder_seq_len=8) if not reduced \
        else cfg
    got = stubs.audio_frame_embeddings(small, 2, seed=1, device="cpu")
    _same(got, jstubs.audio_spec(dataclasses.replace(
        jcfg, encoder_seq_len=small.encoder_seq_len), 2))
    assert got.device.type == "cpu"


def test_vision_specs_and_patches_match_jax():
    """The vision half at paligemma-3b's prefix (256 patches of d 2048):
    ``vision_spec`` and ``vision_patch_embeddings`` against the
    reference's shape and dtype, full and reduced (8 patches)."""
    jcfg, cfg = j_get_config("paligemma-3b"), get_config("paligemma-3b")
    for c, jc in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert c.vision_prefix_len == jc.vision_prefix_len
        spec = stubs.vision_spec(c, 2)
        assert spec.device.type == "meta"
        _same(spec, jstubs.vision_spec(jc, 2))
        _same(stubs.vision_patch_embeddings(c, 2, seed=0, device="cpu"),
              jstubs.vision_spec(jc, 2))


def test_stubs_are_deterministic_in_the_seed_and_standard_normal():
    """The same seed draws the same frames (and patches), another seed
    other ones; 2 × 1500 × 256 float32 frames have mean 0 and variance 1
    within 5 standard errors."""
    cfg = get_config("whisper-large-v3").reduced(encoder_seq_len=1500)
    a = stubs.audio_frame_embeddings(cfg, 2, seed=3, device="cpu")
    assert torch.equal(a, stubs.audio_frame_embeddings(cfg, 2, seed=3,
                                                       device="cpu"))
    assert not torch.equal(a, stubs.audio_frame_embeddings(cfg, 2, seed=4,
                                                           device="cpu"))
    n = a.numel()
    assert abs(a.mean().item()) <= 5 / math.sqrt(n)
    assert abs(a.var().item() - 1.0) <= 5 * math.sqrt(2 / n)
    vc = dataclasses.replace(cfg, vision_prefix_len=8)
    p = stubs.vision_patch_embeddings(vc, 2, seed=3, device="cpu")
    assert torch.equal(p, stubs.vision_patch_embeddings(vc, 2, seed=3,
                                                        device="cpu"))
    assert not torch.equal(p, stubs.vision_patch_embeddings(vc, 2, seed=4,
                                                            device="cpu"))


def test_stubs_draw_on_the_card_by_default(monkeypatch):
    """Without ``device`` the stubs draw on the card, as every entry point
    of the port: with no card they raise rather than move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("whisper-large-v3").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stubs.audio_frame_embeddings(cfg, 1)
