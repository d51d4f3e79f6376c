"""Decentralized expert ensembling for LM backbones (port of
``repro.core.lm_ensemble``).

The paper's decentralized-expert half applied to a language model: K LM
experts trained in isolation on disjoint corpus clusters, a prototype
router on bag-of-tokens statistics, and at inference the experts'
next-token log-probabilities fused with router weights — the Eq. 1
mixture ``p(x_{t+1} | x) = Σ_k p(k | x) p_k(x_{t+1} | x)``, with the
sampler's Top-1 / Top-K / Full strategies.  The port serves the
backbones ``models.zoo`` registers (Mamba2).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.fusion import routing_weights
from repro_torch.kernels import ops
from repro_torch.models import zoo
from repro_torch.models.config import LMConfig

# ---------------------------------------------------------------------------
# Prototype router over token statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenPrototypeRouter:
    """Nearest-prototype routing on normalized token histograms.

    Fitted from per-cluster corpora; ``posterior`` returns
    ``softmax(sim/τ)``.  The prototypes stay host numpy, as in the
    reference, and move to the tokens' device per call.
    """

    # Host-side fitted state, never a cache key (posterior() moves it to
    # the tokens' device per call).  # lint: allow-mutable-config
    prototypes: np.ndarray          # (K, V) normalized token frequencies
    temperature: float = 0.05

    @staticmethod
    def _histogram(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
        """(B, S) tokens -> (B, V) L2-normalized token frequencies."""
        ids = tokens.long()
        counts = torch.zeros((ids.shape[0], vocab), dtype=torch.float32,
                             device=ids.device)
        counts.scatter_add_(1, ids, torch.ones(ids.shape, dtype=torch.float32,
                                               device=ids.device))
        h = counts / torch.clamp(counts.sum(-1, keepdim=True), min=1.0)
        norm = torch.sqrt((h * h).sum(-1, keepdim=True))
        return h / torch.clamp(norm, min=1e-8)

    @classmethod
    def fit(cls, corpora: Sequence, vocab: int,
            temperature: float = 0.05) -> "TokenPrototypeRouter":
        """One prototype per corpus (tokens as tensors or numpy arrays)."""
        protos = []
        for tokens in corpora:
            h = cls._histogram(torch.as_tensor(tokens).reshape(1, -1), vocab)
            protos.append(h[0].cpu().numpy())
        return cls(prototypes=np.stack(protos), temperature=temperature)

    def posterior(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) int tokens -> (B, K) routing posterior."""
        vocab = self.prototypes.shape[1]
        h = self._histogram(tokens, vocab)                       # (B, V)
        protos = torch.as_tensor(self.prototypes, device=tokens.device)
        sims = h @ protos.T                                      # (B, K)
        return torch.softmax(ops.true_div(sims, self.temperature), dim=-1)


def _host_scalar(x: torch.Tensor) -> float:
    """The module's one explicit device→host boundary: perplexities go
    back to callers as Python floats (logs and assertions)."""
    return x.item()  # lint: allow-host-sync


# ---------------------------------------------------------------------------
# Ensemble
# ---------------------------------------------------------------------------


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


@dataclasses.dataclass
class LMExpertEnsemble:
    """K isolated LM experts + router, fused in log-probability space."""

    cfg: LMConfig
    expert_params: list
    router: TokenPrototypeRouter
    strategy: str = "topk"
    top_k: int = 2

    def _log_weights(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens -> (K, B) log fusion weights."""
        w = routing_weights(self.router.posterior(tokens), self.strategy,
                            self.top_k)
        return torch.log(torch.clamp(w, min=1e-12)).T

    def fused_logprobs(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) -> (B, S, V) mixture log-probabilities (Eq. 1 in
        probability space: log Σ_k w_k softmax(logits_k))."""
        logw = self._log_weights(tokens)
        stacked = torch.stack([
            _log_softmax(zoo.forward_train(self.cfg, p, {"tokens": tokens})[0])
            for p in self.expert_params])                        # (K,B,S,V)
        return torch.logsumexp(stacked + logw[:, :, None, None], dim=0)

    def perplexity(self, tokens: torch.Tensor, labels: torch.Tensor) -> float:
        lp = self.fused_logprobs(tokens)
        picked = torch.gather(lp, -1, labels[..., None].long())[..., 0]
        return _host_scalar(torch.exp(-torch.mean(picked)))

    def decode_greedy(self, prompt: torch.Tensor, steps: int) -> torch.Tensor:
        """Greedy continuation with router weights fixed from the prompt.

        Every expert replays the prompt token by token through its decode
        step (the reference's teacher-forced prefix), then the fused
        argmax extends it by ``steps`` tokens.
        """
        logw = self._log_weights(prompt)
        b, s = prompt.shape
        caches = [zoo.make_cache(self.cfg, b, s + steps, prompt.device)
                  for _ in self.expert_params]
        out = prompt
        tok = prompt[:, :1]
        for i in range(s + steps - 1):
            pos = torch.full((b,), i, dtype=torch.int32, device=prompt.device)
            logits = []
            for e, p in enumerate(self.expert_params):
                lg, caches[e] = zoo.decode_step(self.cfg, p, caches[e], tok,
                                                pos)
                logits.append(lg)
            if i + 1 < s:
                tok = prompt[:, i + 1:i + 2]       # teacher-forced prefix
                continue
            fused = torch.logsumexp(
                torch.stack([_log_softmax(lg) for lg in logits])
                + logw[:, :, None], dim=0)
            tok = torch.argmax(fused, dim=-1).to(prompt.dtype)[:, None]
            out = torch.cat([out, tok], dim=1)
        return out


def expert_perplexity(cfg: LMConfig, params, tokens: torch.Tensor,
                      labels: torch.Tensor) -> float:
    """Single-expert perplexity (baseline for the ensemble comparison)."""
    logits, _ = zoo.forward_train(cfg, params, {"tokens": tokens})
    lp = _log_softmax(logits)
    picked = torch.gather(lp, -1, labels[..., None].long())[..., 0]
    return _host_scalar(torch.exp(-torch.mean(picked)))
