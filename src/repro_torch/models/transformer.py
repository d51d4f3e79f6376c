"""The transformer family's module of the port (``repro.models.transformer``).

Holds only the token-mean cross-entropy that every LM backbone's
``loss_fn`` uses; the dense, MoE and VLM backbones themselves are not
ported yet (ROADMAP.md, module queue A.10).
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  chunk: int = 0) -> torch.Tensor:
    """Token-mean CE.  ``chunk`` > 0 evaluates the softmax over sequence
    chunks of ``chunk`` positions (a memory lever for large vocabularies)
    and averages the ``S // chunk`` whole chunks, as the reference does:
    a remainder of fewer than ``chunk`` positions is left out."""
    if chunk and logits.shape[1] > chunk:
        n = logits.shape[1] // chunk
        ces = [_ce(logits[:, c * chunk:(c + 1) * chunk],
                   labels[:, c * chunk:(c + 1) * chunk]) for c in range(n)]
        return torch.stack(ces).mean()
    return _ce(logits, labels)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - picked)
