"""Stacked-expert parameter store (dense storage).

The routed engine serves every expert from one stacked tree whose leaves
carry a leading expert axis ``(K, ...)``.  ``DenseStore`` types that tree
and exposes the ragged backend's access pattern, ``ragged_view``: the raw
stacked leaves, which ``kernels.ops.ragged_expert_matmul`` indexes per
row group.  Quantized (int8/fp8) and cast (fp32/bf16) storage are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models.dit import tree_leaves

#: valid ``SamplerConfig.param_dtype`` values of the reference; the port
#: serves ``native`` only so far.
PARAM_DTYPES = ("native", "fp32", "bf16", "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class DenseStore:
    """Dense stacked store: leaves kept at checkpoint precision."""

    stacked: Any
    num_experts: int

    @classmethod
    def from_stacked(cls, stacked: Any) -> "DenseStore":
        leaves = tree_leaves(stacked)
        if not leaves:
            raise ValueError("empty stacked tree")
        return cls(stacked=stacked, num_experts=int(leaves[0].shape[0]))

    def ragged_view(self):
        """Raw stacked leaves for the ragged grouped-GEMM backend."""
        return self.stacked


def make_store(stacked: Any, *, dtype: str = "native") -> DenseStore:
    """Build a store from a stacked tree (leaves ``(K, ...)``)."""
    if dtype not in PARAM_DTYPES:
        raise ValueError(
            f"unknown param_dtype {dtype!r}; expected one of {PARAM_DTYPES}"
        )
    if dtype != "native":
        raise NotImplementedError(
            f"param_dtype={dtype!r} is not ported yet (quantized and cast "
            f"stores) — ROADMAP.md, module queue A"
        )
    return DenseStore.from_stacked(stacked)


def as_store(stacked_or_store: Any, *, dtype: str = "native"):
    """A store passes through; a raw stacked tree is wrapped; None stays."""
    if stacked_or_store is None or isinstance(stacked_or_store, DenseStore):
        return stacked_or_store
    return make_store(stacked_or_store, dtype=dtype)
