"""The dry-run's three-term roofline, the model FLOPs and the collective
wire factors (port of ``repro.launch.hlo_analysis``, the parts that are
not XLA).

A collective's bytes on the wire are its result's bytes times a factor of
the group size ``n`` (``wire_factor``):

    all-reduce          2·(n−1)/n ≈ 2   (ring: reduce-scatter + all-gather)
    all-gather          (n−1)/n   ≈ 1
    reduce-scatter      (n−1)/n   ≈ 1
    all-to-all          (n−1)/n   ≈ 1
    collective-permute  1

with the asymptotic factor where the group size is unknown (``n`` 0).
The reference's ``collective_bytes`` and ``compiled_bytes_accessed``
parse XLA's optimized HLO text and its ``cost_analysis``; the port has no
XLA program, and counts a step's operations and collectives as they are
dispatched instead (``launch.op_cost``), so neither has a counterpart
here.
"""

from __future__ import annotations

import dataclasses

#: the collectives the wire factors cover (the reference's HLO names)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def wire_factor(op: str, n: int = 0) -> float:
    """Bytes on the wire per result byte of collective ``op`` over a
    group of ``n`` ranks (``n`` ≤ 1: the asymptotic factor)."""
    if op == "all-reduce":
        return 2.0 * (n - 1) / n if n > 1 else 2.0
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / n if n > 1 else 1.0
    if op == "collective-permute":
        return 1.0
    raise ValueError(f"unknown collective {op!r}; known: {COLLECTIVES}")


@dataclasses.dataclass
class Roofline:
    """Three roofline terms, seconds per step per device.  ``ici_bw`` is
    the collective link's rate (the reference's name; NVLink on the
    card, ``launch.mesh.LINK_BW``)."""

    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    peak_flops: float
    hbm_bw: float
    ici_bw: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / self.ici_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops(cfg, shape, params_total: int, active_params: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D for a train step;
    2·N·D_tokens for inference (forward only)."""
    del cfg, params_total
    n = active_params
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
