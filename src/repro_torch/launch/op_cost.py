"""A step's cost counted as its operations are dispatched (the port's
counterpart of ``repro.launch.hlo_cost``, the dry-run's "profiler").

``OpCost`` is a ``TorchDispatchMode``: run one step under it (the
dry-run runs it on fake tensors, ``FakeTensorMode``, so nothing is
allocated and nothing is computed) and it sums the three roofline
inputs:

* **FLOPs** — each matrix product and convolution by
  ``torch.utils.flop_counter``'s formulas (``2·M·N·K`` a product);
  elementwise work is not counted, as in the reference.  The Python
  layer loops run every layer, so the trip counts the reference parses
  from its while loops are the loops' own.
* **HBM bytes** — each operation reads its operands and writes its
  result once: no operation's output stays in cache for the next, and an
  elementwise chain is as many round trips as it has operations (the
  port runs them unfused; the reference counts XLA's fusions as one).
  Views cost nothing; a gather or embedding lookup reads only the rows
  it returns (twice its result, as the reference's dynamic-slice), an
  in-place scatter touches only its update region (twice the update),
  and a copy into a slice reads its source and writes the slice.
* **A port kernel is one operation** (``kernels.ops.COUNTER``): the
  attention and the SSD scan, forward and backward, count by the FLOP
  and byte reckoning of ``PERF.md``'s kernel table (``KERNEL_COSTS``:
  the products on the pairs a mask leaves open; each input read once,
  each output written once).  Their plain versions' intermediates — the
  S×S scores of the plain attention — are not traffic.
* **Collective bytes by type** — from the ``_c10d_functional``
  collectives (the FSDP gathers, their gradients' reduce-scatters, the
  all-reduces): the bytes of the whole tensor times the wire factor of
  the group's size (``hlo_analysis.wire_factor``) — the result's, and a
  reduce-scatter's operand (the reference's HLO count takes every
  collective's result, a reduce-scatter's 1/n shard).  They also count
  as HBM traffic, as every other operation.

Like the reference's, this is a static model: no caching across
operations, no overlap of collectives with compute.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed.distributed_c10d as c10d
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.hlo_analysis import wire_factor

#: the ``_c10d_functional`` collectives, by the reference's HLO names
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "all_reduce": "all-reduce",
                   "all_to_all_single": "all-to-all"}

#: operations that move no data: allocation, metadata, waits
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "device",
         "wait_tensor", "set_", "resize_", "_unsafe_view"}

#: reads only the rows they return
_GATHERS = {"embedding", "index", "gather", "index_select"}

#: in place, touching only their update region
_SCATTERS = {"index_put_", "index_copy_", "scatter_", "scatter_add_",
             "index_add_", "_index_put_impl_"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _open_pairs(s: int, causal: bool, window: int, skv: int,
                prefix: int) -> int:
    """(query, key) pairs a mask leaves open over one head: ``s`` query
    rows over ``skv`` keys (a causal or windowed call has equal lengths;
    under ``causal`` a prefix P opens every pair below P)."""
    if skv != s:
        return s * skv
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = (np.minimum(s, np.maximum(q + 1, prefix)) if causal
          else np.full_like(q, s))
    return int((hi - lo).sum())


def flash_attention_cost(*, b, hq, hkv, s, skv, d, elt, causal, window,
                         prefix) -> tuple[float, float]:
    """(FLOPs, bytes) of the attention kernel: q·kᵀ and p·v on the open
    pairs; q, k, v read and the output written once."""
    pairs = _open_pairs(s, causal, window, skv, prefix) * b * hq
    return 4.0 * d * pairs, elt * d * b * (2.0 * hq * s + 2.0 * hkv * skv)


def flash_attention_bwd_cost(*, b, hq, hkv, s, skv, d, elt, causal,
                             window, prefix) -> tuple[float, float]:
    """(FLOPs, bytes) of its backward: five S×S×D products a head on the
    open pairs; q, o, dO, dq and k, v, dk, dv once, and the row lse."""
    pairs = _open_pairs(s, causal, window, skv, prefix) * b * hq
    return (10.0 * d * pairs,
            elt * d * b * (4.0 * hq * s + 4.0 * hkv * skv) + 4.0 * b * hq * s)


def ssd_scan_cost(*, b, h, s, p, n, q, elt) -> tuple[float, float]:
    """(FLOPs, bytes) of the SSD scan: C·Bᵀ once per (batch, chunk) and
    the intra-chunk product on the causal triangle, the inter-chunk and
    state products per (batch, head, chunk); each input read once, y and
    the state written once."""
    chunks = b * (s // q)
    tri = q * (q + 1) / 2
    flops = 2.0 * chunks * tri * n + 2.0 * chunks * h * (
        tri * p + 2 * q * p * n)
    nbytes = (elt * (2.0 * b * s * h * p + 2.0 * b * s * n)
              + 4.0 * (b * s * h + h + b * h * p * n))
    return flops, nbytes


def ssd_scan_bwd_cost(*, b, h, s, p, n, q, elt) -> tuple[float, float]:
    """(FLOPs, bytes) of its backward: per (batch, chunk) C·Bᵀ again and
    the head-summed (dP∘L)·B and (dP∘L)ᵀ·C on the triangle; per (batch,
    head, chunk) the triangle's two products and four (q × P)·(P × N)
    ones; each input (the tile-start states among them) read once and
    each gradient written once."""
    nc = -(-s // q)
    chunks = b * nc
    tri = q * (q + 1) / 2
    flops = 3 * 2.0 * chunks * tri * n + chunks * h * (
        2 * 2.0 * tri * p + 4 * 2.0 * q * p * n)
    nbytes = (elt * (3.0 * b * s * h * p + 4.0 * b * s * n)
              + 4.0 * (2 * b * s * h + 2 * h + b * h * nc * p * n))
    return flops, nbytes


#: a port kernel's (FLOPs, bytes) by the name ``kernels.ops`` reports it
KERNEL_COSTS = {"flash_attention": flash_attention_cost,
                "flash_attention_bwd": flash_attention_bwd_cost,
                "ssd_scan": ssd_scan_cost,
                "ssd_scan_bwd": ssd_scan_bwd_cost}


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_type: dict = dataclasses.field(default_factory=dict)
    collective_count: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    ops: int = 0

    def scaled(self, k: float) -> "CostTotals":
        """The totals times ``k`` (op and kernel counts kept)."""
        return CostTotals(
            self.flops * k, self.hbm_bytes * k, self.collective_bytes * k,
            {t: v * k for t, v in self.collective_by_type.items()},
            dict(self.collective_count), dict(self.kernels), self.ops)


def _group_size(name: str) -> int:
    return c10d._resolve_process_group(name).size()


class OpCost(TorchDispatchMode):
    """Counts every operation dispatched while active (see the module
    docstring); ``totals`` holds the sums.  Use it as a context manager,
    inside ``FakeTensorMode`` for a step that must not allocate; a port
    kernel given fake tensors is counted through ``kernels.ops.COUNTER``
    (set by ``counting``) as one op, and given real CPU tensors computes
    its plain version, whose ops are counted as any others."""

    def __init__(self):
        super().__init__()
        self.totals = CostTotals()

    def kernel(self, name: str, **shape) -> None:
        """One launch of the port kernel ``name`` at ``shape``."""
        flops, nbytes = KERNEL_COSTS[name](**shape)
        t = self.totals
        t.flops += flops
        t.hbm_bytes += nbytes
        t.kernels[name] = t.kernels.get(name, 0) + 1
        t.ops += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        t = self.totals
        if name in _FREE or _is_view(func):
            return
        t.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            t.flops += float(flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            size = _group_size(args[-1])
            whole = ins if kind == "reduce-scatter" else outs
            wire = sum(map(_nbytes, whole)) * wire_factor(kind, size)
            t.collective_bytes += wire
            t.collective_by_type[kind] = t.collective_by_type.get(
                kind, 0.0) + wire
            t.collective_count[kind] = t.collective_count.get(kind, 0) + 1
        if name in _GATHERS:
            idx = sum(_nbytes(a) for a in ins[1:]
                      if not a.is_floating_point())
            t.hbm_bytes += 2 * sum(map(_nbytes, outs)) + idx
        elif name in _SCATTERS:
            t.hbm_bytes += sum(2 * _nbytes(a) if a.is_floating_point()
                               else _nbytes(a) for a in ins[1:])
        elif name == "copy_":
            t.hbm_bytes += _nbytes(args[0]) + _nbytes(args[1])
        else:
            seen, nb = set(), 0
            for a in ins:
                if id(a) not in seen:
                    seen.add(id(a))
                    nb += _nbytes(a)
            # an in-place result is written back: counted as an output too
            t.hbm_bytes += nb + sum(map(_nbytes, outs))


def _is_view(func) -> bool:
    """An operation whose result aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


@contextlib.contextmanager
def counting():
    """``with counting() as cost:`` — an ``OpCost`` active, and the port's
    kernel wrappers reporting to it (``kernels.ops.COUNTER``)."""
    from repro_torch.kernels import ops

    cost = OpCost()
    prev, ops.COUNTER = ops.COUNTER, cost
    try:
        with cost:
            yield cost
    finally:
        ops.COUNTER = prev
