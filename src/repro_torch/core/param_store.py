"""Stacked-expert parameter stores: dense, cast (fp32/bf16) and quantized
(int8/fp8).

The routed engine serves every expert from one stacked tree whose leaves
carry a leading expert axis ``(K, ...)``.  A store types that tree and
owns its storage dtype:

* ``DenseStore`` keeps the leaves at checkpoint precision (``native``) or
  cast to ``fp32``/``bf16`` (``storage`` records which);
* ``QuantizedStore`` keeps int8 or fp8 (e4m3) leaves with symmetric
  per-expert-per-leaf scales ``scale[e] = absmax(leaf[e]) / qmax`` (qmax
  127 or 448), so every layer of a stacked block leaf shares its
  expert's one scale.  int8 rounds half to even and clips to ±127.

Access patterns: ``gather``/``expert``/``static_slice``/``materialize``
expand routed or sliced quantized bytes through
``kernels.ops.dequant_params`` (the ``hetero_fuse_dequant`` kernel on the
card), and ``ragged_view`` hands the ragged executor the raw leaves —
dense tensors, or ``QuantLeaf`` bundles of int8/fp8 bytes plus ``(K,)``
scales that reach the ragged GEMM unexpanded.

Expert sharding: ``launch.sharding.shard_store`` cuts a rank's resident
slice, the experts ``[first_expert, first_expert + K_local)`` of every
leaf, scale and ``valid`` entry.  The slice keeps ``num_experts`` the
global ``K``; ``gather``, ``expert`` and ``set_expert`` take global ids,
``ragged_view`` and ``valid_mask`` are the resident rows, and ``nbytes``
counts the resident bytes.  An elastic slice also carries the whole
``(K,)`` mask, replicated (``routing_valid``): routing reads it through
``routing_mask()``.  ``logical_axes`` annotates every leaf with
its leading ``"expert"`` axis (``("expert", None, ...)``; scales and
``valid`` ``("expert",)``), as the reference's stores do.

Elastic membership: the leading expert axis is a *capacity*.
``pad_to_capacity`` zero-pads every leaf to ``(K_cap, ...)`` (quantized
scales pad with 1.0) and attaches a ``(K_cap,)`` bool ``valid`` mask on
the store's device; ``None`` means every slot is live.  Routing zeroes
dead slots (``core.fusion.fusion_weights``) and plans remap them to a
live slot at weight 0 (``core.dispatch.routed_slots``), so no executor
reads a dead slot's bytes.  Stores are functional: ``set_expert`` and
``with_valid`` return new stores and never write the old one's leaves,
so a request holding an older store as its admission-time snapshot is
served unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

#: the logical name of the stacked leaves' leading axis
EXPERT_AXIS = "expert"

#: valid ``SamplerConfig.param_dtype`` values.
PARAM_DTYPES = ("native", "fp32", "bf16", "int8", "fp8")

_DENSE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
_QUANT = {"int8": (torch.int8, 127.0), "fp8": (torch.float8_e4m3fn, 448.0)}


def _tree_nbytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _leaf_axes(x: torch.Tensor) -> tuple:
    return (EXPERT_AXIS,) + (None,) * (x.dim() - 1)


def _set_row(s: torch.Tensor, e: int, row) -> torch.Tensor:
    """A copy of ``s`` with ``s[e]`` replaced by ``row`` (cast to ``s``'s
    dtype); ``s`` itself is left as it is."""
    out = s.clone()
    out[e] = torch.as_tensor(row, device=s.device).to(s.dtype)
    return out


class _Membership:
    """The elastic-membership and resident-slice methods both stores
    share."""

    def _device(self) -> torch.device:
        return tree_leaves(self._leaves())[0].device

    @property
    def num_resident(self) -> int:
        """The experts this store holds: ``num_experts``, or a resident
        slice's share of them."""
        return int(tree_leaves(self._leaves())[0].shape[0])

    def _local(self, e):
        """A global expert id (an int or a tensor of them) as a row of the
        resident leaves."""
        return e - self.first_expert if self.first_expert else e

    def valid_mask(self) -> torch.Tensor:
        """``(K_resident,)`` bool: which resident slots hold a live expert
        (all of them for a store without a mask)."""
        if self.valid is not None:
            return self.valid
        return torch.ones((self.num_resident,), dtype=torch.bool,
                          device=self._device())

    def with_valid(self, mask):
        """A new store with ``valid`` replaced (same leaves)."""
        if mask is not None:
            mask = torch.as_tensor(mask, device=self._device()).to(
                torch.bool)
            if tuple(mask.shape) != (self.num_resident,):
                raise ValueError(f"valid mask shape {tuple(mask.shape)} != "
                                 f"({self.num_resident},)")
        return dataclasses.replace(self, valid=mask)

    def routing_mask(self):
        """The ``(K,)`` liveness mask routing reads: a resident slice's
        replicated whole mask, else ``valid`` (None: every slot live)."""
        if self.routing_valid is not None:
            return self.routing_valid
        return self.valid

    def _valid_axes(self):
        return None if self.valid is None else (EXPERT_AXIS,)

    def _nbytes_valid(self) -> int:
        return 0 if self.valid is None else self.valid.numel()


@dataclasses.dataclass(frozen=True)
class QuantLeaf:
    """One quantized stacked leaf and its per-expert scales, unexpanded:
    ``q`` ``(K, ...)`` int8/fp8 and ``scale`` ``(K,)`` float32."""

    q: torch.Tensor
    scale: torch.Tensor


def dequant_leaf(leaf):
    """Expand a view leaf to float32: ``float(q)·scale`` per expert row
    (``kernels.ops.dequant_params``).  Plain tensors (dense stores) pass
    through untouched."""
    if not isinstance(leaf, QuantLeaf):
        return leaf
    return ops.dequant_params(leaf.q, leaf.scale)


@dataclasses.dataclass(frozen=True)
class DenseStore(_Membership):
    """Dense stacked store: leaves at checkpoint precision (``native``) or
    cast to ``fp32``/``bf16`` (``storage``)."""

    stacked: Any
    num_experts: int
    storage: str = "native"
    #: ``(K,)`` bool liveness mask, or None (every slot live).
    valid: Any = None
    #: a resident slice's first global expert id (0: the whole store).
    first_expert: int = 0
    #: a resident slice's whole ``(K,)`` mask, replicated (None: ``valid``
    #: is whole); routing metadata, not counted by ``nbytes``.
    routing_valid: Any = None

    def _leaves(self):
        return self.stacked

    @classmethod
    def from_stacked(cls, stacked: Any,
                     storage: str = "native") -> "DenseStore":
        leaves = tree_leaves(stacked)
        if not leaves:
            raise ValueError("empty stacked tree")
        return cls(stacked=stacked, num_experts=int(leaves[0].shape[0]),
                   storage=storage)

    def gather(self, idx: torch.Tensor):
        """Leaves of the routed experts: ``(B, ...)`` for ``(B,)`` ids, one
        expert's leaves for a 0-d id."""
        idx = self._local(idx)
        return tree_map(lambda s: s[idx], self.stacked)

    def expert(self, e: int):
        e = self._local(e)
        return tree_map(lambda s: s[e], self.stacked)

    def static_slice(self, lo: int, hi: int) -> "DenseStore":
        return DenseStore(stacked=tree_map(lambda s: s[lo:hi], self.stacked),
                          num_experts=hi - lo, storage=self.storage,
                          valid=None if self.valid is None
                          else self.valid[lo:hi])

    def set_expert(self, e: int, params: Any) -> "DenseStore":
        """A new store with slot ``e`` holding ``params`` (cast to the
        storage dtype); ``valid`` is left as it is."""
        e = self._local(e)
        return dataclasses.replace(self, stacked=tree_map(
            lambda s, p: _set_row(s, e, p), self.stacked, params))

    def materialize(self, dtype=None):
        if dtype is None:
            return self.stacked
        return tree_map(lambda s: s.to(dtype), self.stacked)

    def ragged_view(self):
        """Raw stacked leaves for the ragged grouped-GEMM backend."""
        return self.stacked

    def logical_axes(self) -> "DenseStore":
        """The store with every leaf replaced by its axis names."""
        return dataclasses.replace(
            self, stacked=tree_map(_leaf_axes, self.stacked),
            valid=self._valid_axes())

    def nbytes(self) -> int:
        return _tree_nbytes(self.stacked) + self._nbytes_valid()


def _quantize_leaf(x: torch.Tensor, storage: str):
    """Symmetric per-expert quantization of one stacked leaf ``(K, ...)``:
    ``(q, scale)`` with ``scale`` ``(K,)`` float32."""
    qdtype, qmax = _QUANT[storage]
    x32 = x.to(torch.float32)
    absmax = x32.reshape(x.shape[0], -1).abs().amax(dim=1)
    scale = torch.where(absmax > 0.0, ops.true_div(absmax, qmax),
                        torch.ones_like(absmax))
    scaled = x32 / scale.reshape((-1,) + (1,) * (x.dim() - 1))
    if storage == "int8":
        return torch.clamp(torch.round(scaled), -qmax, qmax).to(qdtype), scale
    return scaled.to(qdtype), scale


@dataclasses.dataclass(frozen=True)
class QuantizedStore(_Membership):
    """int8/fp8 stacked store with per-expert-per-leaf symmetric scales.

    ``qvals`` leaves are ``(K, ...)`` in the storage dtype, ``scales``
    leaves ``(K,)`` float32.  Every access expands only what it gathered
    or sliced, through the dequant kernel.
    """

    qvals: Any
    scales: Any
    num_experts: int
    storage: str                           # 'int8' | 'fp8'
    #: ``(K,)`` bool liveness mask, or None (every slot live).
    valid: Any = None
    #: a resident slice's first global expert id (0: the whole store).
    first_expert: int = 0
    #: a resident slice's whole ``(K,)`` mask, replicated (None: ``valid``
    #: is whole); routing metadata, not counted by ``nbytes``.
    routing_valid: Any = None

    def _leaves(self):
        return self.qvals

    @classmethod
    def quantize(cls, stacked: Any, storage: str) -> "QuantizedStore":
        if storage not in _QUANT:
            raise ValueError(f"unknown quantized storage {storage!r}; "
                             f"expected one of {tuple(_QUANT)}")
        leaves = tree_leaves(stacked)
        if not leaves:
            raise ValueError("empty stacked tree")
        quant = tree_map(lambda x: QuantLeaf(*_quantize_leaf(x, storage)),
                         stacked)
        return cls(qvals=tree_map(lambda leaf: leaf.q, quant),
                   scales=tree_map(lambda leaf: leaf.scale, quant),
                   num_experts=int(leaves[0].shape[0]), storage=storage)

    def _dequant(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """``scale·q`` over the leading (row) axis, through the kernel."""
        return ops.dequant_params(q, scale)

    def gather(self, idx: torch.Tensor):
        idx = self._local(torch.as_tensor(idx))
        if idx.dim() == 0:
            one = idx.reshape(1)
            return tree_map(lambda q, s: self._dequant(q[one], s[one])[0],
                            self.qvals, self.scales)
        return tree_map(lambda q, s: self._dequant(q[idx], s[idx]),
                        self.qvals, self.scales)

    def expert(self, e: int):
        e = self._local(e)
        return tree_map(lambda q, s: self._dequant(q[e:e + 1], s[e:e + 1])[0],
                        self.qvals, self.scales)

    def static_slice(self, lo: int, hi: int) -> "QuantizedStore":
        return QuantizedStore(
            qvals=tree_map(lambda q: q[lo:hi], self.qvals),
            scales=tree_map(lambda s: s[lo:hi], self.scales),
            num_experts=hi - lo, storage=self.storage,
            valid=None if self.valid is None else self.valid[lo:hi])

    def set_expert(self, e: int, params: Any) -> "QuantizedStore":
        """A new store with slot ``e`` holding ``params`` quantized as one
        expert (``_quantize_leaf(p[None])``, so the slot's bytes and scale
        are those of a store quantized with it from the start); ``valid``
        is left as it is."""
        e = self._local(e)

        def quantized(q, p):
            p = torch.as_tensor(p, device=q.device)
            return QuantLeaf(*_quantize_leaf(p[None], self.storage))

        quant = tree_map(quantized, self.qvals, params)
        return dataclasses.replace(
            self,
            qvals=tree_map(lambda q, a: _set_row(q, e, a.q[0]),
                           self.qvals, quant),
            scales=tree_map(lambda s, a: _set_row(s, e, a.scale[0]),
                            self.scales, quant))

    def materialize(self, dtype=None):
        out = tree_map(self._dequant, self.qvals, self.scales)
        if dtype is not None:
            out = tree_map(lambda x: x.to(dtype), out)
        return out

    def ragged_view(self):
        """``QuantLeaf`` bundles of the raw bytes and their scales."""
        return tree_map(lambda q, s: QuantLeaf(q, s),
                        self.qvals, self.scales)

    def logical_axes(self) -> "QuantizedStore":
        """The store with every leaf and scale replaced by its axis names:
        a scale rides the leading expert axis of the leaf it rescales."""
        return dataclasses.replace(
            self, qvals=tree_map(_leaf_axes, self.qvals),
            scales=tree_map(_leaf_axes, self.scales),
            valid=self._valid_axes())

    def nbytes(self) -> int:
        return (_tree_nbytes(self.qvals) + _tree_nbytes(self.scales)
                + self._nbytes_valid())


def make_store(stacked: Any, *, dtype: str = "native"):
    """Build a store from a stacked tree (leaves ``(K, ...)``): ``native``
    wraps the leaves untouched, ``fp32``/``bf16`` cast them, ``int8``/
    ``fp8`` quantize them."""
    if dtype not in PARAM_DTYPES:
        raise ValueError(
            f"unknown param_dtype {dtype!r}; expected one of {PARAM_DTYPES}"
        )
    if dtype == "native":
        return DenseStore.from_stacked(stacked)
    if dtype in _DENSE_DTYPES:
        target = _DENSE_DTYPES[dtype]
        return DenseStore.from_stacked(
            tree_map(lambda x: x.to(target), stacked), storage=dtype)
    return QuantizedStore.quantize(stacked, dtype)


def retype_store(store, dtype: str):
    """A ``native`` store (whole, or a resident slice) in the storage
    ``dtype`` selects (``make_store``'s rules, expert row by expert row, so
    a slice converts to the rows of the converted whole), its global
    ``num_experts``, masks and ``first_expert`` kept."""
    if dtype == "native":
        return store
    out = make_store(store.stacked, dtype=dtype)
    return dataclasses.replace(
        out, num_experts=store.num_experts, valid=store.valid,
        first_expert=store.first_expert, routing_valid=store.routing_valid)


def pad_to_capacity(store, capacity: int):
    """Grow a store's expert axis to ``capacity`` slots: every leaf
    zero-padded (quantized scales padded with 1.0, so a pad slot expands
    to exact zeros), ``valid`` the old mask followed by dead slots.
    ``num_experts`` is then the capacity.  A whole store only: a resident
    slice is cut after padding."""
    k = store.num_experts
    if store.num_resident != k:
        raise ValueError("pad_to_capacity pads a whole store, not a "
                         "resident slice")
    if capacity < k:
        raise ValueError(f"capacity {capacity} < current expert count {k}")
    pad = capacity - k
    valid = torch.cat([store.valid_mask(), torch.zeros(
        (pad,), dtype=torch.bool, device=store._device())])

    def pad_leaf(x, fill=0):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    if isinstance(store, DenseStore):
        return DenseStore(stacked=tree_map(pad_leaf, store.stacked),
                          num_experts=capacity, storage=store.storage,
                          valid=valid)
    if isinstance(store, QuantizedStore):
        return QuantizedStore(
            qvals=tree_map(pad_leaf, store.qvals),
            scales=tree_map(lambda s: pad_leaf(s, fill=1), store.scales),
            num_experts=capacity, storage=store.storage, valid=valid)
    raise TypeError(f"cannot pad {type(store).__name__}")


def as_store(stacked_or_store: Any, *, dtype: str = "native"):
    """A store passes through; a raw stacked tree is wrapped; None stays."""
    if stacked_or_store is None or isinstance(
            stacked_or_store, (DenseStore, QuantizedStore)):
        return stacked_or_store
    return make_store(stacked_or_store, dtype=dtype)
