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

#: valid ``SamplerConfig.param_dtype`` values.
PARAM_DTYPES = ("native", "fp32", "bf16", "int8", "fp8")

_DENSE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
_QUANT = {"int8": (torch.int8, 127.0), "fp8": (torch.float8_e4m3fn, 448.0)}


def _tree_nbytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _set_row(s: torch.Tensor, e: int, row) -> torch.Tensor:
    """A copy of ``s`` with ``s[e]`` replaced by ``row`` (cast to ``s``'s
    dtype); ``s`` itself is left as it is."""
    out = s.clone()
    out[e] = torch.as_tensor(row, device=s.device).to(s.dtype)
    return out


class _Membership:
    """The elastic-membership methods both stores share."""

    def _device(self) -> torch.device:
        return tree_leaves(self._leaves())[0].device

    def valid_mask(self) -> torch.Tensor:
        """``(K,)`` bool: which capacity slots hold a live expert (all of
        them for a store without a mask)."""
        if self.valid is not None:
            return self.valid
        return torch.ones((self.num_experts,), dtype=torch.bool,
                          device=self._device())

    def with_valid(self, mask):
        """A new store with ``valid`` replaced (same leaves)."""
        if mask is not None:
            mask = torch.as_tensor(mask, device=self._device()).to(
                torch.bool)
            if tuple(mask.shape) != (self.num_experts,):
                raise ValueError(f"valid mask shape {tuple(mask.shape)} != "
                                 f"({self.num_experts},)")
        return dataclasses.replace(self, valid=mask)

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
        return tree_map(lambda s: s[idx], self.stacked)

    def expert(self, e: int):
        return tree_map(lambda s: s[e], self.stacked)

    def static_slice(self, lo: int, hi: int) -> "DenseStore":
        return DenseStore(stacked=tree_map(lambda s: s[lo:hi], self.stacked),
                          num_experts=hi - lo, storage=self.storage,
                          valid=None if self.valid is None
                          else self.valid[lo:hi])

    def set_expert(self, e: int, params: Any) -> "DenseStore":
        """A new store with slot ``e`` holding ``params`` (cast to the
        storage dtype); ``valid`` is left as it is."""
        return dataclasses.replace(self, stacked=tree_map(
            lambda s, p: _set_row(s, e, p), self.stacked, params))

    def materialize(self, dtype=None):
        if dtype is None:
            return self.stacked
        return tree_map(lambda s: s.to(dtype), self.stacked)

    def ragged_view(self):
        """Raw stacked leaves for the ragged grouped-GEMM backend."""
        return self.stacked

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
        idx = torch.as_tensor(idx)
        if idx.dim() == 0:
            one = idx.reshape(1)
            return tree_map(lambda q, s: self._dequant(q[one], s[one])[0],
                            self.qvals, self.scales)
        return tree_map(lambda q, s: self._dequant(q[idx], s[idx]),
                        self.qvals, self.scales)

    def expert(self, e: int):
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


def pad_to_capacity(store, capacity: int):
    """Grow a store's expert axis to ``capacity`` slots: every leaf
    zero-padded (quantized scales padded with 1.0, so a pad slot expands
    to exact zeros), ``valid`` the old mask followed by dead slots.
    ``num_experts`` is then the capacity."""
    k = store.num_experts
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
