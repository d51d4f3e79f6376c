"""npz checkpointing with tree flattening + expert metadata.

Reads and writes the reference's format: one ``.npz`` whose members are
the flattened leaves (keys joined by ``::``, list indices as digits) plus
a JSON ``__metadata__`` entry carrying the expert's objective, schedule
and cluster id — so either package serves the other's checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.weights import params_from_numpy, resolve_device

SEP = "::"


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix.rstrip(SEP[-1]).rstrip(SEP[0])] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _intify(tree)


def _intify(node):
    """Convert dicts whose keys are 0..n-1 back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _intify(v) for k, v in node.items()}
    keys = list(node)
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [node[str(i)] for i in idx]
    return node


def save_checkpoint(
    path: str, params: Any, *, metadata: dict | None = None
) -> None:
    """Write ``params`` (tensors or numpy arrays) and ``metadata``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(params)
    meta = json.dumps(metadata or {})
    np.savez(path, __metadata__=np.asarray(meta), **flat)


def load_checkpoint(path: str, device=None) -> tuple[Any, dict]:
    """Load a ``save_checkpoint`` artifact onto ``device`` (``None`` →
    ``"cuda"``, raising without a GPU), failing with *named* errors.

    A missing file raises ``FileNotFoundError`` naming the resolved path;
    a missing ``__metadata__`` entry, a truncated/corrupt archive, a
    non-zip file or mangled metadata JSON raises ``ValueError`` naming the
    file and the reason.
    """
    device = resolve_device(device)
    if not path.endswith(".npz"):
        path = path + ".npz"
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint not found: {path} (expected an .npz written by "
            f"save_checkpoint)"
        )
    try:
        with np.load(path, allow_pickle=False) as z:
            names = sorted(z.files)
            has_meta = "__metadata__" in z.files
            raw_meta = str(z["__metadata__"]) if has_meta else ""
            flat = {k: z[k] for k in z.files if k != "__metadata__"}
    except Exception as e:
        # zipfile.BadZipFile (non-zip bytes), OSError/EOFError (archive
        # truncated mid-member), struct.error, np.load's own ValueError.
        raise ValueError(
            f"{path}: corrupt or truncated checkpoint archive — "
            f"{type(e).__name__}: {e}"
        ) from e
    if not has_meta:
        raise ValueError(
            f"{path}: missing '__metadata__' entry — not a "
            f"save_checkpoint artifact (archive keys: {names[:5]}"
            f"{'...' if len(names) > 5 else ''})"
        )
    try:
        meta = json.loads(raw_meta)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"{path}: mangled '__metadata__' JSON — {e}"
        ) from e
    return params_from_numpy(_unflatten(flat), device), meta


def expert_metadata(
    *, name: str, objective: str, schedule: str, cluster_id: int,
    arch: str, step: int = 0, extra: dict | None = None,
) -> dict:
    md = {
        "name": name, "objective": objective, "schedule": schedule,
        "cluster_id": cluster_id, "arch": arch, "step": step,
        "format_version": 1,
    }
    if extra:
        md.update(extra)
    return md
