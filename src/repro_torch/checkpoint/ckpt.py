"""Checkpointing: a flat-path ``.npz`` of any tree plus a metadata sidecar.

The reference's file format (``repro/checkpoint/ckpt.py``), so each package
reads the other's params checkpoints: leaves are stored under their tree
paths joined with ``|`` (dict keys as they are, sequence indices as
``#i``), dicts in sorted key order; bfloat16 leaves are upcast to float32
(exact) and cast back to the dtype of ``like`` on restore; the sidecar
``<path>.meta.json`` holds the caller's metadata.

Leaves the reference has no counterpart for: a ``torch.Generator`` (the
trainer's seed source) is stored as its byte state and restored into a new
generator on ``like``'s device, so a resumed run draws the same seeds; a
Python int (the trainer's step) as an int64 scalar.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree

PyTree = Any

_SEP = "|"


def _paths(node, prefix: Tuple[str, ...], out: List) -> None:
    """``(path, leaf)`` pairs in the order ``repro_torch.tree`` flattens."""
    if isinstance(node, dict):
        for k in sorted(node):
            _paths(node[k], prefix + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, c in enumerate(node):
            _paths(c, prefix + (f"#{i}",), out)
    else:
        out.append((_SEP.join(prefix), node))


def _leaves_with_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    out: List = []
    _paths(tree, (), out)
    return out


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int64)
    return np.asarray(leaf)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta(path: str) -> str:
    return re.sub(r"\.npz$", "", path) + ".meta.json"


def save(path: str, tree: PyTree, meta: Dict | None = None) -> None:
    """Write ``tree`` to ``<path>.npz`` and ``meta`` to the sidecar."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(_npz(path), **{k: _to_numpy(v)
                            for k, v in _leaves_with_paths(tree)})
    with open(_meta(path), "w") as f:
        json.dump(meta or {}, f, indent=2, default=str)


def _back(arr: np.ndarray, like: Any) -> Any:
    if isinstance(like, torch.Generator):
        g = torch.Generator(device=like.device)
        g.set_state(torch.from_numpy(arr))
        return g
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(dtype=like.dtype, device=like.device)
    if isinstance(like, int):
        return int(arr)
    return arr


def restore(path: str, like: PyTree) -> PyTree:
    """Restore into the structure, dtypes and devices of ``like``."""
    pairs = _leaves_with_paths(like)
    with np.load(_npz(path)) as npz:
        if len(npz.files) != len(pairs):
            raise ValueError(f"{path}: {len(npz.files)} arrays, the tree "
                             f"has {len(pairs)} leaves")
        leaves = [_back(npz[k], l) for k, l in pairs]
    return _tree.unflatten(_tree.flatten(like)[1], leaves)


def load_meta(path: str) -> Dict:
    with open(_meta(path)) as f:
        return json.load(f)
