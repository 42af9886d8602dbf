"""Minimal pytrees over dicts, lists and tuples, in JAX's leaf order.

``jax.tree.flatten`` visits dict entries in *sorted key* order, while
``torch.utils._pytree`` keeps insertion order.  Leaf order fixes the flat
bucket offsets, which are the encode kernel's counter ``idx_base``, so it
fixes the payload bits: the port flattens exactly as JAX does.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any
_LEAF = "*"


def _spec(node, leaves: list):
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_spec(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, len(node),
                tuple(_spec(c, leaves) for c in node))
    leaves.append(node)
    return _LEAF


def flatten(tree: PyTree) -> Tuple[List[Any], tuple]:
    """``(leaves, treedef)``; the treedef is a hashable nested tuple."""
    leaves: list = []
    return leaves, _spec(tree, leaves)


def leaves(tree: PyTree) -> List[Any]:
    return flatten(tree)[0]


def unflatten(treedef: tuple, leaves_: List[Any]) -> PyTree:
    it = iter(leaves_)

    def build(spec):
        if spec == _LEAF:
            return next(it)
        kind, meta, children = spec
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(meta, built))
        return built if kind == "list" else tuple(built)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` applied leaf-wise over trees of one structure."""
    ls, td = flatten(tree)
    others = []
    for r in rest:
        rl, rtd = flatten(r)
        if rtd != td:
            raise ValueError("tree structures differ")
        others.append(rl)
    return unflatten(td, [fn(*xs) for xs in zip(ls, *others)])
