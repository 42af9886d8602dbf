"""Circulant gossip over a stacked worker axis.

All decentralized state is a pytree whose leaves carry a leading worker dim
``[n, ...]``.  ``torch.roll(leaf, -o, 0)`` brings worker ``i + o``'s value to
row ``i``; on one card it stands for the collective-permute of a mesh, as
``jnp.roll`` does in the reference's CPU runs.  Weighted circulant mixing is

    (X W)[i] = sum_o  w_o * X[(i + o) mod n]  = sum_o w_o * roll(X, -o)[i]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.core.topology import Topology

PyTree = Any


@dataclasses.dataclass
class BytesLedger:
    """Bytes sent per worker per gossip round (payload only, excl. headers).

    ``bytes_slow`` is the gossip-link traffic (the only tier a single-tier
    round has), ``bytes_fast`` the intra-node traffic of tiered rounds;
    ``bytes_per_worker`` is the total.
    """
    bytes_per_worker: int = 0
    bytes_fast: int = 0
    bytes_slow: int = 0

    def add(self, nbytes: int, n_sends: int, tier: str = "slow") -> None:
        if tier not in ("fast", "slow"):
            raise ValueError(f"unknown tier {tier!r}")
        total = nbytes * n_sends
        self.bytes_per_worker += total
        if tier == "fast":
            self.bytes_fast += total
        else:
            self.bytes_slow += total


def as_weight(w: float, dtype: torch.dtype) -> float:
    """``w`` rounded to ``dtype``, as JAX rounds a weakly typed Python float
    that multiplies an array of that dtype."""
    return torch.tensor(w, dtype=dtype).item()


def _roll(leaf: torch.Tensor, offset: int) -> torch.Tensor:
    return torch.roll(leaf, -offset, 0) if offset % leaf.shape[0] else leaf


def mix(X: PyTree, topo: Topology) -> PyTree:
    """Full-precision circulant mixing ``X W`` (D-PSGD line 'communicate'):
    ``sum_o roll(x, o) * w_o`` over the offsets in order, self included."""
    def mix_leaf(x):
        out = None
        for o, w in zip(topo.offsets, topo.weights):
            t = _roll(x, o) * as_weight(w, x.dtype)
            out = t if out is None else out + t
        return out.to(x.dtype)
    return tree.map(mix_leaf, X)


def neighbor_sum(X: PyTree, topo: Topology,
                 transform: Callable[[torch.Tensor, int], torch.Tensor]
                 ) -> PyTree:
    """``sum_{o != 0} w_o * transform(roll(X, -o), o)`` leaf-wise."""
    def f(x):
        out = None
        for o, w in zip(topo.offsets, topo.weights):
            if o % topo.n == 0:
                continue
            t = transform(_roll(x, o), o) * as_weight(w, x.dtype)
            out = t if out is None else out + t
        return out
    return tree.map(f, X)


def self_weight(topo: Topology) -> float:
    return sum(w for o, w in zip(topo.offsets, topo.weights) if o % topo.n == 0)
