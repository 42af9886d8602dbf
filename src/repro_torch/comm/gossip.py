"""Circulant gossip over a stacked worker axis.

All decentralized state is a pytree whose leaves carry a leading worker dim
``[n, ...]``.  ``_roll(leaf, o)`` brings worker ``i + o``'s value to row
``i``: in one process ``torch.roll(leaf, -o, 0)``, as ``jnp.roll`` is in
the reference's CPU runs; with the worker dim split over ranks (a mesh
context, ``comm/workers.py``) the rows a rank needs from its peers, sent
point to point, the collective-permute of the reference's mesh.  Weighted
circulant mixing is

    (X W)[i] = sum_o  w_o * X[(i + o) mod n]  = sum_o w_o * roll(X, -o)[i]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.comm import workers
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
    """Row ``i`` of the result is row ``(i + offset) mod n`` of the global
    stacked leaf (under a worker split, ``leaf`` is this rank's block)."""
    return workers.roll(leaf, offset)


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


def moniqua_gossip(X: PyTree, topo: Topology, codec, theta,
                   uniforms: Optional[PyTree] = None,
                   ledger: Optional[BytesLedger] = None, *,
                   seeds: Optional[Sequence[int]] = None,
                   generator: Optional[torch.Generator] = None) -> PyTree:
    """Algorithm 1 lines 3-6 with the functional ``MoniquaCodec``: one
    Moniqua gossip round on stacked models, leaf by leaf; returns
    ``X_{k+1/2}``.

    Every worker broadcasts one payload (its packed residue).  Stochastic
    rounding draws per leaf, shared by all workers: ``uniforms`` (a tree
    shaped like ``X``) for the plain codec, ``seeds`` (one hash seed a leaf)
    for ``codec.use_kernels``, or else draws from ``generator``.  (The
    reference splits one key per leaf.)  ``ledger`` is credited with each
    leaf's payload bytes times the neighbor count.
    """
    n_neighbors = len(topo.neighbor_offsets())
    if n_neighbors == 0:          # single worker
        return X
    leaves, td = tree.flatten(X)
    us = (tree.leaves(uniforms) if uniforms is not None
          else [None] * len(leaves))
    ss = list(seeds) if seeds is not None else [None] * len(leaves)

    def gossip_leaf(x, u, seed):
        packed = codec.encode(x, theta, u, seed=seed, generator=generator)
        x_hat_self = codec.decode_self(packed, x, theta)    # line 4
        acc = None
        for o, w in zip(topo.offsets, topo.weights):
            if o % topo.n == 0:
                continue
            remote = _roll(packed, o)                       # the collective
            x_hat_j = codec.decode(remote, x, theta)        # line 5
            d = (x_hat_j - x_hat_self) * w
            acc = d if acc is None else acc + d
        if ledger is not None:
            ledger.add(codec.payload_bytes(tuple(x.shape[1:])), n_neighbors)
        return (x.float() + acc).to(x.dtype)                # line 6

    return tree.unflatten(td, [gossip_leaf(l, u, sd)
                               for l, u, sd in zip(leaves, us, ss)])


def payload_bytes_tree(X: PyTree, codec) -> int:
    """Total packed bytes for one broadcast of every leaf (per worker)."""
    return sum(codec.payload_bytes(tuple(leaf.shape[1:]))
               for leaf in tree.leaves(X))


def dtype_bytes_tree(X: PyTree) -> int:
    """Full-precision bytes per broadcast (per worker): the D-PSGD
    baseline."""
    return sum(int(np.prod(tuple(leaf.shape[1:]), dtype=np.int64))
               * leaf.element_size() for leaf in tree.leaves(X))
