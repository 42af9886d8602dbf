"""Circulant gossip topologies (numpy only).

Own copy of ``repro.core.topology``'s flat circulant graphs: worker ``i``
averages from workers ``i + o (mod n)`` for a fixed offset set with weights
``w``.  A symmetric offset set gives a symmetric doubly-stochastic ``W``:

* ring            offsets {-1, 0, +1}
* torus (rows x cols)   offsets {0, ±1, ±cols} on the flattened grid
* exponential graph     offsets {0, ±1, ±2, ±4, ...}
* fully connected       all offsets, weight 1/n

Circulance is what lets gossip be a few ``torch.roll``s of the stacked
worker axis (``comm/gossip.py``).  Masked, time-varying and hierarchical
topologies belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """A circulant gossip topology over ``n`` workers."""
    name: str
    n: int
    offsets: Tuple[int, ...]   # includes 0 (self)
    weights: Tuple[float, ...]

    def __post_init__(self):
        if len(self.offsets) != len(self.weights):
            raise ValueError("offsets/weights length mismatch")
        if abs(sum(self.weights) - 1.0) > 1e-9:
            raise ValueError(f"weights must sum to 1, got {sum(self.weights)}")
        woff: Dict[int, float] = {}
        for o, w in zip(self.offsets, self.weights):
            woff[o % self.n] = woff.get(o % self.n, 0.0) + w
        for o, w in list(woff.items()):
            if abs(woff.get((-o) % self.n, 0.0) - w) > 1e-9:
                raise ValueError("offset set must be symmetric for symmetric W")

    @property
    def matrix(self) -> np.ndarray:
        """Dense ``W`` with ``W[j, i]`` = weight worker *i* puts on worker *j*."""
        W = np.zeros((self.n, self.n))
        for o, w in zip(self.offsets, self.weights):
            for i in range(self.n):
                W[(i + o) % self.n, i] += w
        return W

    @property
    def rho(self) -> float:
        """Spectral gap parameter: second-largest absolute eigenvalue (A2)."""
        ev = np.sort(np.abs(np.linalg.eigvalsh(self.matrix)))[::-1]
        return float(ev[1]) if self.n > 1 else 0.0

    def neighbor_offsets(self) -> Tuple[int, ...]:
        return tuple(o for o in self.offsets if o % self.n != 0)

    def slack(self, gamma: float) -> "Topology":
        """``W_bar = gamma W + (1 - gamma) I`` (Theorem 3 consensus step)."""
        woff: Dict[int, float] = {}
        for o, w in zip(self.offsets, self.weights):
            woff[o % self.n] = woff.get(o % self.n, 0.0) + gamma * w
        woff[0] = woff.get(0, 0.0) + (1.0 - gamma)
        offs = tuple(sorted(woff))
        return Topology(f"{self.name}-slack{gamma:g}", self.n, offs,
                        tuple(woff[o] for o in offs))


def ring(n: int, self_weight: float | None = None) -> Topology:
    """Bidirectional ring. Default uniform 1/3 weights (paper's experiments)."""
    if n == 1:
        return Topology("ring", 1, (0,), (1.0,))
    if n == 2:
        sw = 0.5 if self_weight is None else self_weight
        return Topology("ring", 2, (0, 1), (sw, 1.0 - sw))
    sw = 1.0 / 3.0 if self_weight is None else self_weight
    nw = (1.0 - sw) / 2.0
    return Topology("ring", n, (-1, 0, 1), (nw, sw, nw))


def torus(rows: int, cols: int) -> Topology:
    """2-D torus on ``rows*cols`` workers flattened row-major; 1/5 weights."""
    n = rows * cols
    if rows < 3 or cols < 3:
        raise ValueError("torus needs rows, cols >= 3 for distinct offsets")
    offs = (-cols, -1, 0, 1, cols)
    w = 1.0 / len(offs)
    return Topology("torus", n, offs, tuple([w] * len(offs)))


def exponential(n: int) -> Topology:
    """Exponential graph: hops ±2^j up to n // 2, deduplicated mod n."""
    seen = {0}
    offsets = [0]
    h = 1
    while h <= n // 2:
        for o in (h, -h):
            if o % n not in seen:
                seen.add(o % n)
                offsets.append(o)
        h *= 2
    w = 1.0 / len(offsets)
    return Topology("exponential", n, tuple(offsets), tuple([w] * len(offsets)))


def fully_connected(n: int) -> Topology:
    offs = tuple(range(n))
    return Topology("complete", n, offs, tuple([1.0 / n] * n))


def get_topology(name: str, n: int, **kw) -> Topology:
    if name == "ring":
        return ring(n, **kw)
    if name == "exponential":
        return exponential(n)
    if name == "complete":
        return fully_connected(n)
    if name == "torus":
        side = int(round(np.sqrt(n)))
        if side * side != n:
            raise ValueError(f"torus needs square n, got {n}")
        return torus(side, side)
    raise ValueError(f"unknown topology {name!r}")
