"""Circulant gossip topologies (numpy only).

Own copy of ``repro.core.topology``'s flat circulant graphs: worker ``i``
averages from workers ``i + o (mod n)`` for a fixed offset set with weights
``w``.  A symmetric offset set gives a symmetric doubly-stochastic ``W``:

* ring            offsets {-1, 0, +1}
* torus (rows x cols)   offsets {0, ±1, ±cols} on the flattened grid
* exponential graph     offsets {0, ±1, ±2, ±4, ...}
* fully connected       all offsets, weight 1/n

Circulance is what lets gossip be a few ``torch.roll``s of the stacked
worker axis (``comm/gossip.py``).

Elastic rounds: ``Topology.with_presence(mask)`` renormalizes the mixing
weights over the workers that showed up (absent workers keep self-weight
1, W stays symmetric doubly stochastic), and ``TimeVaryingTopology`` holds
a per-round matrix schedule with a *joint* spectral gap over one window.
Both are numpy analysis objects: the engine applies the renormalization
edge-wise and never builds them.  Hierarchical topologies belong to a
later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

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

    @property
    def phi(self) -> float:
        """Smallest nonzero entry of W (Theorem 1's phi)."""
        W = self.matrix
        nz = W[W > 1e-12]
        return float(nz.min()) if nz.size else 0.0

    @property
    def t_mix_bound(self) -> float:
        """Supp. E: ``t_mix <= log(4n) / (1 - rho)`` for reversible chains."""
        gap = 1.0 - self.rho
        if gap <= 0:
            return float("inf")
        return float(np.log(4 * self.n) / gap)

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

    def with_presence(self, mask: Sequence[int]) -> "MaskedTopology":
        """Renormalize the round over the workers that showed up: an edge
        survives only if both endpoints are present, and the weight a
        worker loses folds back into its self-weight."""
        return MaskedTopology(base=self, presence=normalize_mask(mask,
                                                                 self.n))


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


def normalize_mask(mask: Sequence[int], n: int) -> Tuple[int, ...]:
    """Validate a presence mask: length ``n``, entries coerced to {0, 1}."""
    vals = tuple(int(bool(v)) for v in mask)
    if len(vals) != n:
        raise ValueError(f"presence mask has length {len(vals)}, want {n}")
    return vals


@dataclasses.dataclass(frozen=True)
class MaskedTopology:
    """A circulant topology restricted to the workers that showed up.

    ``W'[i, j] = W[i, j] * p_i * p_j`` off the diagonal, and each worker's
    lost edge mass folds back into its self-weight:

        W'[i, i] = W[i, i] + sum_{j != i} W[i, j] * (1 - p_i * p_j)

    W' is symmetric doubly stochastic for any mask, an absent worker's row
    is the identity row, and full presence gives ``base.matrix`` exactly.
    Not circulant, so it is the analysis object (theta schedules, rho);
    the engine applies the same renormalization edge-wise.
    """
    base: Topology
    presence: Tuple[int, ...]

    @property
    def name(self) -> str:
        up = sum(self.presence)
        return f"{self.base.name}-p{up}of{self.base.n}"

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def matrix(self) -> np.ndarray:
        W = self.base.matrix
        p = np.asarray(self.presence, dtype=np.float64)
        P = np.outer(p, p)
        M = W * P
        np.fill_diagonal(M, 0.0)
        # off-diagonal mass each row lost to dead edges -> self-weight
        lost = (W * (1.0 - P)).sum(axis=1) \
            - np.diag(W) * (1.0 - p * p)
        idx = np.arange(self.n)
        M[idx, idx] = np.diag(W) + lost
        return M

    @property
    def rho(self) -> float:
        ev = np.sort(np.abs(np.linalg.eigvalsh(self.matrix)))[::-1]
        return float(ev[1]) if self.n > 1 else 0.0

    @property
    def phi(self) -> float:
        W = self.matrix
        nz = W[W > 1e-12]
        return float(nz.min()) if nz.size else 0.0

    @property
    def t_mix_bound(self) -> float:
        gap = 1.0 - self.rho
        if gap <= 0:
            return float("inf")
        return float(np.log(4 * self.n) / gap)


@dataclasses.dataclass(frozen=True)
class TimeVaryingTopology:
    """A per-round schedule of mixing matrices with a *joint* spectral gap.

    Round ``k`` uses ``schedule[k % len(schedule)]`` (anything with a
    ``matrix``).  The contraction of one full window is

        rho = || W_{T-1} ... W_1 W_0 - J/n ||_2 ^ (1/T)

    the per-round geometric-average contraction factor, at most the
    geometric mean of the per-matrix rhos for doubly stochastic entries.
    """
    schedule: Tuple[object, ...]

    def __post_init__(self):
        if not self.schedule:
            raise ValueError("TimeVaryingTopology needs a non-empty schedule")
        ns = {t.n for t in self.schedule}
        if len(ns) != 1:
            raise ValueError(f"schedule mixes worker counts: {sorted(ns)}")

    def __len__(self) -> int:
        return len(self.schedule)

    def at(self, k: int):
        """The topology in effect at round ``k`` (periodic schedule)."""
        return self.schedule[k % len(self.schedule)]

    @property
    def name(self) -> str:
        return f"varying[{self.schedule[0].name}..x{len(self.schedule)}]"

    @property
    def n(self) -> int:
        return self.schedule[0].n

    @property
    def window_matrix(self) -> np.ndarray:
        """Product of one schedule window, ``W_{T-1} ... W_0`` (later
        rounds multiply from the left)."""
        P = self.schedule[0].matrix
        for t in self.schedule[1:]:
            P = t.matrix @ P
        return P

    @property
    def rho(self) -> float:
        """Joint spectral gap: per-round contraction of one window."""
        if self.n == 1:
            return 0.0
        J = np.full((self.n, self.n), 1.0 / self.n)
        sig = np.linalg.norm(self.window_matrix - J, ord=2)
        return float(sig ** (1.0 / len(self.schedule)))

    @property
    def phi(self) -> float:
        """Most pessimistic smallest nonzero entry across the window."""
        return min(t.phi for t in self.schedule)

    @property
    def t_mix_bound(self) -> float:
        gap = 1.0 - self.rho
        if gap <= 0:
            return float("inf")
        return float(np.log(4 * self.n) / gap)

    def slack(self, gamma: float) -> "TimeVaryingTopology":
        """Slack every round of the window (Theorem 3 entrywise)."""
        return TimeVaryingTopology(
            tuple(t.slack(gamma) for t in self.schedule))


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
