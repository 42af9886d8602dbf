"""Per-edge link models: the alpha-beta cost ``T = alpha + bytes / beta``.

A :class:`LinkModel` prices one point-to-point transfer with the classic
alpha-beta (latency-bandwidth) model plus an optional jitter term:

    T(bytes) = alpha + bytes / beta + jitter * u,   u ~ U[0, 1)

``alpha`` is the per-message base latency in seconds, ``beta`` the link
bandwidth in *bytes per second* (so the formula reads literally), and the
jitter draw is deterministic — see :func:`sim_uniform` below.

A :class:`NetworkModel` maps edges of a circulant
:class:`~repro_torch.core.topology.Topology` to links, with three levels of
specificity (most specific wins):

1. ``per_edge``   — an explicit undirected worker pair ``(i, j)``;
2. ``per_offset`` — keyed by the *hop distance* ``min(o, n - o)`` of the
   topology offset connecting the pair (how the WAN scenarios make long
   exponential-graph hops slower than ring-neighbor hops);
3. ``default``    — everything else.

Determinism contract: nothing in ``repro_torch.sim`` owns mutable RNG state.
Every stochastic draw is :func:`sim_uniform` — a splitmix64 counter hash
of (seed, stream, counters...) — so the same (scenario, seed) always
produces the same event trace (``tests/test_torch_sim.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

_MASK64 = (1 << 64) - 1

# stream tags keeping independent draws independent (arbitrary constants)
STREAM_NET = 0x5E1
STREAM_COMPUTE = 0xC0
STREAM_EDGE_CHOICE = 0xED6
STREAM_GRAD = 0x64AD
STREAM_PAIR = 0xBA12
STREAM_DROP = 0xD20      # per-message loss draws (sim/faults.py)
STREAM_OUTAGE = 0x0FF    # crash-restart outage onsets (sim/cluster.py)


def _mix64(z: int) -> int:
    """splitmix64 finalizer: bijective avalanche on 64-bit ints."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
    return (z ^ (z >> 31)) & _MASK64


def sim_uniform(seed: int, *stream: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, stream counters).

    Pure-integer counter hash (no RNG state to thread), so any sim module
    can draw independent, reproducible randomness keyed by semantic
    counters like (worker, step) or (event index).
    """
    z = (int(seed) + 0x9E3779B97F4A7C15) & _MASK64
    for s in stream:
        z = _mix64((z + (int(s) << 1 | 1) * 0x9E3779B97F4A7C15) & _MASK64)
    return (_mix64(z) >> 11) * (1.0 / (1 << 53))


def sim_randint(seed: int, hi: int, *stream: int) -> int:
    """Deterministic integer in [0, hi) (hi >= 1) from the same hash."""
    return min(int(sim_uniform(seed, *stream) * hi), hi - 1)


def gbit(x: float) -> float:
    """x gigabit/s -> bytes/s (link specs quote bits, the model wants B/s)."""
    return x * 1e9 / 8.0


def mbit(x: float) -> float:
    return x * 1e6 / 8.0


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One point-to-point link under the alpha-beta cost model."""
    alpha_s: float              # base latency per message (s)
    beta_Bps: float             # bandwidth (bytes / s)
    jitter_s: float = 0.0       # max additional latency, uniform in [0, j)

    def __post_init__(self):
        if self.beta_Bps <= 0:
            raise ValueError(f"beta_Bps must be positive, got {self.beta_Bps}")

    def to_dict(self) -> dict:
        return {"alpha_s": self.alpha_s, "beta_Bps": self.beta_Bps,
                "jitter_s": self.jitter_s}

    @staticmethod
    def from_dict(d: Mapping) -> "LinkModel":
        return LinkModel(alpha_s=float(d["alpha_s"]),
                         beta_Bps=float(d["beta_Bps"]),
                         jitter_s=float(d.get("jitter_s", 0.0)))

    def transfer_seconds(self, nbytes: int, u: float = 0.0) -> float:
        """``alpha + bytes/beta`` plus the jitter draw ``jitter * u``."""
        return self.alpha_s + nbytes / self.beta_Bps + self.jitter_s * u

    def occupancy_seconds(self, nbytes: int) -> float:
        """Sender-side NIC occupancy: the bandwidth term alone.

        Back-to-back sends from one worker serialize on this term while
        their alpha (propagation) components overlap — how the sync round
        simulator schedules a worker's per-neighbor payloads.
        """
        return nbytes / self.beta_Bps


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Edge -> LinkModel map over an n-worker circulant topology."""
    default: LinkModel
    per_offset: Tuple[Tuple[int, LinkModel], ...] = ()
    per_edge: Tuple[Tuple[Tuple[int, int], LinkModel], ...] = ()

    @staticmethod
    def homogeneous(alpha_s: float, beta_Bps: float,
                    jitter_s: float = 0.0) -> "NetworkModel":
        return NetworkModel(LinkModel(alpha_s, beta_Bps, jitter_s))

    def with_offset_links(self, links: Mapping[int, LinkModel]
                          ) -> "NetworkModel":
        return dataclasses.replace(
            self, per_offset=tuple(sorted(links.items())))

    def link(self, src: int, dst: int, n: int) -> LinkModel:
        """Resolve the link for the (undirected) edge src—dst."""
        a, b = sorted((src % n, dst % n))
        for (i, j), lm in self.per_edge:
            if (min(i % n, j % n), max(i % n, j % n)) == (a, b):
                return lm
        hop = min((dst - src) % n, (src - dst) % n)
        for o, lm in self.per_offset:
            if o == hop:
                return lm
        return self.default

    def transfer_seconds(self, src: int, dst: int, n: int, nbytes: int,
                         u: float = 0.0) -> float:
        return self.link(src, dst, n).transfer_seconds(nbytes, u)

    def to_dict(self) -> dict:
        """JSON-friendly form (``sim/calibrate.py`` emits and loads these)."""
        return {
            "default": self.default.to_dict(),
            "per_offset": [[o, lm.to_dict()] for o, lm in self.per_offset],
            "per_edge": [[list(e), lm.to_dict()] for e, lm in self.per_edge],
        }

    @staticmethod
    def from_dict(d: Mapping) -> "NetworkModel":
        return NetworkModel(
            default=LinkModel.from_dict(d["default"]),
            per_offset=tuple((int(o), LinkModel.from_dict(lm))
                             for o, lm in d.get("per_offset", ())),
            per_edge=tuple(((int(e[0]), int(e[1])), LinkModel.from_dict(lm))
                           for e, lm in d.get("per_edge", ())))


# ---------------------------------------------------------------------------
# Reference hardware links, shared with the roofline analysis.
# ---------------------------------------------------------------------------

# TPU v5e inter-chip interconnect, per link.  analysis/roofline.py derives
# its collective term from this model (alpha ~ 0: the roofline charges pure
# bandwidth; per-message latency belongs to the event simulator).
TPU_V5E_ICI = LinkModel(alpha_s=0.0, beta_Bps=50e9)

# Datacenter ethernet ballparks used by the scenario catalog.
ETH_10G = LinkModel(alpha_s=50e-6, beta_Bps=gbit(10.0), jitter_s=10e-6)
ETH_1G = LinkModel(alpha_s=0.15e-3, beta_Bps=gbit(1.0), jitter_s=20e-6)
