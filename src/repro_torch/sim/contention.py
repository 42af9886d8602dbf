"""Shared-resource contention: NICs and switches as capacity-limited links.

An isolated-link simulator prices every transfer on its own alpha-beta link,
which overstates full-precision baselines on switched fabrics: concurrent
gossip pairs there share uplink bandwidth, so the fp32 payloads that
saturate the fabric slow each other down — exactly the regime Moniqua's
byte savings were motivated by.  This module adds the missing layer:

* a :class:`Fabric` describes the shared resources a transfer traverses —
  the sender's NIC ``tx`` queue, the receiver's NIC ``rx`` queue, and any
  number of :class:`Switch` resources (oversubscribed ToR uplinks, a
  half-duplex shared medium) between them;
* :func:`solve_rates` splits each resource's capacity over the flows
  crossing it, with either of two sharing disciplines:

  - ``"max-concurrency"`` — a flow's rate is the *most contended* resource
    on its path divided evenly: ``min_r capacity(r) / n_flows(r)``.  Cheap,
    pessimistic (not work-conserving);
  - ``"water-filling"``  — exact progressive-filling max-min fairness: all
    unfrozen flows rise together, a resource that saturates freezes its
    flows, capacity left by frozen flows is redistributed.  Saturated
    resources are used to *exactly* their capacity, and the allocation is
    independent of flow order (``tests/test_torch_sim.py``);

* a :class:`FlowScheduler` runs the fluid model through time: flows drain
  at the solved rates, and every flow arrival/departure re-solves the
  rates (bumping ``epoch`` so stale completion predictions can be
  recognized and discarded — how ``sim/events.py`` interleaves contended
  transfers with compute events without a global barrier);
* :func:`schedule_transfers` is the batch entry point the sync-round mode
  uses: given ``(start, src, dst, nbytes)`` flow specs it returns each
  flow's completion time under the fluid model.

Everything is pure float arithmetic, deterministic, RNG-free (jitter stays
in the event layer, drawn from ``sim_uniform``).  A :class:`Fabric` with no
switches and ``nic_Bps == beta`` reproduces the isolated-link round times
on a symmetric gossip round — contention can only *add* time, a contract
``tests/test_torch_sim.py`` enforces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

MAX_CONCURRENCY = "max-concurrency"
WATER_FILLING = "water-filling"
SHARING_MODES = (MAX_CONCURRENCY, WATER_FILLING)

# relative slack for "this resource is saturated" in the filling loop
_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Switch:
    """One shared switching resource between groups of workers.

    ``members`` lists the workers behind the switch.  A flow traverses the
    switch when it *crosses* the membership boundary — leaving the group
    uses the full-duplex ``up`` direction, entering uses ``down``.  An
    empty ``members`` tuple means a half-duplex shared medium (an old-
    school bus / one radio channel): *every* flow, both directions,
    contends for the single ``shared`` resource.
    """
    name: str
    capacity_Bps: float
    members: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.capacity_Bps <= 0:
            raise ValueError(
                f"capacity_Bps must be positive, got {self.capacity_Bps}")

    def resources(self, src: int, dst: int, n: int) -> Tuple[str, ...]:
        """Resource ids this flow occupies on the switch ('' = none)."""
        if not self.members:
            return (f"sw:{self.name}:shared",)
        mem = {m % n for m in self.members}
        s, d = src % n in mem, dst % n in mem
        if s and not d:
            return (f"sw:{self.name}:up",)
        if d and not s:
            return (f"sw:{self.name}:down",)
        return ()

    def capacity(self, resource: str) -> float:
        return self.capacity_Bps


@dataclasses.dataclass(frozen=True)
class Fabric:
    """The shared-resource view of a cluster network.

    Per-worker NICs (``tx:i`` / ``rx:i``, full-duplex, ``nic_Bps`` each
    way) plus the shared :class:`Switch` resources.  ``alpha_s`` and
    ``jitter_s`` price the per-message latency exactly like
    :class:`~repro_torch.sim.network.LinkModel` — they are added by the event
    layer on top of the fluid completion time, never fed to the solver.
    """
    nic_Bps: float
    switches: Tuple[Switch, ...] = ()
    alpha_s: float = 0.0
    jitter_s: float = 0.0
    mode: str = WATER_FILLING

    def __post_init__(self):
        if self.nic_Bps <= 0:
            raise ValueError(f"nic_Bps must be positive, got {self.nic_Bps}")
        if self.mode not in SHARING_MODES:
            raise ValueError(f"unknown sharing mode {self.mode!r}; "
                             f"one of {SHARING_MODES}")

    def path(self, src: int, dst: int, n: int) -> Tuple[str, ...]:
        """Ordered resource ids a src -> dst transfer occupies."""
        mid: List[str] = []
        for sw in self.switches:
            mid.extend(sw.resources(src, dst, n))
        return (f"tx:{src % n}", *mid, f"rx:{dst % n}")

    def capacity(self, resource: str) -> float:
        if resource.startswith(("tx:", "rx:")):
            return self.nic_Bps
        for sw in self.switches:
            if resource.startswith(f"sw:{sw.name}:"):
                return sw.capacity_Bps
        raise KeyError(f"unknown resource {resource!r}")


def solve_rates(paths: Mapping[int, Tuple[str, ...]],
                capacity, mode: str = WATER_FILLING) -> Dict[int, float]:
    """Per-flow rates (bytes/s) for concurrent flows over shared resources.

    ``paths`` maps flow id -> the resource ids it occupies; ``capacity``
    is a callable ``resource_id -> bytes/s``.  Both disciplines give every
    flow a strictly positive rate, so the fluid model always makes
    progress.
    """
    if mode not in SHARING_MODES:
        raise ValueError(f"unknown sharing mode {mode!r}")
    if not paths:
        return {}
    load: Dict[str, int] = {}
    for p in paths.values():
        for r in p:
            load[r] = load.get(r, 0) + 1
    cap = {r: float(capacity(r)) for r in load}
    if mode == MAX_CONCURRENCY:
        return {f: min(cap[r] / load[r] for r in p)
                for f, p in paths.items()}
    # progressive filling: all unfrozen flows rise together; a resource
    # saturates when its residual is exhausted, freezing its flows there
    rates = {f: 0.0 for f in paths}
    residual = dict(cap)
    unfrozen = set(paths)
    while unfrozen:
        counts: Dict[str, int] = {}
        for f in unfrozen:
            for r in paths[f]:
                counts[r] = counts.get(r, 0) + 1
        inc = min(residual[r] / c for r, c in counts.items())
        for f in unfrozen:
            rates[f] += inc
        for r, c in counts.items():
            residual[r] -= inc * c
        newly = {f for f in unfrozen
                 if any(residual[r] <= _EPS * cap[r] for r in paths[f])}
        if not newly:       # numeric guard; cannot happen with exact floats
            break
        unfrozen -= newly
    return rates


@dataclasses.dataclass
class _Flow:
    path: Tuple[str, ...]
    remaining: float


class FlowScheduler:
    """Fluid-model clock for flows sharing a :class:`Fabric`.

    The scheduler owns (time, active flows, solved rates).  Callers
    :meth:`start` and :meth:`finish` flows at monotonically non-decreasing
    times; between calls, active flows drain at the current rates.  Every
    state change bumps :attr:`epoch`, so a caller that cached projected
    completion times (:meth:`eta`) can detect they went stale — the
    mechanism the async event loop uses to interleave contended transfers
    with compute events.
    """

    def __init__(self, fabric: Fabric, n: int):
        self.fabric = fabric
        self.n = n
        self.t = 0.0
        self.epoch = 0
        self._flows: Dict[int, _Flow] = {}
        self._rates: Dict[int, float] = {}

    @property
    def active(self) -> Tuple[int, ...]:
        return tuple(sorted(self._flows))

    def _advance(self, t: float) -> None:
        if t < self.t - 1e-12:
            raise ValueError(f"time moved backwards: {t} < {self.t}")
        dt = max(t - self.t, 0.0)
        if dt:
            for fid, fl in self._flows.items():
                fl.remaining = max(
                    fl.remaining - self._rates.get(fid, 0.0) * dt, 0.0)
        self.t = t

    def _resolve(self) -> None:
        self._rates = solve_rates(
            {fid: fl.path for fid, fl in self._flows.items()},
            self.fabric.capacity, self.fabric.mode)
        self.epoch += 1

    def start(self, t: float, fid: int, src: int, dst: int,
              nbytes: float) -> None:
        if fid in self._flows:
            raise ValueError(f"flow {fid} already active")
        self._advance(t)
        self._flows[fid] = _Flow(self.fabric.path(src, dst, self.n),
                                 float(nbytes))
        self._resolve()

    def finish(self, t: float, fid: int) -> None:
        """Remove ``fid`` at ``t`` (its bytes must have drained by then)."""
        self._advance(t)
        del self._flows[fid]
        self._resolve()

    def eta(self, fid: int) -> float:
        """Projected completion of ``fid`` under the *current* rates."""
        fl = self._flows[fid]
        if fl.remaining <= 0.0:
            return self.t
        return self.t + fl.remaining / self._rates[fid]


def schedule_transfers(fabric: Fabric, n: int,
                       flows: Sequence[Tuple[float, int, int, float]]
                       ) -> List[float]:
    """Fluid completion time of each ``(start, src, dst, nbytes)`` flow.

    The batch entry point for the sync-round mode: all of a round's
    transfers go in, each one's completion under shared-resource sharing
    comes out (same order).  Latency/jitter are *not* included — the event
    layer adds them, keeping one source of truth for stochastic draws.
    """
    sched = FlowScheduler(fabric, n)
    order = sorted(range(len(flows)), key=lambda i: (flows[i][0], i))
    finish = [0.0] * len(flows)
    active: List[int] = []
    qi = 0
    while qi < len(order) or active:
        t_start = flows[order[qi]][0] if qi < len(order) else float("inf")
        if active:
            t_fin, fid = min((sched.eta(f), f) for f in active)
        else:
            t_fin, fid = float("inf"), -1
        if t_start <= t_fin:
            i = order[qi]
            qi += 1
            _, src, dst, nbytes = flows[i]
            sched.start(t_start, i, src, dst, nbytes)
            active.append(i)
        else:
            sched.finish(t_fin, fid)
            active.remove(fid)
            finish[fid] = t_fin
    return finish


# ---------------------------------------------------------------------------
# Fabric factories for the scenario catalog.
# ---------------------------------------------------------------------------

def tor_groups(n: int, num_groups: int = 2,
               interleave: bool = True) -> Tuple[Tuple[int, ...], ...]:
    """Partition workers into ToR groups.

    ``interleave=True`` assigns round-robin (worker i -> group i % g), the
    adversarial placement for a ring: every neighbor edge crosses a rack
    boundary.  ``False`` gives contiguous blocks (only the seam edges
    cross).
    """
    if not 1 <= num_groups <= n:
        raise ValueError(f"need 1 <= num_groups <= {n}, got {num_groups}")
    if interleave:
        return tuple(tuple(i for i in range(n) if i % num_groups == g)
                     for g in range(num_groups))
    size = (n + num_groups - 1) // num_groups
    return tuple(tuple(range(g * size, min((g + 1) * size, n)))
                 for g in range(num_groups))


def oversubscribed_fabric(n: int, nic_Bps: float, uplink_Bps: float,
                          num_groups: int = 2, interleave: bool = True,
                          alpha_s: float = 0.0, jitter_s: float = 0.0,
                          mode: str = WATER_FILLING) -> Fabric:
    """ToR fabric: each group's cross-rack traffic shares one uplink."""
    switches = tuple(
        Switch(name=f"tor{g}", capacity_Bps=uplink_Bps, members=members)
        for g, members in enumerate(tor_groups(n, num_groups, interleave)))
    return Fabric(nic_Bps=nic_Bps, switches=switches, alpha_s=alpha_s,
                  jitter_s=jitter_s, mode=mode)


def shared_medium_fabric(nic_Bps: float, bus_Bps: float,
                         alpha_s: float = 0.0, jitter_s: float = 0.0,
                         mode: str = WATER_FILLING) -> Fabric:
    """All workers on one half-duplex shared medium of ``bus_Bps``."""
    return Fabric(nic_Bps=nic_Bps,
                  switches=(Switch("bus", bus_Bps),),
                  alpha_s=alpha_s, jitter_s=jitter_s, mode=mode)


def isolated_fabric(nic_Bps: float, alpha_s: float = 0.0,
                    jitter_s: float = 0.0,
                    mode: str = WATER_FILLING) -> Fabric:
    """No shared switches: NIC-limited only (the uncontended twin)."""
    return Fabric(nic_Bps=nic_Bps, alpha_s=alpha_s, jitter_s=jitter_s,
                  mode=mode)
