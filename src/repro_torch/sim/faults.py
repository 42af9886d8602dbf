"""Fault injection for the event simulator: churn, loss, deadlines.

A :class:`FaultSpec` is a frozen catalog of everything that can go wrong
in a gossip round, attached to a :class:`~repro_torch.sim.scenarios.Scenario`
(``scenario.faults``) or passed per-call to the event engines:

``outages``
    Scheduled churn: explicit :class:`Outage` windows (worker ``w`` is
    offline for rounds ``[start, start + rounds)``).  Stochastic
    crash-restart churn lives in the *compute model*
    (:meth:`~repro_torch.sim.cluster.ComputeModel.offline`, the ``crash_restart``
    factory); :func:`presence_of` folds both sources into one mask.
``drop_p``
    Per-directed-message loss probability.  Each (round, src, dst) draws
    on the ``STREAM_DROP`` counter-hash stream, so a replay loses exactly
    the same messages — the sim determinism contract extends to faults.
``deadline_s``
    Deadline-based rounds: the barrier releases at ``t_start +
    deadline_s`` instead of waiting for stragglers.  A worker whose own
    compute overruns the deadline is dropped from the round (its model
    takes the identity mix — self-weight 1); a payload that arrives late
    kills just that edge.  Either way the mixing matrix is renormalized
    over who actually made it — :meth:`Topology.with_presence
    <repro_torch.core.topology.Topology.with_presence>` semantics, executed by
    ``CommEngine.mix(presence=...)``.

The *presence mask* a fault-injected round hands to the engine is the
**participation** mask: present workers whose compute met the deadline.
Per-edge losses (sampled drops, late arrivals) are finer-grained than the
engine's worker-level mask; they shape the wall clock and the event trace
(``MSGDROP`` / ``LATE`` events) but leave worker-level participation
intact.  The async loop is wait-free, so only ``drop_p`` applies there —
a dropped pair exchange replays through ``CommEngine.pair_average(...,
presence=(1, 0))``, the identity exchange (``sim.events.replay_adpsgd``).

Everything here is a pure function of (spec, seed, semantic counters):
no simulator state, no RNG objects — :meth:`SimTrace.fingerprint
<repro_torch.sim.events.SimTrace.fingerprint>` stays stable across reruns.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.sim.network import STREAM_DROP, sim_uniform


@dataclasses.dataclass(frozen=True)
class Outage:
    """Scheduled offline window: ``worker`` down for ``rounds`` rounds."""
    worker: int
    start: int
    rounds: int = 1

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")

    def covers(self, worker: int, step: int) -> bool:
        return (worker == self.worker
                and self.start <= step < self.start + self.rounds)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What can go wrong in a round (see module docstring)."""
    deadline_s: Optional[float] = None
    drop_p: float = 0.0
    outages: Tuple[Outage, ...] = ()

    def __post_init__(self):
        if not 0.0 <= self.drop_p < 1.0:
            raise ValueError(f"drop_p must be in [0, 1), got {self.drop_p}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}")

    def offline(self, worker: int, step: int, compute, seed: int) -> bool:
        """Down at ``step``: a scheduled window covers it, or the compute
        model's stochastic crash-restart predicate fires."""
        if any(o.covers(worker, step) for o in self.outages):
            return True
        return compute.offline(worker, step, seed)

    def message_dropped(self, step: int, src: int, dst: int,
                        seed: int) -> bool:
        """Deterministic per-directed-message loss draw (STREAM_DROP)."""
        if self.drop_p <= 0.0:
            return False
        return sim_uniform(seed, STREAM_DROP, step, src, dst) < self.drop_p


def presence_of(faults: Optional[FaultSpec], compute, n: int, step: int,
                seed: int) -> Optional[Tuple[int, ...]]:
    """Round ``step``'s presence mask, or ``None`` when everyone is up.

    ``None`` covers both "no faults configured" and "faults configured
    but nobody down this round" — callers branch to the exact unfaulted
    code path on ``None``, which is what keeps no-fault simulations
    event-identical to the pre-elastic engine.
    """
    if faults is not None:
        mask = tuple(
            0 if faults.offline(i, step, compute, seed) else 1
            for i in range(n))
    elif getattr(compute, "outage_p", 0.0) > 0.0:
        # crash-restart compute model used without a FaultSpec: churn
        # still applies (the model owns the stochastic outage draws)
        mask = tuple(0 if compute.offline(i, step, seed) else 1
                     for i in range(n))
    else:
        return None
    return None if all(mask) else mask
