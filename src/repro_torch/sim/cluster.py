"""Per-worker compute-time models with straggler distributions.

A :class:`ComputeModel` prices one local step (forward + backward + update)
for worker ``i`` at global step ``k``:

    t(i, k) = base_s * mult_i * (1 + tail(i, k))

* ``mult_i`` — static heterogeneity (mixed hardware generations); defaults
  to 1 for every worker.
* ``tail(i, k)`` — a per-step stochastic straggler term, drawn
  deterministically from :func:`~repro_torch.sim.network.sim_uniform`:

    - ``"none"``:    0
    - ``"exp"``:     ``scale * Exp(1)``      (occasional pauses: GC, page
                     faults — light tail)
    - ``"pareto"``:  ``scale * (Pareto(shape) - 1)`` (heavy tail: the
                     long-tail straggler scenario; shape <= 2 has
                     unbounded variance, the regime where synchronous
                     rounds collapse to the slowest worker)

``tail_workers`` restricts the stochastic term to a subset (e.g. one bad
host); the static multipliers always apply.  All draws are keyed by
(seed, worker, step), so a model is a frozen value object and two runs of
the same scenario agree event-for-event.

**Crash-restart churn.**  ``outage_p`` adds a per-(worker, step) chance
that a worker goes *offline* — crashed, preempted, or partitioned — for
``outage_rounds`` consecutive steps before rejoining.  Onsets are drawn
on their own stream (``STREAM_OUTAGE``) keyed by (seed, worker, step),
so :meth:`ComputeModel.offline` is a pure predicate: whether worker ``i``
is down at step ``k`` is answerable at any time, in any order, without
simulator state — the same replay contract as the straggler tails.  The
fault-injection layer (:mod:`repro_torch.sim.faults`) folds this predicate into
the round's presence mask; ``compute_seconds`` itself is unchanged (an
offline worker is *excluded*, not slowed).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.sim.network import STREAM_COMPUTE, STREAM_OUTAGE, sim_uniform

TAILS = ("none", "exp", "pareto")


@dataclasses.dataclass(frozen=True)
class ComputeModel:
    """Per-worker local-step time model."""
    base_s: float                           # homogeneous per-step seconds
    multipliers: Tuple[float, ...] = ()     # static per-worker factors
    tail: str = "none"                      # none | exp | pareto
    tail_scale: float = 0.0                 # strength of the random term
    tail_workers: Tuple[int, ...] = ()      # affected workers; () = all
    pareto_shape: float = 1.5               # heavy-tail exponent
    outage_p: float = 0.0                   # per-step crash-restart onset
    outage_rounds: int = 1                  # steps offline per onset
    outage_workers: Tuple[int, ...] = ()    # affected workers; () = all

    def __post_init__(self):
        if self.tail not in TAILS:
            raise ValueError(f"unknown tail {self.tail!r}; one of {TAILS}")
        if self.base_s <= 0:
            raise ValueError(f"base_s must be positive, got {self.base_s}")
        if not 0.0 <= self.outage_p < 1.0:
            raise ValueError(f"outage_p must be in [0, 1), "
                             f"got {self.outage_p}")
        if self.outage_rounds < 1:
            raise ValueError(f"outage_rounds must be >= 1, "
                             f"got {self.outage_rounds}")

    def multiplier(self, worker: int) -> float:
        """Static factor for ``worker``; workers past the tuple get 1.0,
        so a prefix like ``(4.0,)`` means "worker 0 is 4x slower"."""
        if worker < len(self.multipliers):
            return self.multipliers[worker]
        return 1.0

    def compute_seconds(self, worker: int, step: int, seed: int) -> float:
        t = self.base_s * self.multiplier(worker)
        if self.tail == "none" or self.tail_scale == 0.0:
            return t
        if self.tail_workers and worker not in self.tail_workers:
            return t
        u = sim_uniform(seed, STREAM_COMPUTE, worker, step)
        # clamp away u == 1 so the inverse-CDF transforms stay finite
        u = min(u, 1.0 - 1e-12)
        if self.tail == "exp":
            extra = -math.log1p(-u)
        else:  # pareto, mean-shifted to start at 0
            extra = (1.0 - u) ** (-1.0 / self.pareto_shape) - 1.0
        return t * (1.0 + self.tail_scale * extra)

    def expected_seconds(self, worker: int) -> float:
        """Mean per-step time ignoring the stochastic tail (planning aid)."""
        return self.base_s * self.multiplier(worker)

    def offline(self, worker: int, step: int, seed: int) -> bool:
        """Is ``worker`` down at ``step``?  Pure counter-hash predicate.

        An onset drawn at step ``j`` keeps the worker offline through
        steps ``j .. j + outage_rounds - 1``, so the check scans the
        trailing onset window — stateless, so replays and out-of-order
        queries agree (the sim determinism contract).
        """
        if self.outage_p <= 0.0:
            return False
        if self.outage_workers and worker not in self.outage_workers:
            return False
        lo = max(0, step - self.outage_rounds + 1)
        return any(
            sim_uniform(seed, STREAM_OUTAGE, worker, j) < self.outage_p
            for j in range(lo, step + 1))


def homogeneous(base_s: float) -> ComputeModel:
    return ComputeModel(base_s=base_s)


def one_straggler(base_s: float, worker: int = 0, slow: float = 4.0,
                  tail_scale: float = 2.0,
                  pareto_shape: float = 1.2) -> ComputeModel:
    """One chronically slow worker with a heavy-tailed per-step term."""
    return ComputeModel(base_s=base_s, tail="pareto", tail_scale=tail_scale,
                        tail_workers=(worker,), pareto_shape=pareto_shape,
                        multipliers=tuple(slow if i == worker else 1.0
                                          for i in range(worker + 1)))


def crash_restart(base_s: float, outage_p: float = 0.05,
                  outage_rounds: int = 3,
                  workers: Tuple[int, ...] = ()) -> ComputeModel:
    """Workers crash for ``outage_rounds`` steps then rejoin (churn).

    Each step each (affected) worker independently draws a crash onset
    with probability ``outage_p`` on the ``STREAM_OUTAGE`` counter-hash
    stream; expected unavailability per worker is roughly ``outage_p *
    outage_rounds``.  Compute cost while up is homogeneous ``base_s`` —
    churn and straggling are orthogonal axes, compose them with
    ``dataclasses.replace`` if a scenario needs both.
    """
    return ComputeModel(base_s=base_s, outage_p=outage_p,
                        outage_rounds=outage_rounds,
                        outage_workers=tuple(workers))
