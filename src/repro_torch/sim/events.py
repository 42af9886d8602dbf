"""Deterministic event-driven engine: bytes ledger -> wall clock.

Two execution modes, matching the repo's two communication regimes:

**Synchronous rounds** (D-PSGD / D2 / Moniqua — everything that calls
``CommEngine.mix``).  One round per worker ``i`` at step ``k``:

    ready(i) = max( compute(i),
                    max_{j in in-nbrs(i)}  depart(j -> i) + alpha + jitter )
    round_k  = max_i ready(i)                       (bulk-synchronous barrier)

where ``depart(j -> i)`` is when the payload for ``i`` clears ``j``'s NIC:
a sender's per-neighbor payloads serialize on the bandwidth term
(``LinkModel.occupancy_seconds``) while their latencies overlap — so on a
homogeneous ring the round time reduces to the familiar

    round = compute + m * bytes/beta + alpha

i.e. round time = max over workers of compute + slowest-neighbor transfer.
The payload size comes straight from the ``CommEngine`` bytes ledger
(``bytes_per_round / num_neighbors``), which is what makes the simulator's
wall clock composable with any codec the engine can put on the wire.

**Contended fabrics.**  A scenario may carry a
:class:`~repro_torch.sim.contention.Fabric` — shared NIC/switch resources with a
bandwidth-sharing discipline.  Both modes then stop pricing transfers
independently: the sync round hands ALL its concurrent transfers to the
fluid solver (:func:`~repro_torch.sim.contention.schedule_transfers`), and the
async loop drives a live :class:`~repro_torch.sim.contention.FlowScheduler`,
re-solving rates whenever a flow starts or finishes (stale completion
predictions are detected by the scheduler epoch and discarded).  With no
fabric the isolated-link pricing is bit-for-bit unchanged.

**Asynchronous AD-PSGD** (Algorithm 3 / the analysis model of
``core/adpsgd.py``).  Workers free-run: compute a gradient on a snapshot of
their model, gossip with one deterministic-randomly chosen neighbor (the
transfer priced by the link model), apply the now-stale gradient, repeat.
The passive peer is never blocked (AD-PSGD's wait-free design), so the
loop cannot deadlock however extreme the stragglers; staleness — how many
times a worker's model changed between gradient snapshot and gradient
application — is tracked per update.  :func:`replay_adpsgd` runs the same
event loop while *applying the actual mixing math* through
``CommEngine.pair_average`` edge by edge, so predicted wall clock and
realized convergence come from one run.

**Fault injection** (:mod:`repro_torch.sim.faults`).  A scenario may carry a
``FaultSpec`` (or one is passed per call): worker churn removes workers
from rounds (``OFFLINE`` events, presence renormalized), per-message loss
kills individual payloads (``MSGDROP``), and a round deadline stops the
barrier from waiting for stragglers — a worker whose compute overruns it
is dropped (``DROPPED``), a payload arriving past it is dead (``LATE``),
and the barrier releases at ``t_start + deadline_s`` whenever anything
was late, else at the last *participant*'s ready time.  Per-round
participation masks land in :attr:`SimTrace.presence` /
:attr:`SimTrace.participation` — exactly the mask
``CommEngine.mix(presence=...)`` renormalizes over.  With no faults the
code path, events and fingerprint are bit-identical to the pre-elastic
engine; fault draws live on their own hash streams, so adding faults
never perturbs jitter or straggler draws either.

Determinism: every stochastic choice (jitter, straggler tails, edge
choice, outage onsets, message loss) is a counter hash of
(scenario.seed, semantic counters) — replays are event-for-event
identical, which :meth:`SimTrace.fingerprint` makes cheap to assert.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.sim.faults import presence_of
from repro_torch.sim.network import (STREAM_EDGE_CHOICE, STREAM_NET, sim_randint,
                               sim_uniform)

# event kinds, in the order they appear inside one sync round
COMPUTE = "compute"      # worker finished local grad/update work
TRANSFER = "transfer"    # payload worker -> peer fully arrived
ROUND = "round"          # barrier: every worker finished the round
GOSSIP = "gossip"        # async: pair exchange (worker, peer) completed
UPDATE = "update"        # async: worker applied its (stale) gradient
FLOW = "_flow"           # heap-internal: contended-flow completion candidate
                         # (never appears in the trace; see fabric handling)
# elastic-round kinds (fault injection; all enter the fingerprint)
OFFLINE = "offline"      # worker absent this round (churn)
DROPPED = "dropped"      # present worker overran the round deadline
MSGDROP = "msgdrop"      # payload lost on the wire (drop_p draw)
LATE = "late"            # payload arrived after the round deadline


@dataclasses.dataclass(frozen=True)
class SimEvent:
    """One timestamped event; the trace is the ordered tuple of these."""
    t: float
    kind: str
    worker: int
    peer: int = -1
    step: int = -1
    nbytes: int = 0

    def row(self) -> Tuple[float, str, int, int, int, int]:
        return (round(self.t, 12), self.kind, self.worker, self.peer,
                self.step, self.nbytes)


@dataclasses.dataclass
class SimTrace:
    """Result of one simulation: the event list plus aggregate predictions."""
    events: List[SimEvent]
    total_seconds: float
    bytes_on_wire: int
    round_seconds: List[float] = dataclasses.field(default_factory=list)
    staleness: List[int] = dataclasses.field(default_factory=list)
    # elastic rounds only (empty on unfaulted runs): per-round fraction of
    # workers that made the round, and the exact participation masks —
    # what ``CommEngine.mix(presence=...)`` renormalizes over on replay
    participation: List[float] = dataclasses.field(default_factory=list)
    presence: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)

    @property
    def mean_round_seconds(self) -> float:
        if not self.round_seconds:
            return 0.0
        return sum(self.round_seconds) / len(self.round_seconds)

    @property
    def participation_mean(self) -> float:
        """Mean per-round participation; 1.0 when no faults were injected."""
        if not self.participation:
            return 1.0
        return sum(self.participation) / len(self.participation)

    @property
    def staleness_max(self) -> int:
        return max(self.staleness) if self.staleness else 0

    @property
    def staleness_mean(self) -> float:
        if not self.staleness:
            return 0.0
        return sum(self.staleness) / len(self.staleness)

    def cumulative_seconds(self) -> List[float]:
        """Wall clock at the end of each round (sync traces)."""
        out, acc = [], 0.0
        for r in self.round_seconds:
            acc += r
            out.append(acc)
        return out

    def fingerprint(self) -> str:
        """Stable digest of the full event trace (determinism tests)."""
        h = hashlib.sha256()
        for e in self.events:
            h.update(repr(e.row()).encode())
        return h.hexdigest()

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e.kind == kind)

    def to_chrome(self, pid: int = 1, process_name: str = "sim"
                  ) -> Dict[str, Any]:
        """Chrome-trace JSON of this timeline (one track per worker plus a
        barrier track), in the reference through
        ``obs.trace.sim_trace_to_chrome``, which the port does not have
        yet."""
        raise NotImplementedError(
            "SimTrace.to_chrome is not ported yet: ROADMAP Queue 1 #11 "
            "(telemetry: obs/trace.py)")


# ---------------------------------------------------------------------------
# Synchronous-round mode.
# ---------------------------------------------------------------------------

def simulate_sync_rounds(scenario, bytes_per_neighbor: int, num_rounds: int,
                         faults=None) -> SimTrace:
    """Wall-clock for ``num_rounds`` bulk-synchronous gossip rounds.

    ``bytes_per_neighbor`` is one worker's payload to ONE neighbor per
    round — ``CommEngine.bytes_per_round(X) / len(topo.neighbor_offsets())``.
    The trace carries per-round barrier times (``round_seconds``) so a
    loss-vs-step trajectory converts to loss-vs-wall-clock by indexing
    :meth:`SimTrace.cumulative_seconds`.

    ``faults`` (a :class:`~repro_torch.sim.faults.FaultSpec`; defaults to
    ``scenario.faults``) turns on elastic rounds — module docstring for
    the semantics.  Presence is failure-detector knowledge: dead edges
    send nothing (no NIC occupancy, no bytes); sampled drops and late
    arrivals DO put their bytes on the wire — they were sent, then lost.
    Participation masks per round land on the trace.
    """
    topo, net, comp, seed = (scenario.topo, scenario.network,
                             scenario.compute, scenario.seed)
    fabric = getattr(scenario, "fabric", None)
    if faults is None:
        faults = getattr(scenario, "faults", None)
    deadline = faults.deadline_s if faults is not None else None
    n = topo.n
    offsets = topo.neighbor_offsets()
    events: List[SimEvent] = []
    round_seconds: List[float] = []
    participation: List[float] = []
    presence: List[Tuple[int, ...]] = []
    total_bytes = 0
    t_start = 0.0
    for k in range(num_rounds):
        pres = presence_of(faults, comp, n, k, seed)
        up = [True] * n if pres is None else [bool(b) for b in pres]
        compute = [comp.compute_seconds(i, k, seed) if up[i] else 0.0
                   for i in range(n)]
        for i in range(n):
            if up[i]:
                events.append(SimEvent(t_start + compute[i], COMPUTE, i,
                                       step=k))
            else:
                events.append(SimEvent(t_start, OFFLINE, i, step=k))
        # participants: present AND own compute met the deadline; a worker
        # still computing at the deadline is dropped from the round (its
        # model takes the identity mix), and the barrier fires at the
        # deadline because its peers waited that long for it
        part = list(up)
        late = False
        if deadline is not None:
            for i in range(n):
                if up[i] and compute[i] > deadline:
                    part[i] = False
                    late = True
                    events.append(SimEvent(t_start + deadline, DROPPED, i,
                                           step=k))
        # arrival[i] accumulates the latest in-payload; senders serialize
        # their per-neighbor payloads on the NIC bandwidth term
        ready = [t_start + compute[i] for i in range(n)]

        def _deliver(j, dst, arrive):
            """Classify one payload's arrival; returns ready-time or None."""
            nonlocal total_bytes, late
            total_bytes += bytes_per_neighbor
            if faults is not None and faults.message_dropped(k, j, dst,
                                                             seed):
                events.append(SimEvent(arrive, MSGDROP, j, peer=dst, step=k,
                                       nbytes=bytes_per_neighbor))
                return None
            if deadline is not None and arrive > t_start + deadline:
                events.append(SimEvent(arrive, LATE, j, peer=dst, step=k,
                                       nbytes=bytes_per_neighbor))
                late = True
                return None
            events.append(SimEvent(arrive, TRANSFER, j, peer=dst, step=k,
                                   nbytes=bytes_per_neighbor))
            return arrive

        if fabric is not None:
            # contended fabric: the round's transfers share NIC / switch
            # capacity; the fluid solver prices them jointly
            from repro_torch.sim.contention import schedule_transfers
            specs = [(t_start + compute[j], j, (j - o) % n,
                      bytes_per_neighbor)
                     for j in range(n) for o in offsets
                     if part[j] and part[(j - o) % n]]
            finishes = schedule_transfers(fabric, n, specs)
            for (_, j, dst, nb), fin in zip(specs, finishes):
                u = sim_uniform(seed, STREAM_NET, k, j, dst)
                arrive = _deliver(j, dst, fin + fabric.alpha_s
                                  + fabric.jitter_s * u)
                if arrive is not None:
                    ready[dst] = max(ready[dst], arrive)
        else:
            for j in range(n):
                if not part[j]:
                    continue
                nic_free = t_start + compute[j]
                for o in offsets:
                    dst = (j - o) % n   # i = j - o receives FROM j = i + o
                    if not part[dst]:
                        continue        # dead edge: nothing enters the NIC
                    link = net.link(j, dst, n)
                    nic_free += link.occupancy_seconds(bytes_per_neighbor)
                    u = sim_uniform(seed, STREAM_NET, k, j, dst)
                    arrive = _deliver(j, dst, nic_free + link.alpha_s
                                      + link.jitter_s * u)
                    if arrive is not None:
                        ready[dst] = max(ready[dst], arrive)
        if deadline is not None and late:
            t_end = t_start + deadline
        else:
            pready = [ready[i] for i in range(n) if part[i]]
            t_end = max(pready) if pready else (
                t_start + (deadline if deadline is not None else 0.0))
        events.append(SimEvent(t_end, ROUND, -1, step=k))
        round_seconds.append(t_end - t_start)
        if faults is not None or pres is not None:
            participation.append(sum(part) / n)
            presence.append(tuple(int(b) for b in part))
        t_start = t_end
    return SimTrace(events=events, total_seconds=t_start,
                    bytes_on_wire=total_bytes, round_seconds=round_seconds,
                    participation=participation, presence=presence)


# ---------------------------------------------------------------------------
# Asynchronous AD-PSGD mode.
# ---------------------------------------------------------------------------

def simulate_async_gossip(
    scenario,
    bytes_per_exchange: int,
    num_updates: int,
    on_gossip: Optional[Callable[[int, int, int], None]] = None,
    on_update: Optional[Callable[[int, int, int], None]] = None,
    faults=None,
    on_drop: Optional[Callable[[int, int, int], None]] = None,
) -> SimTrace:
    """Event loop for AD-PSGD: one gossip + one stale gradient per update.

    Each worker cycles compute -> gossip(random incident edge) -> apply.
    Exactly ``num_updates`` update events (and exactly one gossip each) are
    processed in deterministic time order; ties break on a monotonic
    sequence number, never on worker identity.  Callbacks:

    * ``on_gossip(i, j, gossip_idx)`` — the edge exchange completed; the
      caller mutates its models here (``replay_adpsgd`` routes this to
      ``CommEngine.pair_average``).
    * ``on_update(i, local_step, staleness)`` — worker ``i`` applies the
      gradient snapshot taken ``staleness`` model-versions ago.

    ``bytes_per_exchange`` is ONE endpoint's payload; a pair exchange
    ships it in both directions (``pair_average`` encodes both models),
    so each gossip puts ``2 * bytes_per_exchange`` on the wire while the
    transfer time stays one payload's worth — the two payloads cross
    concurrently on the full-duplex link.

    The passive peer never blocks, so straggler-heavy scenarios slow the
    straggler's own update rate but cannot deadlock the loop (contract
    tested in ``tests/test_torch_sim.py``).

    Faults: the loop is wait-free, so of the :class:`FaultSpec` catalog
    only ``drop_p`` applies (deadlines guard barriers the loop doesn't
    have; churn is a compute-model concern here).  A dropped exchange
    ships its bytes (sent, then lost), mixes nothing, and fires
    ``on_drop(i, j, idx)`` instead of ``on_gossip`` — the worker still
    applies its stale gradient.  Loss draws key on the gossip index
    (``STREAM_DROP``), so replays lose the same exchanges.
    """
    topo, net, comp, seed = (scenario.topo, scenario.network,
                             scenario.compute, scenario.seed)
    fabric = getattr(scenario, "fabric", None)
    if faults is None:
        faults = getattr(scenario, "faults", None)
    n = topo.n
    offsets = [o % n for o in topo.neighbor_offsets()]
    if not offsets:
        raise ValueError("async gossip needs a topology with neighbors")
    events: List[SimEvent] = []
    heap: List[Tuple] = []                # (time, seq, kind, worker[, extra])
    seq = 0
    # per-worker state: model version (bumped by every gossip touching the
    # worker and every applied update) and the version at gradient snapshot
    version = [0] * n
    snap_version = [0] * n
    local_step = [0] * n
    # worker -> (peer, lost?) of the in-flight gossip; the loss draw is
    # taken at launch, keyed by the gossip index
    pending_peer: Dict[int, Tuple[int, bool]] = {}
    staleness: List[int] = []
    total_bytes = 0
    gossip_idx = 0
    updates_done = 0

    # contended-fabric state: a live fluid scheduler; each gossip g is two
    # directed flows (2g: i->j, 2g+1: j->i) crossing the full-duplex fabric
    # concurrently.  Flow-completion predictions go on the heap tagged with
    # the scheduler epoch; any start/finish re-solves rates and bumps the
    # epoch, so stale predictions are recognized and dropped on pop.
    sched = None
    if fabric is not None:
        from repro_torch.sim.contention import FlowScheduler
        sched = FlowScheduler(fabric, n)
    flows_left: Dict[int, int] = {}       # gossip -> directed flows in flight
    gossip_of: Dict[int, Tuple[int, int]] = {}    # gossip -> (initiator, peer)

    def _push_flow_etas():
        nonlocal seq
        for fid in sched.active:
            heapq.heappush(heap, (sched.eta(fid), seq, FLOW, fid,
                                  sched.epoch))
            seq += 1

    for i in range(n):
        dt = comp.compute_seconds(i, 0, seed)
        heapq.heappush(heap, (dt, seq, COMPUTE, i))
        seq += 1
        snap_version[i] = version[i]

    t_now = 0.0
    while updates_done < num_updates and heap:
        t_now, _, kind, i, *extra = heapq.heappop(heap)
        if kind == FLOW:
            if extra[0] != sched.epoch:
                continue                  # rates changed since prediction
            fid = i
            sched.finish(t_now, fid)
            _push_flow_etas()
            g = fid // 2
            flows_left[g] -= 1
            if flows_left[g] == 0:
                del flows_left[g]
                gi, gj = gossip_of.pop(g)
                u = sim_uniform(seed, STREAM_NET, g, gi, gj)
                arrive = t_now + fabric.alpha_s + fabric.jitter_s * u
                heapq.heappush(heap, (arrive, seq, GOSSIP, gi))
                seq += 1
            continue
        if kind == COMPUTE:
            # gradient ready; gossip on a deterministic-random incident edge
            o = offsets[sim_randint(seed, len(offsets), STREAM_EDGE_CHOICE,
                                    i, local_step[i])]
            j = (i + o) % n
            if sched is not None:
                # both directions enter the shared fabric now; the gossip
                # completes when the slower flow drains (+ alpha, jitter)
                sched.start(t_now, 2 * gossip_idx, i, j, bytes_per_exchange)
                sched.start(t_now, 2 * gossip_idx + 1, j, i,
                            bytes_per_exchange)
                flows_left[gossip_idx] = 2
                gossip_of[gossip_idx] = (i, j)
                _push_flow_etas()
            else:
                u = sim_uniform(seed, STREAM_NET, gossip_idx, i, j)
                dt = net.transfer_seconds(i, j, n, bytes_per_exchange, u)
                heapq.heappush(heap, (t_now + dt, seq, GOSSIP, i))
                seq += 1
            lost = (faults is not None
                    and faults.message_dropped(gossip_idx, i, j, seed))
            pending_peer[i] = (j, lost)
            events.append(SimEvent(t_now, COMPUTE, i, peer=j,
                                   step=local_step[i]))
            gossip_idx += 1
        elif kind == GOSSIP:
            j, lost = pending_peer.pop(i)
            # credited at completion: gossips still in flight when the loop
            # hits num_updates never touched models and are not counted
            total_bytes += 2 * bytes_per_exchange
            if lost:
                # exchange on the wire, then dropped: models untouched, no
                # version bumps — but the worker's cycle continues below
                if on_drop is not None:
                    on_drop(i, j, len(staleness))
                events.append(SimEvent(t_now, MSGDROP, i, peer=j,
                                       step=local_step[i],
                                       nbytes=2 * bytes_per_exchange))
            else:
                if on_gossip is not None:
                    on_gossip(i, j, len(staleness))
                version[i] += 1
                version[j] += 1
                events.append(SimEvent(t_now, GOSSIP, i, peer=j,
                                       step=local_step[i],
                                       nbytes=2 * bytes_per_exchange))
            # apply the stale gradient immediately after the exchange
            stale = version[i] - snap_version[i]
            staleness.append(stale)
            if on_update is not None:
                on_update(i, local_step[i], stale)
            version[i] += 1
            events.append(SimEvent(t_now, UPDATE, i, step=local_step[i]))
            local_step[i] += 1
            updates_done += 1
            # next compute phase; snapshot the model version it reads
            snap_version[i] = version[i]
            dt = comp.compute_seconds(i, local_step[i], seed)
            heapq.heappush(heap, (t_now + dt, seq, COMPUTE, i))
            seq += 1
    return SimTrace(events=events, total_seconds=t_now,
                    bytes_on_wire=total_bytes, staleness=staleness)


def replay_adpsgd(scenario, engine, x0, grad_fn, alpha: float,
                  num_updates: int, theta: float = 2.0,
                  faults=None) -> Dict[str, Any]:
    """Replay AD-PSGD through ``CommEngine.pair_average`` edge by edge.

    ``x0`` is the stacked ``[n, d]`` initial model (a tensor on the device
    the replay runs on), ``grad_fn(x, i, seed)`` the per-worker stochastic
    gradient with ``seed`` an int.  Each simulated gossip applies the
    engine's pair exchange (quantized or exact, per its wire) to the live
    models; each update applies the gradient *snapshot* its worker took at
    compute start, the same staleness the wall clock prices.  Returns the
    final stacked models, the trace, and the mean squared distance to the
    mean model.

    Randomness: the reference turns each draw ``s = sim_randint(...)`` into
    ``jax.random.PRNGKey(s)``, whose hash seed (``kops._key_to_seed``, the
    key's last word) is ``s`` itself; so the pair exchange gets
    ``seed=s`` and ``grad_fn`` the gradient draw as an int.

    Faults (``faults`` or ``scenario.faults``): a lost exchange replays
    through ``engine.pair_average(..., presence=(1, 0))``, the identity
    exchange.
    """
    import torch

    from repro_torch.sim.network import STREAM_GRAD, STREAM_PAIR

    n = x0.shape[0]
    X = [x0[i] for i in range(n)]
    snap = [x0[i] for i in range(n)]
    grads: List[Optional[Any]] = [None] * n
    scenario_seed = scenario.seed

    def _take_grad(i: int, idx: int) -> None:
        # snapshot & gradient for the exchange initiator were taken at its
        # compute start; compute them lazily here (values equal by purity)
        if grads[i] is None:
            grads[i] = grad_fn(snap[i], i, sim_randint(
                scenario_seed, 2**31 - 1, STREAM_GRAD, i, idx))

    def _exchange(i: int, j: int, idx: int, presence) -> None:
        _take_grad(i, idx)
        seed = sim_randint(scenario_seed, 2**31 - 1, STREAM_PAIR, idx)
        res = engine.pair_average(X[i], X[j], theta=theta, seed=seed,
                                  presence=presence)
        X[i], X[j] = res.xi, res.xj

    def on_gossip(i: int, j: int, idx: int) -> None:
        _exchange(i, j, idx, None)

    def on_drop(i: int, j: int, idx: int) -> None:
        _exchange(i, j, idx, (1, 0))    # lost payload: identity exchange

    def on_update(i: int, step: int, stale: int) -> None:
        X[i] = X[i] - alpha * grads[i]
        grads[i] = None
        snap[i] = X[i]          # next gradient reads the post-update model

    nbytes = engine.codec.payload_bytes(tuple(x0.shape[1:]))
    trace = simulate_async_gossip(scenario, bytes_per_exchange=nbytes,
                                  num_updates=num_updates,
                                  on_gossip=on_gossip, on_update=on_update,
                                  faults=faults, on_drop=on_drop)
    Xf = torch.stack(X)
    consensus = float(torch.mean(torch.sum(
        (Xf - torch.mean(Xf, dim=0, keepdim=True)) ** 2, dim=1)))
    return {"X": Xf, "trace": trace, "consensus_sq": consensus}
