"""Named simulation scenarios: topology x network x cluster presets.

A :class:`Scenario` bundles everything the event engine needs — a
circulant :class:`~repro_torch.core.topology.Topology`, a
:class:`~repro_torch.sim.network.NetworkModel`, a
:class:`~repro_torch.sim.cluster.ComputeModel`, and the seed all deterministic
draws key off.  The catalog covers the regimes the paper's wall-clock
claims span:

``lan-10gbe-ring``
    Homogeneous datacenter baseline: 10 GbE ring, microsecond latency.
    Compute-bound — codecs barely matter; the control scenario.
``wan-exponential``
    Geo-distributed exponential graph: 200 Mbit/s links, 20 ms base
    latency, and the long ``2^j`` hops (hop distance >= 4) at half
    bandwidth and double latency — heterogeneous links keyed by topology
    offsets.
``straggler-longtail``
    1 GbE ring with one chronically slow worker carrying a Pareto
    (shape 1.2, unbounded-variance) per-step tail: the regime where
    synchronous rounds collapse to the slowest worker and the async
    AD-PSGD loop shines.
``bandwidth-starved``
    25 Mbit/s, 5 ms links (Fig. 1's worst network, further starved):
    fp32 payloads dominate the round; Moniqua's 1-bit wire is the
    headline win here.
``oversubscribed-tor``
    Same 10 GbE NICs as the LAN control, but workers are spread
    round-robin across two racks whose ToR uplinks carry only 100 Mbit/s
    — every ring edge crosses a rack boundary, so the round's 16
    concurrent transfers share two uplinks (water-filling fair share).
    The fp32 payloads saturate the fabric and slow *each other* down;
    the 1-bit wire barely notices — contention widens the wall-clock gap
    beyond what any isolated link predicts.
``shared-uplink-ring``
    All workers behind one half-duplex 300 Mbit/s shared medium: the
    maximally contended regime (every transfer, both directions, one
    resource).
``two-tier-tor``
    The hierarchical-gossip fabric: nodes of 4 workers on ICI-fast 40
    Gbit/s NICs, contiguous placement (intra-node traffic never leaves
    the rack), each node behind a 200 Mbit/s oversubscribed uplink.  The
    scenario topology is the *slow phase* of a two-tier round: lane
    offsets ``±n_intra`` — worker ``(g, j)`` ships its owned shard to
    ``(g±1, j)`` — so every simulated flow crosses a node boundary and
    contends on the uplinks, while the full-precision intra phase is
    priced analytically on the NIC term (``bench_hierarchical``).
``calibrated-from-bench``
    Links are not datasheet constants but an alpha-beta fit
    (``sim/calibrate.py``) on measured probe times — by default synthetic
    probes of Fig. 1's worst network, or a ``NetworkModel`` JSON emitted
    by ``python -m repro_torch.sim.calibrate`` (pass ``model_path`` or set
    ``REPRO_SIM_NETMODEL``).
``churn-ring``
    Elastic-gossip stress test: 1 GbE ring whose workers crash-restart
    (each round each worker draws a ~3-round outage with probability
    ``outage_p``) and whose messages drop with probability ``drop_p`` —
    the :mod:`repro_torch.sim.faults` catalog exercised end to end.  Pair with
    ``Scenario.with_deadline`` to compare deadline-dropped rounds against
    wait-for-everyone (``bench_elastic``).

Factories take ``n`` so benchmarks can match the scenario to their
worker count; ``get_scenario(name, n=...)`` is the registry entry point
and forwards any extra keyword arguments to the factory (e.g. the
straggler knobs of ``straggler-longtail`` or the churn rates of
``churn-ring``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.topology import Topology, exponential, ring
from repro_torch.sim.cluster import (ComputeModel, crash_restart, homogeneous,
                               one_straggler)
from repro_torch.sim.contention import (Fabric, oversubscribed_fabric,
                                  shared_medium_fabric)
from repro_torch.sim.faults import FaultSpec
from repro_torch.sim.network import LinkModel, NetworkModel, gbit, mbit

# default local-step cost: ResNet20-scale fwd+bwd on a P100 at batch 128
# (the paper's Fig. 1 workload; bench_walltime uses the same constant)
DEFAULT_COMPUTE_S = 0.05


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Everything one simulation run needs, as a frozen value object.

    ``fabric`` (optional) switches the event engine from isolated
    per-link pricing to shared-resource contention scheduling — see
    :mod:`repro_torch.sim.contention`.  ``network`` stays populated either way:
    it is the isolated-link twin of the same hardware, used by code paths
    that want the uncontended baseline.
    """
    name: str
    topo: Topology
    network: NetworkModel
    compute: ComputeModel
    seed: int = 0
    description: str = ""
    fabric: Optional[Fabric] = None
    faults: Optional[FaultSpec] = None

    def with_compute(self, base_s: float) -> "Scenario":
        """Same scenario, different per-step compute cost (e.g. measured)."""
        comp = dataclasses.replace(self.compute, base_s=base_s)
        return dataclasses.replace(self, compute=comp)

    def with_seed(self, seed: int) -> "Scenario":
        return dataclasses.replace(self, seed=seed)

    def with_faults(self, faults: Optional[FaultSpec]) -> "Scenario":
        """Same scenario, different fault catalog (None clears it)."""
        return dataclasses.replace(self, faults=faults)

    def with_deadline(self, deadline_s: float) -> "Scenario":
        """Deadline-based rounds on top of whatever faults are configured.

        This is the knob ``bench_elastic`` turns: the same scenario with
        and without a deadline isolates deadline-dropping from churn.
        """
        base = self.faults if self.faults is not None else FaultSpec()
        return dataclasses.replace(
            self, faults=dataclasses.replace(base, deadline_s=deadline_s))


def lan_10gbe_ring(n: int = 8, compute_s: float = DEFAULT_COMPUTE_S,
                   seed: int = 0) -> Scenario:
    return Scenario(
        name="lan-10gbe-ring",
        topo=ring(n),
        network=NetworkModel.homogeneous(alpha_s=50e-6, beta_Bps=gbit(10.0),
                                         jitter_s=10e-6),
        compute=homogeneous(compute_s),
        seed=seed,
        description="homogeneous 10 GbE datacenter ring (compute-bound)")


def wan_exponential(n: int = 16, compute_s: float = DEFAULT_COMPUTE_S,
                    seed: int = 0) -> Scenario:
    short = LinkModel(alpha_s=20e-3, beta_Bps=mbit(200.0), jitter_s=2e-3)
    long_ = LinkModel(alpha_s=40e-3, beta_Bps=mbit(100.0), jitter_s=4e-3)
    topo = exponential(n)
    # hops of distance >= 4 cross regions: half bandwidth, double latency
    far = {min(o % n, (-o) % n) for o in topo.neighbor_offsets()
           if min(o % n, (-o) % n) >= 4}
    return Scenario(
        name="wan-exponential",
        topo=topo,
        network=NetworkModel(short).with_offset_links(
            {h: long_ for h in far}),
        compute=homogeneous(compute_s),
        seed=seed,
        description="geo-distributed exponential graph; long 2^j hops "
                    "slower (heterogeneous links keyed by offset)")


def straggler_longtail(n: int = 8, compute_s: float = DEFAULT_COMPUTE_S,
                       seed: int = 0, worker: int = 0, slow: float = 4.0,
                       tail_scale: float = 2.0,
                       pareto_shape: float = 1.2) -> Scenario:
    return Scenario(
        name="straggler-longtail",
        topo=ring(n),
        network=NetworkModel.homogeneous(alpha_s=0.15e-3,
                                         beta_Bps=gbit(1.0),
                                         jitter_s=30e-6),
        compute=one_straggler(compute_s, worker=worker, slow=slow,
                              tail_scale=tail_scale,
                              pareto_shape=pareto_shape),
        seed=seed,
        description=f"1 GbE ring; worker {worker} is {slow:g}x slower with "
                    "a Pareto long-tail per-step term")


def bandwidth_starved(n: int = 8, compute_s: float = DEFAULT_COMPUTE_S,
                      seed: int = 0) -> Scenario:
    return Scenario(
        name="bandwidth-starved",
        topo=ring(n),
        network=NetworkModel.homogeneous(alpha_s=5e-3, beta_Bps=mbit(25.0),
                                         jitter_s=0.5e-3),
        compute=homogeneous(compute_s),
        seed=seed,
        description="25 Mbit/s, 5 ms links: fp32 payloads dominate; the "
                    "1-bit wire's headline scenario")


def oversubscribed_tor(n: int = 8, compute_s: float = DEFAULT_COMPUTE_S,
                       seed: int = 0) -> Scenario:
    """LAN NICs, starved rack uplinks: contention is the whole story.

    Workers sit on two racks round-robin (worker i -> rack i % 2), the
    adversarial placement for a ring: *every* gossip edge crosses a rack
    boundary, so all 2n concurrent transfers of a round squeeze through
    the two 100 Mbit/s ToR uplinks while the 10 GbE NICs sit idle.
    Compare against ``lan-10gbe-ring`` — identical NICs, alpha, jitter
    and compute; the only difference is the shared fabric.
    """
    nic = gbit(10.0)
    return Scenario(
        name="oversubscribed-tor",
        topo=ring(n),
        network=NetworkModel.homogeneous(alpha_s=50e-6, beta_Bps=nic,
                                         jitter_s=10e-6),
        compute=homogeneous(compute_s),
        seed=seed,
        fabric=oversubscribed_fabric(n, nic_Bps=nic, uplink_Bps=mbit(100.0),
                                     num_groups=2, interleave=True,
                                     alpha_s=50e-6, jitter_s=10e-6),
        description="10 GbE NICs, two racks with 100 Mbit/s ToR uplinks, "
                    "round-robin placement: every ring edge crosses a "
                    "rack; concurrent fp32 payloads contend on the "
                    "uplinks (water-filling fair share)")


def lan_1gbe_ring(n: int = 8, compute_s: float = DEFAULT_COMPUTE_S,
                  seed: int = 0) -> Scenario:
    """Isolated 1 GbE ring: the uncontended twin of shared-uplink-ring.

    Identical NICs, alpha, jitter and compute — the only difference is
    that transfers do NOT share a medium, so comparing the two isolates
    contention (the pairing ``bench_network_sim``'s contention summary
    and ``tools/check_bench.py`` guard).
    """
    return Scenario(
        name="lan-1gbe-ring",
        topo=ring(n),
        network=NetworkModel.homogeneous(alpha_s=0.15e-3,
                                         beta_Bps=gbit(1.0),
                                         jitter_s=20e-6),
        compute=homogeneous(compute_s),
        seed=seed,
        description="isolated 1 GbE ring (no shared fabric): the "
                    "uncontended twin of shared-uplink-ring")


def shared_uplink_ring(n: int = 8, compute_s: float = DEFAULT_COMPUTE_S,
                       seed: int = 0) -> Scenario:
    """One half-duplex shared medium carries every transfer."""
    nic = gbit(1.0)
    return Scenario(
        name="shared-uplink-ring",
        topo=ring(n),
        network=NetworkModel.homogeneous(alpha_s=0.15e-3, beta_Bps=nic,
                                         jitter_s=20e-6),
        compute=homogeneous(compute_s),
        seed=seed,
        fabric=shared_medium_fabric(nic_Bps=nic, bus_Bps=mbit(300.0),
                                    alpha_s=0.15e-3, jitter_s=20e-6),
        description="1 GbE NICs behind one half-duplex 300 Mbit/s shared "
                    "medium: all transfers, both directions, contend for "
                    "a single resource")


def two_tier_tor(n: int = 32, compute_s: float = DEFAULT_COMPUTE_S,
                 seed: int = 0, n_intra: int = 4) -> Scenario:
    """Two-tier hierarchy fabric: ICI-fast nodes, oversubscribed uplinks.

    ``n`` workers in contiguous nodes of ``n_intra`` (worker ``w = g *
    n_intra + j``, matching ``HierarchicalTopology``'s flat index), 40
    Gbit/s NICs inside a node, one 200 Mbit/s ToR uplink per node.  The
    scenario's topology is the slow-axis *lane* graph of a tiered round:
    offsets ``±n_intra``, i.e. member ``j`` of node ``g`` exchanges with
    member ``j`` of nodes ``g±1`` — every flow crosses a node boundary,
    so a round's ``2 * n`` shard transfers contend on the ``n/n_intra``
    uplinks (water-filling).  Single-tier baselines on the same fabric
    reuse it with a flat ring topology (contiguous placement is the
    *favorable* placement for them: only seam edges cross).
    """
    if n % n_intra:
        raise ValueError(f"n_intra must divide n: {n} % {n_intra}")
    nic = gbit(40.0)
    lanes = Topology("node-lanes", n, (-n_intra, 0, n_intra),
                     (1 / 3, 1 / 3, 1 / 3))
    return Scenario(
        name="two-tier-tor",
        topo=lanes,
        network=NetworkModel.homogeneous(alpha_s=10e-6, beta_Bps=nic,
                                         jitter_s=5e-6),
        compute=homogeneous(compute_s),
        seed=seed,
        fabric=oversubscribed_fabric(n, nic_Bps=nic, uplink_Bps=mbit(200.0),
                                     num_groups=n // n_intra,
                                     interleave=False,
                                     alpha_s=10e-6, jitter_s=5e-6),
        description="nodes of 4 on 40 Gbit/s ICI behind 200 Mbit/s ToR "
                    "uplinks, contiguous placement; topology = the "
                    "slow-axis shard lanes (offsets +/- n_intra) of a "
                    "two-tier gossip round")


# synthetic calibration probes: Fig. 1's worst network (100 Mbit/s, 5 ms)
# measured at the wire sizes the codec sweep actually ships
_CAL_TRUE_ALPHA_S = 2 * 5e-3            # two messages' latency per round
_CAL_TRUE_BETA_BPS = 100e6 / 8.0
_CAL_PROBE_SIZES = (28_752, 230_016, 230_112, 575_040, 920_064, 2_300_160)


def calibrated_from_bench(n: int = 8, compute_s: float = DEFAULT_COMPUTE_S,
                          seed: int = 0,
                          model_path: Optional[str] = None) -> Scenario:
    """Links fitted from measurements, not quoted from a datasheet.

    If ``model_path`` (or ``$REPRO_SIM_NETMODEL``) names a ``NetworkModel``
    JSON emitted by ``python -m repro_torch.sim.calibrate``, load it (a named
    path that does not exist raises — no silent fallback); otherwise
    self-calibrate deterministically on synthetic probes of Fig. 1's worst
    network — the fit must recover alpha/beta within 5%
    (``tests/test_torch_sim.py``), so the scenario's behavior matches the
    closed-form constants it was probed from.
    """
    from repro_torch.sim import calibrate as CAL

    path = model_path or os.environ.get("REPRO_SIM_NETMODEL", "")
    if path:
        # an explicitly named model must exist — a typo'd path silently
        # falling back to synthetic constants would defeat calibration
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"calibrated-from-bench: network model {path!r} not found "
                "(from model_path or $REPRO_SIM_NETMODEL)")
        net = CAL.load_network_model(path)
        source = os.path.basename(path)
    else:
        fit = CAL.fit_link(CAL.synthetic_samples(
            _CAL_TRUE_ALPHA_S, _CAL_TRUE_BETA_BPS, _CAL_PROBE_SIZES,
            seed=seed))
        net = NetworkModel(fit.link())
        source = "synthetic Fig.1 probes"
    return Scenario(
        name="calibrated-from-bench",
        topo=ring(n),
        network=net,
        compute=homogeneous(compute_s),
        seed=seed,
        description=f"alpha-beta links least-squares fitted ({source}) "
                    "via sim/calibrate.py instead of datasheet constants")


def churn_ring(n: int = 8, compute_s: float = DEFAULT_COMPUTE_S,
               seed: int = 0, outage_p: float = 0.05,
               outage_rounds: int = 3, drop_p: float = 0.01) -> Scenario:
    """Crash-restart churn plus message loss on a 1 GbE ring.

    Expected unavailability per worker is about ``outage_p *
    outage_rounds`` (~15% at the defaults); layer a round deadline on top
    with :meth:`Scenario.with_deadline` to get the full elastic regime.
    """
    return Scenario(
        name="churn-ring",
        topo=ring(n),
        network=NetworkModel.homogeneous(alpha_s=0.15e-3,
                                         beta_Bps=gbit(1.0),
                                         jitter_s=20e-6),
        compute=crash_restart(compute_s, outage_p=outage_p,
                              outage_rounds=outage_rounds),
        seed=seed,
        faults=FaultSpec(drop_p=drop_p),
        description=f"1 GbE ring under churn: {outage_rounds}-round "
                    f"crash-restart outages at p={outage_p:g} per step, "
                    f"messages lost at p={drop_p:g}")


_REGISTRY: Dict[str, Callable[..., Scenario]] = {
    "lan-10gbe-ring": lan_10gbe_ring,
    "wan-exponential": wan_exponential,
    "straggler-longtail": straggler_longtail,
    "bandwidth-starved": bandwidth_starved,
    "lan-1gbe-ring": lan_1gbe_ring,
    "oversubscribed-tor": oversubscribed_tor,
    "two-tier-tor": two_tier_tor,
    "shared-uplink-ring": shared_uplink_ring,
    "calibrated-from-bench": calibrated_from_bench,
    "churn-ring": churn_ring,
}


def list_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_scenario(name: str, n: Optional[int] = None,
                 compute_s: Optional[float] = None,
                 seed: int = 0, **kwargs) -> Scenario:
    """Build a registered scenario; extra kwargs reach the factory.

    The pass-through is what lets callers tune factory-specific knobs —
    ``get_scenario("straggler-longtail", slow=8.0)`` or
    ``get_scenario("churn-ring", outage_p=0.1)`` — without the registry
    enumerating every factory's signature.  Unknown knobs fail loudly as
    a ``TypeError`` from the factory itself.
    """
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"available: {list(list_scenarios())}") from None
    kw = dict(kwargs)
    kw["seed"] = seed
    if n is not None:
        kw["n"] = n
    if compute_s is not None:
        kw["compute_s"] = compute_s
    return factory(**kw)


def scenario_from_netconfig(name: str, bandwidth_bps: float, latency_s: float,
                            topo: Topology, compute_s: float,
                            seed: int = 0) -> Scenario:
    """Bridge from ``benchmarks.common.NetworkConfig``-style constants.

    ``bandwidth_bps`` is in bits/s (how the benchmark tables quote links);
    jitter is zero so the prediction is directly comparable with the
    closed-form analytic model it replaces.
    """
    return Scenario(
        name=name, topo=topo,
        network=NetworkModel.homogeneous(alpha_s=latency_s,
                                         beta_Bps=bandwidth_bps / 8.0),
        compute=homogeneous(compute_s), seed=seed,
        description=f"from NetworkConfig {name}")
