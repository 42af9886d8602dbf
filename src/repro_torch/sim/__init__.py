"""repro_torch.sim: event-driven network/cluster simulator.

The port's own copy of ``repro.sim`` (pure Python; the port imports nothing
of the JAX package), with a PyTorch twin of ``events.replay_adpsgd``.

Turns the byte counts CommEngine already produces (``bytes_per_round`` /
``BytesLedger``) into *wall-clock predictions* under explicit link and
compute models, across heterogeneous named scenarios — the layer that lets
the repo reproduce the paper's wall-clock comparisons without a physical
cluster.  Layout:

* :mod:`repro_torch.sim.network`   — per-edge link models (alpha-beta cost
  ``T = alpha + bytes / beta``, jitter, heterogeneous links keyed by
  topology offsets) and the deterministic counter-hash RNG every sim
  module draws from.
* :mod:`repro_torch.sim.cluster`   — per-worker compute-time models with
  straggler distributions (static multipliers, exponential and Pareto
  tails).
* :mod:`repro_torch.sim.events`    — the deterministic event engine: a
  synchronous-round mode (D-PSGD / D2 / Moniqua) and an asynchronous
  AD-PSGD event loop that replays ``CommEngine.pair_average`` edge by
  edge with staleness tracking.
* :mod:`repro_torch.sim.contention` — shared-resource link scheduling: NICs and
  switches as capacity-limited resources, max-concurrency or exact
  progressive-filling (water-filling) bandwidth sharing, and the fluid
  :class:`~repro_torch.sim.contention.FlowScheduler` both event modes use to
  serialize contended transfers.
* :mod:`repro_torch.sim.calibrate`  — least-squares ``alpha + bytes/beta`` fits
  from measured ``bench_walltime`` probes (or synthetic traces), emitting
  a :class:`~repro_torch.sim.network.NetworkModel` the scenario catalog loads.
* :mod:`repro_torch.sim.scenarios` — the named scenario catalog (homogeneous
  10GbE ring, WAN exponential graph, long-tail straggler,
  bandwidth-starved 1-bit, oversubscribed ToR, shared-uplink medium,
  calibrated-from-bench) and factories for custom ones.

Everything is pure Python + numpy-free arithmetic on floats, fully
deterministic given (scenario, seed): same inputs produce an *identical*
event trace, and the same trace as the reference's, which
``tests/test_torch_sim.py`` enforces.
"""
from repro_torch.sim.calibrate import LinkFit, fit_link, fit_network
from repro_torch.sim.cluster import ComputeModel
from repro_torch.sim.contention import (Fabric, FlowScheduler, Switch,
                                  schedule_transfers, solve_rates)
from repro_torch.sim.events import (SimEvent, SimTrace, replay_adpsgd,
                              simulate_async_gossip, simulate_sync_rounds)
from repro_torch.sim.network import LinkModel, NetworkModel, sim_uniform
from repro_torch.sim.scenarios import (Scenario, get_scenario, list_scenarios,
                                 scenario_from_netconfig)

__all__ = [
    "ComputeModel", "Fabric", "FlowScheduler", "LinkFit", "LinkModel",
    "NetworkModel", "Scenario", "SimEvent", "SimTrace", "Switch",
    "fit_link", "fit_network", "get_scenario", "list_scenarios",
    "replay_adpsgd", "scenario_from_netconfig", "schedule_transfers",
    "sim_uniform", "simulate_async_gossip", "simulate_sync_rounds",
    "solve_rates",
]
