"""The port's simulator (``repro_torch.sim``) against the JAX package's
``repro.sim``, on the CPU.

The simulator is pure-Python float arithmetic with ``heapq`` tie-breaks on
a sequence counter and a counter-hash RNG, so the port's copy must give
the same traces, not close ones: every ``SimTrace`` is compared field by
field with ``==`` on the floats, for every scenario of the catalog at its
defaults, sync and async, with faults and a round deadline.  The fluid
solver, the flow scheduler, the calibration fits and the fault predicates
agree exactly too.  ``replay_adpsgd``'s twin drives the port's
``pair_average`` (the reference's JAX key becomes the hash seed it holds,
``kops._key_to_seed``): bitwise on the ``full`` and ``moniqua`` wires,
dropped exchanges the identity.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as jsim
import repro_torch.sim as tsim
from repro.comm import engine as jeng
from repro.core import topology as jtopo
from repro.core.quantizers import QuantSpec as JSpec
from repro.sim import calibrate as jcal
from repro.sim import cluster as jcl
from repro.sim import contention as jct
from repro.sim import events as jev
from repro.sim import faults as jfa
from repro.sim import network as jnet
from repro.sim import scenarios as jsc
from repro_torch.comm import engine as teng
from repro_torch.core import topology as ttopo
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.sim import calibrate as tcal
from repro_torch.sim import cluster as tcl
from repro_torch.sim import contention as tct
from repro_torch.sim import events as tev
from repro_torch.sim import faults as tfa
from repro_torch.sim import network as tnet
from repro_torch.sim import scenarios as tsc

SCENARIOS = jsc.list_scenarios()
ROUNDS = 12
UPDATES = 60
NBYTES = 68_168            # ResNet-20's 1-bit payload to one neighbour


def _trace_fields(tr):
    """Every field of a SimTrace, events as plain tuples."""
    d = {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr)}
    d["events"] = [dataclasses.astuple(e) for e in tr.events]
    return d


def _assert_traces_equal(ref, out):
    a, b = _trace_fields(ref), _trace_fields(out)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k
    assert ref.fingerprint() == out.fingerprint()
    assert ref.mean_round_seconds == out.mean_round_seconds
    assert ref.participation_mean == out.participation_mean
    assert ref.cumulative_seconds() == out.cumulative_seconds()


def _faults(pkg):
    """Churn on a schedule, stochastic loss and a deadline, in one spec."""
    return pkg.FaultSpec(drop_p=0.05, deadline_s=0.06,
                         outages=(pkg.Outage(worker=1, start=2, rounds=3),
                                  pkg.Outage(worker=3, start=5)))


def test_exports_match_reference():
    assert sorted(tsim.__all__) == sorted(jsim.__all__)
    for name in tsim.__all__:
        assert hasattr(tsim, name), name
    assert tsc.list_scenarios() == jsc.list_scenarios()
    assert len(SCENARIOS) == 10


@pytest.mark.parametrize("name", SCENARIOS)
def test_sync_trace_matches_reference(name):
    """At the scenario's defaults (its own faults, if any)."""
    js, ts = jsc.get_scenario(name), tsc.get_scenario(name)
    assert ts.name == js.name and ts.description == js.description
    assert ts.topo.offsets == js.topo.offsets
    _assert_traces_equal(jev.simulate_sync_rounds(js, NBYTES, ROUNDS),
                         tev.simulate_sync_rounds(ts, NBYTES, ROUNDS))


@pytest.mark.parametrize("name", SCENARIOS)
def test_sync_trace_with_faults_and_deadline_matches_reference(name):
    js = jsc.get_scenario(name, seed=3).with_faults(_faults(jfa))
    ts = tsc.get_scenario(name, seed=3).with_faults(_faults(tfa))
    ref = jev.simulate_sync_rounds(js.with_deadline(0.055), NBYTES, ROUNDS)
    out = tev.simulate_sync_rounds(ts.with_deadline(0.055), NBYTES, ROUNDS)
    _assert_traces_equal(ref, out)
    assert len(out.presence) == ROUNDS
    # faults handed in per call instead of on the scenario
    _assert_traces_equal(
        jev.simulate_sync_rounds(jsc.get_scenario(name), NBYTES, ROUNDS,
                                 faults=_faults(jfa)),
        tev.simulate_sync_rounds(tsc.get_scenario(name), NBYTES, ROUNDS,
                                 faults=_faults(tfa)))


@pytest.mark.parametrize("name", SCENARIOS)
def test_async_trace_matches_reference(name):
    js, ts = jsc.get_scenario(name), tsc.get_scenario(name)
    _assert_traces_equal(jev.simulate_async_gossip(js, NBYTES, UPDATES),
                         tev.simulate_async_gossip(ts, NBYTES, UPDATES))


@pytest.mark.parametrize("name", SCENARIOS)
def test_async_trace_with_drops_matches_reference(name):
    """Loss is the only fault the wait-free loop takes; the callbacks fire
    in the same order with the same arguments."""
    calls = {"ref": [], "port": []}

    def cbs(tag):
        log = calls[tag]
        return dict(on_gossip=lambda i, j, k: log.append(("g", i, j, k)),
                    on_update=lambda i, s, st: log.append(("u", i, s, st)),
                    on_drop=lambda i, j, k: log.append(("d", i, j, k)))

    js = jsc.get_scenario(name, seed=5).with_faults(jfa.FaultSpec(drop_p=0.2))
    ts = tsc.get_scenario(name, seed=5).with_faults(tfa.FaultSpec(drop_p=0.2))
    ref = jev.simulate_async_gossip(js, NBYTES, UPDATES, **cbs("ref"))
    out = tev.simulate_async_gossip(ts, NBYTES, UPDATES, **cbs("port"))
    _assert_traces_equal(ref, out)
    assert calls["ref"] == calls["port"]
    assert any(c[0] == "d" for c in calls["port"])


@pytest.mark.parametrize("seed", [0, 11])
def test_churn_ring_with_deadline_matches_reference(seed):
    """The elastic regime phase 18 replays: churn-ring with a deadline,
    20 rounds, realized masks and all."""
    js = jsc.get_scenario("churn-ring", seed=seed).with_deadline(0.052)
    ts = tsc.get_scenario("churn-ring", seed=seed).with_deadline(0.052)
    ref = jev.simulate_sync_rounds(js, 544_564, 20)
    out = tev.simulate_sync_rounds(ts, 544_564, 20)
    _assert_traces_equal(ref, out)
    assert all(len(m) == 8 for m in out.presence)
    assert out.participation_mean < 1.0


def test_knobs_pass_through_the_registry():
    for name, kw in (("straggler-longtail", dict(worker=3, slow=8.0)),
                     ("churn-ring", dict(outage_p=0.2, drop_p=0.1)),
                     ("two-tier-tor", dict(n=16, n_intra=4)),
                     ("wan-exponential", dict(n=8, compute_s=0.02))):
        js, ts = jsc.get_scenario(name, **kw), tsc.get_scenario(name, **kw)
        _assert_traces_equal(jev.simulate_sync_rounds(js, NBYTES, 6),
                             tev.simulate_sync_rounds(ts, NBYTES, 6))
    with pytest.raises(TypeError):
        tsc.get_scenario("straggler-longtail", nope=1)
    with pytest.raises(ValueError, match="unknown scenario"):
        tsc.get_scenario("no-such-net")
    sc = tsc.scenario_from_netconfig("x", 1e9, 1e-3, ttopo.ring(4), 0.05)
    jscn = jsc.scenario_from_netconfig("x", 1e9, 1e-3, jtopo.ring(4), 0.05)
    _assert_traces_equal(jev.simulate_sync_rounds(jscn, NBYTES, 4),
                         tev.simulate_sync_rounds(sc, NBYTES, 4))
    assert sc.with_compute(0.1).compute.base_s == 0.1


# -- the pieces, exactly ---------------------------------------------------------

def test_counter_hash_rng_matches_reference():
    for args in ((0,), (7, 1, 2, 3), (2**40 + 5, jnet.STREAM_PAIR, 99),
                 (123, jnet.STREAM_DROP, 4, 0, 1)):
        assert tnet.sim_uniform(*args) == jnet.sim_uniform(*args)
        assert (tnet.sim_randint(args[0], 2**31 - 1, *args[1:])
                == jnet.sim_randint(args[0], 2**31 - 1, *args[1:]))
    for s in ("NET", "COMPUTE", "EDGE_CHOICE", "GRAD", "PAIR", "DROP",
              "OUTAGE"):
        assert getattr(tnet, f"STREAM_{s}") == getattr(jnet, f"STREAM_{s}")


@pytest.mark.parametrize("mode", ["water-filling", "max-concurrency"])
def test_solve_rates_matches_reference(mode):
    rng = np.random.default_rng(1)
    res = [f"r{i}" for i in range(6)]
    cap = {r: float(c) for r, c in zip(res, rng.uniform(1e6, 1e9, 6))}
    for trial in range(20):
        paths = {f: tuple(rng.choice(res, size=int(rng.integers(1, 4)),
                                     replace=False))
                 for f in range(int(rng.integers(1, 12)))}
        assert (tct.solve_rates(paths, cap.__getitem__, mode)
                == jct.solve_rates(paths, cap.__getitem__, mode))
    assert tct.solve_rates({}, cap.__getitem__, mode) == {}
    with pytest.raises(ValueError):
        tct.solve_rates({0: ("r0",)}, cap.__getitem__, "fifo")


def test_flow_scheduler_matches_reference():
    """The same start / finish sequence on both schedulers gives the same
    epochs, active sets and completion predictions."""
    def drive(ct):
        fab = ct.oversubscribed_fabric(8, nic_Bps=1.25e9, uplink_Bps=1.25e7,
                                       num_groups=2, interleave=True)
        s = ct.FlowScheduler(fab, 8)
        log = []
        t = 0.0
        for fid in range(10):
            s.start(t, fid, fid % 8, (fid + 3) % 8, 1e5 * (fid + 1))
            log.append((s.epoch, s.active, [s.eta(f) for f in s.active]))
            t += 1e-3
        while s.active:
            t_fin, fid = min((s.eta(f), f) for f in s.active)
            s.finish(t_fin, fid)
            log.append((t_fin, s.epoch, s.active))
        return log
    assert drive(tct) == drive(jct)
    fab_j = jct.shared_medium_fabric(1.25e8, 3.75e7)
    fab_t = tct.shared_medium_fabric(1.25e8, 3.75e7)
    flows = [(0.001 * (i % 3), i % 4, (i + 1) % 4, 1e4 * (i + 1))
             for i in range(9)]
    assert (tct.schedule_transfers(fab_t, 4, flows)
            == jct.schedule_transfers(fab_j, 4, flows))
    assert tct.tor_groups(8, 2, True) == jct.tor_groups(8, 2, True)


def test_fits_match_reference():
    sizes = (28_752, 230_016, 575_040, 920_064, 2_300_160)
    sj = jcal.synthetic_samples(0.01, 12.5e6, sizes, jitter_s=1e-3, seed=4)
    st = tcal.synthetic_samples(0.01, 12.5e6, sizes, jitter_s=1e-3, seed=4)
    assert sj == st
    assert dataclasses.astuple(tcal.fit_link(st)) == \
        dataclasses.astuple(jcal.fit_link(sj))
    groups = {1: st[:3], 4: st[2:], None: st}
    assert (tcal.fit_network(groups, jitter_s=1e-4).to_dict()
            == jcal.fit_network(groups, jitter_s=1e-4).to_dict())
    with pytest.raises(ValueError):
        tcal.fit_link([(1.0, 1.0)])
    col = "s/step 100Mbps-5ms"
    walltime = {"codec_table": [
        {col: t + 0.05 + 1e-4, "mix_ms_measured": 0.1,
         "wire_bytes_per_step": b} for b, t in st] + [{"other": 1.0}]}
    assert (tcal.samples_from_walltime(walltime, "100Mbps-5ms")
            == jcal.samples_from_walltime(walltime, "100Mbps-5ms"))
    assert dataclasses.astuple(tcal.calibrate_from_walltime(
        walltime, "100Mbps-5ms")) == dataclasses.astuple(
        jcal.calibrate_from_walltime(walltime, "100Mbps-5ms"))
    with pytest.raises(ValueError, match="no usable"):
        tcal.samples_from_walltime(walltime, "1Gbps")


def test_presence_and_compute_models_match_reference():
    for comp_j, comp_t in (
            (jcl.crash_restart(0.05, 0.2, 3), tcl.crash_restart(0.05, 0.2, 3)),
            (jcl.one_straggler(0.05, 2), tcl.one_straggler(0.05, 2)),
            (jcl.ComputeModel(0.05, tail="exp", tail_scale=0.5),
             tcl.ComputeModel(0.05, tail="exp", tail_scale=0.5))):
        for faults in ((None, None), (_faults(jfa), _faults(tfa)),
                       (jfa.FaultSpec(), tfa.FaultSpec())):
            for k in range(30):
                assert (tfa.presence_of(faults[1], comp_t, 8, k, 9)
                        == jfa.presence_of(faults[0], comp_j, 8, k, 9))
        for w in range(8):
            for k in range(30):
                assert comp_t.offline(w, k, 9) == comp_j.offline(w, k, 9)
                assert (comp_t.compute_seconds(w, k, 9)
                        == comp_j.compute_seconds(w, k, 9))
    f_j, f_t = _faults(jfa), _faults(tfa)
    assert ([f_t.message_dropped(k, 0, 1, 4) for k in range(200)]
            == [f_j.message_dropped(k, 0, 1, 4) for k in range(200)])
    with pytest.raises(ValueError):
        tfa.FaultSpec(drop_p=1.5)
    with pytest.raises(ValueError):
        tfa.Outage(worker=0, start=0, rounds=0)


def test_calibrated_scenario_reads_the_same_model(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_SIM_NETMODEL", raising=False)
    _assert_traces_equal(
        jev.simulate_sync_rounds(jsc.get_scenario("calibrated-from-bench"),
                                 NBYTES, 4),
        tev.simulate_sync_rounds(tsc.get_scenario("calibrated-from-bench"),
                                 NBYTES, 4))
    path = tmp_path / "net.json"
    tcal.save_network_model(tnet.NetworkModel.homogeneous(1e-3, 5e6, 1e-4),
                            str(path), meta={"source": "test"})
    assert json.loads(path.read_text())["meta"] == {"source": "test"}
    monkeypatch.setenv("REPRO_SIM_NETMODEL", str(path))
    js = jsc.get_scenario("calibrated-from-bench")
    ts = tsc.get_scenario("calibrated-from-bench")
    assert ts.network.to_dict() == js.network.to_dict()
    assert ts.description == js.description
    monkeypatch.setenv("REPRO_SIM_NETMODEL", str(tmp_path / "missing.json"))
    with pytest.raises(FileNotFoundError, match="not found"):
        tsc.get_scenario("calibrated-from-bench")


def test_to_chrome_names_its_roadmap_item():
    """ROADMAP Queue 1 #11 ported ``SimTrace.to_chrome``: the port's
    timeline renders as the reference's ``sim_trace_to_chrome`` of its own
    (``tests/test_torch_obs.py`` holds the async one and validation)."""
    from repro.obs.trace import sim_trace_to_chrome
    tr = tev.simulate_sync_rounds(tsc.get_scenario("lan-10gbe-ring"),
                                  NBYTES, 2)
    jt = jev.simulate_sync_rounds(jsc.get_scenario("lan-10gbe-ring"),
                                  NBYTES, 2)
    assert tr.to_chrome() == sim_trace_to_chrome(jt)
    assert tr.to_chrome(pid=3, process_name="x") == sim_trace_to_chrome(
        jt, pid=3, process_name="x")


# -- replay_adpsgd through the port's pair_average ---------------------------

def _replay(wire, bits, faults_p=0.3, updates=120):
    """Both replays on an [8, 64] model with the identity gradient on a
    lossy 10 GbE ring; the port's dropped exchanges recorded."""
    spec = dict(bits=bits, stochastic=bits > 1) if wire != "full" else {}
    je = jeng.CommEngine(jtopo.ring(8), jeng.make_wire(
        wire, JSpec(**spec) if spec else None))
    te = teng.CommEngine(ttopo.ring(8), teng.make_wire(
        wire, TSpec(**spec) if spec else None))
    js = jsc.get_scenario("lan-10gbe-ring", seed=2).with_faults(
        jfa.FaultSpec(drop_p=faults_p))
    ts = tsc.get_scenario("lan-10gbe-ring", seed=2).with_faults(
        tfa.FaultSpec(drop_p=faults_p))
    x0 = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    ref = jev.replay_adpsgd(js, je, jnp.asarray(x0), lambda x, i, k: x,
                            alpha=0.05, num_updates=updates, theta=4.0)
    drops, seeds = [], []
    pair = te.pair_average

    def spy(xi, xj, presence=None, seed=None, **kw):
        res = pair(xi, xj, presence=presence, seed=seed, **kw)
        seeds.append(seed)
        if presence is not None:
            drops.append((xi, xj, res))
        return res

    object.__setattr__(te, "pair_average", spy)
    out = tev.replay_adpsgd(ts, te, torch.from_numpy(x0),
                            lambda x, i, s: x, alpha=0.05,
                            num_updates=updates, theta=4.0)
    return ref, out, drops, seeds


@pytest.mark.parametrize("wire,bits", [("full", 32), ("moniqua", 8),
                                       ("moniqua", 2)])
def test_replay_adpsgd_matches_reference(wire, bits):
    ref, out, drops, seeds = _replay(wire, bits)
    _assert_traces_equal(ref["trace"], out["trace"])
    np.testing.assert_array_equal(np.asarray(ref["X"]), out["X"].numpy())
    assert out["X"].dtype == torch.float32 and out["X"].shape == (8, 64)
    assert abs(out["consensus_sq"] - ref["consensus_sq"]) <= \
        1e-6 * abs(ref["consensus_sq"])
    n_drop = out["trace"].count(tev.MSGDROP)
    assert len(drops) == n_drop > 0
    assert len(seeds) == n_drop + out["trace"].count(tev.GOSSIP)
    for xi, xj, res in drops:
        assert res.xi is xi and res.xj is xj
    assert all(isinstance(s, int) and 0 <= s < 2**31 - 1 for s in seeds)


def test_replay_seeds_are_the_reference_keys_seeds():
    """The seed handed to pair_average is the hash seed of the reference's
    ``PRNGKey(sim_randint(...))``: the key's last word."""
    from repro.kernels import ops as jops
    for idx in range(5):
        s = tnet.sim_randint(2, 2**31 - 1, tnet.STREAM_PAIR, idx)
        assert int(jops._key_to_seed(jax.random.PRNGKey(s))) == s


def test_replay_without_faults_has_no_drops():
    ref, out, drops, _ = _replay("moniqua", 8, faults_p=0.0, updates=40)
    _assert_traces_equal(ref["trace"], out["trace"])
    np.testing.assert_array_equal(np.asarray(ref["X"]), out["X"].numpy())
    assert drops == [] and out["trace"].count(tev.MSGDROP) == 0
