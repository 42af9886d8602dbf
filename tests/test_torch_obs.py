"""The port's observability (``repro_torch.obs``) against the JAX package's,
on the CPU.

Mirrors ``tests/test_obs.py`` for the port:

1. **Telemetry is observational.**  With ``telemetry=True`` the mixed
   model, the payloads and the WireState are bitwise the same as with it
   off, on every wire (``full``, ``moniqua`` 8/4/1-bit, ``qsgd``,
   ``ef_qsgd``, ``onebit``), both paths, K = 1 and 5, over 3 rounds, on
   ring(8), under a presence mask, and on ``two_tier(8, 2)`` with and
   without a per-node mask; so are ``mix_stale``, AD-PSGD and the four
   instrumented update rules.
2. **Health equals the reference's** ``CommEngine(telemetry=True)`` run
   eagerly on the same inputs and keys (the port gets the hash seed the
   reference derives, ``kops._key_to_seed``): every key exactly, except
   ``ef_residual_l2``, whose float32 sum of squares runs in another order
   than XLA's and is held within ``L2_RTOL`` relative; and the same across
   paths and K.
3. **The alias sentinel**: zero with Lemma 1's guard band, pinned to 0 at
   ``delta >= 1/4``, firing (with the reference's count) when theta is
   undersized; the band predicate bitwise the reference's.
4. **Artifacts**: the port's run logs pass the reference's
   ``validate_records`` and ``tools/check_obs.py``; its Chrome traces (the
   trainer's, ``SimTrace.to_chrome``'s) pass the reference's
   ``validate_chrome``, and ``to_chrome`` is the reference's
   ``sim_trace_to_chrome`` on the same scenario.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as jsim
import repro_torch.sim as tsim
from repro.comm import engine as jeng
from repro.core import adpsgd as jad
from repro.core import algorithms as jalg
from repro.core import topology as jtopo
from repro.core.moniqua import MoniquaCodec as JCodec
from repro.core.quantizers import QuantSpec as JSpec
from repro.data.synthetic import quadratic_grad as j_quadratic_grad
from repro.kernels import moniqua_decode_reduce as jdr
from repro.kernels import ops as jops
from repro.obs import metrics as JM
from repro.obs import runlog as JRL
from repro.obs import trace as JTR
from repro_torch import convert, tree
from repro_torch.comm import engine as teng
from repro_torch.core import adpsgd as tad
from repro_torch.core import algorithms as talg
from repro_torch.core import modulo as tmod
from repro_torch.core import topology as ttopo
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.data.synthetic import quadratic_grad as t_quadratic_grad
from repro_torch.kernels import moniqua_decode_reduce as tdr
from repro_torch.kernels import ops as tops
from repro_torch.obs import metrics as TM
from repro_torch.obs import runlog as TRL
from repro_torch.obs import trace as TTR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
THETA = 2.0
L2_RTOL = 1e-6
WIRES = [("full", 32), ("moniqua", 8), ("moniqua", 4), ("moniqua", 1),
         ("qsgd", 8), ("ef_qsgd", 4), ("onebit", 1)]
WIRE_IDS = [f"{w}{b}" for w, b in WIRES]
MASK = (1, 1, 0, 1, 1, 0, 1, 1)          # workers 2 and 5 absent
NODE_MASK = (1, 0, 1, 1)                 # node 1 (workers 2, 3) absent
# topology of the round, and its presence mask
LAYOUTS = {"ring": ("ring", None), "ring_masked": ("ring", MASK),
           "two_tier": ("two_tier", None),
           "two_tier_masked": ("two_tier", NODE_MASK)}
_to_cpu = functools.partial(convert.to_torch, device="cpu")


def _tree_np(scale=0.02, seed=0):
    """Six leaves with unaligned last dims (K = 5 makes five chunks, the
    shards split mid-tree) and a scalar-per-worker leaf."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal((N,) + shape) * scale).astype(np.float32)
    return {"w": r(300), "b": r(17), "c": r(3, 7), "d": r(65), "e": r(129),
            "s": r()}


def _spec(bits):
    return dict(bits=min(bits, 8), stochastic=1 < bits <= 8)


def _engines(wire, bits, path="bucketed", chunks=1, topo="ring",
             telemetry=True):
    """(reference engine with telemetry, port engine)."""
    spec = _spec(bits)
    jt = jtopo.ring(N) if topo == "ring" else jtopo.two_tier(N, 2)
    tt = ttopo.ring(N) if topo == "ring" else ttopo.two_tier(N, 2)
    je = jeng.CommEngine(jt, jeng.make_wire(wire, JSpec(**spec), warmup=2),
                         backend="jnp", path=path, chunks=chunks,
                         telemetry=True)
    te = teng.CommEngine(tt, teng.make_wire(wire, TSpec(**spec), warmup=2),
                         path=path, chunks=chunks, telemetry=telemetry)
    return je, te


def _kw(wire, key, theta=THETA):
    """Per-round arguments: (reference's, port's)."""
    if wire == "full":
        return {}, {}
    j, t = dict(key=key), dict(seed=int(jops._key_to_seed(key)))
    if wire == "moniqua":
        j["theta"] = t["theta"] = theta
    return j, t


def _assert_health_equal(ref, out, keys=TM.HEALTH_ROUND_KEYS):
    """The port's health dict == the reference's: same keys and dtypes,
    every value exact but ``ef_residual_l2`` (within L2_RTOL)."""
    assert set(out) == set(keys) == set(ref)
    for k in keys:
        a, b = np.asarray(ref[k]), out[k].numpy()
        assert a.dtype == b.dtype, k
        if k == "ef_residual_l2":
            np.testing.assert_allclose(b, a, rtol=L2_RTOL, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


class _EncodeRecorder:
    """Wraps ``ops.moniqua_encode_stacked`` and keeps every payload."""

    def __init__(self, monkeypatch):
        self.payloads = []
        orig = tops.moniqua_encode_stacked

        def rec(*a, **k):
            p = orig(*a, **k)
            self.payloads.append(p)
            return p
        monkeypatch.setattr(tops, "moniqua_encode_stacked", rec)

    def take(self):
        out, self.payloads = self.payloads, []
        return out


# ---------------------------------------------------------------------------
# 1-2. observational, and health == the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("path", ["bucketed", "per_leaf"])
@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_round_telemetry_is_observational_and_matches_reference(
        layout, wire, bits, path, K, monkeypatch):
    """3 rounds with WireState: telemetry on == off bitwise (x, state, the
    round's own payloads); the sentinel's whole-buffer payload is reused
    on a barrier bucketed Moniqua round and re-encoded once elsewhere; the
    health equals the reference's at every round."""
    topo, presence = LAYOUTS[layout]
    je, on = _engines(wire, bits, path, K, topo)
    off = dataclasses.replace(on, telemetry=False)
    X_np = _tree_np()
    Xj, Xon, Xoff = (jax.tree.map(jnp.asarray, X_np), _to_cpu(X_np),
                     _to_cpu(X_np))
    sj = je.init_wire_state(Xj) if je.stateful else None
    son = on.init_wire_state(Xon) if on.stateful else None
    soff = off.init_wire_state(Xoff) if off.stateful else None
    if path == "bucketed" and topo == "ring":
        assert on.round_plan(Xon, **_kw(wire, jax.random.PRNGKey(0))[1],
                             state=son if on.stateful else None
                             ).num_chunks == K
    rec = _EncodeRecorder(monkeypatch)
    spec = on.codec.spec if wire != "full" else None
    sentinel = (wire == "moniqua" and spec.delta < 0.25
                and topo == "ring")
    for k in range(3):
        kj, kt = _kw(wire, jax.random.PRNGKey(40 + k))
        rj = je.mix(Xj, state=sj, presence=presence, **kj)
        roff = off.mix(Xoff, state=soff, presence=presence, **kt)
        p_off = rec.take()
        ron = on.mix(Xon, state=son, presence=presence, **kt)
        p_on = rec.take()
        assert roff.health is None
        for a, b in zip(tree.leaves(roff.x), tree.leaves(ron.x)):
            assert torch.equal(a, b), f"round {k}"
        if on.stateful:
            for name in ("residual", "step"):
                assert torch.equal(roff.state[name], ron.state[name])
        reused = path == "bucketed" and K == 1
        extra = 1 if sentinel and not reused else 0
        assert len(p_on) == len(p_off) + extra
        for a, b in zip(p_off, p_on):
            assert torch.equal(a, b)
        if sentinel:
            layout_ = on.layout(Xon)
            whole = tops.moniqua_encode_stacked(
                layout_.flatten(Xon), tmod.b_theta(THETA, spec.delta), spec,
                kt["seed"])
            rec.take()
            assert torch.equal(p_on[-1] if extra else p_off[0], whole)
        _assert_health_equal(rj.health, ron.health)
        assert ron.health["alias_count"].dtype == torch.int32
        Xj, Xon, Xoff = rj.x, ron.x, roff.x
        if je.stateful:
            sj, son, soff = rj.state, ron.state, roff.state


@pytest.mark.parametrize("presence", [None, MASK], ids=["full", "masked"])
def test_mix_stale_telemetry(presence):
    """One round stale, 3 rounds: x and the carry bitwise on/off, health
    the reference's."""
    je = jeng.CommEngine(jtopo.ring(N), jeng.MoniquaWire(JSpec(8)),
                         backend="jnp", telemetry=True)
    on = teng.CommEngine(ttopo.ring(N), teng.MoniquaWire(TSpec(8)),
                         telemetry=True)
    off = dataclasses.replace(on, telemetry=False)
    X_np = _tree_np()
    Xj, Xt = jax.tree.map(jnp.asarray, X_np), _to_cpu(X_np)
    cj, con, coff = (je.init_gossip_carry(Xj), on.init_gossip_carry(Xt),
                     off.init_gossip_carry(Xt))
    Xon = Xoff = Xt
    for k in range(3):
        key = jax.random.PRNGKey(90 + k)
        seed = int(jops._key_to_seed(key))
        rj = je.mix_stale(Xj, cj, theta=THETA, key=key, presence=presence)
        ron = on.mix_stale(Xon, con, theta=THETA, seed=seed,
                           presence=presence)
        roff = off.mix_stale(Xoff, coff, theta=THETA, seed=seed,
                             presence=presence)
        for a, b in zip(tree.leaves(roff.x), tree.leaves(ron.x)):
            assert torch.equal(a, b)
        for name in ("packed", "ref", "B", "valid"):
            assert torch.equal(roff.state[name], ron.state[name])
        _assert_health_equal(rj.health, ron.health)
        Xj, cj, Xon, con, Xoff, coff = (rj.x, rj.state, ron.x, ron.state,
                                        roff.x, roff.state)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_health_invariant_across_paths_and_K(bits):
    """Bucketed at K = 1 and 5 and per-leaf: the same health, bitwise (it
    is read from the canonical flat buffer and whole-buffer payload)."""
    X = _to_cpu(_tree_np())
    seed = int(jops._key_to_seed(jax.random.PRNGKey(11)))
    ref = None
    for path, K in (("bucketed", 1), ("bucketed", 5), ("per_leaf", 1)):
        _, te = _engines("moniqua", bits, path, K)
        h = te.mix(X, theta=THETA, seed=seed).health
        if ref is None:
            ref = h
            continue
        for k in TM.HEALTH_ROUND_KEYS:
            assert torch.equal(h[k], ref[k]), (k, path, K)


def test_empty_and_single_worker_rounds_report_zero_health():
    eng = teng.CommEngine(ttopo.ring(1), teng.MoniquaWire(TSpec(8)),
                          telemetry=True)
    r = eng.mix({"w": torch.ones(1, 4)}, theta=THETA, seed=1)
    zero = TM.round_health_zero()
    for k in TM.HEALTH_ROUND_KEYS:
        assert torch.equal(r.health[k], zero[k]), k
    assert zero["participation"] == 1.0
    assert zero["alias_count"].dtype == torch.int32
    assert TM.init_health()["alias_total"].dtype == torch.int32


# ---------------------------------------------------------------------------
# 3. the alias sentinel
# ---------------------------------------------------------------------------

def _sentinel_health(X_np, bits, theta, seed_key, path="bucketed"):
    je, te = _engines("moniqua", bits, path)
    key = jax.random.PRNGKey(seed_key)
    hj = je.mix(jax.tree.map(jnp.asarray, X_np), theta=theta,
                key=key).health
    ht = te.mix(_to_cpu(X_np), theta=theta,
                seed=int(jops._key_to_seed(key))).health
    _assert_health_equal(hj, ht)
    return ht


@pytest.mark.parametrize("bits", [4, 8])
def test_alias_zero_when_theta_bound_holds(bits):
    """Lemma 1's hypothesis with the guard band: exactly zero."""
    h = _sentinel_health(_tree_np(scale=0.01), bits, THETA, 0)
    assert int(h["alias_count"]) == 0
    assert float(h["headroom"]) < 0.5


@pytest.mark.parametrize("bits", [1, 2])
def test_alias_pinned_to_zero_without_guard_band(bits):
    """delta >= 1/4: pinned to 0 even under gross violation; headroom is
    the live signal there."""
    X_np = {"w": (np.random.default_rng(5).standard_normal((N, 2048))
                  * 3.0).astype(np.float32)}
    h = _sentinel_health(X_np, bits, 0.05, 2)
    assert int(h["alias_count"]) == 0
    assert float(h["headroom"]) > 0.5


@pytest.mark.parametrize("path", ["bucketed", "per_leaf"])
@pytest.mark.parametrize("bits", [4, 8])
def test_alias_fires_when_theta_undersized(bits, path):
    """Gross theta violation over a 4096-wide buffer: the count is the
    reference's, nonzero, within a loose factor of the ~2*delta rate."""
    X_np = {"w": (np.random.default_rng(5).standard_normal((N, 4096))
                  * 3.0).astype(np.float32)}
    h = _sentinel_health(X_np, bits, 0.05, 2, path)
    count = int(h["alias_count"])
    delta = TSpec(bits=bits).delta
    assert count > 2 * delta * 2 * N * 4096 / 8
    assert float(h["headroom"]) > 0.5


def test_alias_band_mask_semantics():
    """The band predicate on hand-built payload values (B = 1, theta =
    0.4), and on random ones bitwise the reference's."""
    y = torch.zeros((1, 6))
    qb = torch.tensor([[0.00, 0.39, 0.45, 0.55, 0.61, 1.00]])
    mask = tdr.alias_band_mask(qb, y, 1.0, 0.4)[0]
    assert mask.tolist() == [False, False, True, True, False, False]
    assert torch.equal(tdr.alias_band_mask(qb + 3.2, y + 3.2, 1.0, 0.4)[0],
                       mask)
    rng = np.random.default_rng(3)
    qb_np = (rng.standard_normal((4, 999)) * 5).astype(np.float32)
    y_np = (rng.standard_normal((4, 999)) * 5).astype(np.float32)
    for B, theta in ((1.0, 0.4), (2.5, 1.1)):
        ref = np.asarray(jdr.alias_band_mask(jnp.asarray(qb_np),
                                             jnp.asarray(y_np), B, theta))
        out = tdr.alias_band_mask(torch.from_numpy(qb_np),
                                  torch.from_numpy(y_np), B, theta)
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_unpack_values_and_segments_match_reference(bits):
    rng = np.random.default_rng(bits)
    p = rng.integers(0, 256, (3, 37), dtype=np.uint8)
    B = np.float32(1.7)
    np.testing.assert_array_equal(
        tdr.unpack_values(torch.from_numpy(p), bits, torch.tensor(B))
        .numpy(), np.asarray(jdr.unpack_values(jnp.asarray(p), bits, B)))
    flat = (rng.standard_normal((N, 120)) * 0.1).astype(np.float32)
    segs = (50, 40, 30)
    np.testing.assert_array_equal(
        TM.consensus_inf_segments(torch.from_numpy(flat), (-1, 1), segs)
        .numpy(),
        np.asarray(JM.consensus_inf_segments(jnp.asarray(flat), (-1, 1),
                                             segs)))


# ---------------------------------------------------------------------------
# 4. AD-PSGD edge telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire,bits", [("full", 32), ("moniqua", 8),
                                       ("moniqua", 4), ("moniqua", 2),
                                       ("qsgd", 8)])
@pytest.mark.parametrize("shape", [(37,), (3, 29)])
def test_pair_health_matches_reference(wire, bits, shape):
    """The pre-exchange endpoints' health == the reference's
    ``CommEngine.pair_health``, undersized theta included."""
    rng = np.random.default_rng(bits + len(shape))
    xi = (rng.standard_normal(shape) * 3).astype(np.float32)
    xj = (xi + rng.uniform(-2, 2, shape)).astype(np.float32)
    je, te = _engines(wire, bits)
    key = jax.random.PRNGKey(17)
    for theta in (0.3, THETA):
        hj = je.pair_health(jnp.asarray(xi), jnp.asarray(xj), theta=theta,
                            key=key)
        ht = te.pair_health(torch.from_numpy(xi), torch.from_numpy(xj),
                            theta=theta, seed=int(jops._key_to_seed(key)))
        _assert_health_equal(hj, ht)


def _adpsgd_schedule(key, topo, max_delay, iters, n, d):
    """The reference ``run``'s draws, replayed from its key splitting."""
    n_off = len(topo.neighbor_offsets())
    out = {k: [] for k in ("i", "tau", "nb", "seed", "noise")}
    kkey = key
    for _ in range(iters):
        kkey, k_i, k_tau, k_nb, k_g, k_q = jax.random.split(kkey, 6)
        out["i"].append(int(jax.random.randint(k_i, (), 0, n)))
        out["tau"].append(int(jax.random.randint(k_tau, (), 0,
                                                 max_delay + 1)))
        out["nb"].append(int(jax.random.randint(k_nb, (), 0, n_off)))
        out["seed"].append(int(jops._key_to_seed(k_q)))
        out["noise"].append(np.asarray(jax.random.normal(k_g, (d,))))
    sched = {k: torch.tensor(v) for k, v in out.items() if k != "noise"}
    sched["noise"] = torch.from_numpy(np.stack(out["noise"]))
    return sched


@pytest.mark.parametrize("quantized", [False, True])
def test_adpsgd_telemetry_pure_and_matches_reference(quantized):
    """X and the mean trace bitwise with telemetry on or off; the health
    trace (one entry an iteration, on the pre-exchange endpoints) equals
    the reference's eager run's; two extra encodes an iteration."""
    n, d, iters = 6, 16, 12
    spec = dict(bits=8, stochastic=True)
    kw = dict(theta=0.5, max_delay=4, quantized=quantized)
    jcfg = jad.ADPSGDConfig(topo=jtopo.ring(n), codec=JCodec(JSpec(**spec)),
                            telemetry=True, **kw)
    tcfg = tad.ADPSGDConfig(topo=ttopo.ring(n), codec=TCodec(TSpec(**spec)),
                            **kw)
    x0 = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    with jax.disable_jit():
        Xj, _, hj = jad.run(jnp.asarray(x0), lambda x, i, k:
                            j_quadratic_grad(x, 0.2, k, 0.05), 0.05, iters,
                            jcfg, key)
    sched = _adpsgd_schedule(key, jcfg.topo, 4, iters, n, d)

    def grad(x, i, noise):
        return t_quadratic_grad(x, 0.2, noise, 0.05)

    X0, tr0 = tad.run(torch.from_numpy(x0), grad, 0.05, iters, tcfg,
                      schedule=sched)
    calls = []
    orig = tops.moniqua_encode_stacked

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    tops.moniqua_encode_stacked = counting
    try:
        X1, tr1, ht = tad.run(torch.from_numpy(x0), grad, 0.05, iters,
                              dataclasses.replace(tcfg, telemetry=True),
                              schedule=sched)
    finally:
        tops.moniqua_encode_stacked = orig
    assert torch.equal(X0, X1) and torch.equal(tr0, tr1)
    np.testing.assert_array_equal(X1.numpy(), np.asarray(Xj))
    assert len(calls) == (3 * iters if quantized else 0)
    assert set(ht) == set(TM.HEALTH_ROUND_KEYS)
    assert ht["consensus_inf"].shape == (iters,)
    _assert_health_equal(hj, ht)


# ---------------------------------------------------------------------------
# The instrumented update rules
# ---------------------------------------------------------------------------

def _rule_runs(name, wire="moniqua", steps=3):
    """(reference with telemetry, port off, port on) after ``steps``."""
    n, d = N, 256
    rng = np.random.default_rng(0)
    X_np = (rng.standard_normal((n, d)) * 0.05).astype(np.float32)
    g_np = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    spec = dict(bits=8, stochastic=True)
    jhp = jalg.AlgoHyper(topo=jtopo.ring(n), codec=JCodec(JSpec(**spec)),
                         theta=THETA, wire=wire, telemetry=True)
    thp = talg.AlgoHyper(topo=ttopo.ring(n), codec=TCodec(TSpec(**spec)),
                         theta=THETA, wire=wire)
    ja, ta = jalg.get_algorithm(name), talg.get_algorithm(name)
    Xj = jnp.asarray(X_np)
    ej = ja.init(Xj, jhp)
    runs = {}
    for tel in (False, True):
        hp = dataclasses.replace(thp, telemetry=tel)
        Xt = torch.from_numpy(X_np)
        runs[tel] = [Xt, ta.init(Xt, hp), hp]
    for k in range(steps):
        key = jax.random.PRNGKey(100 + k)
        Xj, ej = ja.step(Xj, ej, jnp.asarray(g_np), 0.1, k, key, jhp)
        for r in runs.values():
            r[0], r[1] = ta.step(r[0], r[1], torch.from_numpy(g_np), 0.1, k,
                                 int(jops._key_to_seed(key)), r[2])
    return (Xj, ej), runs[False][:2], runs[True][:2]


@pytest.mark.parametrize("name", ["dpsgd", "moniqua", "d2", "moniqua_d2"])
def test_rule_trajectory_unchanged_and_health_matches_reference(name):
    """Three steps: X and extra bitwise with telemetry on or off; the
    carried health (cumulative alias count threaded) equals the
    reference's eager steps'; X equals the reference's."""
    (Xj, ej), (Xoff, eoff), (Xon, eon) = _rule_runs(name)
    assert torch.equal(Xoff, Xon)
    np.testing.assert_array_equal(Xon.numpy(), np.asarray(Xj))
    assert "health" not in eoff
    eon_rest = {k: v for k, v in eon.items() if k != "health"}
    assert tree.flatten(eoff)[1] == tree.flatten(eon_rest)[1]
    for a, b in zip(tree.leaves(eoff), tree.leaves(eon_rest)):
        assert torch.equal(a, b)
    _assert_health_equal(ej["health"], eon["health"], TM.HEALTH_KEYS)
    assert int(eon["health"]["alias_total"]) == 0
    assert float(eon["health"]["consensus_inf"]) > 0.0


@pytest.mark.parametrize("name", ["moniqua", "moniqua_d2"])
def test_rules_on_the_ef_wire_carry_wire_state_and_health(name):
    """Moniqua and Moniqua-D² on the ``ef_qsgd`` wire (Moniqua-D² keeps its
    WireState under ``extra["wire"]``, as in the reference): bitwise the
    reference's eager steps, WireState included; the residual norm in the
    health."""
    (Xj, ej), (Xoff, eoff), (Xon, eon) = _rule_runs(name, wire="ef_qsgd")
    np.testing.assert_array_equal(Xon.numpy(), np.asarray(Xj))
    assert torch.equal(Xoff, Xon)
    for k in ("residual", "step"):
        np.testing.assert_array_equal(eon["wire"][k].numpy(),
                                      np.asarray(ej["wire"][k]))
    _assert_health_equal(ej["health"], eon["health"], TM.HEALTH_KEYS)
    assert float(eon["health"]["ef_residual_l2"]) > 0.0


# ---------------------------------------------------------------------------
# Phase labels
# ---------------------------------------------------------------------------

def _profiled_keys(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.key for e in prof.key_averages()}


def test_phase_labels_under_the_profiler():
    """Under a profiler a K = 5 round labels every chunk's encode, permute
    and decode-reduce, and the telemetry; a tiered round its intra reduce;
    ``mix_stale`` its decode-reduce and encode.  Without one no label is
    entered."""
    X = _to_cpu(_tree_np())
    _, te = _engines("moniqua", 8, "bucketed", 5)
    assert te.round_plan(X, theta=THETA, seed=3).num_chunks == 5
    keys = _profiled_keys(lambda: te.mix(X, theta=THETA, seed=3))
    for phase in ("comm.encode", "comm.permute", "comm.decode_reduce"):
        for i in range(5):
            assert f"{phase}/chunk{i:02d}of05" in keys, (phase, i)
    assert "comm.telemetry" in keys
    _, tiered = _engines("moniqua", 8, "bucketed", 1, topo="two_tier")
    keys = _profiled_keys(lambda: tiered.mix(X, theta=THETA, seed=3))
    assert {"comm.intra_reduce", "comm.encode", "comm.permute",
            "comm.decode_reduce"} <= keys
    carry = te.init_gossip_carry(X)
    keys = _profiled_keys(lambda: te.mix_stale(X, carry, theta=THETA,
                                               seed=3))
    assert {"comm.encode", "comm.decode_reduce", "comm.telemetry"} <= keys
    assert set(TTR.COMM_PHASES) <= {"comm.encode", "comm.permute",
                                    "comm.decode_reduce", "comm.telemetry"}
    assert not TTR.labels_on()
    assert not isinstance(TTR.named_phase("comm.encode"),
                          torch.profiler.record_function)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(TTR.chunk_phase("comm.encode", 3, 8),
                          torch.profiler.record_function)
    assert isinstance(TTR.trace_annotation("x"),
                      torch.profiler.record_function)


# ---------------------------------------------------------------------------
# Run logs and Chrome traces
# ---------------------------------------------------------------------------

def test_runlog_roundtrip_validates_in_both_packages(tmp_path):
    """A port run log (0-dim tensors among the values) passes the
    reference's validator and reads back; a reference log passes the
    port's; malformed logs draw the same errors from both."""
    path = str(tmp_path / "run.jsonl")
    rec = TTR.SpanRecorder()
    with rec.span("phase.a", tid="t0", step=1):
        pass
    with TRL.RunLogWriter(path, run={"algo": "moniqua", "bits": 8,
                                     "theta": torch.tensor(2.0)}) as w:
        w.step(0, {"loss": torch.tensor(1.5), "obs_alias_count":
                   torch.tensor(0, dtype=torch.int32),
                   "obs_alias_total": 0})
        w.step(5, {"loss": 1.2, "obs_alias_count": 2, "obs_alias_total": 3})
        w.spans_from(rec)
        w.event("checkpoint", {"step": 5})
        w.result(steps=6, bytes_per_step=1234)
    assert JRL.validate_runlog(path) == [] == TRL.validate_runlog(path)
    records = TRL.read_runlog(path)
    assert records[0]["schema"] == TRL.SCHEMA == JRL.SCHEMA
    assert records[0]["run"]["theta"] == 2.0
    assert len(TRL.step_records(records)) == 2
    assert TRL.alias_events(records) == 3 == JRL.alias_events(records)
    jpath = str(tmp_path / "ref.jsonl")
    with JRL.RunLogWriter(jpath, run={"algo": "dpsgd"}) as w:
        w.step(0, {"loss": 1.0})
    assert TRL.validate_runlog(jpath) == []
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write(json.dumps({"kind": "step", "step": 0, "metrics": {}}) + "\n")
        f.write(json.dumps({"kind": "wat"}) + "\n")
        f.write(json.dumps({"kind": "span", "name": "x", "t0_s": -1.0,
                            "dur_s": 0.1}) + "\n")
    assert TRL.validate_runlog(bad) == JRL.validate_runlog(bad) != []


def test_span_recorder_chrome_export_is_the_references():
    """The same spans export to the reference's Chrome object; it
    validates in both packages; merging keeps the pids."""
    rec = TTR.SpanRecorder()
    with rec.span("outer", tid="train", step=0):
        with rec.span("inner", tid="train"):
            pass
    rec.instant("marker", tid="train")
    jrec = JTR.SpanRecorder()
    jrec.events = [dict(e) for e in rec.events]
    obj = rec.to_chrome(process_name="test")
    assert obj == jrec.to_chrome(process_name="test")
    assert TTR.validate_chrome(obj) == [] == JTR.validate_chrome(obj)
    phases = {e["name"]: e["ph"] for e in obj["traceEvents"]
              if e["ph"] in ("X", "i")}
    assert phases["marker"] == "i" and phases["outer"] == "X"
    merged = TTR.merge_chrome_traces([obj, TTR.chrome_trace(
        [{"name": "s", "t0_s": 0.0, "dur_s": 1.0}], pid=1)])
    assert {e.get("pid") for e in merged["traceEvents"]} == {0, 1}
    assert TTR.validate_chrome({"traceEvents": [{"ph": "X", "name": "a",
                                                 "ts": -1, "dur": 1}]})


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sim_trace_to_chrome_is_the_references(mode, tmp_path):
    """``SimTrace.to_chrome`` of the port's timeline == the reference's
    ``sim_trace_to_chrome`` of its own on the same scenario, and validates
    in both packages; saved and merged with a measured trace."""
    if mode == "sync":
        jt = jsim.events.simulate_sync_rounds(
            jsim.scenarios.get_scenario("lan-10gbe-ring", n=4), 10_000, 3)
        tt = tsim.events.simulate_sync_rounds(
            tsim.scenarios.get_scenario("lan-10gbe-ring", n=4), 10_000, 3)
    else:
        jt = jsim.events.simulate_async_gossip(
            jsim.scenarios.get_scenario("churn-ring"), 10_000, 40)
        tt = tsim.events.simulate_async_gossip(
            tsim.scenarios.get_scenario("churn-ring"), 10_000, 40)
    obj = tt.to_chrome()
    assert obj == JTR.sim_trace_to_chrome(jt)
    assert JTR.validate_chrome(obj) == [] == TTR.validate_chrome(obj)
    assert any(e.get("pid") == 1 for e in obj["traceEvents"])
    path = TTR.save_chrome_trace(obj, str(tmp_path / "sim.json"))
    with open(path) as f:
        assert JTR.validate_chrome(json.load(f)) == []


def test_drain_metrics_reads_every_metric_once():
    from repro_torch.train.trainer import drain_metrics
    m = {"loss": torch.tensor(1.25), "alpha": 0.1, "wire_bytes": 544564,
         "obs_alias_total": torch.tensor(7, dtype=torch.int32),
         "g_inf": torch.tensor(3.5)}
    out = drain_metrics(m)
    assert list(out) == list(m)
    assert out == {"loss": 1.25, "alpha": 0.1, "wire_bytes": 544564.0,
                   "obs_alias_total": 7.0, "g_inf": 3.5}
    assert all(type(v) is float for v in out.values())


def test_trainer_telemetry_runlog_and_trace(tmp_path):
    """``Trainer.run`` with telemetry, a run log and a trace on a tiny
    ResNet: params bitwise a telemetry-off run's; ``obs_*`` in the history
    (no alias at theta 2); the log passes the reference's validator and
    ``tools/check_obs.py --require-telemetry`` (by subprocess); the trace
    the reference's ``validate_chrome``, with ``train.step`` spans; the
    callback sees every logged step."""
    from repro_torch.data.synthetic import stacked_cifar_like
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.train.trainer import Trainer, TrainerConfig
    model = ResNetModel(depth=8, width=8, device="cpu")
    batches = [stacked_cifar_like(k, 4, 4, seed=0, device="cpu")
               for k in range(4)]
    log, tr = str(tmp_path / "run.jsonl"), str(tmp_path / "trace.json")
    kw = dict(algo="moniqua", n_workers=4, bits=8, theta=THETA, lr=0.3,
              steps=4, log_every=2, momentum=0.0, weight_decay=0.0)
    seen = []
    on = Trainer(model, TrainerConfig(telemetry=True, log_jsonl=log,
                                      trace_path=tr, **kw),
                 lambda k: batches[k]).run(callback=lambda k, m:
                                           seen.append(k))
    off = Trainer(model, TrainerConfig(**kw), lambda k: batches[k]).run()
    for a, b in zip(tree.leaves(on["state"]["params"]),
                    tree.leaves(off["state"]["params"])):
        assert torch.equal(a, b)
    assert seen == [0, 2, 3]
    h = on["history"][-1]
    assert h["obs_alias_total"] == 0
    assert 0.0 < h["obs_headroom"] < 0.5
    assert h["obs_bits_per_param"] == pytest.approx(8.0, abs=0.5)
    assert not any(k.startswith("obs_") for k in off["history"][-1])
    assert JRL.validate_runlog(log) == []
    records = JRL.read_runlog(log)
    assert records[0]["run"]["telemetry"] is True
    assert "obs_headroom" in JRL.step_records(records)[-1]["metrics"]
    assert any(r.get("kind") == "span" and r["name"] == "train.step"
               for r in records)
    assert any(r.get("kind") == "result" for r in records)
    with open(tr) as f:
        obj = json.load(f)
    assert JTR.validate_chrome(obj) == []
    assert sum(e.get("name") == "train.step" and e.get("ph") == "X"
               for e in obj["traceEvents"]) == 4
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "tools", "check_obs.py"), log,
                          "--trace", tr, "--require-telemetry"],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
