"""Elastic rounds of the port (presence masks) against the JAX package, on
the CPU.

Mirrors ``tests/test_elastic.py`` for the single-tier engine:

* full presence: ``presence`` all-ones is bitwise ``presence=None`` on every
  wire, both paths, K = 1 and K = 5, over 3 rounds with WireState, and for
  ``mix_stale``;
* partial masks (workers 2 and 5 absent on ring(8), worker 3 on
  exponential(8)): the port's round is bitwise the reference's eager round
  for ``full``, ``moniqua``, ``qsgd`` and ``ef_qsgd``, and within
  ``ONEBIT_ULPS`` ulp of each leaf's largest value for ``onebit`` (its
  cluster-mean sums take another order than XLA's, as in
  ``test_torch_overlap.py``);
* absent rows and EF residuals come back exactly, the mean is conserved on
  the full wire, and ``pair_average`` with a missing endpoint is the
  identity on every wire;
* ``AlgoHyper.presence`` through D-PSGD, Moniqua (barrier, stateful,
  stale), D² and Moniqua-D², ``TrainerConfig.presence`` end to end, and the
  analysis topologies to 1e-12.

The reference gets a JAX key; the port the hash seed the reference derives
from it (``kops._key_to_seed``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import engine as jeng
from repro.core import algorithms as jalg
from repro.core import topology as jtopo
from repro.core.moniqua import MoniquaCodec as JCodec
from repro.core.quantizers import QuantSpec as JSpec
from repro.kernels import ops as jops
from repro_torch import convert, tree
from repro_torch.comm import engine as teng
from repro_torch.core import algorithms as talg
from repro_torch.core import topology as ttopo
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec

N = 8
THETA = 2.0
ONEBIT_ULPS = 16
# (wire, bits): the codec matrix of tests/test_torch_overlap.py
WIRES = [("full", 32), ("moniqua", 8), ("moniqua", 1), ("qsgd", 8),
         ("ef_qsgd", 4), ("onebit", 1)]
WIRE_IDS = [f"{w}{b}" for w, b in WIRES]
PATHS = ("bucketed", "per_leaf")
# (topology, mask): two workers absent on the ring, one on exponential(8)
MASKS = [(("ring", N), (1, 1, 0, 1, 1, 0, 1, 1)),
         (("exponential", N), (1, 1, 1, 0, 1, 1, 1, 1))]
_to_cpu = functools.partial(convert.to_torch, device="cpu")


def _tree_np(n=N, scale=0.3, seed=0):
    """Several leaves with unaligned last dims (K = 5 splits mid-tree) and
    a scalar-per-worker leaf."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal((n,) + shape) * scale).astype(np.float32)
    return {"w": r(300), "b": r(17), "c": r(3, 7), "d": r(65), "e": r(129),
            "s": r()}


def _spec(bits):
    return dict(bits=min(bits, 8), stochastic=1 < bits <= 8)


def _engines(wire, bits, topo=("ring", N), path="bucketed", chunks=1,
             backend="jnp"):
    spec = _spec(bits)
    je = jeng.CommEngine(jtopo.get_topology(*topo),
                         jeng.make_wire(wire, JSpec(**spec), warmup=2),
                         backend=backend, path=path, chunks=chunks)
    te = teng.CommEngine(ttopo.get_topology(*topo),
                         teng.make_wire(wire, TSpec(**spec), warmup=2),
                         path=path, chunks=chunks)
    return je, te


def _kw(wire, key):
    """Per-round arguments: (reference's, port's)."""
    if wire == "full":
        return {}, {}
    j, t = dict(key=key), dict(seed=int(jops._key_to_seed(key)))
    if wire == "moniqua":
        j["theta"] = t["theta"] = THETA
    return j, t


def _close(ref, out, wire):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy()
    if wire != "onebit":
        np.testing.assert_array_equal(ref, out)
        return
    tol = ONEBIT_ULPS * np.finfo(np.float32).eps * max(
        1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


def _port_rounds(te, X0, presence, rounds=3, key0=70):
    """``rounds`` iterated port rounds under one mask; every round's
    ``(leaves, state)``."""
    X = X0
    st = te.init_wire_state(X0) if te.stateful else None
    out = []
    for k in range(rounds):
        _, kt = _kw(te.codec.name, jax.random.PRNGKey(key0 + k))
        r = te.mix(X, state=st, presence=presence, **kt)
        X, st = r.x, (r.state if te.stateful else None)
        out.append((tree.leaves(X), st))
    return out


def _assert_rounds_equal(a, b, what):
    for k, ((xa, sa), (xb, sb)) in enumerate(zip(a, b)):
        for la, lb in zip(xa, xb):
            assert torch.equal(la, lb), f"{what} round {k}"
        if sa is not None:
            assert torch.equal(sa["residual"], sb["residual"]), what
            assert torch.equal(sa["step"], sb["step"]), what


# -- full presence is the unmasked round, bit for bit -------------------------

@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
def test_all_ones_presence_bitexact(wire, bits, path, K):
    _, te = _engines(wire, bits, path=path, chunks=K)
    X0 = _to_cpu(_tree_np())
    _assert_rounds_equal(_port_rounds(te, X0, None),
                         _port_rounds(te, X0, (1,) * N), f"{wire} {path}")


@pytest.mark.parametrize("bits", [8, 1])
def test_mix_stale_all_ones_presence_bitexact(bits):
    _, te = _engines("moniqua", bits)
    X0 = _to_cpu(_tree_np())
    outs = []
    for presence in (None, (1,) * N):
        X, carry = X0, te.init_gossip_carry(X0)
        for k in range(3):
            r = te.mix_stale(X, carry, theta=THETA, seed=50 + k,
                             presence=presence)
            X, carry = r.x, r.state
        outs.append((tree.leaves(X), carry))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    for name in ("packed", "ref", "B", "valid"):
        assert torch.equal(outs[0][1][name], outs[1][1][name]), name


# -- partial masks against the reference --------------------------------------

def _masked_against_reference(wire, bits, topo, mask, path, backend="jnp",
                              rounds=3):
    je, te = _engines(wire, bits, topo, path, backend=backend)
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    Xt = _to_cpu(_tree_np())
    sj = je.init_wire_state(Xj) if je.stateful else None
    st = te.init_wire_state(Xt) if te.stateful else None
    for k in range(rounds):
        kj, kt = _kw(wire, jax.random.PRNGKey(70 + k))
        rj = je.mix(Xj, state=sj, presence=mask, **kj)
        rt = te.mix(Xt, state=st, presence=mask, **kt)
        Xj, Xt = rj.x, rt.x
        for a, b in zip(jax.tree.leaves(Xj), tree.leaves(Xt)):
            _close(a, b, wire)
        if te.stateful:
            sj, st = rj.state, rt.state
            _close(sj["residual"], st["residual"], wire)
            assert int(st["step"]) == k + 1 and st["step"].dtype == \
                torch.int32


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("topo,mask", MASKS, ids=["ring", "exponential"])
@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
def test_partial_mask_matches_reference(wire, bits, topo, mask, path):
    _masked_against_reference(wire, bits, topo, mask, path)


def test_masked_moniqua_matches_reference_pallas_interpret():
    """One masked round against the reference's Pallas kernels (interpret
    mode): one single-weight decode-reduce per offset there too."""
    _masked_against_reference("moniqua", 8, ("exponential", N), MASKS[1][1],
                              "bucketed", backend="pallas", rounds=1)


@pytest.mark.parametrize("topo,mask", MASKS, ids=["ring", "exponential"])
@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
def test_masked_chunks_equal_barrier(wire, bits, topo, mask):
    """K = 5 masked rounds are bitwise the K = 1 masked rounds, WireState
    included."""
    X0 = _to_cpu(_tree_np())
    _, t1 = _engines(wire, bits, topo)
    _, t5 = _engines(wire, bits, topo, chunks=5)
    _assert_rounds_equal(_port_rounds(t1, X0, mask),
                         _port_rounds(t5, X0, mask), f"{wire} K=5")


@pytest.mark.parametrize("wire,bits", [("moniqua", 8), ("moniqua", 1),
                                       ("ef_qsgd", 4), ("onebit", 1)])
def test_masked_bucketed_equals_per_leaf(wire, bits):
    """The wires whose per-leaf rounds hash the bucket's global indices
    agree bitwise across paths under a mask too."""
    X0 = _to_cpu(_tree_np())
    topo, mask = MASKS[0]
    _, tb = _engines(wire, bits, topo, "bucketed")
    _, tp = _engines(wire, bits, topo, "per_leaf")
    _assert_rounds_equal(_port_rounds(tb, X0, mask),
                         _port_rounds(tp, X0, mask), f"{wire} paths")


def test_masked_full_wire_paths_sum_in_their_own_orders():
    """The masked full wire's two paths add the gated diffs in different
    orders (bucketed: into ``out`` offset by offset; per-leaf: into ``acc``
    then ``x + acc``), as in the reference: each is bitwise the
    reference's own path (above), and they agree within 2 ulp."""
    X0 = _to_cpu(_tree_np())
    topo, mask = MASKS[1]
    _, tb = _engines("full", 32, topo, "bucketed")
    _, tp = _engines("full", 32, topo, "per_leaf")
    xb = tb.mix(X0, presence=mask).x
    xp = tp.mix(X0, presence=mask).x
    for a, b in zip(tree.leaves(xb), tree.leaves(xp)):
        tol = 2 * np.finfo(np.float32).eps * float(b.abs().max())
        assert float((a - b).abs().max()) <= tol


# -- absent workers, mean, normalization --------------------------------------

@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("topo,mask", MASKS, ids=["ring", "exponential"])
@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
def test_absent_workers_exact_identity(wire, bits, topo, mask, path):
    _, te = _engines(wire, bits, topo, path)
    X0 = _to_cpu(_tree_np())
    absent = [i for i in range(N) if not mask[i]]
    st = te.init_wire_state(X0) if te.stateful else None
    if st is not None:       # a nonzero residual to carry through
        st = dict(st, residual=torch.randn(st["residual"].shape,
                                           generator=torch.Generator()
                                           .manual_seed(3)) * 0.01)
    _, kt = _kw(wire, jax.random.PRNGKey(0))
    res = te.mix(X0, state=st, presence=mask, **kt)
    moved = False
    for a, b in zip(tree.leaves(res.x), tree.leaves(X0)):
        for i in absent:
            assert torch.equal(a[i], b[i])
        moved = moved or not torch.equal(a, b)
    assert moved
    if te.stateful:
        for i in absent:
            assert torch.equal(res.state["residual"][i], st["residual"][i])
        assert int(res.state["step"]) == 1     # advances for everyone


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("topo,mask", MASKS, ids=["ring", "exponential"])
def test_mixed_mean_conserved_under_mask(topo, mask, path):
    _, te = _engines("full", 32, topo, path)
    X0 = _to_cpu(_tree_np())
    res = te.mix(X0, presence=mask)
    for a, b in zip(tree.leaves(res.x), tree.leaves(X0)):
        np.testing.assert_allclose(a.mean(0).numpy(), b.mean(0).numpy(),
                                   rtol=0, atol=1e-6)


def test_presence_normalization_and_helpers():
    topo = ttopo.ring(N)
    assert teng._normalize_presence(None, N) is None
    assert teng._normalize_presence([1] * N, N) is None
    assert teng._normalize_presence([2, 0, 1, 1, 1, 1, 1, 1], N) == \
        (1, 0, 1, 1, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="length"):
        teng._normalize_presence((1, 0), N)
    p = MASKS[0][1]
    cpu = torch.device("cpu")
    alive = teng._alive_cols(p, 1, cpu)
    assert alive.shape == (N, 1) and alive.dtype == torch.bool
    assert alive[:, 0].tolist() == [bool(p[i] and p[(i + 1) % N])
                                    for i in range(N)]
    assert teng._alive_cols(p, 1, cpu) is alive        # cached per device
    assert teng._present_cols(p, cpu, 3).shape == (N, 1, 1)
    assert teng._dropped_edge_count(p, topo) == jeng._dropped_edge_count(
        p, jtopo.ring(N)) == 8
    with pytest.raises(ValueError, match="length"):
        teng.CommEngine(topo).mix(_to_cpu(_tree_np()), theta=THETA, seed=1,
                                  presence=(1, 0, 1))


# -- mix_stale under a mask ---------------------------------------------------

@pytest.mark.parametrize("topo,mask", MASKS, ids=["ring", "exponential"])
@pytest.mark.parametrize("bits", [8, 1])
def test_masked_mix_stale_matches_reference(bits, topo, mask):
    """Three masked stale rounds bitwise, carry included; the absent rows
    apply no delta."""
    je, te = _engines("moniqua", bits, topo)
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    Xt = _to_cpu(_tree_np())
    cj, ct = je.init_gossip_carry(Xj), te.init_gossip_carry(Xt)
    for k in range(3):
        kj, kt = _kw("moniqua", jax.random.PRNGKey(200 + k))
        rj = je.mix_stale(Xj, cj, presence=mask, **kj)
        rt = te.mix_stale(Xt, ct, presence=mask, **kt)
        for i in (i for i in range(N) if not mask[i]):
            for a, b in zip(tree.leaves(rt.x), tree.leaves(Xt)):
                assert torch.equal(a[i], b[i] + 0.0)
        Xj, cj, Xt, ct = rj.x, rj.state, rt.x, rt.state
        for a, b in zip(jax.tree.leaves(Xj), tree.leaves(Xt)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for name in ("packed", "ref", "B", "valid"):
            np.testing.assert_array_equal(np.asarray(cj[name]),
                                          ct[name].numpy(), err_msg=name)


# -- pair_average: a missing endpoint is the identity exchange ---------------

PAIR_WIRES = [("full", 32), ("moniqua", 2), ("moniqua", 8), ("qsgd", 4),
              ("ef_qsgd", 4), ("onebit", 1)]


@pytest.mark.parametrize("wire,bits", PAIR_WIRES,
                         ids=[f"{w}{b}" for w, b in PAIR_WIRES])
def test_pair_average_presence_identity(wire, bits):
    """(1, 0), (0, 1), (0, 0): both models and both EF carries come back
    as they went in (counters not advanced).  (1, 1) and all-ones-as-None
    exchange, bitwise the reference's output, and here the inputs are
    chosen so that the exchange moves both endpoints (theta 0.5: the
    codes of the two endpoints differ)."""
    je, te = _engines(wire, bits, ("ring", 2))
    rng = np.random.default_rng(5)
    xi_np = rng.standard_normal(37).astype(np.float32)
    xj_np = (xi_np + 0.3 * rng.standard_normal(37)).astype(np.float32)
    xi, xj = torch.from_numpy(xi_np), torch.from_numpy(xj_np)
    kt = dict(theta=0.5, seed=int(jops._key_to_seed(jax.random.PRNGKey(2))))
    kw = {}
    if te.stateful:
        kw = dict(state_i=te.init_edge_state(xi),
                  state_j=te.init_edge_state(xj))
        kw["state_i"]["residual"] += 0.01
    for presence in ((1, 0), (0, 1), (0, 0), [0, 0]):
        res = te.pair_average(xi, xj, presence=presence, **kt, **kw)
        assert torch.equal(res.xi, xi) and torch.equal(res.xj, xj)
        if te.stateful:
            for s, s0 in ((res.state_i, kw["state_i"]),
                          (res.state_j, kw["state_j"])):
                assert torch.equal(s["residual"], s0["residual"])
                assert int(s["step"]) == 0
        else:
            assert res.state_i == res.state_j == {}
    kj = dict(theta=0.5, key=jax.random.PRNGKey(2))
    jkw = {k: jax.tree.map(lambda t: jnp.asarray(t.numpy()), v)
           for k, v in kw.items()}
    ref = je.pair_average(jnp.asarray(xi_np), jnp.asarray(xj_np),
                          presence=(1, 1), **kj, **jkw)
    for presence in ((1, 1), None):
        res = te.pair_average(xi, xj, presence=presence, **kt, **kw)
        np.testing.assert_array_equal(np.asarray(ref.xi), res.xi.numpy())
        np.testing.assert_array_equal(np.asarray(ref.xj), res.xj.numpy())
        assert not torch.equal(res.xi, xi) and not torch.equal(res.xj, xj)
        if te.stateful:
            assert int(res.state_i["step"]) == 1


# -- AlgoHyper.presence through the update rules ------------------------------

def _algo_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal((N,) + shape) * scale).astype(np.float32)
    return {"conv": r(3, 3, 2, 5), "w": r(7, 13), "s": r(),
            "blocks": [{"b": r(11)}]}


RULES = [("dpsgd", {}), ("moniqua", {}), ("moniqua", dict(wire="ef_qsgd")),
         ("moniqua", dict(overlap="stale")), ("d2", {}), ("moniqua_d2", {})]


@pytest.mark.parametrize("topo,mask", MASKS, ids=["ring", "exponential"])
@pytest.mark.parametrize("name,over", RULES,
                         ids=["dpsgd", "moniqua", "moniqua-ef_qsgd",
                              "moniqua-stale", "d2", "moniqua_d2"])
def test_rule_with_presence_matches_reference(name, over, topo, mask):
    """Three steps of each rule that takes the mask, with it set, bitwise
    the reference's (X and extra), and not the unmasked trajectory."""
    jt, tt = jtopo.get_topology(*topo), ttopo.get_topology(*topo)
    if name in ("d2", "moniqua_d2"):
        jt, tt = jt.slack(0.75), tt.slack(0.75)
    spec = dict(bits=8, stochastic=True)
    # the reference's "auto" path may pick per-leaf: pin the port's default
    kw = dict(theta=THETA, presence=mask, deadline=0.25, path="bucketed",
              **over)
    jhp = jalg.AlgoHyper(topo=jt, codec=JCodec(JSpec(**spec)), **kw)
    thp = talg.AlgoHyper(topo=tt, codec=TCodec(TSpec(**spec)), **kw)
    ja, ta = jalg.get_algorithm(name), talg.get_algorithm(name)
    X_np = _algo_tree(0)
    Xj = jax.tree.map(jnp.asarray, X_np)
    ej = ja.init(Xj, jhp)
    Xt, et = _to_cpu(X_np), _to_cpu(jax.tree.map(np.asarray, ej))
    Xu, eu = Xt, ta.init(Xt, thp)
    hp_none = talg.AlgoHyper(topo=tt, codec=TCodec(TSpec(**spec)),
                             **dict(kw, presence=None))
    key = jax.random.PRNGKey(7)
    for k in range(3):
        key, kq = jax.random.split(key)
        g_np = _algo_tree(100 + k, scale=0.1)
        Xj, ej = ja.step(Xj, ej, jax.tree.map(jnp.asarray, g_np), 0.05, k,
                         kq, jhp)
        seed = int(jops._key_to_seed(kq))
        Xt, et = ta.step(Xt, et, _to_cpu(g_np), 0.05, k, seed, thp)
        Xu, eu = ta.step(Xu, eu, _to_cpu(g_np), 0.05, k, seed, hp_none)
    for a, b in zip(jax.tree.leaves(Xj), tree.leaves(Xt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(ej), tree.leaves(et)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert any(not torch.equal(a, b) for a, b in
               zip(tree.leaves(Xt), tree.leaves(Xu)))


def test_trainer_config_presence_end_to_end():
    """TrainerConfig.presence and .deadline reach AlgoHyper as the
    reference's build_hyper passes them; all-ones trains bitwise the
    unmasked run; a partial mask trains, deterministically, to other
    params; and the absent worker's D-PSGD trajectory is its trajectory
    when nobody gossips (every edge dead)."""
    from repro.train import trainer as jtrainer
    from repro_torch.data.synthetic import stacked_cifar_like
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.train.trainer import Trainer, TrainerConfig, build_hyper

    mask = [1, 0, 1, 1]
    jhp = jtrainer.build_hyper(jtrainer.TrainerConfig(
        n_workers=4, presence=mask, deadline=0.5))
    thp = build_hyper(TrainerConfig(n_workers=4, presence=mask,
                                    deadline=0.5))
    assert thp.presence == jhp.presence == (1, 0, 1, 1)
    assert thp.deadline == jhp.deadline == 0.5
    assert build_hyper(TrainerConfig()).presence is None

    model = ResNetModel(depth=8, width=8, device="cpu")
    batches = [stacked_cifar_like(k, 16, 4, seed=0, device="cpu")
               for k in range(3)]

    def run(algo, presence):
        tc = TrainerConfig(algo=algo, n_workers=4, bits=8, theta=2.0,
                           lr=0.1, steps=3, log_every=1, presence=presence)
        out = Trainer(model, tc, lambda k: batches[k]).run()
        assert all(np.isfinite(h["loss"]) for h in out["history"])
        return tree.leaves(out["state"]["params"])

    none, ones = run("moniqua", None), run("moniqua", (1, 1, 1, 1))
    masked, again = run("moniqua", mask), run("moniqua", mask)
    assert all(torch.equal(a, b) for a, b in zip(none, ones))
    assert all(torch.equal(a, b) for a, b in zip(masked, again))
    assert any(not torch.equal(a, b) for a, b in zip(none, masked))
    alone = run("dpsgd", (0, 0, 0, 0))
    for a, b in zip(run("dpsgd", mask), alone):
        assert torch.equal(a[1], b[1])


# -- the analysis topologies ---------------------------------------------------

TOPOS = [("ring", 8), ("exponential", 8), ("torus", 9), ("complete", 5),
         ("ring", 2)]


def _masks(n):
    return [tuple(1 for _ in range(n)), tuple(int(i != 1) for i in range(n)),
            tuple(int(i % 3 != 0) for i in range(n)),
            tuple(0 for _ in range(n))]


def _assert_analysis_equal(j, t):
    attr = "window_matrix" if hasattr(j, "window_matrix") else "matrix"
    np.testing.assert_allclose(getattr(t, attr), getattr(j, attr), rtol=0,
                               atol=1e-12)
    for attr in ("rho", "phi", "t_mix_bound"):
        a, b = getattr(j, attr), getattr(t, attr)
        assert (a == b) if np.isinf(a) else abs(a - b) <= 1e-12, attr
    assert t.n == j.n and t.name == j.name


@pytest.mark.parametrize("name,n", TOPOS)
def test_masked_topology_matches_reference(name, n):
    jt, tt = jtopo.get_topology(name, n), ttopo.get_topology(name, n)
    _assert_analysis_equal(jt, tt)
    for mask in _masks(n):
        j, t = jt.with_presence(mask), tt.with_presence(mask)
        assert t.presence == j.presence
        _assert_analysis_equal(j, t)
        W = t.matrix
        np.testing.assert_allclose(W.sum(0), 1.0, atol=1e-12)
        np.testing.assert_allclose(W, W.T, atol=0)
        for i in range(n):
            if not mask[i]:
                assert W[i, i] == 1.0
    np.testing.assert_array_equal(tt.with_presence((1,) * n).matrix,
                                  tt.matrix)
    with pytest.raises(ValueError, match="length"):
        tt.with_presence((1,) * (n + 1))


@pytest.mark.parametrize("name,n", TOPOS[:3])
def test_time_varying_topology_matches_reference(name, n):
    jt, tt = jtopo.get_topology(name, n), ttopo.get_topology(name, n)
    masks = _masks(n)[1:3]
    js = jtopo.TimeVaryingTopology(
        (jt,) + tuple(jt.with_presence(m) for m in masks))
    ts = ttopo.TimeVaryingTopology(
        (tt,) + tuple(tt.with_presence(m) for m in masks))
    _assert_analysis_equal(js, ts)
    assert len(ts) == 3 and ts.at(4).name == js.at(4).name
    # slack applies per round to circulant entries (as in the reference)
    _assert_analysis_equal(
        jtopo.TimeVaryingTopology((jt, jt.slack(0.9))).slack(0.5),
        ttopo.TimeVaryingTopology((tt, tt.slack(0.9))).slack(0.5))
    assert ts.rho <= max(t.rho for t in ts.schedule) + 1e-12
    with pytest.raises(ValueError):
        ttopo.TimeVaryingTopology(())
    with pytest.raises(ValueError):
        ttopo.TimeVaryingTopology((tt, ttopo.ring(n + 1)))
