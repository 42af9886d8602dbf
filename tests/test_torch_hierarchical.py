"""Two-tier rounds of the port against the JAX package, on the CPU.

Mirrors ``tests/test_hierarchical.py`` for the port's ``TieredPlan``:

* the trivial tier ``two_tier(8, 1)`` is bitwise the single-tier bucketed
  round on ``ring(8)``, outputs and WireState, on every wire at K = 1 and 5;
* on ``two_tier(8, 2)`` and ``two_tier(8, 4)`` the port's round is bitwise
  the reference's eager jnp round on every wire at K = 1 and 5 over 3
  rounds with WireState, except ``onebit``, whose cluster-mean levels are
  float32 sums taken in another order than XLA's and are held within
  ``ONEBIT_ULPS`` ulp of each leaf's largest value (as in
  ``test_torch_overlap.py``); the owned-shard payload bytes are bitwise;
* the full wire's round is the ``kron(W_inter, J/k)`` matrix; the slow
  bytes shrink ``n_intra``-fold and the ledger splits fast and slow; the
  owned-shard WireState; ``path="auto"`` on a shard's own census; the
  single-tier entry points raise; slack on the inter tier only;
  ``AlgoHyper(tiers=)`` and ``TrainerConfig(tiers=)``;
* per-node presence: all-ones is bitwise ``None``, and an absent node keeps
  its intra average and its residual rows, bitwise the reference's;
* ``BucketLayout.shard`` / ``BucketChunk.chunks`` windows are the
  reference's, more workers than slots included.

The reference runs on its ``jnp`` backend, which its own tests hold bitwise
to its Pallas path; it gets a JAX key, the port the hash seed the reference
derives from it (``kops._key_to_seed``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import engine as jeng
from repro.comm.gossip import BytesLedger as JLedger
from repro.core import algorithms as jalg
from repro.core import topology as jtopo
from repro.core.moniqua import MoniquaCodec as JCodec
from repro.core.quantizers import QuantSpec as JSpec
from repro.kernels import ops as jops
from repro_torch import convert, tree
from repro_torch.comm import bucket as tbucket
from repro_torch.comm import engine as teng
from repro_torch.comm.gossip import BytesLedger as TLedger
from repro_torch.core import algorithms as talg
from repro_torch.core import topology as ttopo
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.kernels import ops as tops

N = 8
THETA = 2.0
ONEBIT_ULPS = 16
WIRES = [("full", 32), ("moniqua", 8), ("moniqua", 1), ("qsgd", 8),
         ("ef_qsgd", 4), ("onebit", 1)]
WIRE_IDS = [f"{w}{b}" for w, b in WIRES]
TIERS = [2, 4]
_to_cpu = functools.partial(convert.to_torch, device="cpu")


def _tree_np(n=N, scale=0.3, seed=0):
    """Leaves with unaligned last dims (K = 5 and the shards split
    mid-tree) and a scalar-per-worker leaf."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal((n,) + shape) * scale).astype(np.float32)
    return {"w": r(300), "b": r(17), "c": r(3, 7), "d": r(65), "e": r(129),
            "s": r()}


def _spec(bits):
    return dict(bits=min(bits, 8), stochastic=1 < bits <= 8)


def _engines(wire, bits, n_intra, chunks=1, n=N, path="auto"):
    spec = _spec(bits)
    je = jeng.CommEngine(jtopo.two_tier(n, n_intra),
                         jeng.make_wire(wire, JSpec(**spec), warmup=2),
                         backend="jnp", path=path, chunks=chunks)
    te = teng.CommEngine(ttopo.two_tier(n, n_intra),
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


def _port_rounds(te, X0, presence=None, rounds=3, key0=70):
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


# -- the trivial tier is the single-tier round -------------------------------

@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
def test_trivial_tier_bitexact_vs_single_tier(wire, bits, K):
    """two_tier(8, 1) rounds == ring(8) bucketed rounds, bitwise, iterated
    so WireState carries propagate; and == the reference's trivial tier."""
    spec = TSpec(**_spec(bits))
    single = teng.CommEngine(ttopo.ring(N), teng.make_wire(wire, spec,
                                                           warmup=2),
                             path="bucketed", chunks=K)
    je, tiered = _engines(wire, bits, 1, chunks=K)
    assert tiered.tiered and not single.tiered
    X0 = _to_cpu(_tree_np())
    got = _port_rounds(tiered, X0)
    _assert_rounds_equal(_port_rounds(single, X0), got, f"{wire} K={K}")
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    sj = je.init_wire_state(Xj) if je.stateful else None
    for k, (xs, st) in enumerate(got):
        kj, _ = _kw(wire, jax.random.PRNGKey(70 + k))
        rj = je.mix(Xj, state=sj, **kj)
        Xj, sj = rj.x, rj.state
        for a, b in zip(jax.tree.leaves(Xj), xs):
            _close(a, b, wire)
        if st is not None:
            _close(sj["residual"], st["residual"], wire)


# -- nontrivial tiers against the reference ----------------------------------

@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("n_intra", TIERS)
@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
def test_tiered_round_matches_reference(wire, bits, n_intra, K):
    je, te = _engines(wire, bits, n_intra, chunks=K)
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    Xt = _to_cpu(_tree_np())
    sj = je.init_wire_state(Xj) if je.stateful else None
    st = te.init_wire_state(Xt) if te.stateful else None
    if te.stateful:
        assert tuple(st["residual"].shape) == tuple(sj["residual"].shape) \
            == (N // n_intra, te.layout(Xt).padded_elems)
    for k in range(3):
        kj, kt = _kw(wire, jax.random.PRNGKey(70 + k))
        rj = je.mix(Xj, state=sj, **kj)
        rt = te.mix(Xt, state=st, **kt)
        Xj, Xt = rj.x, rt.x
        for a, b in zip(jax.tree.leaves(Xj), tree.leaves(Xt)):
            _close(a, b, wire)
        # every worker of a node leaves with the node's model
        for leaf in tree.leaves(Xt):
            nodes = leaf.reshape(N // n_intra, n_intra, -1)
            assert torch.equal(nodes, nodes[:, :1].expand_as(nodes))
        if te.stateful:
            sj, st = rj.state, rt.state
            _close(sj["residual"], st["residual"], wire)
            assert int(st["step"]) == k + 1 and st["step"].dtype == \
                torch.int32


@pytest.mark.parametrize("n_intra", TIERS)
@pytest.mark.parametrize("wire,bits", WIRES[1:], ids=WIRE_IDS[1:])
def test_shard_payloads_match_reference(wire, bits, n_intra):
    """Each owned shard's chunk payloads (K = 3), encoded from the intra
    reduce with global counter indices, are the reference's bytes."""
    je, te = _engines(wire, bits, n_intra, chunks=3)
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    Xt = _to_cpu(_tree_np())
    kj, kt = _kw(wire, jax.random.PRNGKey(5))
    sj = je.init_wire_state(Xj) if je.stateful else None
    st = te.init_wire_state(Xt) if te.stateful else None
    pj = je.tiered_plan(Xj, state=sj, theta=THETA, key=kj.get("key"))
    pt = te.tiered_plan(Xt, state=st, **dict(kt, theta=THETA))
    zj, zt = pj.intra_reduce(), pt.intra_reduce()
    np.testing.assert_array_equal(np.asarray(zj), zt.numpy())
    n_payloads = {"moniqua": 1, "qsgd": 2, "ef_qsgd": 2, "onebit": 3}[wire]
    for j in range(n_intra):
        if pt.layout.shard(n_intra, j).size == 0:
            continue
        sj_, st_ = pj.shard_plan(j, zj), pt.shard_plan(j, zt)
        assert [c.offset for c in st_.chunks] == \
            [c.offset for c in sj_.chunks]
        for i in range(st_.num_chunks):
            for a, b in zip(sj_.encode_chunk(i)[:n_payloads],
                            st_.encode_chunk(i)[:n_payloads]):
                if wire == "onebit" and b.dtype == torch.float32:
                    _close(a, b, wire)      # the lo/hi levels
                else:
                    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n,n_intra", [(8, 2), (8, 4), (12, 3)])
def test_full_wire_round_equals_kron_matrix(n, n_intra):
    """The executed full-wire round IS multiplication by
    kron(W_inter, J_k/k), and is bitwise the reference's round."""
    hier = ttopo.two_tier(n, n_intra)
    je, te = _engines("full", 32, n_intra, n=n)
    X_np = _tree_np(n)
    out = te.mix(_to_cpu(X_np)).x
    ref = je.mix(jax.tree.map(jnp.asarray, X_np)).x
    W = hier.matrix
    np.testing.assert_allclose(W, jtopo.two_tier(n, n_intra).matrix,
                               rtol=0, atol=0)
    for k in X_np:
        flat = X_np[k].astype(np.float64).reshape(n, -1)
        want = (W @ flat).reshape(X_np[k].shape)
        np.testing.assert_allclose(out[k].double().numpy(), want, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(ref[k]), out[k].numpy())


# -- accounting --------------------------------------------------------------

@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
def test_tiered_slow_axis_bytes_shrink_n_intra_fold(wire, bits):
    X_np = _tree_np(32)
    X = _to_cpu(X_np)
    Xj = jax.tree.map(jnp.asarray, X_np)
    spec = TSpec(**_spec(bits))
    single = teng.CommEngine(ttopo.ring(32), teng.make_wire(wire, spec),
                             path="bucketed")
    je, tiered = _engines(wire, bits, 4, n=32)
    pt = tiered.payload_bytes_per_broadcast(X)
    assert pt == -(-single._staged_payload_bytes(single.layout(X)) // 4)
    assert pt == je.payload_bytes_per_broadcast(Xj)
    padded = tiered.layout(X).padded_elems
    itemsize = 4      # float32 leaves; the EF wires stage in float32
    assert tiered.fast_bytes_per_round(X) == 2 * itemsize * padded * 3 // 4 \
        == je.fast_bytes_per_round(Xj)
    assert tiered.bytes_per_round(X) == je.bytes_per_round(Xj)
    assert single.fast_bytes_per_round(X) == 0
    # a trivial intra tier sends nothing on the fast axis
    assert _engines(wire, bits, 1, n=32)[1].fast_bytes_per_round(X) == 0


@pytest.mark.parametrize("n_intra", [1, 2, 4])
def test_ledger_splits_fast_and_slow_tiers(n_intra):
    je, te = _engines("moniqua", 2, n_intra)
    X_np = _tree_np()
    lt, lj = TLedger(), JLedger()
    te.mix(_to_cpu(X_np), theta=THETA, seed=1, ledger=lt)
    je.mix(jax.tree.map(jnp.asarray, X_np), theta=THETA,
           key=jax.random.PRNGKey(0), ledger=lj)
    m = len(te.gossip_topo.neighbor_offsets())
    assert lt.bytes_slow == te.payload_bytes_per_broadcast(
        _to_cpu(X_np)) * m
    assert lt.bytes_fast == te.fast_bytes_per_round(_to_cpu(X_np))
    assert lt.bytes_per_worker == lt.bytes_slow + lt.bytes_fast
    assert (lt.bytes_per_worker, lt.bytes_fast, lt.bytes_slow) == \
        (lj.bytes_per_worker, lj.bytes_fast, lj.bytes_slow)
    # single-tier rounds account everything as slow-axis
    l1 = TLedger()
    teng.CommEngine(ttopo.ring(N), teng.MoniquaWire(TSpec(2))).mix(
        _to_cpu(X_np), theta=THETA, seed=1, ledger=l1)
    assert l1.bytes_fast == 0 and l1.bytes_slow == l1.bytes_per_worker


@pytest.mark.parametrize("wire,bits", [("ef_qsgd", 4), ("onebit", 1)])
def test_tiered_wire_state_is_owned_shard_sized(wire, bits):
    X_np = _tree_np()
    X = _to_cpu(X_np)
    spec = TSpec(**_spec(bits))
    single = teng.CommEngine(ttopo.ring(N), teng.make_wire(wire, spec),
                             path="bucketed")
    for n_intra in (1, 2, 4):
        je, te = _engines(wire, bits, n_intra)
        padded = te.layout(X).padded_elems
        assert te.wire_state_bytes(X) == -(-padded // n_intra) * 4 + 4 \
            == je.wire_state_bytes(jax.tree.map(jnp.asarray, X_np))
        st = te.init_wire_state(X)
        assert tuple(st["residual"].shape) == (N // n_intra, padded)
        assert st["residual"].dtype == torch.float32
        assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
        if n_intra > 1:
            assert te.wire_state_bytes(X) < single.wire_state_bytes(X)
        else:
            assert te.wire_state_bytes(X) == single.wire_state_bytes(X)


# -- path="auto" on the shard census -----------------------------------------

def _census_tree(n=N):
    return {"big": np.zeros((n, 4096), np.float32),
            **{f"t{i:02d}": np.zeros((n, 3), np.float32) for i in range(12)}}


@pytest.mark.parametrize("wire,bits", [("moniqua", 2), ("qsgd", 8),
                                       ("full", 32)])
def test_auto_path_resolves_on_shard_census(wire, bits):
    """A shard resolves on its own leaves: the verdict of a standalone
    model holding exactly those leaves, and the reference's verdict."""
    X_np = _census_tree()
    X = _to_cpu(X_np)
    je, te = _engines(wire, bits, 2)
    spec = TSpec(**_spec(bits))
    flat_eng = teng.CommEngine(ttopo.ring(N), teng.make_wire(wire, spec))
    layout, jlayout = te.layout(X), je.layout(jax.tree.map(jnp.asarray,
                                                           X_np))
    for i in range(2):
        sh = layout.shard(2, i)
        sub = {f"l{j:02d}": torch.zeros((N,) + s.shape, dtype=s.dtype)
               for j, s in enumerate(sh.slots)}
        got = te.resolved_path(None, shard=sh)
        assert got == flat_eng.resolved_path(sub)
        assert got == je.resolved_path(None, shard=jlayout.shard(2, i))
    whole = layout.shard(1, 0)
    assert te.resolved_path(None, shard=whole) == flat_eng.resolved_path(X)
    # stateful wires always bucket, a named path is taken as it is
    assert _engines("ef_qsgd", 4, 2)[1].resolved_path(
        None, shard=layout.shard(2, 1)) == "bucketed"
    assert _engines(wire, bits, 2, path="per_leaf")[1].resolved_path(
        None, shard=layout.shard(2, 0)) == "per_leaf"


@pytest.mark.parametrize("path", ["auto", "bucketed", "per_leaf"])
def test_shard_chunk_counts_follow_the_census(path):
    """A shard resolved per-leaf runs one chunk a slot, like the
    reference's shard plans, on every path setting."""
    je, te = _engines("moniqua", 8, 4, chunks=2, path=path)
    X_np = _tree_np()
    pt = te.tiered_plan(_to_cpu(X_np), theta=THETA, seed=1)
    pj = je.tiered_plan(jax.tree.map(jnp.asarray, X_np), theta=THETA,
                        key=jax.random.PRNGKey(1))
    zt, zj = pt.intra_reduce(), pj.intra_reduce()
    for j in range(4):
        if pt.layout.shard(4, j).size == 0:
            continue
        a, b = pt.shard_plan(j, zt), pj.shard_plan(j, zj)
        assert [(c.offset, c.size) for c in a.chunks] == \
            [(c.offset, c.size) for c in b.chunks]
        assert a.base == b.base and a.topo.n == b.topo.n == 2


# -- guards ------------------------------------------------------------------

def test_single_tier_only_entry_points_raise():
    X = _to_cpu(_tree_np())
    _, eng = _engines("moniqua", 2, 2)
    with pytest.raises(ValueError):
        eng.round_plan(X, theta=THETA, seed=0)
    with pytest.raises(ValueError):
        eng.init_gossip_carry(X)
    with pytest.raises(ValueError):
        eng.mix_stale(X, {}, theta=THETA, seed=0)
    with pytest.raises(ValueError):
        eng.neighbor_sum(X, lambda x, o: x)
    with pytest.raises(ValueError):
        eng.self_weight()
    with pytest.raises(ValueError):   # moniqua tiered round needs theta
        eng.mix(X, seed=0)
    with pytest.raises(ValueError):   # a flat engine has no tiered plan
        teng.CommEngine(ttopo.ring(N)).tiered_plan(X, theta=THETA, seed=0)
    mixed = dict(X, b=X["b"].to(torch.bfloat16))
    with pytest.raises(ValueError):   # mixed dtypes on the full wire
        _engines("full", 32, 2)[1].mix(mixed)
    with pytest.raises(ValueError):   # the presence mask is per node
        eng.mix(X, theta=THETA, seed=0, presence=(1,) * N)
    with pytest.raises(TypeError):
        teng.CommEngine(ttopo.ring(N).with_presence((1,) * N))


# -- topology ----------------------------------------------------------------

@pytest.mark.parametrize("n,n_intra,inter", [(8, 1, "ring"), (8, 2, "ring"),
                                             (8, 4, "ring"),
                                             (12, 3, "ring"),
                                             (16, 2, "exponential"),
                                             (32, 4, "ring")])
def test_hierarchical_topology_matches_reference(n, n_intra, inter):
    t, j = ttopo.two_tier(n, n_intra, inter), jtopo.two_tier(n, n_intra,
                                                             inter)
    assert (t.name, t.n, t.n_intra, t.n_inter) == \
        (j.name, j.n, j.n_intra, j.n_inter)
    np.testing.assert_array_equal(t.matrix, j.matrix)
    assert t.rho == pytest.approx(j.rho, abs=1e-12)
    assert t.rho == pytest.approx(max(t.intra.rho, t.inter.rho), abs=1e-9)
    assert t.phi == pytest.approx(j.phi, abs=1e-12)
    assert t.t_mix_bound == pytest.approx(j.t_mix_bound, rel=1e-12)
    assert t.neighbor_offsets() == j.neighbor_offsets()


def test_two_tier_errors():
    for mod in (ttopo, jtopo):
        with pytest.raises(ValueError):
            mod.two_tier(8, 3)
        with pytest.raises(ValueError):
            mod.two_tier(8, 0)
        with pytest.raises(ValueError):
            mod.two_tier(8, 2, intra=mod.ring(4))
    assert ttopo.two_tier(8, 2, intra=ttopo.ring(2)).intra.name == "ring"


def test_slack_applies_to_inter_tier_only():
    hier = ttopo.two_tier(8, 2)
    slacked = hier.slack(0.5)
    np.testing.assert_allclose(slacked.intra.matrix, hier.intra.matrix)
    np.testing.assert_allclose(
        slacked.inter.matrix,
        0.5 * hier.inter.matrix + 0.5 * np.eye(4), atol=1e-12)
    np.testing.assert_array_equal(
        slacked.matrix, jtopo.two_tier(8, 2).slack(0.5).matrix)
    assert ttopo.two_tier(32, 4).neighbor_offsets() == (-4, 4)


# -- per-node presence --------------------------------------------------------

@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
def test_all_ones_presence_bitexact_tiered(wire, bits):
    _, te = _engines(wire, bits, 2, chunks=2)
    X0 = _to_cpu(_tree_np())
    _assert_rounds_equal(_port_rounds(te, X0, None),
                         _port_rounds(te, X0, (1,) * (N // 2)), wire)


@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
def test_absent_node_keeps_its_intra_average(wire, bits):
    """Node 1 (workers 2-3) absent on two_tier(8, 2): it comes back as its
    intra average with its residual rows untouched, the rest gossip among
    the present nodes; 3 rounds bitwise the reference's (onebit within
    ``ONEBIT_ULPS``)."""
    mask = (1, 0, 1, 1)
    je, te = _engines(wire, bits, 2)
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    Xt = _to_cpu(_tree_np())
    sj = je.init_wire_state(Xj) if je.stateful else None
    st = te.init_wire_state(Xt) if te.stateful else None
    for k in range(3):
        kj, kt = _kw(wire, jax.random.PRNGKey(70 + k))
        rj = je.mix(Xj, state=sj, presence=mask, **kj)
        rt = te.mix(Xt, state=st, presence=mask, **kt)
        for a, b in zip(tree.leaves(Xt), tree.leaves(rt.x)):
            # the intra tier's mix of workers 2 and 3, weights 1/2
            avg = a[2] * 0.5 + a[3] * 0.5
            assert torch.equal(b[2], avg) and torch.equal(b[3], avg)
        for a, b in zip(jax.tree.leaves(rj.x), tree.leaves(rt.x)):
            _close(a, b, wire)
        if te.stateful:
            assert torch.equal(rt.state["residual"][1], st["residual"][1])
            _close(rj.state["residual"], rt.state["residual"], wire)
            sj, st = rj.state, rt.state
        Xj, Xt = rj.x, rt.x


# -- shard windows and the chunk encode's counter base ------------------------

@pytest.mark.parametrize("align", [1, 8])
def test_shard_windows_match_reference(align):
    """``BucketLayout.shard`` and ``BucketChunk.chunks`` windows are the
    reference's, with empty trailing windows when there are more workers
    than slots (6 slots, 8-way axis)."""
    X_np = _tree_np()
    tl = tbucket.layout_of(_to_cpu(X_np), align)
    from repro.comm import bucket as jbucket
    jl = jbucket.layout_of(jax.tree.map(jnp.asarray, X_np), align)

    def desc(c):
        return (c.index, c.offset, c.size, len(c.slots))
    for size in (1, 2, 3, 4, 6, 8):
        shards = [tl.shard(size, j) for j in range(size)]
        assert [desc(c) for c in shards] == \
            [desc(jl.shard(size, j)) for j in range(size)]
        assert sum(c.size for c in shards) == tl.padded_elems
        assert tl.shard(size, 0) is tl.shard(size, 0)     # memoized
        for j, c in enumerate(shards):
            for k in (1, 2, 5):
                assert [desc(d) for d in c.chunks(k)] == \
                    [desc(d) for d in jl.shard(size, j).chunks(k)]
    assert [desc(tl.shard(8, j)) for j in (6, 7)] == \
        [(6, tl.padded_elems, 0, 0), (7, tl.padded_elems, 0, 0)]
    assert tl.shard(8, 7).chunks(3) == ()
    assert desc(tl.shard(1, 0)) == (0, 0, tl.padded_elems, tl.num_leaves)
    for bad in ((0, 0), (2, 2), (2, -1)):
        with pytest.raises(ValueError):
            tl.shard(*bad)


@pytest.mark.parametrize("bits,stochastic", [(8, True), (1, False)])
def test_encode_chunk_hashes_the_global_index(bits, stochastic):
    """A window sliced at a shard-local offset with ``idx_base`` = its
    global offset encodes to the whole buffer's bytes there, as the
    reference's does; without the override it does not."""
    spec = TSpec(bits, stochastic)
    rng = np.random.default_rng(4)
    flat_np = (rng.standard_normal((4, 4096)) * 0.7).astype(np.float32)
    flat = torch.from_numpy(flat_np)
    B = torch.tensor(8.0)
    whole = tops.moniqua_encode_stacked(flat, B, spec, 99)
    base, off, size = 1024, 512, 1536           # global window [1536, 3072)
    shard = flat[:, base:]
    got = tops.moniqua_encode_chunk(shard, off, size, B, spec, 99,
                                    idx_base=base + off)
    vpb = spec.values_per_byte
    want = whole[:, (base + off) // vpb:(base + off + size) // vpb]
    assert torch.equal(got, want)
    ref = jops.moniqua_encode_chunk(jnp.asarray(flat_np[:, base:]), off,
                                    size, jnp.float32(8.0),
                                    JSpec(bits, stochastic),
                                    jnp.uint32(99), backend="jnp",
                                    idx_base=base + off)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    if stochastic:
        local = tops.moniqua_encode_chunk(shard, off, size, B, spec, 99)
        assert not torch.equal(local, want)


# -- AlgoHyper(tiers=), the rules and the trainer ----------------------------

def test_algo_hyper_tiers_builds_hierarchy():
    hp = talg.AlgoHyper(topo=ttopo.ring(8), codec=TCodec(TSpec(bits=2)),
                        theta=THETA, tiers=4)
    jhp = jalg.AlgoHyper(topo=jtopo.ring(8), codec=JCodec(JSpec(bits=2)),
                         theta=THETA, tiers=4)
    hier = hp.comm_topo()
    assert hier.n == 8 and hier.n_intra == 4
    assert hier.inter.name == "ring" and hier.inter.n == 2
    assert hier.intra.matrix == pytest.approx(
        ttopo.fully_connected(4).matrix)
    assert hier.name == jhp.comm_topo().name
    assert hp.engine().tiered and hp.exact_engine().tiered
    assert hp.path == jhp.path == "auto"
    # tiers=1 stays flat; slack on the flat topo is replayed on the inter
    flat = talg.AlgoHyper(topo=ttopo.ring(8), codec=TCodec(TSpec(bits=2)))
    assert flat.comm_topo() is flat.topo and not flat.engine().tiered
    hp_s = dataclasses.replace(hp, topo=ttopo.ring(8).slack(0.5))
    jhp_s = dataclasses.replace(jhp, topo=jtopo.ring(8).slack(0.5))
    assert hp_s.comm_topo().inter.name.endswith("slack0.5")
    np.testing.assert_array_equal(hp_s.comm_topo().matrix,
                                  jhp_s.comm_topo().matrix)
    given = ttopo.two_tier(8, 2)
    assert dataclasses.replace(hp, topo=given).comm_topo() is given


def _algo_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal((N,) + shape) * scale).astype(np.float32)
    return {"conv": r(3, 3, 2, 5), "w": r(7, 13), "s": r(),
            "blocks": [{"b": r(11)}]}


RULES = [("dpsgd", {}), ("moniqua", {}), ("moniqua", dict(wire="ef_qsgd")),
         ("moniqua", dict(wire="qsgd")), ("d2", {}), ("moniqua_d2", {})]


@pytest.mark.parametrize("name,over", RULES,
                         ids=["dpsgd", "moniqua", "moniqua-ef_qsgd",
                              "moniqua-qsgd", "d2", "moniqua_d2"])
def test_rule_with_tiers_matches_reference(name, over):
    """Three steps of each rule that gossips through the engines, with
    ``tiers=2`` and each package's default path, bitwise the reference's
    (X and extra); bytes per step and extra memory its numbers."""
    jt, tt = jtopo.ring(N), ttopo.ring(N)
    if name in ("d2", "moniqua_d2"):
        jt, tt = jt.slack(0.75), tt.slack(0.75)
    spec = dict(bits=8, stochastic=True)
    kw = dict(theta=THETA, tiers=2, **over)
    jhp = jalg.AlgoHyper(topo=jt, codec=JCodec(JSpec(**spec)),
                         backend="jnp", **kw)
    thp = talg.AlgoHyper(topo=tt, codec=TCodec(TSpec(**spec)), **kw)
    ja, ta = jalg.get_algorithm(name), talg.get_algorithm(name)
    X_np = _algo_tree(0)
    Xj = jax.tree.map(jnp.asarray, X_np)
    ej = ja.init(Xj, jhp)
    Xt, et = _to_cpu(X_np), _to_cpu(jax.tree.map(np.asarray, ej))
    assert ta.bytes_per_step(Xt, thp) == ja.bytes_per_step(Xj, jhp)
    assert ta.extra_memory_bytes(Xt, thp) == ja.extra_memory_bytes(Xj, jhp)
    key = jax.random.PRNGKey(7)
    for k in range(3):
        key, kq = jax.random.split(key)
        g_np = _algo_tree(100 + k, scale=0.1)
        Xj, ej = ja.step(Xj, ej, jax.tree.map(jnp.asarray, g_np), 0.05, k,
                         kq, jhp)
        Xt, et = ta.step(Xt, et, _to_cpu(g_np), 0.05, k,
                         int(jops._key_to_seed(kq)), thp)
    for a, b in zip(jax.tree.leaves(Xj), tree.leaves(Xt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(ej), tree.leaves(et)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_trainer_config_tiers():
    """``TrainerConfig(tiers=)`` reaches the hyper and theta's rho, a tiered
    EF run carries its ``[n_inter, D]`` residual through a checkpoint and
    resumes bitwise."""
    from repro.train import trainer as jtrainer
    from repro_torch.data.synthetic import stacked_cifar_like
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.train.trainer import Trainer, TrainerConfig, build_hyper
    import tempfile

    thp = build_hyper(TrainerConfig(n_workers=4, tiers=2))
    jhp = jtrainer.build_hyper(jtrainer.TrainerConfig(n_workers=4, tiers=2))
    assert thp.tiers == jhp.tiers == 2
    assert thp.path == jhp.path == "auto"
    assert thp.comm_topo().name == jhp.comm_topo().name
    assert build_hyper(TrainerConfig(comm_path="per_leaf")).path == \
        "per_leaf"

    model = ResNetModel(depth=8, width=8, device="cpu")
    batches = [stacked_cifar_like(k, 16, 4, seed=0, device="cpu")
               for k in range(4)]

    def trainer(**kw):
        tc = TrainerConfig(n_workers=4, bits=8, theta=2.0, lr=0.1,
                           log_every=1, tiers=2, **kw)
        return Trainer(model, tc, lambda k: batches[k])

    tr = trainer(steps=2)
    assert tr.tcfg.theta.rho == pytest.approx(thp.comm_topo().rho)
    for algo in ("moniqua", "dpsgd"):
        out = trainer(algo=algo, steps=2).run()
        assert all(np.isfinite(h["loss"]) for h in out["history"])
    full = trainer(wire="ef_qsgd", steps=4).run()["state"]
    assert tuple(full["extra"]["wire"]["residual"].shape)[0] == 2
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/tiered"
        trainer(wire="ef_qsgd", steps=2, checkpoint_path=path,
                checkpoint_every=2).run()
        resumer = trainer(wire="ef_qsgd", steps=2, checkpoint_path=path)
        state = resumer.restore_state()
        assert tuple(state["extra"]["wire"]["residual"].shape)[0] == 2
        resumed = resumer.run(state)["state"]
    for a, b in zip(tree.leaves(full["params"]),
                    tree.leaves(resumed["params"])):
        assert torch.equal(a, b)
    assert torch.equal(full["extra"]["wire"]["residual"],
                       resumed["extra"]["wire"]["residual"])


@pytest.mark.parametrize("n,n_intra", [(8, 4), (4, 4)],
                         ids=["more-workers-than-slots", "one-node"])
@pytest.mark.parametrize("wire,bits", [("full", 32), ("moniqua", 8),
                                       ("ef_qsgd", 4)])
def test_degenerate_tiers_match_reference(wire, bits, n, n_intra):
    """Two leaves on a 4-way intra axis (shards 2 and 3 are empty
    windows, skipped), and a single node (the round is the intra average,
    the residual untouched): 2 rounds bitwise the reference's."""
    rng = np.random.default_rng(9)
    X_np = {"a": (rng.standard_normal((n, 40)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((n, 3, 5)) * 0.3).astype(np.float32)}
    je, te = _engines(wire, bits, n_intra, n=n)
    Xj, Xt = jax.tree.map(jnp.asarray, X_np), _to_cpu(X_np)
    sj = je.init_wire_state(Xj) if je.stateful else None
    st = te.init_wire_state(Xt) if te.stateful else None
    for k in range(2):
        kj, kt = _kw(wire, jax.random.PRNGKey(20 + k))
        rj = je.mix(Xj, state=sj, **kj)
        rt = te.mix(Xt, state=st, **kt)
        for a, b in zip(jax.tree.leaves(rj.x), tree.leaves(rt.x)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        if te.stateful:
            np.testing.assert_array_equal(np.asarray(rj.state["residual"]),
                                          rt.state["residual"].numpy())
            assert int(rt.state["step"]) == k + 1
            if n == n_intra:
                assert torch.equal(rt.state["residual"], st["residual"])
            sj, st = rj.state, rt.state
        Xj, Xt = rj.x, rt.x
