"""The port's bucket layout and CommEngine against the JAX package.

Exact equality throughout: bucket layouts on the ResNet-20 tree, eager
``CommEngine.mix(...).x`` on the ``full`` and ``moniqua`` wires (ring,
exponential, torus x 1/2/4/8 bits x both paths), the port's bucketed round
against its own per-leaf round, and the byte accounting.  The reference runs
its jnp backend eagerly; the port gets the reference's hash seed
(``kops._key_to_seed(key)``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import bucket as jbucket
from repro.comm import engine as jeng
from repro.comm.gossip import BytesLedger as JLedger
from repro.core import quantizers as jq
from repro.core import topology as jtopo
from repro.kernels import ops as jops
from repro.models import resnet as jresnet
from repro_torch import convert, tree
from repro_torch.comm import bucket as tbucket
from repro_torch.comm import engine as teng
from repro_torch.comm.gossip import BytesLedger as TLedger
from repro_torch.core import modulo as tmod
from repro_torch.core import quantizers as tq
from repro_torch.core import topology as ttopo
from repro_torch.kernels import ops as tops

BITS = [1, 2, 4, 8]
TOPOS = [("ring", 9), ("exponential", 9), ("torus", 9)]
_to_cpu = functools.partial(convert.to_torch, device="cpu")


def _tree_np(n=9, seed=0, scale=1.5):
    """Mixed-shape stacked tree: a conv-like 4-d leaf, a matrix with a
    ragged last dim, a scalar-per-worker leaf and a nested vector."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal((n,) + shape) * scale).astype(np.float32)
    return {"conv": r(3, 3, 2, 5), "w": r(7, 13), "s": r(),
            "blocks": [{"b": r(11)}]}


@functools.lru_cache(maxsize=None)
def _resnet20_np():
    return jax.tree.map(np.asarray, jresnet.init_resnet(
        jax.random.PRNGKey(0), depth=20, width=16))


def _resnet_tree_np(n=2):
    """ResNet-20 (width 16) params stacked over ``n`` workers."""
    return jax.tree.map(lambda a: np.broadcast_to(
        a[None], (n,) + a.shape).copy(), _resnet20_np())


def _both(name, n):
    return jtopo.get_topology(name, n), ttopo.get_topology(name, n)


def _wires(wire, bits):
    if wire == "full":
        return jeng.FullPrecisionWire(), teng.FullPrecisionWire()
    spec = dict(bits=bits, stochastic=bits > 1)
    return (jeng.MoniquaWire(jq.QuantSpec(**spec)),
            teng.MoniquaWire(tq.QuantSpec(**spec)))


def _assert_trees_equal(ref, out):
    rl, ol = jax.tree.leaves(ref), tree.leaves(out)
    assert len(rl) == len(ol)
    for a, b in zip(rl, ol):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("align", [1, 2, 4, 8])
def test_bucket_layout_matches_reference_on_resnet20(align):
    X = _resnet_tree_np()
    jl = jbucket.layout_of(jax.tree.map(jnp.asarray, X), align)
    tl = tbucket.layout_of(_to_cpu(X), align)
    assert tl.num_leaves == jl.num_leaves == 61
    assert tl.total_elems == jl.total_elems == 272282
    assert tl.padded_elems == jl.padded_elems
    assert tl.offsets == jl.offsets
    assert [s.shape for s in tl.slots] == [s.shape for s in jl.slots]
    for k in (1, 3, 7):
        assert ([(c.offset, c.size) for c in tl.chunks(k)]
                == [(c.offset, c.size) for c in jl.chunks(k)])
    if align not in (1, 8):     # the full wire's and the 8-bit main path's
        return
    flat = tl.flatten(_to_cpu(X))
    # flatten only moves data, so the jitted reference is exact
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jl.flatten)(jax.tree.map(jnp.asarray, X))),
        flat.numpy())
    _assert_trees_equal(X, tl.unflatten(flat))


@pytest.mark.parametrize("path", ["bucketed", "per_leaf", "auto"])
@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: t[0])
def test_full_wire_mix_bitwise(topo, path):
    X = _tree_np()
    jt, tt = _both(*topo)
    ref = jeng.CommEngine(jt, jeng.FullPrecisionWire(), backend="jnp",
                          path=path).mix(jax.tree.map(jnp.asarray, X)).x
    out = teng.CommEngine(tt, teng.FullPrecisionWire(), path=path).mix(
        _to_cpu(X)).x
    _assert_trees_equal(ref, out)


@pytest.mark.parametrize("path", ["bucketed", "per_leaf", "auto"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: t[0])
def test_moniqua_mix_bitwise(topo, bits, path):
    X = _tree_np(seed=bits)
    jt, tt = _both(*topo)
    jw, tw = _wires("moniqua", bits)
    key = jax.random.PRNGKey(bits)
    ref = jeng.CommEngine(jt, jw, backend="jnp", path=path).mix(
        jax.tree.map(jnp.asarray, X), theta=2.0, key=key).x
    out = teng.CommEngine(tt, tw, path=path).mix(
        _to_cpu(X), theta=2.0, seed=int(jops._key_to_seed(key))).x
    _assert_trees_equal(ref, out)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: t[0])
def test_port_bucketed_equals_per_leaf(topo, bits):
    X = _to_cpu(_tree_np(seed=7))
    tt = ttopo.get_topology(*topo)
    tw = teng.MoniquaWire(tq.QuantSpec(bits=bits, stochastic=bits > 1))
    a = teng.CommEngine(tt, tw, path="bucketed").mix(X, theta=2.0, seed=99).x
    b = teng.CommEngine(tt, tw, path="per_leaf").mix(X, theta=2.0, seed=99).x
    for u, v in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(u, v)


def test_bucketed_payload_is_concatenated_per_leaf_payload():
    spec = tq.QuantSpec(bits=4, stochastic=True)
    X = _to_cpu(_tree_np(seed=3))
    layout = tbucket.layout_of(X, spec.values_per_byte)
    B = tmod.b_theta(2.0, spec.delta, "cpu")
    p_bucket = tops.moniqua_encode_stacked(layout.flatten(X), B, spec, 5)
    p_leaves = [tops.moniqua_encode_stacked(
        l[:, None] if l.dim() == 1 else l, B, spec, 5, idx_base=off)
        .reshape(l.shape[0], -1)
        for l, off in zip(tree.leaves(X), layout.offsets)]
    assert torch.equal(p_bucket, torch.cat(p_leaves, dim=1))


@pytest.mark.parametrize("path", ["bucketed", "per_leaf", "auto"])
@pytest.mark.parametrize("wire,bits", [("full", 8)] + [("moniqua", b)
                                                       for b in BITS])
def test_bytes_per_round_and_ledger_match_reference(wire, bits, path):
    X = _resnet_tree_np(n=8)
    jX = jax.tree.map(jnp.asarray, X)
    tX = _to_cpu(X)
    jw, tw = _wires(wire, bits)
    je = jeng.CommEngine(jtopo.ring(8), jw, backend="jnp", path=path)
    te = teng.CommEngine(ttopo.ring(8), tw, path=path)
    assert te.bytes_per_round(tX) == je.bytes_per_round(jX)
    assert (te.payload_bytes_per_broadcast(tX)
            == je.payload_bytes_per_broadcast(jX))
    jl, tl = JLedger(), TLedger()
    je._record(jX, jl)
    te._record(tX, tl)
    assert (tl.bytes_per_worker, tl.bytes_slow, tl.bytes_fast) == \
        (jl.bytes_per_worker, jl.bytes_slow, jl.bytes_fast)
    if wire == "moniqua" and bits in (1, 8):
        # the main path's bytes: padded_elems / vpb x 2 neighbors
        assert te.bytes_per_round(tX) == {8: 544564, 1: 68168}[bits]


@pytest.mark.parametrize("name,n", [("ring", 8), ("ring", 2),
                                    ("exponential", 8), ("exponential", 6),
                                    ("torus", 16), ("complete", 5)])
def test_topologies_match_reference(name, n):
    jt, tt = _both(name, n)
    assert (tt.offsets, tt.weights) == (jt.offsets, jt.weights)
    assert tt.neighbor_offsets() == jt.neighbor_offsets()
    np.testing.assert_array_equal(tt.matrix, jt.matrix)
    assert tt.rho == jt.rho
    js, ts = jt.slack(0.3), tt.slack(0.3)
    assert (ts.name, ts.offsets, ts.weights) == (js.name, js.offsets,
                                                 js.weights)


def test_gossip_mix_and_neighbor_sum_bitwise():
    from repro.comm import gossip as jg
    from repro_torch.comm import gossip as tg
    X = _tree_np()
    jX, tX = jax.tree.map(jnp.asarray, X), _to_cpu(X)
    jt, tt = _both("exponential", 9)
    _assert_trees_equal(jg.mix(jX, jt), tg.mix(tX, tt))
    _assert_trees_equal(jg.neighbor_sum(jX, jt, lambda v, o: v * 2.0 + o),
                        tg.neighbor_sum(tX, tt, lambda v, o: v * 2.0 + o))


def test_engine_rejects_missing_seed_and_theta():
    X = _to_cpu(_tree_np())
    eng = teng.CommEngine(ttopo.ring(9))
    with pytest.raises(ValueError):
        eng.mix(X, theta=2.0)                 # stochastic needs a seed
    with pytest.raises(ValueError):
        eng.mix(X, seed=1)                    # moniqua needs theta
    with pytest.raises(ValueError, match="unknown path"):
        teng.CommEngine(ttopo.ring(9), path="fused")
