"""The port's scale+codes and error-feedback wires against the JAX package,
on the CPU.

* The segmented ``qsgd`` / ``ef_qsgd`` codecs and the per-tensor ``qsgd``
  codec: payload bits and scales bitwise against the reference run
  eagerly, counters wrapping past 2^32 included.
* ``onebit``: nearest-mode codes bitwise; the cluster-mean levels are
  float32 sums that XLA and PyTorch take in different orders, so they are
  held within ``LEVEL_ULPS`` ulp of the segment's largest value; in
  stochastic mode a level one ulp apart can move ``floor(lat + u)`` across
  an integer, so the codes that differ are counted and held under
  ``MAX_FLIP_SHARE`` of the elements.
* The EF residual contracts of ``tests/test_ef_codecs.py``: the residual
  is ``v - decode(sent)`` bitwise, it stays bounded over 100 rounds, the
  onebit warmup rounds are the full-precision round and the switch fires at
  ``step == warmup``; decode is a select of the shipped levels.
* The port's bucketed round against its per-leaf round, bitwise, for
  ``ef_qsgd`` and ``onebit``; the per-leaf ``qsgd`` round against the
  reference's (it hashes a seed per leaf); ``pair_average`` on the
  ``qsgd`` and EF wires against the reference; the byte and memory
  accounting on ResNet-20.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import engine as jeng
from repro.core import quantizers as jq
from repro.core import topology as jtopo
from repro.kernels import ops as jops
from repro.models import resnet as jresnet
from repro_torch import convert, tree
from repro_torch.comm import engine as teng
from repro_torch.comm import gossip as tgossip
from repro_torch.core import adpsgd as tad
from repro_torch.core import quantizers as tq
from repro_torch.core import topology as ttopo

LEVEL_ULPS = 16
MAX_FLIP_SHARE = 1e-3
NEAR_WRAP = 2 ** 32 - 300       # counters cross 2^32 inside the buffer
_to_cpu = functools.partial(convert.to_torch, device="cpu")
EPS = np.finfo(np.float32).eps


def _flat_np(n=4, d=344, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * scale).astype(np.float32)


SEGS = (64, 200, 8, 72)         # sums to 344; every width vpb-aligned


def _eq(ref, out):
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def _specs(bits, stochastic):
    return (jq.QuantSpec(bits=bits, stochastic=stochastic),
            tq.QuantSpec(bits=bits, stochastic=stochastic))


# -- codecs against the reference ---------------------------------------------

@pytest.mark.parametrize("idx_base", [0, 344, NEAR_WRAP])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_qsgd_segmented_codec_bitwise(bits, stochastic, idx_base):
    """Counter ``w * stride + idx_base + e`` mod 2^32, as the reference's
    uint32 (a stride of the whole buffer, as a chunked encode passes)."""
    x = _flat_np()
    js, ts = _specs(bits, stochastic)
    p, s = jq.qsgd_encode_segmented(jnp.asarray(x), js, jnp.uint32(77),
                                    SEGS, idx_base=idx_base,
                                    idx_stride=1000)
    pt, st = tq.qsgd_encode_segmented(torch.from_numpy(x), ts, 77, SEGS,
                                      idx_base=idx_base, idx_stride=1000)
    _eq(p, pt)
    _eq(s, st)
    _eq(jq.qsgd_decode_segmented(p, s, js, SEGS),
        tq.qsgd_decode_segmented(pt, st, ts, SEGS))


@pytest.mark.parametrize("idx_base", [0, NEAR_WRAP])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_ef_qsgd_codec_bitwise(bits, stochastic, idx_base):
    v = _flat_np(seed=1)
    js, ts = _specs(bits, stochastic)
    p, s = jq.ef_qsgd_encode_segmented(jnp.asarray(v), js, jnp.uint32(5),
                                       SEGS, idx_base)
    pt, st = tq.ef_qsgd_encode_segmented(torch.from_numpy(v), ts, 5, SEGS,
                                         idx_base)
    _eq(p, pt)
    _eq(s, st)


@pytest.mark.parametrize("worker_axis", [True, False])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_qsgd_per_tensor_codec_bitwise(bits, worker_axis):
    x = _flat_np(d=37).reshape(4, 37)
    js, ts = _specs(bits, True)
    p, s = jq.qsgd_encode(jnp.asarray(x), js, jnp.uint32(9), worker_axis)
    pt, st = tq.qsgd_encode(torch.from_numpy(x), ts, 9, worker_axis)
    _eq(p, pt)
    _eq(s, st)
    _eq(jq.qsgd_decode(p, s, js, 37), tq.qsgd_decode(pt, st, ts, 37))


def _level_tol(v):
    return LEVEL_ULPS * EPS * max(1.0, float(np.abs(v).max()))


@pytest.mark.parametrize("idx_base", [0, NEAR_WRAP])
@pytest.mark.parametrize("stochastic", [False, True])
def test_onebit_codec_against_reference(stochastic, idx_base):
    v = _flat_np(seed=2)
    p, lo, hi = jq.onebit_encode_segmented(jnp.asarray(v), jnp.uint32(3),
                                           SEGS, idx_base, stochastic)
    pt, lot, hit = tq.onebit_encode_segmented(torch.from_numpy(v), 3, SEGS,
                                              idx_base, stochastic)
    for a, b in ((lo, lot), (hi, hit)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=_level_tol(v))
    codes = np.unpackbits(np.asarray(p), bitorder="little")
    codes_t = np.unpackbits(pt.numpy(), bitorder="little")
    if stochastic:
        assert np.mean(codes != codes_t) <= MAX_FLIP_SHARE
    else:
        np.testing.assert_array_equal(codes, codes_t)
    # decode is a select: the reference's payload decodes bitwise
    _eq(jq.onebit_decode_segmented(p, lo, hi, SEGS),
        tq.onebit_decode_segmented(torch.from_numpy(np.array(p)),
                                   torch.from_numpy(np.array(lo)),
                                   torch.from_numpy(np.array(hi)), SEGS))


def test_payload_bytes_match_reference():
    for shape in [(), (5,), (3, 7), (2, 3, 17)]:
        for bits in (1, 2, 4, 8):
            assert (tq.qsgd_payload_bytes(shape, bits)
                    == jq.qsgd_payload_bytes(shape, bits))
        assert tq.onebit_payload_bytes(shape) == jq.onebit_payload_bytes(
            shape)


def test_stochastic_modes_require_seed():
    v = torch.ones((1, 8))
    with pytest.raises(ValueError, match="seed"):
        tq.onebit_encode_segmented(v, None, (8,), stochastic=True)
    with pytest.raises(ValueError, match="seed"):
        tq.ef_qsgd_encode_segmented(v, tq.QuantSpec(bits=4), None, (8,))


# -- the EF residual contracts --------------------------------------------------

def _tree_np(n=8, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n, 37)) * scale).astype(np.float32),
            "b": (rng.standard_normal((n, 5)) * scale).astype(np.float32)}


def _engine(wire, bits=4, stochastic=False, warmup=16, path="bucketed"):
    return teng.CommEngine(ttopo.ring(8), teng.make_wire(
        wire, tq.QuantSpec(bits=bits, stochastic=stochastic),
        warmup=warmup), path=path)


def _seeded_state(eng, X, scale=0.1):
    st = eng.init_wire_state(X)
    gen = torch.Generator().manual_seed(42)
    return {"residual": torch.randn(st["residual"].shape, generator=gen)
            * scale, "step": st["step"]}


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("wire,bits", [("ef_qsgd", 2), ("ef_qsgd", 8),
                                       ("onebit", 1)])
def test_residual_is_wire_determined(wire, bits, stochastic):
    """The post-round residual is ``v - decode(own payload)`` bitwise, and
    payload + residual rebuild ``v`` to ~1 ulp of its scale."""
    eng = _engine(wire, bits, stochastic, warmup=0)
    X = _to_cpu(_tree_np())
    layout = eng.layout(X)
    st = _seeded_state(eng, X)
    st1 = eng.mix(X, seed=7, state=st).state
    v = layout.flatten(X).float() + st["residual"]
    seg = layout.segment_sizes
    if wire == "ef_qsgd":
        d = tq.qsgd_decode_segmented(*tq.ef_qsgd_encode_segmented(
            v, eng.codec.spec, 7, seg), eng.codec.spec, seg)
    else:
        d = tq.onebit_decode_segmented(*tq.onebit_encode_segmented(
            v, 7, seg, 0, stochastic), seg)
    assert torch.equal(st1["residual"], v - d)
    tol = float(v.abs().max()) * 2.0 ** -22
    assert float((d + st1["residual"] - v).abs().max()) <= tol


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_ef_qsgd_residual_bounded_100_rounds(bits, stochastic):
    """Under the EF fixpoint ``q * max|x| / (1 - q)`` (q one lattice step
    of the max-norm scale), as the reference's test bounds it."""
    eng = _engine("ef_qsgd", bits, stochastic)
    X = _to_cpu(_tree_np())
    st = eng.init_wire_state(X)
    sups = []
    for k in range(100):
        st = eng.mix(X, seed=1000 + k, state=st).state
        sups.append(float(st["residual"].abs().max()))
    xmax = max(float(l.abs().max()) for l in tree.leaves(X))
    q = (2.0 if stochastic else 1.0) / (2 ** bits - 1)
    assert max(sups) <= 1.5 * q * xmax / (1.0 - q)


def test_onebit_residual_bounded_100_rounds():
    """The sign / cluster-mean compressor is contractive: the residual
    plateaus instead of growing (the reference test's two checks)."""
    eng = _engine("onebit", 1, False, warmup=0)
    X = _to_cpu(_tree_np())
    st = eng.init_wire_state(X)
    sups = []
    for k in range(100):
        st = eng.mix(X, seed=k, state=st).state
        sups.append(float(st["residual"].abs().max()))
    xmax = max(float(l.abs().max()) for l in tree.leaves(X))
    assert max(sups) <= 16.0 * xmax
    assert max(sups[80:]) <= 1.2 * max(sups[:50])


def test_onebit_warmup_switch_fires_at_warmup():
    """Warm rounds are the full-precision round bitwise with the residual
    untouched; from ``step == warmup`` on the round is quantized."""
    W = 3
    eng = _engine("onebit", warmup=W)
    X = _to_cpu(_tree_np(seed=5))
    st = eng.init_wire_state(X)
    for k in range(2 * W):
        ref = tgossip.mix(X, ttopo.ring(8))
        r = eng.mix(X, seed=500 + k, state=st)
        X, st = r.x, r.state
        assert int(st["step"]) == k + 1
        same = all(torch.equal(a, b) for a, b in zip(tree.leaves(X),
                                                     tree.leaves(ref)))
        assert same == (k < W), k
        assert (float(st["residual"].abs().max()) == 0.0) == (k < W), k


def test_onebit_levels_are_exact_and_decoded_values_shipped():
    v = torch.tensor([[-0.5] * 4 + [0.25] * 4])
    packed, lo, hi = tq.onebit_encode_segmented(v, None, (8,))
    assert float(lo[0, 0]) == -0.5 and float(hi[0, 0]) == 0.25
    assert torch.equal(tq.onebit_decode_segmented(packed, lo, hi, (8,)), v)
    v = torch.from_numpy(_flat_np(n=2, d=24))
    seg = (16, 8)
    packed, lo, hi = tq.onebit_encode_segmented(v, None, seg)
    d = tq.onebit_decode_segmented(packed, lo, hi, seg)
    off = 0
    for si, size in enumerate(seg):
        for row in range(2):
            assert set(d[row, off:off + size].tolist()) <= {
                float(lo[row, si]), float(hi[row, si])}
        off += size


# -- paths, pair exchanges and accounting --------------------------------------

@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("wire,bits,warmup", [("ef_qsgd", 4, 16),
                                              ("onebit", 1, 2)])
def test_bucketed_equals_per_leaf(wire, bits, warmup, stochastic):
    """Both paths run the same per-segment helpers on the same canonical
    residual: outputs and WireState bitwise over 4 rounds (onebit's
    crossing the switch)."""
    rng = np.random.default_rng(3)
    Xn = {"conv": rng.standard_normal((8, 3, 3, 2, 5)).astype(np.float32),
          "w": rng.standard_normal((8, 7, 13)).astype(np.float32),
          "s": rng.standard_normal((8,)).astype(np.float32)}
    a = _engine(wire, bits, stochastic, warmup, path="bucketed")
    b = _engine(wire, bits, stochastic, warmup, path="per_leaf")
    Xa = Xb = _to_cpu(Xn)
    sa = sb = a.init_wire_state(Xa)
    for k in range(4):
        ra, rb = a.mix(Xa, seed=k, state=sa), b.mix(Xb, seed=k, state=sb)
        Xa, Xb, sa, sb = ra.x, rb.x, ra.state, rb.state
        for u, v in zip(tree.leaves(Xa), tree.leaves(Xb)):
            assert torch.equal(u, v), k
        assert torch.equal(sa["residual"], sb["residual"])
        assert torch.equal(sa["step"], sb["step"])


@pytest.mark.parametrize("bits", [2, 8])
def test_per_leaf_qsgd_round_matches_reference(bits):
    """The per-leaf qsgd round hashes a seed per leaf: held to the
    reference's per-leaf round (not to the bucketed one)."""
    rng = np.random.default_rng(4)
    Xn = {"a": rng.standard_normal((8, 4, 9)).astype(np.float32),
          "s": rng.standard_normal((8,)).astype(np.float32)}
    key = jax.random.PRNGKey(11)
    js, ts = _specs(bits, True)
    ref = jeng.CommEngine(jtopo.ring(8), jeng.QSGDWire(js), backend="jnp",
                          path="per_leaf").mix(
        jax.tree.map(jnp.asarray, Xn), key=key).x
    out = teng.CommEngine(ttopo.ring(8), teng.QSGDWire(ts),
                          path="per_leaf").mix(
        _to_cpu(Xn), seed=int(jops._key_to_seed(key))).x
    for u, v in zip(jax.tree.leaves(ref), tree.leaves(out)):
        _eq(u, v)


@pytest.mark.parametrize("wire", ["ef_qsgd", "onebit"])
def test_ef_round_from_a_reference_state(wire):
    """A reference WireState (``convert.to_torch``) continues bitwise on
    ``ef_qsgd``; on ``onebit`` within ``LEVEL_ULPS``."""
    spec = dict(bits=4 if wire == "ef_qsgd" else 1, stochastic=False)
    je = jeng.CommEngine(jtopo.ring(8), jeng.make_wire(
        wire, jq.QuantSpec(**spec), warmup=0), backend="jnp",
        path="bucketed")
    te = teng.CommEngine(ttopo.ring(8), teng.make_wire(
        wire, tq.QuantSpec(**spec), warmup=0), path="bucketed")
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    r1 = je.mix(Xj, state=je.init_wire_state(Xj))
    r2 = je.mix(r1.x, state=r1.state)
    st = _to_cpu(jax.tree.map(np.asarray, r1.state))
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 1
    rt = te.mix(_to_cpu(jax.tree.map(np.asarray, r1.x)), state=st)
    outs = list(zip(jax.tree.leaves(r2.x), tree.leaves(rt.x)))
    outs.append((r2.state["residual"], rt.state["residual"]))
    for u, v in outs:
        u = np.asarray(u)
        if wire == "ef_qsgd":
            _eq(u, v)
        else:
            np.testing.assert_allclose(v.numpy(), u, rtol=0,
                                       atol=_level_tol(u))


@pytest.mark.parametrize("wire", ["qsgd", "ef_qsgd", "onebit"])
def test_pair_average_matches_reference(wire):
    """Three exchanges on one edge, carries threaded (onebit crosses its
    warmup of 1)."""
    rng = np.random.default_rng(6)
    xi, xj = (rng.standard_normal((2, 45)) * 0.4).astype(np.float32)
    stochastic = wire != "onebit"
    js, ts = _specs(8 if wire != "onebit" else 1, stochastic)
    je = jeng.CommEngine(jtopo.ring(8), jeng.make_wire(wire, js, warmup=1),
                         backend="jnp")
    te = teng.CommEngine(ttopo.ring(8), teng.make_wire(wire, ts, warmup=1))
    a, b = jnp.asarray(xi), jnp.asarray(xj)
    c, d = torch.from_numpy(xi), torch.from_numpy(xj)
    sj = (je.init_edge_state(a), je.init_edge_state(b))
    st = (te.init_edge_state(c), te.init_edge_state(d))
    for k in range(3):
        key = jax.random.PRNGKey(30 + k)
        rj = je.pair_average(a, b, key=key, state_i=sj[0], state_j=sj[1])
        rt = te.pair_average(c, d, seed=int(jops._key_to_seed(key)),
                             state_i=st[0], state_j=st[1])
        a, b, c, d = rj.xi, rj.xj, rt.xi, rt.xj
        pairs = [(a, c), (b, d)]
        if te.stateful:
            sj, st = (rj.state_i, rj.state_j), (rt.state_i, rt.state_j)
            pairs += [(sj[0]["residual"], st[0]["residual"]),
                      (sj[1]["residual"], st[1]["residual"])]
            assert int(st[0]["step"]) == k + 1
        for u, v in pairs:
            u = np.asarray(u)
            if wire == "onebit":
                np.testing.assert_allclose(v.numpy(), u, rtol=0,
                                           atol=_level_tol(u))
            else:
                _eq(u, v)


def test_adpsgd_config_builds_the_qsgd_wire():
    cfg = tad.ADPSGDConfig(topo=ttopo.ring(8), quantized=True, wire="qsgd")
    assert cfg.engine().codec.name == "qsgd"
    assert tad.ADPSGDConfig(topo=ttopo.ring(8),
                            quantized=True).engine().codec.name == "moniqua"


def test_make_wire_builds_all_five():
    assert teng.WIRES == jeng.WIRES
    for name in teng.WIRES:
        w = teng.make_wire(name, tq.QuantSpec(bits=4), warmup=3)
        assert w.name == name
    ob = teng.make_wire("onebit", tq.QuantSpec(bits=8), warmup=3)
    assert ob.spec.bits == 1 and ob.warmup == 3 and ob.stateful
    assert ob.warmup_payload_bytes((3, 7)) == 84


@functools.lru_cache(maxsize=None)
def _resnet20_np():
    return jax.tree.map(np.asarray, jresnet.init_resnet(
        jax.random.PRNGKey(0), depth=20, width=16))


# wire, bits -> (bytes per step, extra memory per worker) on ResNet-20,
# ring(8), the reference's CommEngine's numbers
TABLE = [("moniqua", 8, 544564, 0), ("qsgd", 8, 545052, 0),
         ("ef_qsgd", 8, 545052, 1089132), ("ef_qsgd", 4, 272770, 1089132),
         ("onebit", 1, 69144, 1090692)]


@pytest.mark.parametrize("wire,bits,nbytes,mem", TABLE,
                         ids=[f"{w}{b}" for w, b, _, _ in TABLE])
def test_bytes_and_memory_on_resnet20(wire, bits, nbytes, mem):
    X = jax.tree.map(lambda a: np.broadcast_to(
        a[None], (2,) + a.shape), _resnet20_np())
    js, ts = _specs(bits, bits > 1)
    je = jeng.CommEngine(jtopo.ring(8), jeng.make_wire(wire, js),
                         backend="jnp", path="bucketed")
    Xj = jax.tree.map(jnp.asarray, X)
    Xt = tree.map(lambda a: torch.empty(a.shape), X)
    for path in ("bucketed", "per_leaf"):
        te = teng.CommEngine(ttopo.ring(8), teng.make_wire(wire, ts),
                             path=path)
        assert te.bytes_per_round(Xt) == je.bytes_per_round(Xj) == nbytes
        assert te.wire_state_bytes(Xt) == je.wire_state_bytes(Xj) == mem
