"""The port's staged round (``chunks=K``) and one-round-stale overlap
against the JAX package, on the CPU.

Mirrors ``tests/test_overlap.py``: for every wire of its ``WIRES``, the
port's K-chunk round equals its K = 1 round bitwise, outputs and the EF
wires' post-round WireState, over 3 rounds that cross the onebit warmup
switch; and its K = 1 round equals the reference's eager jnp round on the
same inputs, bitwise for ``full``, ``moniqua``, ``qsgd`` and ``ef_qsgd``.
``onebit``'s cluster-mean levels are float32 sums that XLA and PyTorch take
in different orders, so its rounds are held within ``ONEBIT_ULPS`` ulp of
each leaf's largest value (its nearest-mode codes are held bitwise in
``test_torch_ef_codecs.py``).  ``mix_stale`` is held bitwise over 3
rounds.  The reference gets a JAX key; the port the hash seed the reference
derives from it (``kops._key_to_seed``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import bucket as jbucket
from repro.comm import engine as jeng
from repro.core import topology as jtopo
from repro.core.quantizers import QuantSpec as JSpec
from repro.kernels import ops as jops
from repro.models import resnet as jresnet
from repro_torch import convert, tree
from repro_torch.comm import bucket as tbucket
from repro_torch.comm import engine as teng
from repro_torch.core import topology as ttopo
from repro_torch.core.quantizers import QuantSpec as TSpec

# (wire, bits): the codec matrix of the reference's tests/test_overlap.py
WIRES = [("full", 32), ("moniqua", 8), ("moniqua", 1), ("qsgd", 8),
         ("ef_qsgd", 4), ("onebit", 1)]
KS = [2, 5]
ONEBIT_ULPS = 16
_to_cpu = functools.partial(convert.to_torch, device="cpu")


def _tree_np(n=8, scale=0.3):
    """Several leaves with unaligned last dims, so K = 5 splits mid-tree."""
    rng = np.random.default_rng(0)

    def r(*shape):
        return (rng.standard_normal((n,) + shape) * scale).astype(np.float32)
    return {"w": r(300), "b": r(17), "c": r(3, 7), "d": r(65), "e": r(129)}


def _spec(bits):
    return dict(bits=min(bits, 8), stochastic=1 < bits <= 8)


def _engines(wire, bits, chunks=1, topo=("ring", 8), backend="jnp"):
    spec = _spec(bits)
    je = jeng.CommEngine(jtopo.get_topology(*topo),
                         jeng.make_wire(wire, JSpec(**spec), warmup=2),
                         backend=backend, path="bucketed", chunks=chunks)
    te = teng.CommEngine(ttopo.get_topology(*topo),
                         teng.make_wire(wire, TSpec(**spec), warmup=2),
                         path="bucketed", chunks=chunks)
    return je, te


def _kw(wire, key):
    """Per-round arguments: (reference's, port's)."""
    if wire == "full":
        return {}, {}
    j, t = dict(key=key), dict(seed=int(jops._key_to_seed(key)))
    if wire == "moniqua":
        j["theta"] = t["theta"] = 2.0
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


def _rounds(wire, bits, K, topo=("ring", 8), backend="jnp", rounds=3):
    """``rounds`` iterated rounds of the reference (K = 1) and of the port
    at K = 1 and at K; each round is compared before the next."""
    je, t1 = _engines(wire, bits, 1, topo, backend)
    _, tk = _engines(wire, bits, K, topo)
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    X1 = Xk = _to_cpu(_tree_np())
    sj = je.init_wire_state(Xj) if je.stateful else None
    s1 = sk = t1.init_wire_state(X1) if t1.stateful else None
    for k in range(rounds):
        kj, kt = _kw(wire, jax.random.PRNGKey(70 + k))
        rj = je.mix(Xj, state=sj, **kj)
        r1 = t1.mix(X1, state=s1, **kt)
        rk = tk.mix(Xk, state=sk, **kt)
        Xj, X1, Xk = rj.x, r1.x, rk.x
        for a, b in zip(tree.leaves(X1), tree.leaves(Xk)):
            assert torch.equal(a, b), f"round {k} K={K}"
        for a, b in zip(jax.tree.leaves(Xj), tree.leaves(X1)):
            _close(a, b, wire)
        if t1.stateful:
            sj, s1, sk = rj.state, r1.state, rk.state
            assert torch.equal(s1["residual"], sk["residual"])
            assert int(s1["step"]) == int(sk["step"]) == k + 1
            assert s1["step"].dtype == torch.int32
            _close(sj["residual"], s1["residual"], wire)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("wire,bits", WIRES,
                         ids=[f"{w}{b}" for w, b in WIRES])
def test_chunked_round_matches_barrier_and_reference(wire, bits, K):
    _rounds(wire, bits, K)


@pytest.mark.parametrize("K", KS)
def test_chunked_round_on_exponential_topology(K):
    """Four neighbours: the multi-offset reduction order survives chunks."""
    _rounds("moniqua", 4, K, topo=("exponential", 8), rounds=1)


def test_chunked_moniqua_matches_reference_pallas_interpret():
    """One case against the reference's Pallas kernels (interpret mode)."""
    _rounds("moniqua", 8, 5, backend="pallas", rounds=1)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("wire,bits", WIRES,
                         ids=[f"{w}{b}" for w, b in WIRES])
def test_chunk_payloads_concatenate_to_whole_payload(wire, bits, K):
    """Chunk c's payload (codes AND scales / levels) is the window of the
    whole-round payload, which equals the reference's (onebit's levels
    within ``ONEBIT_ULPS``)."""
    je, te = _engines(wire, bits)
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    Xt = _to_cpu(_tree_np())
    kj, kt = _kw(wire, jax.random.PRNGKey(13))
    sj = je.init_wire_state(Xj) if je.stateful else None
    st = te.init_wire_state(Xt) if te.stateful else None
    ref = je.round_plan(Xj, state=sj, chunks=1, **kj).encode_chunk(0)
    whole = te.round_plan(Xt, state=st, chunks=1, **kt).encode_chunk(0)
    plan = te.round_plan(Xt, state=st, chunks=K, **kt)
    assert plan.num_chunks == K
    # the EF wires append the local compensated value v: not on the wire
    n_payload = {"full": 1, "moniqua": 1, "qsgd": 2, "ef_qsgd": 2,
                 "onebit": 3}[wire]
    parts = [plan.encode_chunk(i) for i in range(K)]
    for j in range(n_payload):
        cat = torch.cat([p[j].reshape(8, -1) for p in parts], dim=1)
        assert torch.equal(whole[j].reshape(8, -1), cat), f"array {j}"
        if wire == "onebit" and j > 0:
            _close(ref[j], whole[j], wire)
        else:
            np.testing.assert_array_equal(np.asarray(ref[j]),
                                          whole[j].numpy())


def test_run_issues_the_skewed_pipeline():
    """At tick t: encode(t), permute(t-1), decode_reduce(t-2)."""
    _, te = _engines("moniqua", 8, chunks=3)
    plan = te.round_plan(_to_cpu(_tree_np()), theta=2.0, seed=1)
    order = []
    for phase, tag in (("encode_chunk", "E"), ("permute", "P"),
                       ("decode_reduce", "D")):
        fn = getattr(plan, phase)

        def rec(i, *a, _fn=fn, _tag=tag):
            order.append(f"{_tag}{i}")
            return _fn(i, *a)
        setattr(plan, phase, rec)
    plan.run()
    assert order == ["E0", "E1", "P0", "E2", "P1", "D0", "P2", "D1", "D2"]


@functools.lru_cache(maxsize=None)
def _resnet20_np():
    return jax.tree.map(np.asarray, jresnet.init_resnet(
        jax.random.PRNGKey(0), depth=20, width=16))


@pytest.mark.parametrize("K", [1, 2, 5, 61, 100])
def test_round_plan_chunk_count_on_resnet20(K):
    """ResNet-20 has 61 leaves: K chunks, at most one a leaf."""
    X = _to_cpu(jax.tree.map(lambda a: np.broadcast_to(
        a[None], (2,) + a.shape).copy(), _resnet20_np()))
    eng = teng.CommEngine(ttopo.ring(2), teng.MoniquaWire(TSpec(8)),
                          chunks=K)
    assert eng.round_plan(X, theta=2.0, seed=0).num_chunks == min(K, 61)


def test_chunks_must_be_positive():
    with pytest.raises(ValueError, match="chunks"):
        teng.CommEngine(ttopo.ring(8), chunks=0)


# -- BucketLayout.chunks(K): the alignment contracts, against the reference

@pytest.mark.parametrize("K", [1, 2, 3, 5, 100])
def test_chunks_cover_contiguously_and_slot_aligned(K):
    layout = tbucket.layout_of(_to_cpu(_tree_np()), 2)
    ref = jbucket.layout_of(jax.tree.map(jnp.asarray, _tree_np()), 2)
    chunks = layout.chunks(K)
    assert ([(c.offset, c.size, c.segment_sizes) for c in chunks]
            == [(c.offset, c.size, c.segment_sizes) for c in ref.chunks(K)])
    assert 1 <= len(chunks) <= min(K, len(layout.slots))
    pos = 0
    for i, c in enumerate(chunks):
        assert c.index == i and c.offset == pos and c.size > 0
        pos += c.size
    assert pos == layout.padded_elems
    assert [s for c in chunks for s in c.slots] == list(layout.slots)
    for c in chunks:
        assert c.size == sum(c.segment_sizes)
        assert c.offset == c.slots[0].offset
    assert layout.segment_sizes == ref.segment_sizes


def test_chunks_clamp_to_slot_count():
    layout = tbucket.layout_of(_to_cpu(_tree_np()), 2)
    n_slots = len(layout.slots)
    assert len(layout.chunks(n_slots + 50)) == n_slots
    assert len(layout.chunks(0)) == len(layout.chunks(-3)) == 1


@pytest.mark.parametrize("vpb", [2, 4, 8])
def test_chunk_offsets_stay_on_vpb_boundaries(vpb):
    for c in tbucket.layout_of(_to_cpu(_tree_np()), vpb).chunks(5):
        assert c.offset % vpb == 0 and c.size % vpb == 0


# -- one-round-stale overlap --------------------------------------------------

@pytest.mark.parametrize("bits", [8, 1])
def test_mix_stale_matches_reference_over_three_rounds(bits):
    """Bitwise, carry included: round 1 returns the model (the first
    round's delta is masked; its add turns -0.0 into +0.0 in both), later
    rounds move it."""
    je, te = _engines("moniqua", bits)
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    X0 = Xt = _to_cpu(_tree_np())
    cj, ct = je.init_gossip_carry(Xj), te.init_gossip_carry(Xt)
    assert not bool(ct["valid"]) and ct["ref"].dtype == torch.float32
    for k in range(3):
        kj, kt = _kw("moniqua", jax.random.PRNGKey(200 + k))
        rj = je.mix_stale(Xj, cj, **kj)
        rt = te.mix_stale(Xt, ct, **kt)
        Xj, cj, Xt, ct = rj.x, rj.state, rt.x, rt.state
        for a, b in zip(jax.tree.leaves(Xj), tree.leaves(Xt)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for name in ("packed", "ref", "B", "valid"):
            np.testing.assert_array_equal(np.asarray(cj[name]),
                                          ct[name].numpy(), err_msg=name)
        moved = max(float((a - b).abs().max())
                    for a, b in zip(tree.leaves(Xt), tree.leaves(X0)))
        assert (moved == 0.0) == (k == 0), k


def test_mix_stale_continues_from_a_reference_carry():
    """A reference carry (``convert.to_torch``) continues bitwise."""
    je, te = _engines("moniqua", 8)
    Xj = jax.tree.map(jnp.asarray, _tree_np())
    kj, _ = _kw("moniqua", jax.random.PRNGKey(5))
    r1 = je.mix_stale(Xj, je.init_gossip_carry(Xj), **kj)
    kj, kt = _kw("moniqua", jax.random.PRNGKey(6))
    r2 = je.mix_stale(r1.x, r1.state, **kj)
    carry = _to_cpu(jax.tree.map(np.asarray, r1.state))
    assert carry["valid"].dtype == torch.bool and carry["B"].dim() == 0
    rt = te.mix_stale(_to_cpu(jax.tree.map(np.asarray, r1.x)), carry, **kt)
    for a, b in zip(jax.tree.leaves(r2.x), tree.leaves(rt.x)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_mix_stale_needs_the_moniqua_wire():
    _, te = _engines("qsgd", 8)
    with pytest.raises(ValueError, match="moniqua"):
        te.init_gossip_carry(_to_cpu(_tree_np()))


def _tiny_trainer(**kw):
    from repro_torch.data.synthetic import stacked_cifar_like
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.train.trainer import Trainer, TrainerConfig
    model = ResNetModel(depth=8, width=8, device="cpu")
    batches = [stacked_cifar_like(k, 4, 2, seed=0, device="cpu")
               for k in range(6)]
    tc = TrainerConfig(algo="moniqua", n_workers=2, bits=8, theta=2.0,
                       lr=0.1, log_every=1, momentum=0.0, weight_decay=0.0,
                       **kw)
    return Trainer(model, tc, lambda k: batches[k])


def test_stale_trainer_is_deterministic():
    """``overlap="stale"``, ``chunks=2``: the carry rides extra["gossip"],
    losses stay finite, and two runs replay bitwise."""
    def run():
        out = _tiny_trainer(overlap="stale", chunks=2, steps=6).run()
        assert set(out["state"]["extra"]) == {"gossip"}
        assert np.isfinite(out["history"][-1]["loss"])
        return out

    a, b = run(), run()
    assert [h["loss"] for h in a["history"]] == \
        [h["loss"] for h in b["history"]]
    for la, lb in zip(tree.leaves(a["state"]["params"]),
                      tree.leaves(b["state"]["params"])):
        assert torch.equal(la, lb)


def test_chunked_trainer_equals_barrier_trainer():
    """``chunks=3`` trains bitwise the ``chunks=1`` run."""
    a = _tiny_trainer(chunks=1, steps=3).run()
    b = _tiny_trainer(chunks=3, steps=3).run()
    for la, lb in zip(tree.leaves(a["state"]["params"]),
                      tree.leaves(b["state"]["params"])):
        assert torch.equal(la, lb)
