"""``path="auto"``, the default gossip path, against the JAX package, on the
CPU.

The reference defaults to ``path="auto"`` (``CommEngine``, ``AlgoHyper``,
``TrainerConfig.comm_path``): a per-(layout, wire) verdict from the
crossover table it derives from the committed ``BENCH_comm_fusion.json``.
On ResNet-20 (61 leaves) it buckets ``moniqua`` and per-leafs ``qsgd`` and
``full``, whose per-leaf rounds differ from the bucketed ones (``qsgd``
hashes a seed per leaf; the masked full wire adds its diffs in another
order).  These tests hold the port to the same table, the same verdicts on
ResNet-20 and on random trees, and the same default rounds, bit for bit.
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
from repro.kernels import moniqua_encode as jenc
from repro.kernels import ops as jops
from repro.train import trainer as jtrainer
from repro_torch import convert, tree
from repro_torch.comm import engine as teng
from repro_torch.core import algorithms as talg
from repro_torch.core import topology as ttopo
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.models import resnet as tresnet
from repro_torch.train import trainer as ttrainer

N = 8
WIRES = [("full", 32), ("moniqua", 8), ("moniqua", 1), ("moniqua", 2),
         ("qsgd", 8), ("qsgd", 4), ("ef_qsgd", 4), ("onebit", 1)]
WIRE_IDS = [f"{w}{b}" for w, b in WIRES]
_to_cpu = functools.partial(convert.to_torch, device="cpu")


def _spec(bits):
    return dict(bits=min(bits, 8), stochastic=1 < bits <= 8)


def _engines(wire, bits, topo, **kw):
    spec = _spec(bits)
    je = jeng.CommEngine(topo[0], jeng.make_wire(wire, JSpec(**spec)),
                         backend="jnp", **kw)
    te = teng.CommEngine(topo[1], teng.make_wire(wire, TSpec(**spec)), **kw)
    return je, te


def _topos(n_intra):
    if n_intra == 0:
        return jtopo.ring(N), ttopo.ring(N)
    return jtopo.two_tier(N, n_intra), ttopo.two_tier(N, n_intra)


def _both(X_np):
    return jax.tree.map(jnp.asarray, X_np), _to_cpu(X_np)


@functools.lru_cache(maxsize=1)
def _resnet20_np():
    """ResNet-20 at width 16 stacked over 8 workers (only the shapes
    matter to the verdict; the values are the port's initialisation)."""
    p = tresnet.init_resnet(torch.Generator().manual_seed(1), depth=20,
                            width=16)
    return tree.map(lambda a: np.broadcast_to(a.numpy()[None],
                                              (N,) + tuple(a.shape)).copy(),
                    p)


# -- the table ---------------------------------------------------------------

def test_crossover_table_equals_reference():
    got, want = teng._crossover_table(), jeng._crossover_table()
    assert got == want
    assert got["moniqua"] == pytest.approx(9.79066610896025)
    assert got["qsgd"] == got["full"] == float("inf")
    assert teng._FALLBACK_CROSSOVER == jeng._FALLBACK_CROSSOVER
    assert (teng.REF_TILE_ROWS, teng.REF_TILE_COLS) == \
        (jenc.DEFAULT_BLOCK_ROWS, jenc.DEFAULT_BLOCK_COLS)


def test_crossover_table_without_the_file(monkeypatch, tmp_path):
    """A tree without ``BENCH_comm_fusion.json`` takes the reference's
    fallback table."""
    monkeypatch.setattr(teng, "_BENCH_COMM_FUSION",
                        str(tmp_path / "BENCH_comm_fusion.json"))
    teng._crossover_table.cache_clear()
    try:
        assert teng._crossover_table() == jeng._FALLBACK_CROSSOVER
    finally:
        teng._crossover_table.cache_clear()
    monkeypatch.undo()
    assert teng._crossover_table() == jeng._crossover_table()


@pytest.mark.parametrize("elems", [0, 1, 3, 1024, 1025, 262144, 262145,
                                   272282, 1730522])
def test_tile_padded_equals_reference(elems):
    assert teng._tile_padded(elems) == jeng._tile_padded(elems)


# -- verdicts ----------------------------------------------------------------

RESNET20_FLAT = {"full": "per_leaf", "moniqua": "bucketed",
                 "qsgd": "per_leaf", "ef_qsgd": "bucketed",
                 "onebit": "bucketed"}


@pytest.mark.parametrize("wire,bits", WIRES, ids=WIRE_IDS)
def test_resolved_path_on_resnet20(wire, bits):
    """ResNet-20 (n = 8): moniqua buckets, qsgd and full go per-leaf, the
    EF wires always bucket; on the tiered engines each shard on its own
    census (two_tier(8, 4): shards 1-3 of moniqua go per-leaf)."""
    Xj, Xt = _both(_resnet20_np())
    je, te = _engines(wire, bits, _topos(0))
    assert te.resolved_path(Xt) == je.resolved_path(Xj) == \
        RESNET20_FLAT[wire]
    for n_intra in (2, 4):
        je, te = _engines(wire, bits, _topos(n_intra))
        tl, jl = te.layout(Xt), je.layout(Xj)
        got = [te.resolved_path(None, shard=tl.shard(n_intra, j))
               for j in range(n_intra)]
        assert got == [je.resolved_path(None, shard=jl.shard(n_intra, j))
                       for j in range(n_intra)]
        if wire == "moniqua" and n_intra == 4:
            assert got == ["bucketed"] + ["per_leaf"] * 3
        elif wire in ("qsgd", "full"):
            assert got == ["per_leaf"] * n_intra


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    leaves = {}
    for i in range(int(rng.integers(1, 40))):
        nd = int(rng.integers(0, 4))
        shape = tuple(int(v) for v in rng.choice(
            [1, 3, 7, 16, 33, 64, 257, 1000, 4096], size=nd))
        if np.prod(shape) > 2 ** 21:
            shape = shape[-1:]
        leaves[f"l{i:02d}"] = np.zeros((N,) + shape, np.float32)
    return leaves


@pytest.mark.parametrize("seed", range(8))
def test_resolved_path_on_random_trees(seed):
    """Random trees (1-39 leaves, 0-3 dims): every wire's verdict, flat
    and per shard, is the reference's."""
    Xj, Xt = _both(_random_tree(seed))
    for wire, bits in WIRES:
        je, te = _engines(wire, bits, _topos(0))
        assert te.resolved_path(Xt) == je.resolved_path(Xj), wire
        for n_intra in (2, 4):
            je, te = _engines(wire, bits, _topos(n_intra))
            tl, jl = te.layout(Xt), je.layout(Xj)
            for j in range(n_intra):
                assert te.resolved_path(None, shard=tl.shard(n_intra, j)) \
                    == je.resolved_path(None, shard=jl.shard(n_intra, j))


def test_random_trees_take_both_verdicts():
    """The random trees above exercise both sides of the crossover."""
    seen = set()
    for seed in range(8):
        X = _to_cpu(_random_tree(seed))
        seen.add(_engines("moniqua", 8, _topos(0))[1].resolved_path(X))
    assert seen == {"bucketed", "per_leaf"}


# -- default-path rounds, bit for bit ----------------------------------------

def test_defaults_are_auto():
    assert teng.CommEngine(ttopo.ring(N)).path == \
        jeng.CommEngine(jtopo.ring(N)).path == "auto"
    assert "auto" in teng.PATHS
    assert talg.AlgoHyper(topo=ttopo.ring(N)).path == \
        jalg.AlgoHyper(topo=jtopo.ring(N)).path == "auto"
    assert ttrainer.TrainerConfig().comm_path == \
        jtrainer.TrainerConfig().comm_path == "auto"
    assert ttrainer.build_hyper(ttrainer.TrainerConfig()).path == "auto"
    with pytest.raises(ValueError, match="unknown path"):
        teng.CommEngine(ttopo.ring(N), path="fused")


def _small_tree(seed=0, scale=0.3):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal((N,) + shape) * scale).astype(np.float32)
    return {"w": r(300), "b": r(17), "c": r(3, 7), "d": r(65), "e": r(129),
            "s": r()}


@pytest.mark.parametrize("tree_of", ["small", "resnet20"])
def test_default_qsgd_round_matches_reference_default(tree_of):
    """``CommEngine`` with the default path on the ``qsgd`` wire: 3 rounds
    bitwise the reference's default round (per-leaf, a seed a leaf)."""
    X_np = _small_tree() if tree_of == "small" else tree.map(
        lambda a: a + np.random.default_rng(1).standard_normal(
            a.shape).astype(np.float32) * 0.02, _resnet20_np())
    Xj, Xt = _both(X_np)
    je, te = _engines("qsgd", 8, _topos(0))
    assert te.resolved_path(Xt) == "per_leaf"
    bucketed = teng.CommEngine(ttopo.ring(N), teng.QSGDWire(TSpec(8)),
                               path="bucketed")
    for k in range(3 if tree_of == "small" else 1):
        key = jax.random.PRNGKey(40 + k)
        seed = int(jops._key_to_seed(key))
        want = je.mix(Xj, key=key).x
        got = te.mix(Xt, seed=seed).x
        other = bucketed.mix(Xt, seed=seed).x
        for a, b in zip(jax.tree.leaves(want), tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert any(not torch.equal(a, b) for a, b in
                   zip(tree.leaves(got), tree.leaves(other)))
        Xj, Xt = want, got


def _step_both(name, topo, rounds=3, **kw):
    """``rounds`` steps of rule ``name`` in both packages with their
    default paths, ``kw`` the shared AlgoHyper fields; the port's X is
    bitwise the reference's.  Returns the port's hyper and X."""
    spec = dict(bits=8, stochastic=True)
    jhp = jalg.AlgoHyper(topo=jtopo.get_topology(topo, N),
                         codec=JCodec(JSpec(**spec)), theta=2.0,
                         backend="jnp", **kw)
    thp = talg.AlgoHyper(topo=ttopo.get_topology(topo, N),
                         codec=TCodec(TSpec(**spec)), theta=2.0, **kw)
    ja, ta = jalg.get_algorithm(name), talg.get_algorithm(name)
    Xj, Xt = _both(_small_tree(3))
    ej = ja.init(Xj, jhp)
    et = _to_cpu(jax.tree.map(np.asarray, ej))
    key = jax.random.PRNGKey(9)
    for k in range(rounds):
        key, kq = jax.random.split(key)
        g_np = _small_tree(100 + k, scale=0.05)
        Xj, ej = ja.step(Xj, ej, jax.tree.map(jnp.asarray, g_np), 0.05, k,
                         kq, jhp)
        Xt, et = ta.step(Xt, et, _to_cpu(g_np), 0.05, k,
                         int(jops._key_to_seed(kq)), thp)
    for a, b in zip(jax.tree.leaves(Xj), tree.leaves(Xt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return thp, Xt


def test_default_algo_hyper_qsgd_step_matches_reference():
    """Moniqua's rule on the ``qsgd`` wire with ``AlgoHyper``'s default
    path: 3 steps bitwise the reference's default."""
    thp, Xt = _step_both("moniqua", "ring", wire="qsgd")
    assert thp.engine().resolved_path(Xt) == "per_leaf"


@pytest.mark.parametrize("topo,mask", [
    ("ring", (1, 1, 0, 1, 1, 0, 1, 1)),
    ("exponential", (1, 1, 1, 0, 1, 1, 1, 1))], ids=["ring", "exponential"])
def test_default_masked_dpsgd_matches_reference(topo, mask):
    """D-PSGD under a mask with the default path: 3 steps bitwise the
    reference's default (the full wire goes per-leaf there, whose masked
    sum takes another order than the bucketed one's)."""
    thp, Xt = _step_both("dpsgd", topo, presence=mask)
    assert thp.exact_engine().resolved_path(Xt) == "per_leaf"
    a = teng.CommEngine(thp.topo, teng.FullPrecisionWire(),
                        path="bucketed").mix(Xt, presence=mask).x
    b = thp.exact_engine().mix(Xt, presence=mask).x
    assert any(not torch.equal(u, v) for u, v in
               zip(tree.leaves(a), tree.leaves(b)))
