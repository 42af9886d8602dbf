"""The update rules' pieces under a split of the weights, in one process.

No process group: a split is installed with ``tensor_parallel.AxisGroup``
s that carry a rank, a size and the split dims but no group (the draw and
the accounting run no collective), and a worker split with a
``workers.WorkerGroup`` of its own; split views are built as the encode's
tests build them (``tensor_parallel.split_view``).

* A shard's rounding uniforms (``algorithms.draw_uniforms``) equal the
  cut of one process's draw, for leaves split on one dim, on two dims
  (blocks of rows) and whole, under a worker split, and past 2^32
  elements a worker; and the draw creates no tensor larger than the
  shard's own uniforms (its index temporaries are chunked).
* ``bytes_per_step`` and ``extra_memory_bytes`` of all ten rules under a
  ``model`` split, and under FSDP ``data`` with ``model``, equal one
  process's (on ``meta`` tensors).
* ``state_pspecs`` of D² and Choco equal the reference's
  (``tests/test_torch_sharding.py``'s ``_check_specs``) on the single-pod
  and multi-pod meshes.
* Each rule's declared ``mirrors`` are exactly the keys of its state
  that mirror the params leaf for leaf (what a split cuts, gathers and
  restores with them).
* A decode cache whose layout a rank's slots do not tell (``model`` not
  dividing the KV heads) is read from its specs' context or its ring's
  length, and refused without either.
"""
import types

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.comm import tensor_parallel as TP
from repro_torch.comm import workers
from repro_torch.configs import get_config
from repro_torch.core import algorithms as talg
from repro_torch.core.moniqua import MoniquaCodec
from repro_torch.core.quantizers import QuantSpec
from repro_torch.core.topology import ring
from repro_torch.models.model_factory import Model
from repro_torch.models.sharding import ShardingRules
from repro_torch.train import train_step as TS

N = 4
SEED = 0x5EED7


def _tree():
    """A stacked tree: a leaf cut on dim 1, one on dims 1 and 3 (blocks of
    rows), one whole, a vector and one element a worker."""
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(N, 6, 5, generator=g),
            "b": torch.randn(N, 3, 4, 2, 6, generator=g),
            "c": torch.randn(N, 7, 3, generator=g),
            "d": torch.randn(N, 10, generator=g),
            "e": torch.randn(N, generator=g)}


# flatten order a, b, c, d, e; the stacked dims each axis splits
MODEL_DIMS = (1, 3, None, 1, None)
DATA_DIMS = (None, 2, None, None, None)


def _cut(X, groups):
    for g in groups:
        X = g.cut(X)
    return X


def _groups(m_rank, d_rank=None):
    out = [TP.AxisGroup("model", rank=m_rank, size=2, dims=MODEL_DIMS)]
    if d_rank is not None:
        out.append(TP.AxisGroup("data", rank=d_rank, size=2,
                                dims=DATA_DIMS))
    return out


@pytest.mark.parametrize("split", ["model", "model+data"])
def test_shard_uniforms_are_the_cut_of_one_process_draw(split):
    X = _tree()
    whole = talg.draw_uniforms(X, SEED)
    ranks = ([(m, None) for m in range(2)] if split == "model"
             else [(m, d) for m in range(2) for d in range(2)])
    for m, d in ranks:
        groups = _groups(m, d)
        shard = _cut(X, groups)
        with TP.axis_context(*groups):
            got = talg.draw_uniforms(shard, SEED)
        want = _cut(whole, groups)
        for a, b in zip(tree.leaves(got), tree.leaves(want)):
            assert a.shape == b.shape
            assert torch.equal(a, b)


def test_worker_split_draws_its_rows_of_one_process_draw():
    """A rank holding workers ``[2, 4)`` of 4 draws those rows, also with
    its ``model`` shard on top."""
    X = _tree()
    whole = talg.draw_uniforms(X, SEED)
    wg = workers.WorkerGroup(ranks=(0, 1), index=1)
    rows = tree.map(lambda a: a[2:].clone(), X)
    for m in range(2):
        groups = _groups(m)
        with workers.worker_context(wg), TP.axis_context(*groups):
            got = talg.draw_uniforms(_cut(rows, groups), SEED)
        want = _cut(tree.map(lambda a: a[2:], whole), groups)
        for a, b in zip(tree.leaves(got), tree.leaves(want)):
            assert torch.equal(a, b)


def test_draw_is_uniform_and_differs_by_worker_leaf_and_seed():
    X = {"a": torch.zeros(N, 64, 64), "b": torch.zeros(N, 64, 64)}
    u = talg.draw_uniforms(X, SEED)
    a, b = u["a"], u["b"]
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert abs(float(a.mean()) - 0.5) < 0.01
    assert not torch.equal(a[0], a[1]) and not torch.equal(a, b)
    assert not torch.equal(a, talg.draw_uniforms(X, SEED + 1)["a"])


def test_indices_past_2_32_change_the_stream(monkeypatch):
    """A worker's element ``e`` and ``e + 2^32`` of one leaf draw apart:
    the index's high word mixes into the seed.  A leaf of 2^32 + 8
    elements a worker is drawn only at its two ends, through a shard's
    split view (the split dim's offset puts the shard past 2^32)."""
    whole = 2 ** 32 + 8
    x = torch.zeros(1, 8, 1)                  # rows 0..7 of a [1, W, 1]
    lo = TP.AxisGroup("model", rank=0, size=whole // 8, dims=(1,))
    hi = TP.AxisGroup("model", rank=whole // 8 - 1, size=whole // 8,
                      dims=(1,))
    with TP.axis_context(lo):
        first = talg.draw_uniforms((x,), SEED)[0]
    with TP.axis_context(hi):
        last = talg.draw_uniforms((x,), SEED)[0]
    # element 2^32 is the last shard's first; element 0 the first's
    assert not torch.equal(first, last)
    from repro_torch.core.quantizers import _counter_uniform
    s = talg._stream_seed(SEED, 0, 0)
    assert float(first[0, 0, 0]) == float(_counter_uniform(s, torch.tensor(
        [0]))[0])
    assert float(last[0, 0, 0]) == float(_counter_uniform(
        s ^ 0x9E3779B1, torch.tensor([2 ** 32]))[0])


@pytest.mark.parametrize("chunk", [16, 100, 1 << 22])
@pytest.mark.parametrize("split", ["none", "model", "model+data"])
def test_draw_does_not_depend_on_its_chunks(monkeypatch, chunk, split):
    """A draw in chunks of 16 elements (leaves one at a time, and chunks
    inside a leaf), of 100 (chunks across leaves) and of 2^22 (the tree
    in one chunk) gives the same bits, whole and on shards."""
    X = _tree()
    groups = {"none": [], "model": _groups(1),
              "model+data": _groups(1, 0)}[split]
    shard = _cut(X, groups)
    with TP.axis_context(*groups):
        want = talg.draw_uniforms(shard, SEED)
        monkeypatch.setattr(talg, "_DRAW_CHUNK", chunk)
        got = talg.draw_uniforms(shard, SEED)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b)


class _Largest(TorchDispatchMode):
    """The largest tensor any op creates (elements; ``meta`` tensors, the
    whole shapes the accounting reads, hold no memory)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree.leaves(out if isinstance(out, (list, tuple))
                             else [out]):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.largest = max(self.largest, t.numel())
        return out


def test_no_rank_allocates_beyond_its_cut(monkeypatch):
    """With the draw's chunk at 16 elements, no op of a shard's draw
    creates a tensor larger than that shard's largest leaf (its own
    uniforms): never a whole leaf."""
    monkeypatch.setattr(talg, "_DRAW_CHUNK", 16)
    X = _tree()
    groups = _groups(1, 1)
    shard = _cut(X, groups)
    biggest_shard = max(a.numel() for a in tree.leaves(shard))
    with TP.axis_context(*groups), _Largest() as mode:
        talg.draw_uniforms(shard, SEED)
    assert mode.largest <= biggest_shard
    assert mode.largest < max(a.numel() for a in tree.leaves(X))


# -- accounting -------------------------------------------------------------

def _hyper(name):
    topo = ring(N).slack(0.75) if name in ("d2", "moniqua_d2") else ring(N)
    return talg.AlgoHyper(topo=topo, codec=MoniquaCodec(QuantSpec(8, True)))


@pytest.mark.parametrize("mode", ["decentralized", "hierarchical"])
@pytest.mark.parametrize("name", sorted(talg.ALGORITHMS))
def test_bytes_and_memory_under_a_split_are_one_process(mode, name):
    """Reduced llama3.2-3b's stacked tree on ``meta``, cut for every rank
    of ``(data=1, model=2)`` (decentralized) or ``(data=2, model=2)``
    (hierarchical: FSDP over ``data``): the rule's ``bytes_per_step`` and
    ``extra_memory_bytes`` on each rank's shards equal one process's."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              dtype="float32")
    model = Model(cfg, "meta")
    rules = ShardingRules(mode)
    shape = {"data": 2 if mode == "hierarchical" else 1, "model": 2}
    specs = TS.params_pspecs(model, rules, shape, stacked=True)
    X = tree.map(lambda a: torch.empty((N,) + tuple(a.shape),
                                       dtype=a.dtype, device="meta"),
                 TS.abstract_params(model))
    algo, hp = talg.get_algorithm(name), _hyper(name)
    want = (algo.bytes_per_step(X, hp), algo.extra_memory_bytes(X, hp))
    axes = [a for a in ("model", "data") if shape[a] > 1]
    for ranks in ([(m,) for m in range(2)] if len(axes) == 1
                  else [(m, d) for m in range(2) for d in range(2)]):
        groups = [TP.AxisGroup(a, rank=r, size=2,
                               dims=TP.axis_dims(specs, a))
                  for a, r in zip(axes, ranks)]
        shard = _cut(X, groups)
        assert sum(a.numel() for a in tree.leaves(shard)) < sum(
            a.numel() for a in tree.leaves(X))
        with TP.axis_context(*groups):
            got = (algo.bytes_per_step(shard, hp),
                   algo.extra_memory_bytes(shard, hp))
        assert got == want, (ranks, got, want)


# -- the state's specs ------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["1pod", "2pod"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-72b", "dbrx-132b"])
def test_state_specs_of_the_replica_rules_equal_the_reference(arch,
                                                              mesh_name):
    """D²'s and Choco's ``state_pspecs`` equal the reference's, path for
    path: their replicas whole over ``model`` (and FSDP ``data``) as the
    reference places them at init; the trainer holds them in the params'
    cut (``train_step.state_pspecs``)."""
    from test_torch_sharding import _check_specs
    _check_specs(arch, mesh_name, hypers=("d2", "choco"))


# -- the state a split holds in the params' cut -----------------------------

@pytest.mark.parametrize("name", sorted(talg.ALGORITHMS))
def test_declared_mirrors_are_the_params_shaped_state(name):
    """``Algorithm.mirrors`` names exactly the keys of ``init``'s state
    whose subtree has the params' structure and leaf shapes."""
    X = _tree()
    algo = talg.get_algorithm(name)
    extra = algo.init(X, _hyper(name))
    td = tree.flatten(X)[1]
    shaped = {k for k, v in extra.items() if tree.flatten(v)[1] == td
              and all(a.shape == b.shape for a, b in zip(tree.leaves(v),
                                                         tree.leaves(X)))}
    assert shaped == set(algo.mirrors)


# -- the decode cache's layout ----------------------------------------------

def test_decode_cache_layout_needs_its_specs():
    """Under ``model`` = 2 over 3 KV heads a rank's slots do not tell the
    ``kv_seq`` share from the whole ring: the layout comes from the
    context ``train.serve_step`` enters, or from the ring's length when
    the cache is built, and decode without either raises."""
    from repro_torch.models import layers as L
    cfg = types.SimpleNamespace(num_kv_heads=3)
    with TP.axis_context(TP.AxisGroup("model", rank=0, size=2, dims=())):
        with pytest.raises(ValueError, match="make_serve_step"):
            L.cache_layout(cfg)
        assert L.cache_layout(cfg, 9) == "whole"
        assert L.cache_layout(cfg, 8) == "seq"
        for layout in ("whole", "seq"):
            with L.cache_layout_context(layout):
                assert L.cache_layout(cfg) == layout
    with TP.axis_context(TP.AxisGroup("model", rank=0, size=2, dims=())):
        assert L.cache_layout(types.SimpleNamespace(num_kv_heads=4)) \
            == "heads"
