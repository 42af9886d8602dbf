"""The port's sharding rules and meshes against the reference's.

Every case of ``tests/test_sharding.py`` on ``repro_torch.models.sharding``;
then the resolved ``params_pspecs``, ``state_pspecs``, ``batch_pspecs`` and
``cache_pspecs`` of all eleven archs (reduced, plus the published
llama3.2-3b and dbrx-132b) equal the reference's, path for path, at the
single-pod, multi-pod and two-tier mesh shapes, with both ``kv_div``
values; the mesh factories on torch's fake process group (no ranks run);
a weight-sharding mesh refused with ``NotImplementedError`` (#13e) for the
families the port does not split, and admitted for the dense family at
head counts ``model`` does not divide (context-parallel attention); the
decode cache a rank holds on the production mesh, on ``meta``, is the cut
its resolved ``cache_pspecs`` name.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_MODULES
from repro.configs import get_config as jget_config
from repro.core.algorithms import AlgoHyper as JHyper
from repro.core.algorithms import get_algorithm as jget_algorithm
from repro.core.topology import ring as jring
from repro.models.model_factory import build_model as jbuild
from repro.models.sharding import ShardingRules as JRules
from repro.train import serve_step as JSS
from repro.train import train_step as JTS
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, get_input_shape
from repro_torch.core.algorithms import AlgoHyper, get_algorithm
from repro_torch.core.topology import ring
from repro_torch.models import sharding as SH
from repro_torch.models.model_factory import build_model
from repro_torch.models.sharding import P, ShardingRules, dim_divides, \
    safe_pspec
from repro_torch.train import serve_step as SS
from repro_torch.train import train_step as TS

torch.set_num_threads(1)

MESH_1POD = {"data": 16, "model": 16}
MESH_2POD = {"pod": 2, "data": 16, "model": 16}
MESH_TIER = {"inter": 8, "intra": 4, "model": 8}
MESHES = {"1pod": (MESH_1POD, {}), "2pod": (MESH_2POD, {"multi_pod": True}),
          "tier": (MESH_TIER, {"tiers": 2})}
ARCHS = list(ARCH_MODULES)          # the ten assigned archs and resnet20


# -- tests/test_sharding.py, case for case -----------------------------------

def test_worker_axes_by_mode():
    assert ShardingRules("decentralized").worker_axes == ("data",)
    assert ShardingRules("decentralized", multi_pod=True).worker_axes \
        == ("pod", "data")
    assert ShardingRules("hierarchical").worker_axes == ()
    assert ShardingRules("hierarchical", multi_pod=True).worker_axes \
        == ("pod",)
    assert ShardingRules("decentralized", tiers=2).worker_axes \
        == ("inter", "intra")


def test_safe_pspec_fallback():
    assert safe_pspec((48, 128), P("model", None), MESH_1POD) \
        == P("model", None)
    assert safe_pspec((8, 128), P("model", None), MESH_1POD) == P(None, None)
    assert dim_divides(32, MESH_2POD, ("pod", "data"))
    assert not dim_divides(24, MESH_2POD, ("pod", "data"))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "dbrx-132b", "xlstm-125m",
                                  "zamba2-1.2b", "whisper-base"])
def test_params_pspecs_align_with_param_tree(arch):
    from repro_torch import tree
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    specs = TS.params_pspecs(model, ShardingRules(cfg.dist_mode), MESH_1POD,
                             stacked=True)
    s_leaves = tree.leaves(specs)
    a_leaves = tree.leaves(TS.abstract_params(model))
    assert len(s_leaves) == len(a_leaves)
    for sp, leaf in zip(s_leaves, a_leaves):
        assert isinstance(sp, P)
        assert len(sp) <= leaf.dim() + 1


def test_n_workers_for():
    assert TS.n_workers_for(None, ShardingRules("decentralized"),
                            MESH_1POD) == 16
    assert TS.n_workers_for(None, ShardingRules("decentralized", True),
                            MESH_2POD) == 32
    assert TS.n_workers_for(None, ShardingRules("hierarchical"),
                            MESH_1POD) == 1
    assert TS.n_workers_for(None, ShardingRules("hierarchical", True),
                            MESH_2POD) == 2
    assert TS.n_workers_for(None, ShardingRules("decentralized", tiers=2),
                            MESH_TIER) == 32


def test_hierarchical_fsdp_axis():
    r = ShardingRules("hierarchical")
    assert r.fsdp_axis == "data"
    assert r.pspec("embed", "mlp") == P("data", "model")
    assert ShardingRules("decentralized").pspec("embed", "mlp") \
        == P(None, "model")


def test_constraint_context_noop_without_launcher():
    x = torch.zeros((4, 8))
    assert SH.constrain(x, None, "kv_seq") is x
    assert SH.mesh_axis_size("model") == 1
    with SH.constraint_context(ShardingRules("decentralized"), MESH_1POD):
        assert SH.mesh_axis_size("model") == 16
        spec = SH.safe_pspec((4, 8), ShardingRules("decentralized")
                             .pspec(None, "kv_seq"), MESH_1POD)
        assert spec == P(None, None)                  # 8 % 16 -> replicate
        assert SH.constrain(x, None, "kv_seq") is x   # replicated: runs
    assert SH.mesh_axis_size("model") == 1


def test_kv_seq_rule():
    assert ShardingRules("decentralized").pspec("kv_seq") == P("model")


# -- the port's spec type and rules against the reference's ------------------

def test_partition_spec_normalizes_as_jax():
    for parts in [(), (None,), ("data",), (("data",), None),
                  (("pod", "data"), "model"), ([], "model"),
                  (["pod", "data"],)]:
        assert tuple(P(*parts)) == tuple(JP(*parts)), parts
    assert P("a", None) != P("a") and hash(P("a")) == hash(P(("a",)))


@pytest.mark.parametrize("mode", ["decentralized", "hierarchical"])
@pytest.mark.parametrize("multi_pod,tiers", [(False, 1), (True, 1),
                                             (False, 2)])
def test_rule_tables_equal_the_reference(mode, multi_pod, tiers):
    ours = ShardingRules(mode, multi_pod=multi_pod, tiers=tiers)
    ref = JRules(mode, multi_pod=multi_pod, tiers=tiers)
    assert ours.table() == ref.table()
    assert ours.worker_axes == ref.worker_axes
    assert ours.fsdp_axis == ref.fsdp_axis
    for names in [("worker", "batch"), ("embed", "heads", None),
                  ("stack", "global_batch", "kv_seq", None), ("nope",)]:
        assert tuple(ours.pspec(*names)) == tuple(ref.pspec(*names))


# -- resolved specs, path for path -------------------------------------------

def _jflat(t):
    out = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(jax.tree_util.keystr(p), tuple(v)) for p, v in out]


def _tflat(t, pre=""):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _tflat(t[k], f"{pre}['{k}']")]
    if isinstance(t, (list, tuple)):
        return [x for i, v in enumerate(t) for x in _tflat(v, f"{pre}[{i}]")]
    return [(pre, tuple(t))]


def _models(arch, published=False):
    jc, tc = jget_config(arch), get_config(arch)
    if not published:
        jc, tc = jc.reduced(), tc.reduced()
    return jbuild(jc), build_model(tc, device="cpu")


def _rules(cfg, over):
    """The arch's mode; the two-tier worker split is decentralized (a
    hierarchical arch's FSDP axis ``data`` is not on that mesh)."""
    mode = "decentralized" if over.get("tiers", 1) > 1 else cfg.dist_mode
    return JRules(mode, **over), ShardingRules(mode, **over)


HYPERS = {"moniqua": ("moniqua", {}), "ef_qsgd": ("moniqua",
                                                  {"wire": "ef_qsgd"}),
          "stale": ("moniqua", {"overlap": "stale"}), "d2": ("d2", {}),
          "choco": ("choco", {})}


def _check_specs(arch, mesh_name, published=False, hypers=("moniqua",)):
    mesh, over = MESHES[mesh_name]
    jm, tm = _models(arch, published)
    jr, tr = _rules(tm.cfg, over)
    assert _tflat(TS.params_pspecs(tm, tr, mesh)) \
        == _jflat(JTS.params_pspecs(jm, jr, mesh))
    assert _tflat(TS.params_pspecs(tm, tr, mesh, stacked=False)) \
        == _jflat(JTS.params_pspecs(jm, jr, mesh, stacked=False))
    n = TS.n_workers_for(None, tr, mesh)
    for h in hypers:
        algo, kw = HYPERS[h]
        # a two-tier mesh: nodes of its intra size (the EF residual is
        # then [n_inter, D], replicated in both packages)
        tiers = mesh.get("intra", 1)
        jst = JTS.state_pspecs(jm, jget_algorithm(algo),
                               JHyper(topo=jring(n), tiers=tiers, **kw), jr,
                               mesh, n)
        jst["gen"] = jst.pop("key")
        tst = TS.state_pspecs(tm, get_algorithm(algo),
                              AlgoHyper(topo=ring(n), tiers=tiers, **kw), tr,
                              mesh, n)
        assert _tflat(tst) == _jflat(jst), h
    shape = InputShape("t", 64, n * 2, "train")
    spec = tm.batch_spec(shape)
    jb = {k: jax.ShapeDtypeStruct((n, s[0] // n) + tuple(s[1:]), np.float32)
          for k, (s, _) in spec.items()}
    tb = {k: torch.empty((n, s[0] // n) + tuple(s[1:]), device="meta")
          for k, (s, _) in spec.items()}
    assert _tflat(TS.batch_pspecs(tb, tr, mesh)) \
        == _jflat(JTS.batch_pspecs(jb, jr, mesh))
    dec = get_input_shape("decode_32k")
    assert _tflat(SS.cache_pspecs(tm, dec, tr, mesh)) \
        == _jflat(JSS.cache_pspecs(jm, dec, jr, mesh))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolved_specs_equal_the_reference(arch, mesh_name):
    # the stale overlap is single-tier only
    hypers = {"1pod": tuple(HYPERS), "2pod": ("moniqua",),
              "tier": ("moniqua", "ef_qsgd", "d2")}[mesh_name]
    _check_specs(arch, mesh_name, hypers=hypers)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "dbrx-132b"])
def test_published_specs_equal_the_reference(arch):
    _check_specs(arch, "1pod", published=True)


@pytest.mark.parametrize("kv_div", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logical_equals_the_reference(arch, kv_div):
    jm, tm = _models(arch)
    assert tm.cache_logical(kv_div=kv_div) == jm.cache_logical(kv_div=kv_div)


def test_both_kv_div_values_resolve():
    """llama's 8 KV heads do not divide 16 model ranks (the cache shards
    its sequence dim) and divide 8 (it shards the heads)."""
    _, tm = _models("llama3.2-3b", published=True)
    dec = get_input_shape("decode_32k")
    one = SS.cache_pspecs(tm, dec, ShardingRules("decentralized"), MESH_1POD)
    tier = SS.cache_pspecs(tm, dec, ShardingRules("decentralized", tiers=2),
                           MESH_TIER)
    assert one["layers"]["k"] == P(None, "data", "model", None, None)
    assert tier["layers"]["k"] == P(None, ("inter", "intra"), None, "model",
                                    None)


# -- meshes on the fake process group ----------------------------------------

@pytest.fixture(scope="module")
def fake_world():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_factories_shapes(fake_world):
    from repro_torch.launch import mesh as M
    for mesh, shape in [
            (M.make_production_mesh(device_type="cpu"),
             {"data": 16, "model": 16}),
            (M.make_production_mesh(multi_pod=True, device_type="cpu"),
             {"pod": 2, "data": 16, "model": 16}),
            (M.make_two_tier_mesh(device_type="cpu"),
             {"inter": 8, "intra": 4, "model": 8}),
            (M.make_host_mesh(device_type="cpu"), {"data": 4, "model": 2}),
            (M.make_host_mesh(pod=2, device_type="cpu"),
             {"pod": 2, "data": 4, "model": 2})]:
        assert M.mesh_shape_dict(mesh) == shape
        assert list(mesh.mesh_dim_names) == list(shape)


def test_weight_sharding_mesh_raises_13e(fake_world):
    """The production mesh's model axis (16) on a family whose weights the
    port does not split (whisper-base, ROADMAP #13e.4): the trainer
    refuses it rather than replicating them.  (The dense family runs there
    since context-parallel attention: below.)"""
    from repro_torch.launch import mesh as M
    from repro_torch.models.model_factory import Model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    mesh = M.make_production_mesh(device_type="cpu")
    model = Model(get_config("whisper-base").reduced(), "cpu")
    tc = TrainerConfig(n_workers=16, steps=1)
    with pytest.raises(NotImplementedError, match="#13e"):
        Trainer(model, tc, InputShape("t", 32, 16, "train"), mesh=mesh,
                rules=ShardingRules("decentralized"))


def test_placements_of_resolved_specs(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import mesh as M
    mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
    assert SH.placements(P(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert SH.placements(P(None, None), mesh) == [Replicate()] * 3


def test_constrain_raises_on_the_model_axis():
    """A constraint over ``model`` raises, except the context-parallel
    ``kv_seq``, whose share ``models.layers._context_parallel_kv`` cuts."""
    x = torch.zeros((4, 32, 2, 8))
    with SH.constraint_context(ShardingRules("decentralized"), MESH_1POD):
        with pytest.raises(NotImplementedError, match="#13e"):
            SH.constrain(x, None, "mlp", None, None)
        assert SH.constrain(x, None, "kv_seq", None, None) is x


def test_indivisible_worker_split_is_refused(fake_world):
    """6 workers on 4 data ranks: ``safe_pspec`` replicates a state leaf
    whose leading dim is the 6 workers (the EF residual), and the trainer
    refuses the split rather than run any of it replicated."""
    from repro_torch.launch import mesh as M
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.train.trainer import Trainer, TrainerConfig
    mesh = M.make_host_mesh(data=4, model=1, device_type="cpu")
    rules = ShardingRules("decentralized")
    model = ResNetModel(depth=8, width=8, device="cpu")
    specs = TS.state_pspecs(model, get_algorithm("moniqua"),
                            AlgoHyper(topo=ring(6), wire="ef_qsgd"), rules,
                            M.mesh_shape_dict(mesh), 6)
    assert specs["extra"]["wire"]["residual"] == P(None, None)
    with pytest.raises(ValueError, match="do not split"):
        Trainer(model, TrainerConfig(n_workers=6, steps=1, wire="ef_qsgd"),
                lambda k: {}, mesh=mesh, rules=rules)


@pytest.mark.parametrize("arch,mode", [("llama3.2-3b", "decentralized"),
                                       ("chatglm3-6b", "decentralized"),
                                       ("qwen2-72b", "hierarchical")])
def test_production_mesh_admits_heads_model_does_not_divide(arch, mode):
    """The published dense configs on the production mesh (model 16):
    llama3.2-3b's 24 heads and 8 KV heads, chatglm3-6b's 32 over 2,
    qwen2-72b's 64 over 8 (FSDP over data): context-parallel attention or
    replicated-KV GQA, none refused; the attention weights of the heads
    case resolve whole over ``model`` (``safe_pspec`` replicates
    ``heads`` and ``kv``)."""
    cfg = get_config(arch)
    rules = ShardingRules(mode)
    assert SH.tensor_parallel_refusal(cfg, rules, MESH_1POD) is None
    if cfg.num_heads % MESH_1POD["model"]:
        specs = SS.serving_pspecs(build_model(cfg, device="meta"), rules,
                                  MESH_1POD)
        for leaf, spec in specs["blocks"]["attn"].items():
            assert "model" not in [a for e in spec for a in
                                   (e if isinstance(e, tuple) else (e,))], \
                (leaf, spec)


@pytest.mark.parametrize("arch,mode", [("qwen2-72b", "hierarchical"),
                                       ("llama3.2-3b", "decentralized"),
                                       ("chatglm3-6b", "decentralized")])
def test_decode_cache_a_rank_holds_is_its_specs_cut(fake_world, arch, mode):
    """The cache a rank of the production mesh ``(data=16, model=16)``
    holds for ``decode_32k`` (built on ``meta``: nothing allocated) is the
    cut of ``abstract_cache`` its resolved ``cache_pspecs`` name over
    ``model`` and the rules' FSDP axis (the batch rows it serves): the KV
    heads do not divide 16, so every KV head over 32768 / 16 slots.  For
    qwen2-72b under the hierarchical rules (8 rows a ``data`` rank, 80
    layers, 8 KV heads of 128, K and V in bfloat16) that is 5 GiB; a
    cache of every slot, as each rank held before, is 80 GiB."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.launch import mesh as M
    mesh = M.make_production_mesh(device_type="cpu")
    rules = ShardingRules(mode)
    model = dataclasses.replace(build_model(get_config(arch), device="cpu"),
                                device="meta")
    shape = get_input_shape("decode_32k")
    lo, hi = SS.batch_rows(shape.global_batch, mesh, rules)
    got = SS.make_cache(model, hi - lo, shape, mesh=mesh, rules=rules)
    axes = ("model",) + ((rules.fsdp_axis,) if rules.fsdp_axis else ())
    want = SS.cache_cut(model, shape, rules, MESH_1POD, axes=axes)
    g_leaves, w_leaves = tree.leaves(got), tree.leaves(want)
    assert [a.shape for a in g_leaves] == [w.shape for w in w_leaves]
    assert all(a.device.type == "meta" for a in g_leaves)
    nbytes = sum(a.numel() * a.element_size() for a in g_leaves)
    whole_slots = sum(a.numel() * a.element_size() for a in
                      tree.leaves(got["layers"])) * MESH_1POD["model"]
    assert got["layers"]["k"].shape[2] * 16 == 32768
    if arch == "qwen2-72b":
        assert hi - lo == 8
        assert nbytes <= 5 * 2 ** 30 + 64
        assert whole_slots == 80 * 2 ** 30
