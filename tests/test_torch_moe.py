"""The MoE family (dbrx-132b, grok-1-314b) in the port against the JAX
package.

The layer alone at ``d 32 / f 64`` and the two configs at the reference's
reduced size (2 layers, d 256, 4 query heads of 64, E 4 top-2, group 64,
capacity factor 1.25, vocab 512); weights from the reference's init,
carried across with ``repro_torch.convert``; inputs numpy draws handed to
both sides.

Routing is discrete: a token whose K-th and (K+1)-th gates lie closer than
the two frameworks' rounding may go to other experts in each, and then its
output differs by far more than any tolerance.  So every float32
comparison holds its premise on its own inputs: a token is compared when
the gap between its K-th and (K+1)-th gate exceeds ``GAP`` at every layer
(at least ``CLEAR`` of the tokens do, on these inputs), and every such
token must be routed alike in both packages (top-k indices and the
kept/dropped slot of each choice, every layer).  Ties are held exactly: a
zeroed router ties every gate, and the indices must be equal everywhere.
In bfloat16 (whose rounding moves a gate by ~1e-3) the logits are compared
over the tokens routed alike in both packages at every layer, and at least
``BF16_SAME`` of the tokens must be.

Tolerances: the layer's ``y`` within 1e-5 x max|y| and its aux within
1e-6; the models with the dense zoo's (logits within 1e-4 x max|logit| in
float32, 3e-2 in bfloat16), per-worker losses ``rtol=1e-5`` and gradients
1e-4 of each leaf's largest entry, one Moniqua train step with
``tests/test_torch_lm_train.py``'s.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JM
from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JShape
from repro.configs.base import MoEConfig as JMoE
from repro.core import algorithms as jalg
from repro.core.moniqua import MoniquaCodec as JCodec
from repro.core.quantizers import QuantSpec as JSpec
from repro.core.theta import ThetaSchedule as JTheta
from repro.core.topology import ring as jring
from repro.kernels import ops as jops
from repro.models.model_factory import build_model as jbuild
from repro.optim import sgd as jsgd
from repro.train import train_step as jts
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert, tree
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import InputShape as TShape
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.core import algorithms as talg
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.core.theta import ThetaSchedule as TTheta
from repro_torch.core.topology import ring as tring
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.model_factory import build_model as tbuild
from repro_torch.optim import sgd as tsgd
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = ("dbrx-132b", "grok-1-314b")
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
GAP = 1e-4
CLEAR = 0.98
BF16_SAME = 0.75
B, S = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six
    test workers on one machine, and each op's thread team would spin
    against the other workers' (measured: a 2-second test took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- routing, read from both packages ----------------------------------------

def _kept(topi, E, C):
    """The reference's capacity rule in numpy: whether choice ``kk`` of
    each token keeps its slot.  topi [G, g, K] -> bool [G, g, K]."""
    G, g, K = topi.shape
    fill = np.zeros((G, E), np.int64)
    kept = np.zeros(topi.shape, bool)
    for kk in range(K):
        oh = topi[..., kk, None] == np.arange(E)
        pos = fill[:, None, :] + np.cumsum(oh, axis=1) - 1
        kept[..., kk] = np.take_along_axis(pos, topi[..., kk, None],
                                           -1)[..., 0] < C
        fill += oh.sum(axis=1)
    return kept


def _signature(topi, moe):
    """Per token: its top-k experts and kept flags, ``[G * g, 2K]``."""
    G, g, K = topi.shape
    C = TM.capacity(g, K, moe.capacity_factor, moe.num_experts)
    kept = _kept(topi, moe.num_experts, C)
    return np.concatenate([topi, kept], -1).reshape(G * g, 2 * K)


def _gaps(gates, K):
    """The gap between each token's K-th and (K+1)-th gate."""
    s = np.sort(gates, axis=-1)[..., ::-1]
    return (s[..., K - 1] - s[..., K]).reshape(-1)


@contextlib.contextmanager
def _port_routes(monkeypatch):
    """Record ``(gates, topi)`` of every ``moe.route`` call of the port."""
    seen = []
    orig = TM.route

    def spy(p, xg, moe):
        out = orig(p, xg, moe)
        gates = torch.softmax(xg.float() @ p["router"], -1)
        seen.append((gates.detach().numpy(), out[1].numpy()))
        return out
    monkeypatch.setattr(TM, "route", spy)
    yield seen
    monkeypatch.setattr(TM, "route", orig)


@contextlib.contextmanager
def _ref_routes(monkeypatch):
    """Record ``(gates, topi)`` of every ``moe_layer`` call of the
    reference, computed with its own ops on the layer's input, eagerly."""
    seen = []
    orig = JM.moe_layer

    def spy(p, x, moe, gated):
        Bx, Sx, d = x.shape
        g = min(moe.group_size, Sx)
        xg = x.reshape(Bx * (Sx // g), g, d)
        gates = jax.nn.softmax(xg.astype(jnp.float32) @ p["router"], -1)
        topi = jax.lax.top_k(gates, moe.top_k)[1]
        seen.append((np.asarray(gates), np.asarray(topi)))
        return orig(p, x, moe, gated)
    monkeypatch.setattr(JM, "moe_layer", spy)
    with jax.disable_jit():
        yield seen
    monkeypatch.setattr(JM, "moe_layer", orig)


def _same_routing(jseen, tseen, moe):
    """Bool per token: routed alike in both packages at every call."""
    assert len(jseen) == len(tseen) > 0
    same = None
    for (_, ji), (_, ti) in zip(jseen, tseen):
        s = (_signature(ji, moe) == _signature(ti, moe)).all(-1)
        same = s if same is None else same & s
    return same


def _clear(gates_seen, K):
    """Bool per token: its gap exceeds GAP at every call."""
    return np.all([_gaps(g, K) > GAP for g in gates_seen], axis=0)


def _compared(jseen, tseen, moe, dtype="float32"):
    """The tokens to compare, after asserting the premise (module doc)."""
    same = _same_routing(jseen, tseen, moe)
    if dtype != "float32":
        assert same.mean() >= BF16_SAME, same.mean()
        return same
    clear = _clear([g for g, _ in jseen], moe.top_k)
    assert clear.mean() >= CLEAR, clear.mean()
    assert same[clear].all()
    return clear


def _assert_premise(jseen, tseen, moe):
    """For a comparison over the whole sequence (a loss, its gradients):
    the premise of ``_compared``, and every token routed alike."""
    _compared(jseen, tseen, moe)
    assert _same_routing(jseen, tseen, moe).all()


# -- capacity, top-k and the layer ---------------------------------------------

@pytest.mark.parametrize("case", [(256, 4, 1.25, 16), (64, 2, 2.0, 4),
                                  (1, 1, 0.1, 64), (1, 4, 1.25, 16),
                                  (1, 2, 1.25, 8), (64, 2, 1.25, 4)])
def test_capacity_matches_reference(case):
    """The reference's own cases (tests/test_moe_routing.py), and decode's
    group of one token for both configs."""
    assert TM.capacity(*case) == JM.capacity(*case)


@pytest.mark.parametrize("shape,k", [((5, 4), 2), ((3, 300, 16), 4)],
                         ids=["zeros", "integer-ties"])
def test_top_k_breaks_ties_like_lax(shape, k):
    """All-zero rows and small integers (many ties): values and indices
    equal ``jax.lax.top_k``'s, the lower index first."""
    rng = np.random.default_rng(0)
    a = (np.zeros(shape) if shape == (5, 4)
         else rng.integers(0, 3, shape)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(a), k)
    tv, ti = TM.top_k(torch.from_numpy(a), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _layer_case(router, cf, gated, E=4, K=2, g=64, d=32, f=64):
    moe_j = JMoE(num_experts=E, top_k=K, capacity_factor=cf, group_size=g)
    moe_t = TMoE(num_experts=E, top_k=K, capacity_factor=cf, group_size=g)
    p = JM.init_moe(jax.random.PRNGKey(0), d, f, moe_j, gated, jnp.float32)
    if router == "zero":
        p = dict(p, router=jnp.zeros_like(p["router"]))
    x = np.random.default_rng(1).standard_normal((2, 2 * g, d)
                                                 ).astype(np.float32)
    return moe_j, moe_t, p, convert.to_torch(jax.tree.map(np.asarray, p),
                                             device="cpu"), x


CASES = [("random", 1.25), ("zero", 1.25), ("random", 0.1)]
CASE_IDS = ["cf1.25", "zero-router-ties", "cf0.1-drops"]


@pytest.mark.parametrize("router,cf", CASES, ids=CASE_IDS)
def test_route_matches_reference(router, cf):
    """``route``'s top-k indices equal ``jax.lax.top_k``'s on the
    reference's gates (every gate ties under the zeroed router); dispatch
    and combine equal the reference's capacity rule applied to them."""
    moe_j, moe_t, p, tp, x = _layer_case(router, cf, True)
    E, K = moe_t.num_experts, moe_t.top_k
    xg = x.reshape(-1, moe_t.group_size, x.shape[-1])
    gates = jax.nn.softmax(jnp.asarray(xg) @ p["router"], -1)
    jg, ji = (np.asarray(a) for a in jax.lax.top_k(gates, K))
    topg, topi, dispatch, combine, aux = TM.route(tp, torch.from_numpy(xg),
                                                  moe_t)
    ti = topi.numpy()
    if router == "zero":                 # every gate ties
        np.testing.assert_array_equal(ti, ji)
    else:
        clear = _clear([np.asarray(gates)], K).reshape(ji.shape[:2])
        assert clear.mean() >= CLEAR
        np.testing.assert_array_equal(ti[clear], ji[clear])
    np.testing.assert_allclose(topg.numpy(), jg, rtol=1e-6, atol=0)
    C = TM.capacity(moe_t.group_size, K, cf, E)
    kept = _kept(ti, E, C)
    assert kept.any() and (cf > 1 or not kept.all())
    if router == "zero":             # all to experts 0 and 1: C of g kept
        assert kept.mean() == C / moe_t.group_size
    # the rule token by token: choice kk of token t -> (expert, slot) if kept
    want = np.zeros(dispatch.shape, np.float32)
    want_c = np.zeros(combine.shape, np.float32)
    fill = np.zeros((xg.shape[0], E), np.int64)
    for kk in range(K):
        for z in range(xg.shape[0]):
            for t in range(xg.shape[1]):
                e = ti[z, t, kk]
                if fill[z, e] < C:
                    want[z, t, e, fill[z, e]] = 1.0
                    want_c[z, t, e, fill[z, e]] = topg.numpy()[z, t, kk]
                fill[z, e] += 1
    np.testing.assert_array_equal(dispatch.numpy(), want)
    np.testing.assert_array_equal(combine.numpy(), want_c)
    assert aux.dtype == torch.float32


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "gelu"])
@pytest.mark.parametrize("router,cf", CASES, ids=CASE_IDS)
def test_moe_layer_matches_reference(router, cf, gated, monkeypatch):
    """``y`` within 1e-5 x max|y| (over the tokens whose gaps clear GAP;
    all of them under the zeroed router), ``aux`` within 1e-6."""
    moe_j, moe_t, p, tp, x = _layer_case(router, cf, gated)
    with _ref_routes(monkeypatch) as jseen:
        yj, aj = JM.moe_layer(p, jnp.asarray(x), moe_j, gated)
    with _port_routes(monkeypatch) as tseen:
        yt, at = TM.moe_layer(tp, torch.from_numpy(x), moe_t, gated)
    rows = (np.ones(x.shape[:2], bool) if router == "zero" else
            _compared(jseen, tseen, moe_t).reshape(x.shape[:2]))
    yj = np.asarray(yj)
    assert yt.shape == yj.shape and at.shape == ()
    err = np.abs(yt.numpy() - yj)[rows]
    assert err.max() <= 1e-5 * np.abs(yj).max()
    assert abs(float(at) - float(aj)) <= 1e-6


def test_moe_layer_vmap_grad_matches_reference(monkeypatch):
    """Two workers' gradients of ``sum(y) + aux`` under ``vmap(grad)``
    (the train step's transform): the router's included."""
    moe_j, moe_t, p, _, x = _layer_case("random", 1.25, True)
    rng = np.random.default_rng(2)
    P = jax.tree.map(lambda a: (np.asarray(a)[None] + 0.02 * rng.standard_normal(
        (2,) + a.shape)).astype(np.float32), p)
    X = np.stack([x, x[::-1].copy()])
    tP = convert.to_torch(P, device="cpu")
    for w in range(2):              # the premise, worker by worker
        with _ref_routes(monkeypatch) as jseen:
            JM.moe_layer(jax.tree.map(lambda a: jnp.asarray(a[w]), P),
                         jnp.asarray(X[w]), moe_j, True)
        with _port_routes(monkeypatch) as tseen:
            TM.moe_layer(tree.map(lambda a: a[w], tP), torch.from_numpy(X[w]),
                         moe_t, True)
        _assert_premise(jseen, tseen, moe_t)

    def jf(p, x):
        y, aux = JM.moe_layer(p, x, moe_j, True)
        return jnp.sum(y * y) + aux

    def tf(p, x):
        y, aux = TM.moe_layer(p, x, moe_t, True)
        return torch.sum(y * y) + aux
    jg = jax.vmap(jax.grad(jf))(jax.tree.map(jnp.asarray, P), jnp.asarray(X))
    tg = torch.func.vmap(torch.func.grad(tf))(tP, torch.from_numpy(X))
    for a, c in zip(jax.tree.leaves(jg), tree.leaves(tg)):
        a = np.asarray(a)
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(c.numpy(), a, rtol=0,
                                   atol=1e-4 * float(np.abs(a).max()))


# -- the two configs, reduced ----------------------------------------------------

def _models(arch, dtype="float32"):
    jm = jbuild(dataclasses.replace(jget_config(arch).reduced(), dtype=dtype))
    tm = tbuild(dataclasses.replace(tget_config(arch).reduced(), dtype=dtype),
                device="cpu")
    params = jm.init(jax.random.PRNGKey(0))
    return jm, tm, params, convert.to_torch(jax.tree.map(np.asarray, params),
                                            device="cpu")


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def _gap(ref, got, rows=None):
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    scale = np.abs(ref).max()
    if rows is not None:
        ref, got = ref[rows], got[rows]
    return np.abs(got - ref).max() / scale


def test_reduced_configs_are_the_moe_family():
    for arch in ARCHS:
        cfg = tget_config(arch).reduced()
        assert cfg.family == "moe" and cfg.moe.num_experts == 4
        assert cfg.moe.top_k == 2 and cfg.moe.group_size == 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, monkeypatch):
    """Prefill logits (all positions and ``last_only``), then 8 decode
    steps (each token routed alone: a group of one, capacity 1) from an
    empty cache, over the tokens routed alike (all of them in float32)."""
    jm, tm, params, tp = _models(arch, dtype)
    moe = tm.cfg.moe
    toks = _tokens(jm.cfg.vocab_size, (B, S))
    for last_only in (False, True):
        with _ref_routes(monkeypatch) as jseen:
            ref = jm.prefill_logits(params, {"tokens": jnp.asarray(toks)},
                                    last_only=last_only)
        with _port_routes(monkeypatch) as tseen:
            got = tm.prefill_logits(tp, {"tokens": torch.from_numpy(toks)},
                                    last_only=last_only)
        rows = _compared(jseen, tseen, moe, dtype).reshape(B, S)
        assert _gap(ref, got, rows[:, -1:] if last_only else rows) \
            <= TOL[dtype]
    dec = _tokens(jm.cfg.vocab_size, (B, 8), seed=1)
    jc = jm.init_cache(B, JShape("d", 16, B, "decode"))
    tc = tm.init_cache(B, TShape("d", 16, B, "decode"))
    n_same = 0
    for s in range(8):
        with _ref_routes(monkeypatch) as jseen:
            jl, jc = jm.decode_step(params, jc, jnp.asarray(dec[:, s:s + 1]))
        with _port_routes(monkeypatch) as tseen:
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(dec[:, s:s + 1]))
        rows = (_compared(jseen, tseen, moe) if dtype == "float32"
                else _same_routing(jseen, tseen, moe))
        n_same += rows.sum()
        assert _gap(jl, tl, rows.reshape(B, 1)) <= TOL[dtype]
        assert int(jc["pos"]) == int(tc["pos"]) == s + 1
    assert n_same >= BF16_SAME * 8 * B
    assert tuple(tc["layers"]["k"].shape) == jc["layers"]["k"].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_aux_matches_reference(arch, monkeypatch):
    """``Model.loss`` = ``xent`` + 0.01 x the aux summed over layers, equal
    to the reference's; the aux term is there (about 1 a layer)."""
    jm, tm, params, tp = _models(arch)
    toks = _tokens(jm.cfg.vocab_size, (B, S + 1), seed=4)
    b = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    with _ref_routes(monkeypatch) as jseen:
        want = float(jm.loss(params, jax.tree.map(jnp.asarray, b)))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with _port_routes(monkeypatch) as tseen:
        got = tm.loss(tp, tb)
    _assert_premise(jseen, tseen, tm.cfg.moe)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    logits, aux = TT.lm_logits(tp, tm.cfg, tb["tokens"])
    xe = TT.xent(logits, tb["labels"], tm.cfg.vocab_size)
    assert aux.dtype == torch.float32
    assert 0.9 * tm.cfg.num_layers <= float(aux) <= 2.0 * tm.cfg.num_layers
    assert torch.equal(got, xe + tm.cfg.moe.aux_loss_weight * aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_match_reference(arch, monkeypatch):
    """Two workers' losses and gradients (the train step's ``vmap(grad)``)
    through the port's flash route, against the reference's."""
    jm, tm, params, _ = _models(arch)
    rng = np.random.default_rng(3)
    X = jax.tree.map(lambda a: (np.asarray(a)[None] + 0.02
                                * rng.standard_normal((2,) + a.shape))
                     .astype(np.float32), params)
    toks = _tokens(jm.cfg.vocab_size, (2, B, S + 1), seed=2)
    b = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}
    tX = convert.to_torch(X, device="cpu")
    for w in range(2):              # the premise, worker by worker
        with _ref_routes(monkeypatch) as jseen:
            jm.loss(jax.tree.map(lambda a: jnp.asarray(a[w]), X),
                    {k: jnp.asarray(v[w]) for k, v in b.items()})
        with _port_routes(monkeypatch) as tseen:
            tm.loss(tree.map(lambda a: a[w], tX),
                    {k: torch.from_numpy(v[w]) for k, v in b.items()})
        _assert_premise(jseen, tseen, tm.cfg.moe)
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jm.loss)))(
        jax.tree.map(jnp.asarray, X), jax.tree.map(jnp.asarray, b))
    assert tm.cfg.flash_attention
    tg, tl = torch.func.vmap(torch.func.grad_and_value(tm.loss))(
        tX, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for a, c in zip(jax.tree.leaves(jg), tree.leaves(tg)):
        a = np.asarray(a)
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(c.numpy(), a, rtol=0,
                                   atol=1e-4 * float(np.abs(a).max()))
    assert tg["blocks"]["moe"]["router"].dtype == torch.float32


def _hypers(n):
    spec = dict(bits=8, stochastic=True)
    return (jalg.AlgoHyper(topo=jring(n), codec=JCodec(JSpec(**spec)),
                           theta=2.0, backend="jnp"),
            talg.AlgoHyper(topo=tring(n), codec=TCodec(TSpec(**spec)),
                           theta=2.0))


@pytest.mark.parametrize("arch", ARCHS)
def test_moniqua_train_step_matches_reference(arch):
    """One Moniqua 8-bit ``train_step`` on ring(2) over the MoE tree (the
    float32 router beside the other leaves), the reference's per-step seed
    handed in: the parameters within ``1e-6 + lr * 1e-4 * max|d|`` of each
    leaf, the loss within ``rtol=1e-5``, the wire bytes equal."""
    n, lr = 2, 0.1
    jm, tm, params, _ = _models(arch)
    rng = np.random.default_rng(0)
    X = jax.tree.map(lambda a: (np.asarray(a)[None] + 0.02
                                * rng.standard_normal((n,) + a.shape))
                     .astype(np.float32), params)
    jX, tX = jax.tree.map(jnp.asarray, X), convert.to_torch(X, device="cpu")
    jhp, thp = _hypers(n)
    assert jhp.engine().resolved_path(jX) == thp.engine().resolved_path(tX)
    sgd = dict(momentum=0.9, weight_decay=5e-4)
    jstep = jax.jit(jts.make_train_step(jm, jhp, jts.TrainStepConfig(
        algo="moniqua", sgd=jsgd.SGDConfig(**sgd), lr=lr,
        theta=JTheta(value=2.0))))
    tstep = tts.make_train_step(tm, thp, tts.TrainStepConfig(
        algo="moniqua", sgd=tsgd.SGDConfig(**sgd), lr=lr,
        theta=TTheta(value=2.0)))
    js = {"params": jX, "mom": jsgd.init_momentum(jX), "extra": {},
          "step": jnp.zeros((), jnp.int32),
          "g_inf": jnp.ones((), jnp.float32), "key": jax.random.PRNGKey(0)}
    ts = {"params": tX, "mom": tsgd.init_momentum(tX), "extra": {},
          "step": 0, "g_inf": torch.ones(()), "gen": torch.Generator()}
    toks = _tokens(jm.cfg.vocab_size, (n, B, S + 1), seed=5)
    b = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}
    seed = int(jops._key_to_seed(jax.random.split(js["key"])[1]))
    js, jmet = jstep(js, jax.tree.map(jnp.asarray, b))
    ts, tmet = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()},
                     seed=seed)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert tmet["wire_bytes"] == float(jmet["wire_bytes"])
    for a, c, d in zip(jax.tree.leaves(js["params"]),
                       tree.leaves(ts["params"]),
                       jax.tree.leaves(js["mom"])):
        a, d = np.asarray(a), np.asarray(d)
        assert c.dtype == torch.float32
        tol = 1e-6 + lr * 1e-4 * np.abs(d).max()
        assert (np.abs(c.numpy() - a) <= tol).all()


SHAPE = ("tiny", 64, 4, "train")


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_on_moe_matches_reference_bytes(arch):
    """``Trainer(model, tc, shape)`` on the reduced config, bf16 as
    published: the reference ``Trainer``'s ``bytes_per_step`` on its
    abstract state, for D-PSGD and Moniqua 8-bit; finite losses that
    include the aux term."""
    over = dict(dtype="bfloat16", num_layers=1)
    jmodel = jbuild(dataclasses.replace(jget_config(arch).reduced(), **over))
    tmodel = tbuild(dataclasses.replace(tget_config(arch).reduced(), **over),
                    device="cpu")
    common = dict(n_workers=2, lr=0.1, steps=2, log_every=1, seed=1)
    for algo, kw in (("dpsgd", {}), ("moniqua", dict(bits=8, theta=2.0))):
        out = Trainer(tmodel, TrainerConfig(algo=algo, **common, **kw),
                      TShape(*SHAPE)).run()
        jt = JTrainer(jmodel, JShape(*SHAPE), JTrainerConfig(
            algo=algo, **common, **kw))
        assert out["bytes_per_step"] == jt.bytes_per_step(
            jts.abstract_state(jmodel, jt.algo, jt.hp, 2))
        losses = [h["loss"] for h in out["history"]]
        assert np.isfinite(losses).all() and len(losses) == 2
