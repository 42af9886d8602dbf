"""The hybrid family (Mamba2 + a shared attention block: zamba2-1.2b) in
the port against the JAX package.

The Mamba2 pieces at small shapes, then zamba2-1.2b at the reference's
reduced size (d 256, 4 heads of 64, SSM state 16, chunk 32, vocab 512)
with 4 layers and the shared block after every 2nd, so that it runs twice
and its gradient sums two call sites.  Weights from the reference's init,
carried across with ``repro_torch.convert``; the float32 ``a_log``,
``dt_bias`` and ``d_skip`` (0, 0 and 1 at init) first set to the same
seeded values on both sides, so that their paths are exercised.  Inputs
are numpy draws handed to both.

Tolerances:

* ``_causal_conv`` within 1e-6 x max (eager float32 on both sides);
* ``_ssd_chunked`` in float32 within 1e-5 x max of the reference evaluated
  in float64, and within 3e-5 of it in float32 (measured 1.5e-5: the
  reference's ``jnp.cumsum`` associates otherwise than a running sum and
  sits 4.2e-6 from float64 where the port's sits 9.5e-7, and the chunk's
  decay exponentiates differences of those sums); in bfloat16 within 3e-2
  of the max (measured 1e-3 and 4e-3);
* ``mamba_block`` and 8 steps of ``mamba_decode`` within 1e-4 x max;
* the model: logits within 1e-4 x max|logit| in float32; in bfloat16
  within 6e-2 (measured 3.9e-2: the reference's own bfloat16 logits lie
  3.6e-2 from its float32 evaluation of the same weights, the bf16 chunk
  states and decays rounding at every layer); per-worker losses
  ``rtol=1e-5`` and gradients 1e-4 of each leaf's largest entry; one
  Moniqua train step with ``tests/test_torch_lm_train.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JShape
from repro.core import algorithms as jalg
from repro.core.moniqua import MoniquaCodec as JCodec
from repro.core.quantizers import QuantSpec as JSpec
from repro.core.theta import ThetaSchedule as JTheta
from repro.core.topology import ring as jring
from repro.kernels import ops as jops
from repro.models import mamba2 as JMB
from repro.models.model_factory import build_model as jbuild
from repro.optim import sgd as jsgd
from repro.train import train_step as jts
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert, tree
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import InputShape as TShape
from repro_torch.core import algorithms as talg
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.core.theta import ThetaSchedule as TTheta
from repro_torch.core.topology import ring as tring
from repro_torch.models import mamba2 as TMB
from repro_torch.models import zamba as TZ
from repro_torch.models.model_factory import build_model as tbuild
from repro_torch.optim import sgd as tsgd
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "zamba2-1.2b"
OVER = dict(num_layers=4, shared_attn_every=2)
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
B, S = 2, 64
SSM_LEAVES = ("a_log", "dt_bias", "d_skip")


def _rel(got, ref):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _seeded_ssm(p, rng, lead=()):
    """``a_log``, ``dt_bias`` (0 at init) and ``d_skip`` (1) set to seeded
    values: A = -exp(a_log) in ~[0.5, 2], dt offsets, skip weights."""
    shape = p["a_log"].shape
    return dict(p, a_log=jnp.asarray(0.3 * rng.standard_normal(shape),
                                     jnp.float32),
                dt_bias=jnp.asarray(0.5 * rng.standard_normal(shape),
                                    jnp.float32),
                d_skip=jnp.asarray(1 + 0.3 * rng.standard_normal(shape),
                                   jnp.float32))


def _cfgs(dtype="float32", **over):
    over = dict(OVER, dtype=dtype, **over)
    return (dataclasses.replace(jget_config(ARCH).reduced(), **over),
            dataclasses.replace(tget_config(ARCH).reduced(), **over))


def _models(dtype="float32", **over):
    jcfg, tcfg = _cfgs(dtype, **over)
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    params = jm.init(jax.random.PRNGKey(0))
    body = dict(params["body"], mamba=_seeded_ssm(
        params["body"]["mamba"], np.random.default_rng(7)))
    params = dict(params, body=body)
    return jm, tm, params, convert.to_torch(jax.tree.map(np.asarray, params),
                                            device="cpu")


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six
    test workers on one machine, and each op's thread team would spin
    against the other workers' (measured: a 2-second test took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the Mamba2 pieces ---------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "state"])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, 16, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    jo, js = JMB._causal_conv(jnp.asarray(u), jnp.asarray(w),
                              None if st is None else jnp.asarray(st))
    to, ts = TMB._causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                              None if st is None else torch.from_numpy(st))
    assert _rel(to, jo) <= 1e-6
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _ssd_inputs(S=64, H=4, D=16, N=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, H, D)).astype(np.float32)
    dtv = np.log1p(np.exp(rng.standard_normal((2, S, H)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((2, S, N)).astype(np.float32)
    Cm = rng.standard_normal((2, S, N)).astype(np.float32)
    return x, dtv, A, Bm, Cm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(dtype):
    """``y`` and the final chunk state (x, B, C in ``dtype``; dt and A
    float32), 2 chunks of 32."""
    x, dtv, A, Bm, Cm = _ssd_inputs()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    yt, ht = TMB._ssd_chunked(
        torch.from_numpy(x).to(tdt), torch.from_numpy(dtv),
        torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
        torch.from_numpy(Cm).to(tdt), 32)
    assert yt.dtype == ht.dtype == tdt
    yj, hj = JMB._ssd_chunked(
        jnp.asarray(x).astype(jdt), jnp.asarray(dtv), jnp.asarray(A),
        jnp.asarray(Bm).astype(jdt), jnp.asarray(Cm).astype(jdt), 32)
    if dtype == "bfloat16":
        assert _rel(yt, yj) <= 3e-2 and _rel(ht, hj) <= 3e-2
        return
    assert _rel(yt, yj) <= 3e-5 and _rel(ht, hj) <= 3e-5
    with jax.enable_x64(True):
        y64, h64 = JMB._ssd_chunked(*(jnp.asarray(a, jnp.float64) for a in
                                      (x, dtv, A, Bm, Cm)), 32)
        y64, h64 = np.asarray(y64), np.asarray(h64)
    assert np.abs(yt.double().numpy() - y64).max() <= 1e-5 * np.abs(y64).max()
    assert np.abs(ht.double().numpy() - h64).max() <= 1e-5 * np.abs(h64).max()


def test_ssd_gradient_stays_finite_at_a_published_chunk():
    """A chunk of 128 at dt ~ softplus(N(0, 1)) and A = -1: the decay
    exponent above the diagonal reaches ~100, beyond float32's ``exp``.
    The reference's masked ``exp`` then gives its dt gradient ``0 * inf =
    nan``; the port's (``exp`` of ``-inf`` there) stays finite and within
    1e-4 x max of the reference's gradient evaluated in float64."""
    x, dtv, _, Bm, Cm = _ssd_inputs(S=128, H=2, D=8, N=4, seed=1)
    A = -np.ones(2, np.float32)

    def jf(x, dtv, A, Bm, Cm):
        return jnp.sum(JMB._ssd_chunked(x, dtv, A, Bm, Cm, 128)[0])

    def tf(x, dtv):
        return TMB._ssd_chunked(x, dtv, *(torch.from_numpy(a) for a in
                                          (A, Bm, Cm)), 128)[0].sum()
    j32 = jax.grad(jf, argnums=1)(*(jnp.asarray(a) for a in
                                    (x, dtv, A, Bm, Cm)))
    assert not np.isfinite(np.asarray(j32)).all()
    gx, gdt = torch.func.grad(tf, argnums=(0, 1))(torch.from_numpy(x),
                                                 torch.from_numpy(dtv))
    with jax.enable_x64(True):
        want = jax.grad(jf, argnums=(0, 1))(*(jnp.asarray(a, jnp.float64)
                                              for a in (x, dtv, A, Bm, Cm)))
        want = [np.asarray(w) for w in want]
    for got, w in zip((gx, gdt), want):
        assert torch.isfinite(got).all()
        assert np.abs(got.double().numpy() - w).max() <= 1e-4 * np.abs(w).max()


def _block_case():
    jcfg, tcfg = _cfgs()
    p = _seeded_ssm(JMB.init_mamba(jax.random.PRNGKey(0), jcfg),
                    np.random.default_rng(3))
    tp = convert.to_torch(jax.tree.map(np.asarray, p), device="cpu")
    x = np.random.default_rng(4).standard_normal((B, S, jcfg.d_model)
                                                 ).astype(np.float32)
    return jcfg, tcfg, p, tp, x


def test_mamba_block_matches_reference():
    jcfg, tcfg, p, tp, x = _block_case()
    yj = JMB.mamba_block(p, jcfg, jnp.asarray(x))
    yt = TMB.mamba_block(tp, tcfg, torch.from_numpy(x))
    assert _rel(yt, yj) <= 1e-4
    assert _rel(yt - torch.from_numpy(x), np.asarray(yj) - x) <= 1e-4


def test_mamba_decode_matches_reference():
    """8 tokens one at a time from a zero state: each output and the state
    after it (``h`` and the conv window); the chain equals the block's
    forward on the same 8 tokens."""
    jcfg, tcfg, p, tp, x = _block_case()
    js = JMB.init_mamba_state(B, jcfg)
    ts = TMB.init_mamba_state(B, tcfg, "cpu")
    outs = []
    for s in range(8):
        xs = x[:, s:s + 1]
        jo, js = JMB.mamba_decode(p, jcfg, jnp.asarray(xs), js)
        to, ts = TMB.mamba_decode(tp, tcfg, torch.from_numpy(xs), ts)
        assert _rel(to, jo) <= 1e-4
        assert _rel(ts["h"], js["h"]) <= 1e-4
        np.testing.assert_allclose(ts["conv"].numpy(), np.asarray(js["conv"]),
                                   rtol=0, atol=1e-6 * np.abs(
                                       np.asarray(js["conv"])).max())
        outs.append(to)
    cfg8 = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm,
                                                             chunk=8))
    full = TMB.mamba_block(tp, cfg8, torch.from_numpy(x[:, :8]))
    assert _rel(torch.cat(outs, 1), full.numpy()) <= 1e-5


# -- zamba2-1.2b, reduced --------------------------------------------------------

def test_reduced_config_runs_the_shared_block_twice():
    _, tcfg = _cfgs()
    assert tcfg.family == "hybrid" and TZ.n_shared_invocations(tcfg) == 2
    assert tcfg.ssm.chunk == 32 and tcfg.num_heads == tcfg.num_kv_heads == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits (all positions and ``last_only``), then 8 decode
    steps from an empty cache: logits, ``pos``, the Mamba states and the
    shared block's two KV caches."""
    jm, tm, params, tp = _models(dtype)
    toks = _tokens(jm.cfg.vocab_size, (B, S))
    for last_only in (False, True):
        ref = jm.prefill_logits(params, {"tokens": jnp.asarray(toks)},
                                last_only=last_only)
        got = tm.prefill_logits(tp, {"tokens": torch.from_numpy(toks)},
                                last_only=last_only)
        assert got.dtype == torch.float32
        assert _rel(got, ref) <= TOL[dtype]
    dec = _tokens(jm.cfg.vocab_size, (B, 8), seed=1)
    jc = jm.init_cache(B, JShape("d", 16, B, "decode"))
    tc = tm.init_cache(B, TShape("d", 16, B, "decode"))
    assert jax.tree.structure(jax.tree.map(np.asarray, jc)) == \
        jax.tree.structure(convert.to_numpy(tc))
    jdecode = jax.jit(jm.decode_step)
    for s in range(8):
        jl, jc = jdecode(params, jc, jnp.asarray(dec[:, s:s + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(dec[:, s:s + 1]))
        assert _rel(tl, jl) <= TOL[dtype]
        assert int(jc["pos"]) == int(tc["pos"]) == s + 1
    for a, c in zip(jax.tree.leaves(jc["body"]), tree.leaves(tc["body"])):
        assert tuple(c.shape) == a.shape
        assert _rel(c, a) <= TOL[dtype]


def _stacked_pair(jm, params, n=2, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32)[None] + 0.02
                                   * rng.standard_normal((n,) + a.shape))
                        .astype(np.float32), params)


@pytest.mark.parametrize("window", [0, 16], ids=["full", "window16"])
def test_per_worker_loss_and_grads_match_reference(window):
    """Two workers' losses and gradients (the train step's ``vmap(grad)``)
    through the port's flash route, against the reference's; the shared
    block's gradient sums its two call sites.  ``window16``: a
    ``long_context_window`` of 16 under a 64-token sequence, so the shared
    attention is windowed (16) on both sides; its gradients also equal a
    loop of unbatched ones within 1e-5 of each leaf's max (the flash fold
    keeps each worker's rows apart; the Mamba layers' batched products sum
    in another order than unbatched ones: measured 2e-6)."""
    over = dict(long_context_window=window) if window else {}
    jm, tm, params, _ = _models(**over)
    X = _stacked_pair(jm, params)
    toks = _tokens(jm.cfg.vocab_size, (2, B, S + 1), seed=2)
    b = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jm.loss)))(
        jax.tree.map(jnp.asarray, X), jax.tree.map(jnp.asarray, b))
    assert tm.cfg.flash_attention
    tX = convert.to_torch(X, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tg, tl = torch.func.vmap(torch.func.grad_and_value(tm.loss))(tX, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for a, c in zip(jax.tree.leaves(jg), tree.leaves(tg)):
        a = np.asarray(a)
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(c.numpy(), a, rtol=0,
                                   atol=1e-4 * float(np.abs(a).max()))
    for name in SSM_LEAVES:
        assert tg["body"]["mamba"][name].dtype == torch.float32
    if not window:
        return
    for w in range(2):
        gw = torch.func.grad(tm.loss)(tree.map(lambda a: a[w], tX),
                                      {k: v[w] for k, v in tb.items()})
        for a, c in zip(tree.leaves(tg), tree.leaves(gw)):
            assert float((a[w] - c).abs().max()) <= 1e-5 * float(
                c.abs().max())


def _hypers(n):
    spec = dict(bits=8, stochastic=True)
    return (jalg.AlgoHyper(topo=jring(n), codec=JCodec(JSpec(**spec)),
                           theta=2.0, backend="jnp"),
            talg.AlgoHyper(topo=tring(n), codec=TCodec(TSpec(**spec)),
                           theta=2.0))


def test_moniqua_train_step_matches_reference():
    """One Moniqua 8-bit ``train_step`` on ring(2) over the hybrid tree,
    the reference's per-step seed handed in: the parameters within ``1e-6 +
    lr * 1e-4 * max|d|`` of each leaf, the loss within ``rtol=1e-5``, the
    wire bytes equal."""
    n, lr = 2, 0.1
    jm, tm, params, _ = _models()
    X = _stacked_pair(jm, params, n=n, seed=0)
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
        tol = 1e-6 + lr * 1e-4 * np.abs(d).max()
        assert (np.abs(c.numpy() - a) <= tol).all()


def test_trainer_on_zamba_matches_reference_bytes():
    """``Trainer(model, tc, shape)`` on the reduced config in bf16, as
    published: the reference ``Trainer``'s ``bytes_per_step`` on its
    abstract state, for D-PSGD and Moniqua 8-bit; finite losses."""
    jcfg, tcfg = _cfgs("bfloat16")
    shape = ("tiny", 64, 4, "train")
    common = dict(n_workers=2, lr=0.1, steps=2, log_every=1, seed=1)
    jmodel = jbuild(jcfg)
    for algo, kw in (("dpsgd", {}), ("moniqua", dict(bits=8, theta=2.0))):
        out = Trainer(tbuild(tcfg, device="cpu"), TrainerConfig(
            algo=algo, **common, **kw), TShape(*shape)).run()
        jt = JTrainer(jmodel, JShape(*shape), JTrainerConfig(
            algo=algo, **common, **kw))
        assert out["bytes_per_step"] == jt.bytes_per_step(
            jts.abstract_state(jmodel, jt.algo, jt.hp, 2))
        assert np.isfinite([h["loss"] for h in out["history"]]).all()


# -- the mixed float32 / bf16 trees through convert -----------------------------

@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b", ARCH])
def test_convert_round_trips_mixed_trees(arch):
    """The reference's bf16 trees hold float32 leaves (MoE's router;
    Mamba2's ``a_log``, ``d_skip``, ``dt_bias``): ``to_torch`` keeps each
    leaf's dtype and bits, ``to_numpy`` and the reference's cast back
    restore them bit for bit."""
    over = dict(dtype="bfloat16", **(OVER if arch == ARCH else {}))
    jm = jbuild(dataclasses.replace(jget_config(arch).reduced(), **over))
    params = jm.init(jax.random.PRNGKey(1))
    tp = convert.to_torch(jax.tree.map(np.asarray, params), device="cpu")
    dtypes = {str(a.dtype) for a in jax.tree.leaves(params)}
    assert dtypes == {"bfloat16", "float32"}
    back = convert.to_numpy(tp)
    for a, c, r in zip(jax.tree.leaves(params), tree.leaves(tp),
                       jax.tree.leaves(back)):
        assert str(c.dtype) == f"torch.{a.dtype}"
        again = jnp.asarray(r).astype(a.dtype)
        np.testing.assert_array_equal(
            np.asarray(again).view(np.uint8), np.asarray(a).view(np.uint8))
