"""Checks shared by the per-family test files of the port
(``test_torch_xlstm.py``, ``test_torch_whisper.py``, ``test_torch_vlm.py``):
a model of the reference and one of the port on one set of weights, given
the same numpy batches.

Tolerances (``tests/test_torch_zamba.py``'s): per-worker losses
``rtol=1e-5`` and gradients within 1e-4 of each leaf's largest entry; one
Moniqua 8-bit train step with the parameters within ``1e-6 + lr * 1e-4 *
max|d|`` of each leaf, the loss within ``rtol=1e-5`` and the wire bytes
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import InputShape as JShape
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
from repro_torch.configs.base import InputShape as TShape
from repro_torch.core import algorithms as talg
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.core.theta import ThetaSchedule as TTheta
from repro_torch.core.topology import ring as tring
from repro_torch.models.model_factory import build_model as tbuild
from repro_torch.optim import sgd as tsgd
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs six
    test workers on one machine, and each op's thread team would spin
    against the other workers' (``tests/test_torch_zamba.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, ref):
    """max |got - ref| / max |ref| (``got`` a tensor, ``ref`` array-like)."""
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def models(jcfg, tcfg):
    """Both models and one set of weights: the reference's init, and the
    same carried across to the port."""
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    params = jm.init(jax.random.PRNGKey(0))
    return jm, tm, params, convert.to_torch(jax.tree.map(np.asarray, params),
                                            device="cpu")


def stacked(params, n=2, seed=3):
    """``n`` workers' float32 copies of ``params``, each moved by 0.02 x
    N(0, 1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32)[None] + 0.02
                                   * rng.standard_normal((n,) + a.shape))
                        .astype(np.float32), params)


def check_batch_spec(jm, tm, seq_len, batch):
    """``batch_spec`` of the port equals the reference's for each kind."""
    for kind in ("train", "prefill", "decode"):
        js = jm.batch_spec(JShape("s", seq_len, batch, kind))
        ts = tm.batch_spec(TShape("s", seq_len, batch, kind))
        assert {k: (tuple(s), str(jnp.dtype(d))) for k, (s, d) in js.items()} \
            == {k: (tuple(s), str(d).removeprefix("torch."))
                for k, (s, d) in ts.items()}


def check_loss_and_grads(jm, tm, params, batch):
    """Two workers' losses and gradients (the train step's ``vmap(grad)``)
    against the reference's.  ``batch``: numpy ``[2, ...]`` arrays."""
    X = stacked(params)
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jm.loss)))(
        jax.tree.map(jnp.asarray, X), jax.tree.map(jnp.asarray, batch))
    tg, tl = torch.func.vmap(torch.func.grad_and_value(tm.loss))(
        convert.to_torch(X, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    assert len(tree.leaves(tg)) == len(jax.tree.leaves(jg))
    for a, c in zip(jax.tree.leaves(jg), tree.leaves(tg)):
        a = np.asarray(a)
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(c.numpy(), a, rtol=0,
                                   atol=1e-4 * float(np.abs(a).max()))


def check_moniqua_step(jm, tm, params, batch, n=2, lr=0.1):
    """One Moniqua 8-bit ``train_step`` on ring(n), the reference's
    per-step seed handed in.  ``batch``: numpy ``[n, ...]`` arrays."""
    X = stacked(params, n=n, seed=0)
    jX, tX = jax.tree.map(jnp.asarray, X), convert.to_torch(X, device="cpu")
    spec = dict(bits=8, stochastic=True)
    jhp = jalg.AlgoHyper(topo=jring(n), codec=JCodec(JSpec(**spec)),
                         theta=2.0, backend="jnp")
    thp = talg.AlgoHyper(topo=tring(n), codec=TCodec(TSpec(**spec)),
                         theta=2.0)
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
    seed = int(jops._key_to_seed(jax.random.split(js["key"])[1]))
    js, jmet = jstep(js, jax.tree.map(jnp.asarray, batch))
    ts, tmet = tstep(ts, {k: torch.from_numpy(v) for k, v in batch.items()},
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


def check_trainer_bytes(jcfg, tcfg, shape):
    """``Trainer(model, tc, shape)`` on the port against the reference
    ``Trainer``'s ``bytes_per_step`` on its abstract state, for D-PSGD and
    Moniqua 8-bit; finite losses.  ``shape``: InputShape's fields."""
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
