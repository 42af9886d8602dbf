"""The port's update rules against the JAX package's, on the CPU.

Same numpy inputs from a seed go through ``repro.core.algorithms`` (eagerly,
op by op) and ``repro_torch.core.algorithms``: the stacked tree, the rule's
state ``extra`` (carried across with ``convert.to_torch``), the directions
``g`` and the step size.  The reference draws its rounding noise with
``jax.random.uniform`` on split keys; the test rebuilds those draws from the
key and hands them to the port as ``uniforms``, and hands the port the hash
seed the reference derives from the key for Moniqua's wire.  With the same
draws every rule runs the same float32 operations in the same order, so the
port is held bitwise, nearest rounding included.  One exception: the biased
1-bit sign compressor of Choco and DeepSqueeze scales by a per-worker mean
of ``|v|``, and XLA and PyTorch sum it in different orders (float32 sums of
at most 90 terms here, a few ulp apart).  That scale enters every value once
a step, so those two are held within ``SIGN_ULPS`` ulp of each leaf's
largest value over three steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as jalg
from repro.core import topology as jtopo
from repro.core.moniqua import MoniquaCodec as JCodec
from repro.core.quantizers import QuantSpec as JSpec
from repro.data.synthetic import quadratic_grad as j_quadratic_grad
from repro.kernels import ops as jops
from repro_torch import convert, tree
from repro_torch.core import algorithms as talg
from repro_torch.core import topology as ttopo
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.data.synthetic import quadratic_grad as t_quadratic_grad

N = 8
SIGN_ULPS = 16
NEW_RULES = ["naive", "choco", "deepsqueeze", "dcd", "ecd", "d2",
             "moniqua_d2"]
_to_cpu = functools.partial(convert.to_torch, device="cpu")


def _hypers(name, bits, gamma=0.4, theta=2.0, naive_delta=0.2,
            stochastic=True):
    """The same hyper-parameters in both packages: ring(8), with Theorem
    3's slack 0.75 for the D^2 rules (as ``examples/hetero_d2.py``); the
    wire rounds stochastically above 1 bit unless ``stochastic`` is off."""
    jt, tt = jtopo.ring(N), ttopo.ring(N)
    if name in ("d2", "moniqua_d2"):
        jt, tt = jt.slack(0.75), tt.slack(0.75)
    kw = dict(theta=theta, gamma=gamma, naive_delta=naive_delta)
    spec = dict(bits=bits, stochastic=stochastic and bits > 1)
    return (jalg.AlgoHyper(topo=jt, codec=JCodec(JSpec(**spec)), **kw),
            talg.AlgoHyper(topo=tt, codec=TCodec(TSpec(**spec)), **kw))


def _tree_np(seed, scale=1.0):
    """Mixed-shape stacked tree: a conv-like 4-d leaf, a matrix with a
    ragged last dim, a scalar-per-worker leaf and a nested vector."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal((N,) + shape) * scale).astype(np.float32)
    return {"conv": r(3, 3, 2, 5), "w": r(7, 13), "s": r(),
            "blocks": [{"b": r(11)}]}


def _ref_uniforms(key, X):
    """The reference's rounding draws for a tree shaped like ``X``: one
    ``jax.random.uniform`` per leaf on ``jax.random.split(key, leaves)``."""
    leaves, td = jax.tree.flatten(X)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(td, [np.asarray(jax.random.uniform(k, l.shape))
                                   for k, l in zip(keys, leaves)])


def _assert_trees_equal(ref, out):
    rl, ol = jax.tree.leaves(ref), tree.leaves(out)
    assert len(rl) == len(ol)
    for a, b in zip(rl, ol):
        assert tuple(np.shape(a)) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _assert_trees_close(ref, out, ulps):
    rl, ol = jax.tree.leaves(ref), tree.leaves(out)
    assert len(rl) == len(ol)
    for a, b in zip(rl, ol):
        a = np.asarray(a)
        tol = ulps * np.finfo(np.float32).eps * max(1.0, np.abs(a).max())
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=tol)


def _steps(name, bits, stochastic_key, steps=3, X_np=None, grad=None,
           alpha=0.05, **hyper):
    """Run ``steps`` steps of rule ``name`` in both packages from the same
    state; return the two (X, extra) trajectories' last states."""
    jhp, thp = _hypers(name, bits, stochastic=stochastic_key, **hyper)
    ja, ta = jalg.get_algorithm(name), talg.get_algorithm(name)
    X_np = _tree_np(0) if X_np is None else X_np
    Xj = jax.tree.map(jnp.asarray, X_np)
    ej = ja.init(Xj, jhp)
    Xt, et = _to_cpu(X_np), _to_cpu(jax.tree.map(np.asarray, ej))
    _assert_trees_equal(ej, ta.init(Xt, thp))
    key = jax.random.PRNGKey(7)
    for k in range(steps):
        key, kg, kq = jax.random.split(key, 3)
        g_np = (_tree_np(100 + k) if grad is None
                else grad(jax.tree.map(np.asarray, Xj), kg))
        kq = kq if stochastic_key else None
        Xj, ej = ja.step(Xj, ej, jax.tree.map(jnp.asarray, g_np), alpha, k,
                         kq, jhp)
        seed = None if kq is None else int(jops._key_to_seed(kq))
        uni = None if kq is None else _to_cpu(_ref_uniforms(kq, X_np))
        Xt, et = ta.step(Xt, et, _to_cpu(g_np), alpha, k, seed, thp,
                         uniforms=uni)
    return (Xj, ej), (Xt, et)


@pytest.mark.parametrize("name", NEW_RULES)
@pytest.mark.parametrize("bits", [8, 2, 1])
@pytest.mark.parametrize("stochastic", [True, False])
def test_rule_matches_reference(name, bits, stochastic):
    """init and three steps, X and extra bitwise (stochastic: the
    reference's uniforms handed in; nearest: key=None); the 1-bit sign
    compressor within SIGN_ULPS."""
    (Xj, ej), (Xt, et) = _steps(name, bits, stochastic)
    if bits == 1 and name in ("choco", "deepsqueeze"):
        _assert_trees_close(Xj, Xt, SIGN_ULPS)
        _assert_trees_close(ej, et, SIGN_ULPS)
    else:
        _assert_trees_equal(Xj, Xt)
        _assert_trees_equal(ej, et)


@pytest.mark.parametrize("name", ["choco", "deepsqueeze", "dcd", "d2"])
def test_extra_round_trips_through_convert(name):
    """A rule's state crosses between the packages leaf for leaf, the 0-d
    float32 ``alpha_prev`` of D^2 included, and back unchanged."""
    (Xj, ej), _ = _steps(name, 8, True, steps=1)
    et = _to_cpu(jax.tree.map(np.asarray, ej))
    _assert_trees_equal(ej, et)
    back = convert.to_numpy(et)
    for a, b in zip(jax.tree.leaves(ej), tree.leaves(back)):
        assert b.dtype == np.float32 and b.shape == np.shape(a)
        np.testing.assert_array_equal(np.asarray(a), b)
    if name == "d2":
        assert et["alpha_prev"].shape == ()
        assert float(et["alpha_prev"]) == float(np.float32(0.05))


def test_registry_holds_all_ten_names():
    assert sorted(talg.ALGORITHMS) == sorted(jalg.ALGORITHMS)
    assert len(talg.ALGORITHMS) == 10
    for name in jalg.ALGORITHMS:
        assert talg.get_algorithm(name).name == name
    with pytest.raises(ValueError):
        talg.get_algorithm("sgdmagic")


@pytest.mark.parametrize("bits", [8, 1])
def test_accounting_matches_reference(bits):
    """bytes_per_step and extra_memory_bytes of all ten rules equal the
    reference's on a mixed tree, and Table 1's ordering holds: Moniqua 0,
    Choco/DCD/ECD the m + 1 replicas, DeepSqueeze one buffer, D^2 two."""
    X_np = _tree_np(3)
    Xj, Xt = jax.tree.map(jnp.asarray, X_np), _to_cpu(X_np)
    model_bytes = sum(a[0].nbytes for a in jax.tree.leaves(X_np))
    for name in jalg.ALGORITHMS:
        jhp, thp = _hypers(name, bits)
        ja, ta = jalg.get_algorithm(name), talg.get_algorithm(name)
        assert ta.bytes_per_step(Xt, thp) == ja.bytes_per_step(Xj, jhp), name
        assert (ta.extra_memory_bytes(Xt, thp)
                == ja.extra_memory_bytes(Xj, jhp)), name
    _, thp = _hypers("moniqua", bits)
    mem = {n: talg.get_algorithm(n).extra_memory_bytes(Xt, thp)
           for n in talg.ALGORITHMS}
    assert mem["moniqua"] == mem["dpsgd"] == 0
    assert mem["choco"] == mem["dcd"] == mem["ecd"] == 3 * model_bytes
    assert mem["deepsqueeze"] == model_bytes
    assert mem["d2"] == mem["moniqua_d2"] == 2 * model_bytes


@pytest.mark.parametrize("name", ["dcd", "ecd"])
def test_one_bit_dcd_ecd_diverge_like_the_reference(name):
    """Table 2: DCD/ECD need an unbiased quantizer, and 1-bit stochastic
    rounding makes them diverge on the Theorem-1 quadratic.  The port
    follows the reference bitwise step by step while the values stay
    finite, and both blow up against the 8-bit run."""
    delta, d = 0.2, 32
    X_np = {"x": np.zeros((N, d), np.float32)}

    def grad(X, key):
        keys = jax.random.split(key, N)
        noise = np.stack([np.asarray(jax.random.normal(k, (d,)))
                          for k in keys])
        g_ref = np.stack([np.asarray(j_quadratic_grad(
            jnp.asarray(X["x"][w]), delta, keys[w], 0.05)) for w in range(N)])
        g = t_quadratic_grad(torch.from_numpy(np.array(X["x"])), delta,
                             torch.from_numpy(noise), 0.05)
        np.testing.assert_array_equal(g_ref, g.numpy())
        return {"x": g_ref}

    spread = {}
    for bits in (1, 8):
        (Xj, _), (Xt, _) = _steps(name, bits, True, steps=12, X_np=X_np,
                                  grad=grad, theta=1.0)
        _assert_trees_equal(Xj, Xt)
        assert torch.isfinite(Xt["x"]).all()
        spread[bits] = float(Xt["x"].abs().max())
    assert spread[8] < 1.0 and spread[1] > 1e3 * spread[8]


def test_trainer_runs_every_rule_and_carries_extra():
    """make_train_step runs every registered rule on a tiny ResNet and
    carries each rule's extra; TrainerConfig.gamma reaches the hyper."""
    from repro_torch.data.synthetic import stacked_cifar_like
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.train.trainer import Trainer, TrainerConfig
    model = ResNetModel(depth=8, width=8, device="cpu")
    batches = [stacked_cifar_like(k, 4, 2, seed=0, device="cpu")
               for k in range(2)]
    for name in talg.ALGORITHMS:
        tc = TrainerConfig(algo=name, n_workers=2, steps=2, log_every=1,
                           gamma=0.3, lr=0.05)
        trainer = Trainer(model, tc, lambda k: batches[k])
        assert trainer.hp.gamma == 0.3
        out = trainer.run()
        losses = [h["loss"] for h in out["history"]]
        assert len(losses) == 2 and all(np.isfinite(losses)), name
        init = talg.get_algorithm(name).init(trainer.init_state()["params"],
                                             trainer.hp)
        assert (tree.flatten(out["state"]["extra"])[1]
                == tree.flatten(init)[1]), name
        assert out["bytes_per_step"] == talg.get_algorithm(
            name).bytes_per_step(out["state"]["params"], trainer.hp)
