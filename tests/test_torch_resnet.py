"""ResNet-20 and the Moniqua training step: the port against the JAX package.

Width 8, n=4 workers on a ring, 16 images per worker; weights are carried
across with ``repro_torch.convert`` and batches are the reference's own
``cifar_like`` draws handed to both sides as numpy arrays.

Tolerances: the two frameworks' convolutions and group norms sum in
different orders, so logits and losses agree to float32 rounding
(``rtol=1e-4, atol=1e-5``).  Gradients pass back through twenty such layers
and the first stage's are ill-conditioned: there the reference's own
float32 gradients are farther from a float64 evaluation than the port's.
So the port's gradients are held to a float64 evaluation of the same
function (1e-2 of each leaf's largest entry) and to the reference's within
3e-2.  The gossip mix itself is bitwise, so a
step's parameters differ by lr times the gradients' difference.  Over a
trajectory, the per-step differences feed back through the next gradient,
and at 8 bits a code can flip at a rounding boundary once the parameters
differ by one ulp, moving that parameter by a lattice step times a gossip
weight: losses agree to ``rtol=2e-3`` over 4 steps, and the parameters to
bounds derived in ``test_loss_trajectory_allclose``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as jalg
from repro.core.moniqua import MoniquaCodec as JCodec
from repro.core.quantizers import QuantSpec as JSpec
from repro.core.theta import ThetaSchedule as JTheta
from repro.core.topology import ring as jring
from repro.data.synthetic import cifar_like
from repro.kernels import ops as jops
from repro.models import resnet as jresnet
from repro.optim import sgd as jsgd
from repro.train import train_step as jts
from repro_torch import convert, tree
from repro_torch.core import algorithms as talg
from repro_torch.core import modulo as tmod
from repro_torch.core import quantizers as tq
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.core.theta import ThetaSchedule as TTheta
from repro_torch.core.topology import ring as tring
from repro_torch.models import resnet as tresnet
from repro_torch.optim import sgd as tsgd
from repro_torch.train import train_step as tts

N, WIDTH, BATCH = 4, 8, 16
_to_cpu = functools.partial(convert.to_torch, device="cpu")


def _stacked_params(perturb=0.02, n=N, width=WIDTH):
    """Stacked ResNet-20 params whose workers differ by a little noise."""
    p = jresnet.init_resnet(jax.random.PRNGKey(0), depth=20, width=width)
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: (np.asarray(a)[None] + perturb
                                   * rng.standard_normal((n,) + a.shape))
                        .astype(np.float32), p)


def _batch(step, n=N, batch=BATCH):
    bs = [cifar_like(step, batch, worker=w, seed=1) for w in range(n)]
    return {"images": np.stack([np.asarray(b["images"]) for b in bs]),
            "labels": np.stack([np.asarray(b["labels"]) for b in bs])}


def _jax_batch(b):
    return jax.tree.map(jnp.asarray, b)


def _torch_batch(b):
    return {"images": torch.from_numpy(b["images"]),
            "labels": torch.from_numpy(b["labels"].astype(np.int64))}


# per-worker loss and gradients of the reference (jitted: they are compared
# allclose, and eager JAX is slow)
_jax_grads = jax.jit(jax.vmap(jax.value_and_grad(jresnet.resnet_loss)))


def _close(ref_tree, out_tree, rtol, atol, leaf_rel=0.0):
    """allclose leaf by leaf, with ``leaf_rel`` times the leaf's largest
    entry added to ``atol``."""
    for a, b in zip(jax.tree.leaves(ref_tree), tree.leaves(out_tree)):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.detach().numpy(), a, rtol=rtol,
            atol=atol + leaf_rel * float(np.abs(a).max()))


def _hypers(wire="moniqua", bits=8, slack=1.0, n=N):
    """The two packages' AlgoHyper, as their trainers' ``build_hyper``
    makes it: 1-bit rounds to nearest, and ``slack < 1`` takes Theorem 3's
    slack matrix ``s W + (1 - s) I``."""
    jt, tt = jring(n), tring(n)
    if slack < 1.0:
        jt, tt = jt.slack(slack), tt.slack(slack)
    spec = dict(bits=bits, stochastic=bits > 1)
    jhp = jalg.AlgoHyper(topo=jt, codec=JCodec(JSpec(**spec)), theta=2.0,
                         wire=wire, backend="jnp", path="bucketed")
    thp = talg.AlgoHyper(topo=tt, codec=TCodec(TSpec(**spec)), theta=2.0,
                         wire=wire, path="bucketed")
    return jhp, thp


def _trajectories(algo, bits=8, slack=1.0, steps=4, perturb=0.02, n=N,
                  width=WIDTH, batch=BATCH):
    """``steps`` full train steps (momentum SGD with weight decay + gossip)
    of the reference and of the port from the same params and batches; the
    port takes the reference's per-step seed.  Returns both packages'
    per-step losses and final stacked params."""
    X = _stacked_params(perturb, n, width)
    jhp, thp = _hypers(bits=bits, slack=slack, n=n)

    class _JaxModel:
        loss = staticmethod(jresnet.resnet_loss)

    sgd = dict(momentum=0.9, weight_decay=5e-4)
    jstep = jax.jit(jts.make_train_step(
        _JaxModel(), jhp, jts.TrainStepConfig(
            algo=algo, sgd=jsgd.SGDConfig(**sgd), lr=0.1,
            theta=JTheta(value=2.0))))
    tstep = tts.make_train_step(
        tresnet.ResNetModel(width=width, device="cpu"), thp,
        tts.TrainStepConfig(algo=algo, sgd=tsgd.SGDConfig(**sgd), lr=0.1,
                            theta=TTheta(value=2.0)))
    jX = jax.tree.map(jnp.asarray, X)
    js = {"params": jX, "mom": jsgd.init_momentum(jX), "extra": {},
          "step": jnp.zeros((), jnp.int32),
          "g_inf": jnp.ones((), jnp.float32), "key": jax.random.PRNGKey(0)}
    tX = _to_cpu(X)
    ts = {"params": tX, "mom": tsgd.init_momentum(tX), "extra": {},
          "step": 0, "g_inf": torch.ones(()), "gen": torch.Generator()}
    jl, tl = [], []
    for k in range(steps):
        b = _batch(k, n, batch)
        # the reference's own per-step key split, as its train step does it
        seed = int(jops._key_to_seed(jax.random.split(js["key"])[1]))
        js, jm = jstep(js, _jax_batch(b))
        ts, tm = tstep(ts, _torch_batch(b), seed=seed)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert tm["wire_bytes"] == float(jm["wire_bytes"])
    return jl, tl, js["params"], ts["params"]


def test_logits_and_per_worker_grads_allclose():
    X = _stacked_params()
    b = _batch(0)
    jX, tX = jax.tree.map(jnp.asarray, X), _to_cpu(X)
    jb, tb = _jax_batch(b), _torch_batch(b)
    _close([jax.jit(jax.vmap(jresnet.resnet_logits))(jX, jb["images"])],
           [torch.func.vmap(tresnet.resnet_logits)(tX, tb["images"])],
           rtol=1e-4, atol=1e-5)
    jl, jg = _jax_grads(jX, jb)
    grad_fn = torch.func.vmap(torch.func.grad_and_value(tresnet.resnet_loss))
    tg, tl = grad_fn(tX, tb)
    _close([jl], [tl], rtol=1e-4, atol=1e-5)
    _close(jg, tg, rtol=1e-4, atol=1e-5, leaf_rel=3e-2)
    g64, _ = grad_fn(tree.map(torch.Tensor.double, tX),
                     dict(tb, images=tb["images"].double()))
    for a, c in zip(tree.leaves(g64), tree.leaves(tg)):
        np.testing.assert_allclose(c.double().numpy(), a.numpy(), rtol=0,
                                   atol=1e-2 * float(a.abs().max()))


def test_moniqua_step_mix_bitwise_and_params_allclose():
    X = _stacked_params()
    b = _batch(1)
    jX, tX = jax.tree.map(jnp.asarray, X), _to_cpu(X)
    jhp, thp = _hypers()
    key = jax.random.PRNGKey(5)
    seed = int(jops._key_to_seed(key))
    ref_mix = jhp.engine().mix(jX, theta=2.0, key=key).x
    out_mix = thp.engine().mix(tX, theta=2.0, seed=seed).x
    for a, c in zip(jax.tree.leaves(ref_mix), tree.leaves(out_mix)):
        np.testing.assert_array_equal(np.asarray(a), c.numpy())

    _, jg = _jax_grads(jX, _jax_batch(b))
    tg, _ = torch.func.vmap(torch.func.grad_and_value(
        tresnet.resnet_loss))(tX, _torch_batch(b))
    jXn, _ = jalg.get_algorithm("moniqua").step(jX, {}, jg, 0.1, 0, key, jhp)
    tXn, _ = talg.get_algorithm("moniqua").step(tX, {}, tg, 0.1, 0, seed,
                                                thp)
    # x_mix - 0.1 * g with a bitwise x_mix: the gradients' tolerance x lr
    for a, c, g in zip(jax.tree.leaves(jXn), tree.leaves(tXn),
                       jax.tree.leaves(jg)):
        np.testing.assert_allclose(
            c.numpy(), np.asarray(a), rtol=0,
            atol=1e-6 + 0.1 * 3e-2 * float(np.abs(np.asarray(g)).max()))


@pytest.mark.parametrize("algo,bits,slack", [
    ("moniqua", 8, 1.0), ("dpsgd", 8, 1.0),
    # the 1-bit main path: nearest rounding and Theorem 3's slack 0.02
    ("moniqua", 1, 0.02)], ids=["moniqua", "dpsgd", "moniqua-1bit-slack"])
def test_loss_trajectory_allclose(algo, bits, slack):
    """Four steps from workers that differ (so every mix moves them).

    Without a code flip, the params drift apart only through the gradients
    (one step: lr x 3e-2 of the largest gradient, see the step test), and
    the drift feeds back through the next gradients: over four steps D-PSGD
    drifts by at most 1.9e-3 and 99% of the entries by at most 2.5e-4, so
    the params are held to 5e-3, and 99% of them to 1e-3.  A Moniqua code
    that flips at a rounding boundary moves its entry by one lattice step
    ``B / 2^bits`` times the weights that decode it (the sender's weight,
    and the off-diagonal weights through a flipped self code), so a Moniqua
    entry may differ by up to twice that on top (8-bit: 378 of 272k entries
    differ by ~0.011, at 1 bit with slack 12 entries by ~0.05); the 99%
    bound catches a missing or misplaced mix, which moves most entries by
    ~1e-2."""
    jl, tl, jX, tX = _trajectories(algo, bits=bits, slack=slack)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    jhp, _ = _hypers(bits=bits, slack=slack)
    off_diag = sum(w for o, w in zip(jhp.topo.offsets, jhp.topo.weights)
                   if o % N)
    flip = 0.0
    if algo == "moniqua":
        B = float(tmod.b_theta(2.0, tq.delta_for_bits(bits, bits > 1),
                               "cpu"))
        flip = 2 * off_diag * B / 2 ** bits
    diff = np.concatenate([np.abs(np.asarray(a) - c.numpy()).ravel()
                           for a, c in zip(jax.tree.leaves(jX),
                                           tree.leaves(tX))])
    assert diff.max() <= 5e-3 + flip, diff.max()
    assert np.quantile(diff, 0.99) <= 1e-3, np.quantile(diff, 0.99)


def test_one_bit_without_slack_diverges_like_the_reference():
    """1-bit Moniqua (nearest rounding) at theta 2.0 on a fresh ResNet-20,
    from identical workers as ``init_state`` starts them, with no slack:
    a 1-bit lattice cell is B/2 = 4 wide with an edge at 0, where most
    fresh weights sit, and every code that flips there moves a weight by a
    neighbor weight times 4.  The reference's loss climbs more than tenfold
    in four steps, and the port's climbs with it, step for step."""
    jl, tl, _, _ = _trajectories("moniqua", bits=1, perturb=0.0)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert jl[-1] > 10 * jl[0] and tl[-1] > 10 * tl[0], (jl, tl)


def test_trainer_runs_and_counts_bytes():
    """The port's Trainer end to end on the CPU: finite losses, the
    reference's byte count, the per-step seeds drawn from the state."""
    from repro_torch.data.synthetic import stacked_cifar_like
    from repro_torch.train.trainer import Trainer, TrainerConfig
    model = tresnet.ResNetModel(width=WIDTH, device="cpu")
    tc = TrainerConfig(n_workers=N, bits=8, steps=2, log_every=1)
    out = Trainer(model, tc, lambda k: stacked_cifar_like(
        k, 4, N, seed=0, device="cpu")).run()
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert np.isfinite([h["loss"] for h in out["history"]]).all()
    jX = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (N,) + a.shape),
                      jresnet.init_resnet(jax.random.PRNGKey(0), depth=20,
                                          width=WIDTH))
    jhp, _ = _hypers()
    assert out["bytes_per_step"] == jalg.get_algorithm(
        "moniqua").bytes_per_step(jX, jhp)


def test_entry_points_default_to_the_card(monkeypatch):
    """device= defaults to "cuda" and raises when no card is visible."""
    from repro_torch.data.synthetic import cifar_like as tcifar
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        tresnet.ResNetModel(width=WIDTH).init(torch.Generator())
    with pytest.raises(RuntimeError):
        tcifar(0, 2)
    with pytest.raises(RuntimeError):
        convert.to_torch({"w": np.zeros(3, np.float32)})
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_direction_and_allreduce_match_reference(nesterov):
    rng = np.random.default_rng(3)
    X = {"a": rng.standard_normal((N, 5, 3)).astype(np.float32),
         "b": [rng.standard_normal((N, 7)).astype(np.float32)]}
    G = jax.tree.map(lambda a: (a * 0.5 + 0.1).astype(np.float32), X)
    M = jax.tree.map(lambda a: (a * -0.2).astype(np.float32), X)
    jd, jm, jinf = jsgd.direction(
        jsgd.SGDConfig(nesterov=nesterov), *(jax.tree.map(jnp.asarray, t)
                                             for t in (G, X, M)))
    td, tm, tinf = tsgd.direction(
        tsgd.SGDConfig(nesterov=nesterov), *(_to_cpu(t)
                                             for t in (G, X, M)))
    _close(jd, td, rtol=1e-6, atol=1e-7)
    _close(jm, tm, rtol=1e-6, atol=1e-7)
    assert float(tinf) == float(jinf)
    jhp, thp = _hypers()
    jx, _ = jalg.get_algorithm("allreduce").step(
        jax.tree.map(jnp.asarray, X), {}, jd, 0.1, 0, None, jhp)
    tx, _ = talg.get_algorithm("allreduce").step(
        _to_cpu(X), {}, td, 0.1, 0, None, thp)
    _close(jx, tx, rtol=1e-6, atol=1e-6)


def test_convert_round_trip_and_accuracy():
    p = jax.tree.map(np.asarray, jresnet.init_resnet(
        jax.random.PRNGKey(1), depth=20, width=WIDTH))
    back = convert.to_numpy(_to_cpu(p))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    b = _batch(0)
    one = {"images": b["images"][0], "labels": b["labels"][0]}
    ref = float(jresnet.resnet_accuracy(jax.tree.map(jnp.asarray, p),
                                        _jax_batch(one)))
    out = float(tresnet.resnet_accuracy(_to_cpu(p),
                                        _torch_batch(one)))
    assert out == ref


if __name__ == "__main__":
    # The 1-bit record: ten steps of the reference and of the port at the
    # main path's widths (ResNet-20 width 16, 8 workers on a ring) with 16
    # images per worker, from identical workers, without and with slack.
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_resnet.py
    for s in (1.0, 0.02):
        jl, tl, _, _ = _trajectories("moniqua", bits=1, slack=s, steps=10,
                                     perturb=0.0, n=8, width=16, batch=16)
        print(f"1-bit slack {s}: reference losses {jl}")
        print(f"1-bit slack {s}: port losses      {tl}")
