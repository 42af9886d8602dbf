"""Decentralized LM training in the port against the JAX package.

The reference's reduced llama3.2-3b (2 layers, d 256, 4 heads of 64, vocab
512, float32 unless stated), weights carried across with
``repro_torch.convert``, token and label batches drawn with numpy and
handed to both sides.

Tolerances (each measured on these inputs first, then given headroom):

* per-worker loss and gradients under ``vmap(grad)`` in float32: losses
  within ``rtol=1e-5``, each gradient leaf within 1e-4 of its largest
  entry (measured: 2e-6; the frameworks sum matmuls and softmaxes in other
  orders), the port's flash route and its plain route alike;
* ``_FlashSDPA``'s hand-written backward against ``torch.autograd``
  through ``sdpa_ref``: float32 within 1e-6 of each gradient's largest
  entry (autograd's softmax backward sums in another order; measured
  2e-7), bfloat16 within one bfloat16 ulp (measured: bitwise); its
  ``vmap`` rule equals a loop over workers bitwise;
* ``xent`` within ``rtol=1e-6``;
* one Moniqua 8-bit ``train_step`` on ring(4) with the reference's
  per-step seed: the gossip mix bitwise (the inputs are), the parameters
  within ``1e-6 + lr * 1e-4 * max|d|`` of each leaf in float32 (the
  gradients' tolerance times the step size), the 3-step losses within
  ``rtol=1e-5`` (measured 1.4e-7); in bfloat16 the parameters within one
  bfloat16 ulp of |x| plus ``lr * 5e-2 * max|d|`` (each side rounds
  ``x_mix - lr d`` to bfloat16 once; bfloat16 gradients differ by up to
  2.5% of a leaf's largest entry, measured), the losses within
  ``rtol=1e-3`` (measured 2e-4).
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
from repro.models import transformer as JT
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
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.data.synthetic import TokenTask
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as TT
from repro_torch.models.model_factory import build_model as tbuild
from repro_torch.optim import sgd as tsgd
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "llama3.2-3b"
N, B, S = 4, 2, 32             # workers, sequences a worker, tokens


def _cfgs(dtype="float32", kv=None, flash=False):
    over = dict(dtype=dtype, flash_attention=flash)
    if kv:
        over["num_kv_heads"] = kv
    return (dataclasses.replace(jget_config(ARCH).reduced(), **over),
            dataclasses.replace(tget_config(ARCH).reduced(), **over))


def _stacked(jm, dtype, n=N, perturb=0.02):
    """The reference's init, stacked over ``n`` workers that differ by a
    little seeded noise, in ``dtype``: (jax tree, torch tree)."""
    p = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    X = jax.tree.map(lambda a: jnp.asarray(
        (np.asarray(a, np.float32)[None] + perturb
         * rng.standard_normal((n,) + a.shape)).astype(np.float32)
    ).astype(dtype), p)
    return X, convert.to_torch(jax.tree.map(np.asarray, X), device="cpu")


def _batch(step, vocab, n=N, b=B, s=S):
    """A stacked ``[n, b, s]`` token stream: labels are the next tokens."""
    toks = np.random.default_rng(100 + step).integers(
        0, vocab, (n, b, s + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}


def _jb(b):
    return jax.tree.map(jnp.asarray, b)


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


# -- Model.loss and its per-worker gradients --------------------------------

@pytest.mark.parametrize("kv,flash,ref_flash", [
    (None, True, False), (None, False, False), (2, True, False),
    (2, False, False), (None, True, True)],
    ids=["kv4-flash", "kv4-plain", "kv2-flash", "kv2-plain",
         "kv4-flash-vs-interpret-kernel"])
def test_per_worker_loss_and_grads_match_reference(kv, flash, ref_flash):
    """``vmap(grad_and_value(Model.loss))`` on the stacked tree against the
    reference's ``vmap(value_and_grad(model.loss))``: its default XLA
    attention and, once, its interpret-mode flash kernel."""
    jcfg, _ = _cfgs(kv=kv, flash=ref_flash)
    _, tcfg = _cfgs(kv=kv, flash=flash)
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jX, tX = _stacked(jm, "float32")
    b = _batch(0, jcfg.vocab_size)
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jm.loss)))(jX, _jb(b))
    tg, tl = torch.func.vmap(torch.func.grad_and_value(tm.loss))(tX, _tb(b))
    assert tl.shape == (N,) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for a, c in zip(jax.tree.leaves(jg), tree.leaves(tg)):
        a = np.asarray(a)
        np.testing.assert_allclose(c.numpy(), a, rtol=0,
                                   atol=1e-4 * float(np.abs(a).max()))


def test_model_loss_is_the_reference_lm_loss_per_worker():
    """Unbatched: ``Model.loss`` == ``lm_loss`` of the logits, and equal to
    the reference's on one worker."""
    jcfg, tcfg = _cfgs(flash=True)
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jX, tX = _stacked(jm, "float32", n=1)
    b = _batch(1, jcfg.vocab_size, n=1)
    p0 = tree.map(lambda a: a[0], tX)
    got = tm.loss(p0, {k: v[0] for k, v in _tb(b).items()})
    want = jm.loss(jax.tree.map(lambda a: a[0], jX),
                   {k: jnp.asarray(v[0]) for k, v in b.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert torch.equal(got, TT.lm_loss(p0, tcfg, torch.from_numpy(
        b["tokens"][0]), torch.from_numpy(b["labels"][0])))


# -- _FlashSDPA alone --------------------------------------------------------

def _qkv(dtype, g=3, bh=6, s=40, d=16, seed=0, lead=()):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(*lead, bh, s, d, generator=gen).to(dtype)
    k = torch.randn(*lead, bh // g, s, d, generator=gen).to(dtype)
    v = torch.randn(*lead, bh // g, s, d, generator=gen).to(dtype)
    go = torch.randn(*lead, bh, s, d, generator=gen).to(dtype)
    return q, k, v, go


@pytest.mark.parametrize("causal,window", [(True, 7), (True, 0),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_autograd(dtype, causal, window):
    """The VJP written out (GQA group 3) against ``torch.autograd`` through
    the oracle with the KV blocks expanded inside autograd."""
    q, k, v, go = _qkv(dtype)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tfa.sdpa_ref(qkv[0], tfa.expand_kv(qkv[1], 3),
                     tfa.expand_kv(qkv[2], 3), 0.25, causal, window)
    want = torch.autograd.grad(o, qkv, go)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tops._FlashSDPA.apply(*qkv, 0.25, causal, window, 0, False)
    got = torch.autograd.grad(o, qkv, go)
    for a, c in zip(want, got):
        assert c.shape == a.shape and c.dtype == a.dtype
        err = (c.float() - a.float()).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-6 * float(a.abs().max())
        else:
            assert bool((err <= tfa.bf16_ulp(a.float())).all())


@pytest.mark.parametrize("in_dims", [(0, 0, 0), (0, None, None), (1, 1, 1)],
                         ids=["batched", "kv-unbatched", "dim1"])
def test_flash_vmap_rule_equals_a_loop(in_dims):
    """``vmap`` over ``_FlashSDPA`` folds the workers into one launch: its
    forward and its ``grad`` equal a Python loop over workers bitwise."""
    n = 3
    q, k, v, _ = _qkv(torch.float32, lead=(n,), seed=1)
    if in_dims[1] is None:
        k, v = k[0], v[0]
    if in_dims[0] == 1:
        q, k, v = (t.movedim(0, 1).contiguous() for t in (q, k, v))

    def f(q, k, v):
        return tops._FlashSDPA.apply(q, k, v, 0.25, True, 9, 0, False)

    def take(t, d, w):
        return t if d is None else t.select(d, w)
    out = torch.func.vmap(f, in_dims=in_dims)(q, k, v)
    loop = torch.stack([f(*(take(t, d, w) for t, d in zip((q, k, v),
                                                          in_dims)))
                        for w in range(n)])
    assert torch.equal(out, loop)

    def loss(q, k, v):
        return (f(q, k, v) ** 2).sum()
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)),
                            in_dims=in_dims)(q, k, v)
    for w in range(n):
        qkv = [take(t, d, w).clone().requires_grad_()
               for t, d in zip((q, k, v), in_dims)]
        loss(*qkv).backward()
        for gv, t in zip(grads, qkv):
            assert torch.equal(gv[w], t.grad)


def test_flash_route_under_vmap_grad_on_a_model():
    """The LM's per-worker gradients through the flash route equal a loop
    of unbatched gradients bitwise (one fold of the workers a layer)."""
    _, tcfg = _cfgs(kv=2, flash=True)
    jm = jbuild(_cfgs(kv=2)[0])
    tm = tbuild(tcfg, device="cpu")
    _, tX = _stacked(jm, "float32", n=2)
    b = _tb(_batch(2, tcfg.vocab_size, n=2))
    g, _ = torch.func.vmap(torch.func.grad_and_value(tm.loss))(tX, b)
    for w in range(2):
        gw = torch.func.grad(tm.loss)(tree.map(lambda a: a[w], tX),
                                      {k: v[w] for k, v in b.items()})
        for a, c in zip(tree.leaves(g), tree.leaves(gw)):
            assert torch.equal(a[w], c)


# -- xent ---------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [300, 512])
def test_xent_matches_reference(vocab):
    """A vocabulary of 300 pads to 512 columns (the -1e30 mask); labels
    of -1 are masked; an all-masked batch divides by max(#valid, 1)."""
    rng = np.random.default_rng(vocab)
    V = -(-vocab // 256) * 256
    logits = (rng.standard_normal((3, 17, V)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 17)).astype(np.int32)
    labels[rng.random((3, 17)) < 0.3] = -1
    for lbl in (labels, np.full_like(labels, -1)):
        want = float(JT.xent(jnp.asarray(logits), jnp.asarray(lbl), vocab))
        got = TT.xent(torch.from_numpy(logits), torch.from_numpy(lbl), vocab)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(TT.xent(torch.from_numpy(logits), torch.full(
        (3, 17), -1, dtype=torch.int32), vocab)) == 0.0
    # the padded columns take no probability: raising them changes nothing
    big = logits.copy()
    big[..., vocab:] = 1e4
    assert float(TT.xent(torch.from_numpy(big), torch.from_numpy(labels),
                         vocab)) == float(TT.xent(torch.from_numpy(logits),
                                                  torch.from_numpy(labels),
                                                  vocab))


# -- the Moniqua train step on an LM ------------------------------------------

def _hypers(n=N):
    spec = dict(bits=8, stochastic=True)
    return (jalg.AlgoHyper(topo=jring(n), codec=JCodec(JSpec(**spec)),
                           theta=2.0, backend="jnp"),
            talg.AlgoHyper(topo=tring(n), codec=TCodec(TSpec(**spec)),
                           theta=2.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moniqua_train_step_matches_reference(dtype):
    """Moniqua 8-bit (stochastic) on ring(4) over the LM tree, the
    reference's per-step seed handed in.  ``path="auto"`` resolves to
    per-leaf on both sides (one encode and one decode-reduce a leaf); the
    mix is bitwise; one step's parameters and a 3-step loss trajectory
    agree within the module's bounds."""
    jcfg, tcfg = _cfgs(dtype)
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jX, tX = _stacked(jm, dtype)
    jhp, thp = _hypers()
    assert jhp.engine().resolved_path(jX) == "per_leaf"
    assert thp.engine().resolved_path(tX) == "per_leaf"
    key = jax.random.PRNGKey(5)
    seed = int(jops._key_to_seed(key))
    for a, c in zip(jax.tree.leaves(jhp.engine().mix(jX, theta=2.0,
                                                     key=key).x),
                    tree.leaves(thp.engine().mix(tX, theta=2.0,
                                                 seed=seed).x)):
        assert c.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_f32(a), c.float().numpy())

    sgd = dict(momentum=0.9, weight_decay=5e-4)
    lr = 0.1
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
    jl, tl = [], []
    for k in range(3):
        b = _batch(k, jcfg.vocab_size)
        seed = int(jops._key_to_seed(jax.random.split(js["key"])[1]))
        js, jmet = jstep(js, _jb(b))
        ts, tmet = tstep(ts, _tb(b), seed=seed)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        assert tmet["wire_bytes"] == float(jmet["wire_bytes"])
        if k:
            continue
        # the first step's direction is the gradient plus weight decay
        # (momentum starts at 0): the reference's momentum holds it
        for a, c, d in zip(jax.tree.leaves(js["params"]),
                           tree.leaves(ts["params"]),
                           jax.tree.leaves(js["mom"])):
            a, d = _f32(a), np.asarray(d)
            assert c.dtype == getattr(torch, dtype)
            err = np.abs(c.float().numpy() - a)
            if dtype == "float32":
                tol = 1e-6 + lr * 1e-4 * np.abs(d).max()
            else:
                tol = (tfa.bf16_ulp(torch.from_numpy(a)).numpy()
                       + lr * 5e-2 * np.abs(d).max())
            assert (err <= tol).all(), float(err.max())
    np.testing.assert_allclose(tl, jl, rtol=1e-5 if dtype == "float32"
                               else 1e-3)
    assert np.isfinite(tl).all()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "chatglm3-6b",
                                  "internlm2-20b", "qwen2-72b"])
def test_auto_path_and_bytes_of_the_published_tree(arch):
    """Shape only (the reference's abstract init, the port's meta
    tensors), at published widths and depth on ring(4): ``path="auto"``
    resolves per-leaf in both packages (an LM's few large leaves pad to
    the reference's tiles about as the bucket does: a pad ratio near 1,
    under the Moniqua crossover of 9.79) and the wire bytes a step agree,
    Moniqua 8-bit and D-PSGD."""
    shapes = jax.eval_shape(jbuild(jget_config(arch)).init,
                            jax.random.PRNGKey(0))
    jX = jax.tree.map(lambda a: jax.ShapeDtypeStruct((N,) + a.shape,
                                                     a.dtype), shapes)
    tX = tree.map(lambda a: torch.empty((N,) + a.shape, device="meta",
                                        dtype=getattr(torch, str(a.dtype))),
                  shapes)
    jhp, thp = _hypers()
    assert jhp.engine().resolved_path(jX) == "per_leaf"
    assert thp.engine().resolved_path(tX) == "per_leaf"
    for algo in ("moniqua", "dpsgd"):
        assert (talg.get_algorithm(algo).bytes_per_step(tX, thp)
                == jalg.get_algorithm(algo).bytes_per_step(jX, jhp))


# -- the Trainer on an LM ----------------------------------------------------

SHAPE = ("tiny", 16, 8, "train")     # tests/test_trainer.py's


def _tiny(cfg):
    return dataclasses.replace(cfg.reduced(), num_layers=1, d_model=64,
                               num_heads=2, num_kv_heads=2, head_dim=32,
                               d_ff=128, vocab_size=64)


def test_trainer_on_an_lm_matches_reference():
    """``Trainer(model, tc, shape)`` on tests/test_trainer.py's tiny model:
    the reference's ``bytes_per_step`` (D-PSGD and Moniqua 8-bit), and the
    quantized run tracks D-PSGD as the reference test asserts."""
    jmodel = jbuild(_tiny(jget_config(ARCH)))
    tmodel = tbuild(_tiny(tget_config(ARCH)), device="cpu")
    common = dict(n_workers=4, lr=0.3, steps=25, log_every=25,
                  momentum=0.0, weight_decay=0.0, seed=1)
    out = {}
    for algo, kw in (("dpsgd", {}), ("moniqua", dict(bits=8, theta=2.0))):
        tr = Trainer(tmodel, TrainerConfig(algo=algo, **common, **kw),
                     TShape(*SHAPE))
        out[algo] = tr.run()
        ref = JTrainer(jmodel, JShape(*SHAPE), JTrainerConfig(
            algo=algo, **dict(common, steps=1), **kw)).run()
        assert out[algo]["bytes_per_step"] == ref["bytes_per_step"]
        assert np.isfinite([h["loss"] for h in out[algo]["history"]]).all()
    l_fp = out["dpsgd"]["history"][-1]["loss"]
    l_mq = out["moniqua"]["history"][-1]["loss"]
    assert abs(l_mq - l_fp) < 0.25 * l_fp
    assert (out["moniqua"]["bytes_per_step"] * 4
            <= out["dpsgd"]["bytes_per_step"] * 1.01)


def test_trainer_lm_batches_are_the_pipeline_worker_batches():
    """The trainer reads ``SyntheticLMPipeline(model, shape, n,
    seed=tc.seed).worker_batch``; the callable form still works."""
    tmodel = tbuild(_tiny(tget_config(ARCH)), device="cpu")
    tc = TrainerConfig(algo="dpsgd", n_workers=2, steps=1, seed=4)
    tr = Trainer(tmodel, tc, TShape(*SHAPE))
    want = SyntheticLMPipeline(tmodel, TShape(*SHAPE), 2,
                               seed=4).worker_batch(3)
    got = tr.batch_fn(3)
    assert all(torch.equal(got[k], want[k]) for k in want)
    fixed = Trainer(tmodel, tc, lambda k: want)
    assert fixed.batch_fn(0) is want


# -- data --------------------------------------------------------------------

def test_worker_batch_shapes_and_determinism():
    tmodel = tbuild(_tiny(tget_config(ARCH)), device="cpu")
    shape = TShape("t", 16, 8, "train")
    pipe = SyntheticLMPipeline(tmodel, shape, 4, seed=2)
    wb, wb2, g = pipe.worker_batch(5), pipe.worker_batch(5), \
        pipe.global_batch(5)
    assert set(wb) == {"tokens", "labels"}
    for k in wb:
        assert wb[k].shape == (4, 2, 16) and wb[k].dtype == torch.int32
        assert torch.equal(wb[k], wb2[k])
        assert torch.equal(wb[k].reshape(8, 16), g[k])
    assert not torch.equal(wb["tokens"], pipe.worker_batch(6)["tokens"])
    with pytest.raises(ValueError):
        SyntheticLMPipeline(tmodel, shape, 3).worker_batch(0)


def test_token_task_teacher_and_labels():
    """Each label is the token drawn after its input token: the next input;
    the labels follow the seeded teacher (their mean log-likelihood under
    it is well above the uniform one); deterministic in (seed, step)."""
    task = TokenTask(vocab_size=48, seed=3)
    b = task.batch(0, 64, 40, device="cpu")
    toks, lbl = b["tokens"], b["labels"]
    assert toks.shape == lbl.shape == (64, 40)
    assert toks.dtype == lbl.dtype == torch.int32
    assert torch.equal(toks[:, 1:], lbl[:, :-1])
    assert torch.equal(lbl, task.batch(0, 64, 40, device="cpu")["labels"])
    assert not torch.equal(lbl, task.batch(1, 64, 40, device="cpu")["labels"])
    teacher = task.teacher()
    assert teacher.shape == (48, 48) and teacher.dtype == torch.float32
    assert torch.equal(teacher, TokenTask(48, seed=3).teacher())
    lp = torch.log_softmax(teacher, -1)[toks.long(), lbl.long()]
    entropy = -(torch.softmax(teacher, -1)
                * torch.log_softmax(teacher, -1)).sum(-1).mean()
    assert float(lp.mean()) > -float(np.log(48)) + 1.0
    assert abs(float(-lp.mean()) - float(entropy)) < 0.25
