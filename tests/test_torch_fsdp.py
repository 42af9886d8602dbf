"""FSDP weights over ``data`` under the hierarchical rules, and
replicated-KV GQA over ``model``, against JAX.

Four gloo groups on the CPU run ``tests/torch_fsdp_cases.py`` side by side,
one thread a rank, the port only (``torch_fsdp_cases.WORLDS``): reduced
qwen2-72b (``qkv_bias``, GQA 4:2 by override) under
``ShardingRules("hierarchical")`` on ``(data=2, model=1)`` and ``(data=2,
model=2)`` and under ``ShardingRules("hierarchical", multi_pod=True)`` on
``(pod=2, data=2)``; reduced chatglm3-6b (4 query heads, 2 KV heads,
replicated over ``model``) on ``(data=1, model=4)``.  This process draws
the inputs from the JAX reference's init, stacked over 4 workers that
differ by seeded noise, runs the reference while the ranks run, and holds
the gathered results against it, with ``tests/test_torch_tensor_parallel
.py``'s bounds:

* the FSDP and Megatron operators under ``vmap(grad)`` against one
  process's autograd (checked in the ranks: 1e-5 of each gradient's
  largest entry);
* per-worker loss and gradients under ``vmap(grad)``: losses within
  ``rtol=1e-5``, each gradient leaf within 1e-4 of its largest entry
  (the loss's token sums and the weights' gradients are summed over
  ``data`` by all-reduces, in another order than one process's sums);
* the Moniqua round (8-bit stochastic, 1-bit nearest) and the ``full``
  round on the shards: bitwise the reference's round, gathered; the
  unsplit leaves bitwise equal over the ranks (checked in the ranks);
* one ``train_step``: the parameters within ``1e-6 + lr 1e-4 max|d|`` of
  each leaf, the loss within ``rtol=1e-5``, ``bytes_per_step`` equal;
* two ``Trainer`` steps with a gathered checkpoint: its restore is the live
  state bitwise (in the ranks); the losses within ``rtol=1e-5`` of the
  port's one-process trainer, the checkpoint's params within two steps'
  bound of it, elements up to Lemma 2's one-round bound beyond it counted;
* float32 prefill and 4 cached decode steps within 1e-4 x max|logit|,
  the cache a rank holds the cut its specs name (checked in the ranks);
* every out-of-scope case refused at construction, naming #13e.

On ``(pod=2, data=2)`` (``C.RULE_WORLDS``: two workers a pod, FSDP over
``data``) the eight other update rules and the masked rounds run on the
shards of reduced qwen2-72b, held as ``tests/test_torch_tensor_parallel
.py`` holds them (``torch_rule_cases``): bitwise the reference's steps
and the port's one process's, the trainer within its bounds, a D²
checkpoint restored bitwise, the masked rounds bitwise.

The head counts of ``C.SPLIT_WORLDS`` run at the same bounds (gradients,
a train step with its code flips counted, prefill and decode, and 12
decode steps on a ring of 8 slots, past each rank's and past the ring's
end): reduced
qwen2-72b with 3 query heads over 1 KV head on ``(data=2, model=2)``
(context-parallel attention under FSDP, the decode cache on its sequence
dim), reduced chatglm3-6b with 24 query heads over 6 KV heads on
``(data=1, model=4)`` (KV groups a rank cannot read whole).

Reduced dbrx-132b (E 4, top-2, group 64) runs on ``(data=2, model=2)``
and ``(pod=2, data=2)`` too (``C.MOE_WORLDS``), its experts split on
``d_model`` over ``data`` and on each expert's ``d_ff`` over ``model``,
held to the same bounds: gradients, the Moniqua 8-bit and 1-bit rounds
on the expert shards (bitwise), a train step, prefill and decode.  A
token that the split routed otherwise than the reference (a top-k
near-tie moved by the split's summation order) would put its logits and
gradients far outside these bounds; none does on these inputs.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

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
from repro.models.model_factory import build_model as jbuild
from repro.optim import sgd as jsgd
from repro.train import train_step as jts

import torch_fsdp_cases as C
import torch_rule_cases as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "torch_fsdp_cases.py")
WORLDS = tuple(C.WORLDS)
ROUND_KEY = jax.random.PRNGKey(5)


def _jcfg(name):
    arch, over = C.arch_of(name)
    return dataclasses.replace(jget_config(arch).reduced(), dtype="float32",
                               flash_attention=False, **over)


def _inputs(path):
    """The reference's init, stacked over ``C.N`` workers with seeded
    noise, batches and serving tokens (``C.port_inputs``'s layout)."""
    rng = np.random.default_rng(0)
    key_step = jax.random.PRNGKey(0)
    out = {"seed_round": np.array(int(jops._key_to_seed(ROUND_KEY))),
           "seed_step": np.array(int(jops._key_to_seed(
               jax.random.split(key_step)[1])))}
    trees = {}
    for a in C.ALL_ARCHS:
        jm = jbuild(_jcfg(a))
        p = jm.init(jax.random.PRNGKey(0))
        # non-zero QKV biases, so their gathers and reductions show
        p = jax.tree_util.tree_map_with_path(
            lambda kp, t: (t + 0.1 if str(kp[-1]).strip("[]'\"") in
                           ("bq", "bk", "bv") else t), p)
        X = jax.tree.map(lambda t: (np.asarray(t, np.float32)[None] + 0.02
                                    * rng.standard_normal((C.N,) + t.shape)
                                    ).astype(np.float32), p)
        for i, leaf in enumerate(jax.tree.leaves(X)):
            out[f"{a}/X/{i}"] = leaf
        if a == C.ARCH:
            out["rule_keys"] = np.asarray(R.reference_inputs(out, a, X))
        toks = rng.integers(0, jm.cfg.vocab_size, (C.N, C.B, C.S + 1)
                            ).astype(np.int32)
        out[f"{a}/tokens"] = toks[..., :-1].copy()
        out[f"{a}/labels"] = toks[..., 1:].copy()
        out[f"{a}/serve"] = rng.integers(
            0, jm.cfg.vocab_size, (C.SERVE_B, C.SERVE_S + C.DECODE)
        ).astype(np.int32)
        trees[a] = (jm, jax.tree.map(jnp.asarray, X))
    np.savez(path, **out)
    return out, trees, key_step


def _launch(tmp, world, inputs):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = os.path.join(tmp, f"out_{world}")
    store = os.path.join(tmp, f"store_{world}")
    return out, [subprocess.Popen(
        [sys.executable, SCRIPT, store, str(r), world, inputs, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(C.WORLDS[world][0])]


def _collect(out, procs, timeout=300):
    logs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(out + ".json") as f:
        checks = json.load(f)["checks"]
    return dict(np.load(out + ".npz")), checks


def _train_step_ref(jm, jX, batch, key_step):
    hp = jalg.AlgoHyper(topo=jring(C.N), codec=JCodec(JSpec(8, True)),
                        theta=C.THETA, backend="jnp")
    step = jax.jit(jts.make_train_step(jm, hp, jts.TrainStepConfig(
        algo="moniqua", sgd=jsgd.SGDConfig(momentum=0.9, weight_decay=5e-4),
        lr=C.LR, theta=JTheta(value=C.THETA))))
    js = {"params": jX, "mom": jsgd.init_momentum(jX), "extra": {},
          "step": jnp.zeros((), jnp.int32),
          "g_inf": jnp.ones((), jnp.float32), "key": key_step}
    js, met = step(js, batch)
    return ([np.asarray(x) for x in jax.tree.leaves(js["params"])],
            [np.asarray(d) for d in jax.tree.leaves(js["mom"])],
            float(met["loss"]), int(met["wire_bytes"]))


def _decode_ref(jm, P, toks, slots, steps):
    """The reference's logits of ``steps`` cached decode steps from an
    empty ring of ``slots``, fed ``toks``."""
    cache = jm.init_cache(C.SERVE_B, JShape("d", slots, C.SERVE_B,
                                            "decode"))
    decode = jax.jit(jm.decode_step)
    dec = []
    for s in range(steps):
        lg, cache = decode(P, cache, toks[:, s:s + 1])
        dec.append(np.asarray(lg))
    return np.stack(dec)


def _reference(inp, trees, key_step):
    """Every number the ranks are held to, from the JAX package."""
    ref = {}
    for a, (jm, jX) in trees.items():
        batch = {k: jnp.asarray(inp[f"{a}/{k}"]) for k in ("tokens",
                                                            "labels")}
        loss, grads = jax.jit(jax.vmap(jax.value_and_grad(jm.loss)))(
            jX, batch)
        ref[f"grads-{a}"] = (np.asarray(loss), [np.asarray(g) for g in
                                                jax.tree.leaves(grads)])
        P = jax.tree.map(lambda t: t[0], jX)
        toks = jnp.asarray(inp[f"{a}/serve"])
        prefill = jax.jit(lambda p, t: jm.prefill_logits(
            p, {"tokens": t}, last_only=False))(P, toks[:, :C.SERVE_S])
        ref[f"serve-{a}"] = (np.asarray(prefill), _decode_ref(
            jm, P, toks, C.SERVE_S + C.DECODE, C.DECODE))
        if a in C.SPLIT_ARCHS:
            ref[f"ring-{a}"] = _decode_ref(jm, P, toks, C.RING, C.RING_STEPS)
        ref[f"step-{a}"] = _train_step_ref(jm, jX, batch, key_step)
        for wire, spec in C.ROUNDS.items():
            if a == C.KV_ARCH and wire != "moniqua8" or (
                    a == C.MOE_ARCH and wire == "full") or a in C.SPLIT_ARCHS:
                continue
            # the reference's bucketed Moniqua round is its per-leaf round
            # bit for bit (its bucket invariants): fewer eager compiles
            hp = jalg.AlgoHyper(topo=jring(C.N), codec=JCodec(JSpec(
                *(spec or (8, True)))), theta=C.THETA, backend="jnp",
                path="auto" if wire == "full" else "bucketed")
            res = (hp.exact_engine().mix(jX) if wire == "full"
                   else hp.engine().mix(jX, theta=C.THETA, key=ROUND_KEY))
            ref[f"round-{wire}-{a}"] = [np.asarray(x)
                                        for x in jax.tree.leaves(res.x)]
    jm, jX = trees[C.ARCH]
    ref.update(R.reference(jm, jX, list(jnp.asarray(inp["rule_keys"])),
                           C.N, C.THETA))
    return ref


def _one_process_trainer(workdir):
    """The port's trainer of the ``trainer`` case in this process."""
    runner = C.Runner.__new__(C.Runner)
    runner.mesh, runner.rules, runner.device = None, None, "cpu"
    runner.arch = C.ARCH
    tr = C.Runner.trainer_of(runner, os.path.join(workdir, "one"))
    out = tr.run()
    return out, dict(np.load(os.path.join(workdir, "one.state.npz")))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("fsdp"))
    inputs = os.path.join(tmp, "inputs.npz")
    inp, trees, key_step = _inputs(inputs)
    runs = {w: _launch(tmp, w, inputs) for w in WORLDS}
    ref = _reference(inp, trees, key_step)
    one = _one_process_trainer(tmp)
    # the port's one process on the rule and masked cases
    rules = C.Runner(0, C.RULE_WORLDS[0], inputs, tmp, "cpu", split=False)
    rules.run(R.rule_names())
    ref["one"], ref["one_checks"] = rules.arrays, rules.checks
    return ref, one, {w: _collect(*runs[w]) for w in WORLDS}


def _leaves(arrays, case):
    keys = sorted((k for k in arrays if k.startswith(case + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [arrays[k] for k in keys]


def _arch(world):
    return C.WORLDS[world][4]


@pytest.mark.parametrize("world", WORLDS)
def test_every_case_ran_in_the_ranks(results, world):
    _, _, res = results
    arrays, checks = res[world]
    assert sorted(checks) == sorted(C.case_names(world))
    for case, (ok, detail, _) in checks.items():
        assert ok, (case, detail)


@pytest.mark.parametrize("world", WORLDS)
def test_per_worker_loss_and_grads_match_reference(results, world):
    ref, _, res = results
    arrays, _ = res[world]
    arch = _arch(world)
    loss, grads = ref[f"grads-{arch}"]
    np.testing.assert_allclose(arrays[f"grads-{arch}/loss"], loss,
                               rtol=1e-5)
    got = _leaves(arrays, f"grads-{arch}/grads")
    assert len(got) == len(grads)
    for c, a in zip(got, grads):
        assert c.shape == a.shape
        np.testing.assert_allclose(c, a, rtol=0,
                                   atol=1e-4 * float(np.abs(a).max()))


@pytest.mark.parametrize("world,wire",
                         [(w, r) for w in WORLDS for r in C.ROUNDS
                          if f"round-{r}" in C.case_names(w)])
def test_sharded_round_is_the_reference_round(results, world, wire):
    ref, _, res = results
    arrays, _ = res[world]
    got = _leaves(arrays, f"round-{wire}/x")
    want = ref[f"round-{wire}-{_arch(world)}"]
    assert len(got) == len(want)
    for c, a in zip(got, want):
        np.testing.assert_array_equal(c, a)


@pytest.mark.parametrize("world", WORLDS)
def test_train_step_matches_reference(results, world):
    ref, _, res = results
    arrays, _ = res[world]
    params, mom, loss, wire_bytes = ref[f"step-{_arch(world)}"]
    got = _leaves(arrays, "step/x")
    assert len(got) == len(params)
    for c, a, d in zip(got, params, mom):
        tol = 1e-6 + C.LR * 1e-4 * np.abs(d).max()
        assert float(np.abs(c - a).max()) <= tol
    np.testing.assert_allclose(float(arrays["step/loss"]), loss, rtol=1e-5)
    assert int(arrays["step/wire_bytes"]) == wire_bytes


@pytest.mark.parametrize("world", [w for w in WORLDS
                                   if "trainer" in C.case_names(w)])
def test_trainer_checkpoint_is_the_one_process_run(results, world):
    """The gathered checkpoint against the port's one-process trainer:
    the file's keys and shapes, the losses, the bytes; each parameter
    within two steps' float32 bound, or Lemma 2's bound of one round
    beyond it (counted, under 1e-4 of the elements)."""
    from repro_torch.core import modulo
    from repro_torch.core.quantizers import delta_for_bits
    _, (one, one_ck), res = results
    arrays, _ = res[world]
    np.testing.assert_allclose(arrays["trainer/losses"],
                               [h["loss"] for h in one["history"]],
                               rtol=1e-5)
    assert int(arrays["trainer/bytes"]) == one["bytes_per_step"]
    keys = sorted(k for k in one_ck if k.startswith("params"))
    assert sorted(k.split("/", 2)[2] for k in arrays
                  if k.startswith("trainer/ckpt/")) == keys
    cell = 2 * (1 - 1 / 3) * delta_for_bits(8, True) * float(
        modulo.b_theta(C.THETA, delta_for_bits(8, True), "cpu"))
    flips = total = 0
    for k in keys:
        c, a = arrays[f"trainer/ckpt/{k}"], one_ck[k]
        assert c.shape == a.shape
        m = one_ck[k.replace("params", "mom", 1)]
        tol = 2 * (1e-6 + C.LR * 1e-4 * np.abs(m).max())
        err = np.abs(c - a)
        assert (err <= tol + cell * 1.001).all(), float(err.max())
        flips += int((err > tol).sum())
        total += err.size
    assert flips <= 1e-4 * total, (flips, total)


@pytest.mark.parametrize("world", WORLDS)
def test_prefill_and_decode_match_reference(results, world):
    ref, _, res = results
    arrays, _ = res[world]
    arch = _arch(world)
    for got, want in zip((arrays[f"serve-{arch}/prefill"],
                          arrays[f"serve-{arch}/decode"]),
                         ref[f"serve-{arch}"]):
        assert got.shape == want.shape and got.dtype == np.float32
        assert (np.abs(got - want).max() / np.abs(want).max()) <= 1e-4


@pytest.mark.parametrize("world", list(C.SPLIT_WORLDS))
def test_split_heads_loss_and_grads_match_reference(results, world):
    """Reduced qwen2-72b with 3 query heads on ``(data=2, model=2)``
    (context-parallel attention) and reduced chatglm3-6b with 24 query
    heads over 6 KV heads on ``(data=1, model=4)`` (KV groups a rank cannot
    read whole): loss and gradients at the bounds above."""
    ref, _, res = results
    arrays, _ = res[world]
    arch = C.SPLIT_WORLDS[world]
    loss, grads = ref[f"grads-{arch}"]
    np.testing.assert_allclose(arrays[f"grads-{arch}/loss"], loss,
                               rtol=1e-5)
    got = _leaves(arrays, f"grads-{arch}/grads")
    assert len(got) == len(grads)
    for c, a in zip(got, grads):
        assert c.shape == a.shape
        np.testing.assert_allclose(c, a, rtol=0,
                                   atol=1e-4 * float(np.abs(a).max()))


@pytest.mark.parametrize("world", list(C.SPLIT_WORLDS))
def test_split_heads_train_step_matches_reference(results, world):
    """Their train step: params within ``1e-6 + lr 1e-4 max|d|``, or one
    Lemma 2 cell beyond it where a code rounds the other way (the split's
    gradients differ from one process's in the last bits): counted, under
    1e-4 of the elements."""
    from repro_torch.core import modulo
    from repro_torch.core.quantizers import delta_for_bits
    ref, _, res = results
    arrays, _ = res[world]
    arch = C.SPLIT_WORLDS[world]
    params, mom, loss, wire_bytes = ref[f"step-{arch}"]
    got = _leaves(arrays, f"step-{arch}/x")
    assert len(got) == len(params)
    cell = 2 * (1 - 1 / 3) * delta_for_bits(8, True) * float(
        modulo.b_theta(C.THETA, delta_for_bits(8, True), "cpu"))
    flips = total = 0
    for c, a, d in zip(got, params, mom):
        tol = 1e-6 + C.LR * 1e-4 * np.abs(d).max()
        err = np.abs(c - a)
        assert float(err.max()) <= tol + cell * 1.001
        flips += int((err > tol).sum())
        total += err.size
    assert flips <= 1e-4 * total, (flips, total)
    np.testing.assert_allclose(float(arrays[f"step-{arch}/loss"]), loss,
                               rtol=1e-5)
    assert int(arrays[f"step-{arch}/wire_bytes"]) == wire_bytes


@pytest.mark.parametrize("world", list(C.SPLIT_WORLDS))
def test_split_heads_prefill_and_decode_match_reference(results, world):
    ref, _, res = results
    arrays, _ = res[world]
    arch = C.SPLIT_WORLDS[world]
    for got, want in zip((arrays[f"serve-{arch}/prefill"],
                          arrays[f"serve-{arch}/decode"]),
                         ref[f"serve-{arch}"]):
        assert got.shape == want.shape and got.dtype == np.float32
        assert (np.abs(got - want).max() / np.abs(want).max()) <= 1e-4


@pytest.mark.parametrize("world", list(C.SPLIT_WORLDS))
def test_split_heads_ring_decode_matches_reference(results, world):
    """``C.RING_STEPS`` decode steps on a ring of ``C.RING`` slots, the
    cache on its sequence dim (``C.RING / M`` slots a rank): the steps
    past rank 0's slots, on every rank's and past the ring's end attend
    the whole ring, as the reference's; the logits within 1e-4 x
    max|logit|."""
    ref, _, res = results
    arrays, _ = res[world]
    arch = C.SPLIT_WORLDS[world]
    got, want = arrays[f"ring-{arch}/decode"], ref[f"ring-{arch}"]
    assert got.shape == want.shape and got.dtype == np.float32
    assert (np.abs(got - want).max() / np.abs(want).max()) <= 1e-4


@pytest.mark.parametrize("world", C.MOE_WORLDS)
def test_moe_loss_and_grads_match_reference(results, world):
    ref, _, res = results
    arrays, _ = res[world]
    loss, grads = ref[f"grads-{C.MOE_ARCH}"]
    np.testing.assert_allclose(arrays[f"grads-{C.MOE_ARCH}/loss"], loss,
                               rtol=1e-5)
    got = _leaves(arrays, f"grads-{C.MOE_ARCH}/grads")
    assert len(got) == len(grads)
    for c, a in zip(got, grads):
        assert c.shape == a.shape
        np.testing.assert_allclose(c, a, rtol=0,
                                   atol=1e-4 * float(np.abs(a).max()))


@pytest.mark.parametrize("world", C.MOE_WORLDS)
@pytest.mark.parametrize("wire", ["moniqua8", "moniqua1"])
def test_moe_round_on_the_expert_shards_is_the_reference_round(results,
                                                               world, wire):
    """Bitwise; at 1 bit the router's rows of E = 4 codes are padded to a
    byte, in one process and on the shards alike."""
    ref, _, res = results
    arrays, _ = res[world]
    got = _leaves(arrays, f"round-{wire}-{C.MOE_ARCH}/x")
    want = ref[f"round-{wire}-{C.MOE_ARCH}"]
    assert len(got) == len(want)
    for c, a in zip(got, want):
        np.testing.assert_array_equal(c, a)


@pytest.mark.parametrize("world", C.MOE_WORLDS)
def test_moe_train_step_matches_reference(results, world):
    """Reduced dbrx-132b's train step on the expert shards: each parameter
    within one step's bound, or Lemma 2's bound of one round beyond it
    (a code rounded the other way from last-bit differences of the
    pre-round params, counted, under 1e-4 of the elements; none on these
    inputs, 3 of ``w_down``'s on ``tests/test_torch_tensor_parallel.py``'s)."""
    from repro_torch.core import modulo
    from repro_torch.core.quantizers import delta_for_bits
    ref, _, res = results
    arrays, _ = res[world]
    params, mom, loss, wire_bytes = ref[f"step-{C.MOE_ARCH}"]
    case = f"step-{C.MOE_ARCH}"
    got = _leaves(arrays, f"{case}/x")
    assert len(got) == len(params)
    cell = 2 * (1 - 1 / 3) * delta_for_bits(8, True) * float(
        modulo.b_theta(C.THETA, delta_for_bits(8, True), "cpu"))
    flips = total = 0
    for c, a, d in zip(got, params, mom):
        tol = 1e-6 + C.LR * 1e-4 * np.abs(d).max()
        err = np.abs(c - a)
        assert float(err.max()) <= tol + cell * 1.001
        flips += int((err > tol).sum())
        total += err.size
    assert flips <= 1e-4 * total, (flips, total)
    np.testing.assert_allclose(float(arrays[f"{case}/loss"]), loss,
                               rtol=1e-5)
    assert int(arrays[f"{case}/wire_bytes"]) == wire_bytes


@pytest.mark.parametrize("world", C.MOE_WORLDS)
def test_moe_prefill_and_decode_match_reference(results, world):
    ref, _, res = results
    arrays, _ = res[world]
    a = C.MOE_ARCH
    for got, want in zip((arrays[f"serve-{a}/prefill"],
                          arrays[f"serve-{a}/decode"]), ref[f"serve-{a}"]):
        assert got.shape == want.shape and got.dtype == np.float32
        assert (np.abs(got - want).max() / np.abs(want).max()) <= 1e-4


@pytest.mark.parametrize("world", C.RULE_WORLDS)
@pytest.mark.parametrize("rule", R.RULES)
def test_rule_on_shards_is_the_reference_step(results, world, rule):
    """Two isolated steps on the pods' workers and the ``data`` shards,
    the reference's uniforms cut alike: bitwise the reference's, gathered
    (``R.check_against_reference``); the bytes and extra memory the
    reference's."""
    ref, _, res = results
    R.check_against_reference(res[world][0], ref, rule)


@pytest.mark.parametrize("world", C.RULE_WORLDS)
@pytest.mark.parametrize("rule", R.RULES)
def test_rule_on_shards_is_the_one_process_step(results, world, rule):
    """The same steps, and with the port's own draw: bitwise the port's
    one process (AllReduce within ``R.SUM_RTOL``: the pods split the
    worker dim)."""
    ref, _, res = results
    assert ref["one_checks"][f"rule-{rule}"][0], ref["one_checks"][
        f"rule-{rule}"]
    R.check_against_one_process(res[world][0], ref["one"], rule,
                                worker_split=True)


@pytest.mark.parametrize("world", C.RULE_WORLDS)
@pytest.mark.parametrize("rule", R.RULES)
def test_rule_trainer_matches_one_process(results, world, rule):
    """Two ``Trainer`` steps under the split against one process's; the
    state in the params' cut and a D² checkpoint restored bitwise (in the
    ranks)."""
    ref, _, res = results
    arrays, checks = res[world]
    ok, detail, _ = checks[f"rule-{rule}"]
    assert ok, detail
    R.check_trainer(arrays, ref["one"], rule, C.lemma2_cell())


@pytest.mark.parametrize("world", C.RULE_WORLDS)
@pytest.mark.parametrize("wire", R.MASKED_WIRES)
def test_masked_round_on_shards_is_the_reference_round(results, world, wire):
    """The Moniqua 8-bit and ``full`` rounds under ``R.PRESENCE`` on the
    shards: bitwise the reference's masked round and the port's one
    process's; the absent worker's rows untouched (in the ranks)."""
    ref, _, res = results
    arrays, checks = res[world]
    ok, detail, _ = checks["round-masked"]
    assert ok, detail
    got = R.leaves(arrays, f"round-masked/{wire}")
    R.assert_equal(got, ref[f"round-masked/{wire}"])
    R.assert_equal(got, R.leaves(ref["one"], f"round-masked/{wire}"))


@pytest.mark.parametrize("world,what", [(w, r) for w in WORLDS
                                        for r in C.REFUSALS[w]])
def test_out_of_scope_is_refused_naming_13e(results, world, what):
    _, _, res = results
    ok, detail, _ = res[world][1][f"refuse-{what}"]
    assert ok, detail
    assert "#13e" in detail


def test_split_view_hashes_the_whole_leaf_counters():
    """``split_view`` lays a shard split on two dims out so that its
    counters are its elements' positions in the whole leaf, for the
    layouts of ``wq`` ``[n, L, d/D, h/M, hd]``, ``wo`` ``[n, L, h/M, hd,
    d/D]`` and ``embed`` ``[n, V/M, d/D]``."""
    from repro_torch.comm import tensor_parallel as TP
    from repro_torch.kernels.moniqua_encode import row_bases
    for shape, (a, b) in (((2, 3, 8, 4, 6), (2, 3)),
                          ((2, 3, 4, 6, 8), (2, 4)),
                          ((2, 12, 8), (1, 2))):
        x = torch.zeros(shape)
        want_all = torch.arange(x[0].numel()).reshape(shape[1:])
        for ra in range(2):
            for rb in range(2):
                ka, kb = shape[a] // 2, shape[b] // 2
                s = x.narrow(a, ra * ka, ka).narrow(b, rb * kb, kb)
                view, off, stride, rpb, bs = TP.split_view(
                    s, ((a, ra * ka, shape[a]), (b, rb * kb, shape[b])))
                rows, cols = view.shape[1:]
                idx = row_bases(rows, off, stride, rpb, bs) + torch.arange(
                    cols)
                want = want_all.narrow(a - 1, ra * ka, ka).narrow(
                    b - 1, rb * kb, kb).reshape(rows, cols)
                assert torch.equal(idx, want)


@pytest.mark.parametrize("shape,a", [((2, 3, 8, 4), 2), ((2, 8, 4), 1),
                                     ((2, 3, 8, 2, 5), 2)],
                         ids=["router", "one-layer", "between"])
def test_split_view_pads_an_unaligned_last_dim(shape, a):
    """A shard split on one dim whose whole last dim is not a whole number
    of code bytes (an MoE router ``[n, L, d/D, E]`` at E 4 and 1 bit)
    hashes the counters one process gives its elements, whose rows are
    padded to whole bytes: ``row_bases`` at the view's offset, padded
    stride and blocks against the whole leaf's padded rows.  A split of
    such a last dim, or two splits, raise ``ValueError``."""
    from repro_torch.comm import tensor_parallel as TP
    from repro_torch.kernels.moniqua_encode import row_bases
    align = 8
    x = torch.zeros(shape)
    last = shape[-1]
    cp = -(-last // align) * align
    rows_whole = x[0].numel() // last
    want_all = (row_bases(rows_whole, 0, cp, None, 0) + torch.arange(last)
                ).reshape(shape[1:])
    for r in range(2):
        k = shape[a] // 2
        s = x.narrow(a, r * k, k)
        view, off, stride, rpb, bs = TP.split_view(
            s, ((a, r * k, shape[a]),), align)
        rows, cols = view.shape[1:]
        assert cols == last and stride == cp
        idx = row_bases(rows, off, stride, rpb, bs) + torch.arange(cols)
        want = want_all.narrow(a - 1, r * k, k).reshape(rows, cols)
        assert torch.equal(idx, want)
    with pytest.raises(ValueError):
        TP.split_view(x.narrow(len(shape) - 1, 0, 2),
                      ((len(shape) - 1, 0, last),), align)


def test_gather_backward_outside_the_context(tmp_path):
    """``fsdp.gather``'s and ``fsdp.matmul``'s backward run in another
    thread (the autograd engine's for a CUDA backward) gather, all-reduce
    and cut as one in the forward's: a one-rank gloo group with the split
    switched on (its all-reduce sums one rank, the identity)."""
    import threading
    import torch.distributed as dist
    from repro_torch.comm import fsdp
    from repro_torch.comm import tensor_parallel as TP
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        g = torch.Generator().manual_seed(0)
        w = torch.randn(4, 5, generator=g, requires_grad=True)
        x = torch.randn(3, 8, generator=g)
        with TP.axis_context(TP.AxisGroup("data", rank=1, size=2,
                                          group=dist.group.WORLD)):
            y = (x @ fsdp.gather(w, 0)).sum() + fsdp.matmul(x, w, 0).sum()
        out = {}

        def backward():
            try:
                out["grad"] = torch.autograd.grad(y, w)[0]
            except Exception as e:              # reported by the assert
                out["error"] = e
        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert "error" not in out, out.get("error")
        # this rank holds rows 4..7 of the whole weight (the others zero)
        assert torch.equal(out["grad"], 2 * (x.T @ torch.ones(3, 5))[4:])
    finally:
        dist.destroy_process_group()


def test_matmul_keeps_only_the_shard_for_backward(tmp_path):
    """Under an FSDP split only the shard of a weight that ``fsdp.matmul``
    multiplies by is kept for the backward pass (the whole weight is
    gathered again there), so no layer's whole weight outlives its
    forward: every tensor the autograd graph of a gated MLP saves is
    recorded, and none has a whole weight's shape; a product with
    ``fsdp.gather``'s whole weight, the control, keeps it.  Nor does the
    backward keep the weight it gathers again when it runs with
    ``create_graph=True``, as ``torch.func.grad`` runs it.  The gradients
    equal the control's.  A one-rank gloo group with the split switched on
    (its all-reduce sums one rank)."""
    import torch.distributed as dist
    from repro_torch.comm import fsdp
    from repro_torch.comm import tensor_parallel as TP
    from repro_torch.models import layers as L
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        g = torch.Generator().manual_seed(0)
        d, f = 8, 12
        p = {"w_up": torch.randn(d // 2, f, generator=g),
             "w_gate": torch.randn(d // 2, f, generator=g),
             "w_down": torch.randn(f, d // 2, generator=g)}
        for w in p.values():
            w.requires_grad_(True)
        x = torch.randn(3, d, generator=g, requires_grad=True)

        def control(p, x):
            h = x @ fsdp.gather(p["w_up"], 0)
            h = torch.nn.functional.silu(x @ fsdp.gather(p["w_gate"], 0)) * h
            return h @ fsdp.gather(p["w_down"], 1)

        def saved(fn):
            shapes = []

            def pack(t):
                shapes.append(tuple(t.shape))
                return t
            with TP.axis_context(TP.AxisGroup("data", rank=1, size=2,
                                              group=dist.group.WORLD)), \
                    torch.autograd.graph.saved_tensors_hooks(pack,
                                                             lambda t: t):
                y = fn(p, x)
                n = len(shapes)
                grads = torch.autograd.grad((y ** 2).sum(), [x, *p.values()],
                                            create_graph=True)
            return shapes[:n], shapes[n:], grads
        got, got_bwd, grads = saved(lambda p, x: L.mlp(p, x, gated=True))
        want, _, grads_want = saved(control)
        wholes = {(d, f), (f, d)}
        assert not wholes & set(got), got
        assert not wholes & set(got_bwd), got_bwd
        assert {(d // 2, f), (f, d // 2)} <= set(got), got
        assert wholes <= set(want), want
        for a, b in zip(grads, grads_want):
            torch.testing.assert_close(a, b)
    finally:
        dist.destroy_process_group()


def test_gathered_weights_freed_under_vmap_grad(tmp_path, monkeypatch):
    """Under ``vmap(grad)``, the trainer's transform, no weight that
    ``fsdp.matmul`` gathers (forward or backward) is alive when a later
    weight's gradient is reduce-scattered: each whole is freed once its
    product is done.  The gathered tensors are watched through weak
    references, counted at every reduce-scatter of a gated MLP's
    backward.  A one-rank gloo group with the split switched on."""
    import gc
    import weakref
    import torch.distributed as dist
    from repro_torch.comm import fsdp
    from repro_torch.comm import tensor_parallel as TP
    from repro_torch.models import layers as L
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    refs, alive = [], []
    whole_of, scatter = TP.whole_of, fsdp._scatter

    def watched(*a):
        out = whole_of(*a)
        refs.append(weakref.ref(out))
        return out

    def counted(*a):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))
        return scatter(*a)
    monkeypatch.setattr(TP, "whole_of", watched)
    monkeypatch.setattr(fsdp, "_scatter", counted)
    try:
        g = torch.Generator().manual_seed(0)
        d, f, n = 8, 12, 2
        p = {"w_up": torch.randn(n, d // 2, f, generator=g),
             "w_gate": torch.randn(n, d // 2, f, generator=g),
             "w_down": torch.randn(n, f, d // 2, generator=g)}
        x = torch.randn(n, 3, d, generator=g)
        with TP.axis_context(TP.AxisGroup("data", rank=1, size=2,
                                          group=dist.group.WORLD)):
            torch.func.vmap(torch.func.grad(
                lambda p, x: (L.mlp(p, x, gated=True) ** 2).sum()))(p, x)
        assert len(refs) == 6 and alive == [0, 0, 0], (len(refs), alive)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("k,heads", [(1, None), (2, None), (-1, None),
                                     (1, (1, 1, 3))])
def test_matmul_gradients_match_the_gathered_product(tmp_path, k, heads):
    """``fsdp.matmul``'s own backward (the whole weight gathered again, a
    narrowed head range padded back, the gradient cut to the shard)
    against autograd through ``x @ M(fsdp.gather(w))``: under plain
    autograd, under ``vmap`` with the worker dim on ``x``, on ``w`` and on
    both (its ``vmap`` rule's stacked products, differentiated by plain
    autograd), and under ``vmap(grad)``.  A one-rank gloo group with the
    split switched on (rank 1 of 2: the other half of the whole zero)."""
    import torch.distributed as dist
    from repro_torch.comm import fsdp
    from repro_torch.comm import tensor_parallel as TP
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        g = torch.Generator().manual_seed(1)
        n = 3
        shape, dim = {1: ((4, 4, 5), 0), 2: ((4, 2, 6), 2),
                      -1: ((7, 6), 1)}[k]
        w = torch.randn((n,) + shape, generator=g)
        K = {1: 8, 2: 8, -1: 12}[k]
        x = torch.randn(n, 2, K, generator=g)
        mat = fsdp._Mat(k, heads)

        def ours(w, x):
            return fsdp.matmul(x, w, dim, k=k, heads=heads)

        def control(w, x):
            return x @ mat.of(fsdp.gather(w, dim))
        with TP.axis_context(TP.AxisGroup("data", rank=1, size=2,
                                          group=dist.group.WORLD)):
            for fn_dims in ((None, None), (0, 0), (0, None), (None, 0)):
                got = []
                for fn in (ours, control):
                    ww = (w if fn_dims[0] is not None else w[0]).clone()
                    xx = (x if fn_dims[1] is not None else x[0]).clone()
                    ww.requires_grad_(True)
                    xx.requires_grad_(True)
                    y = (fn(ww, xx) if fn_dims == (None, None) else
                         torch.func.vmap(fn, in_dims=fn_dims)(ww, xx))
                    (y ** 2).sum().backward()
                    got.append((y.detach(), ww.grad, xx.grad))
                for a, b in zip(*got):
                    torch.testing.assert_close(a, b)
            got = [torch.func.vmap(torch.func.grad(
                lambda w, x: (fn(w, x) ** 2).sum(), argnums=(0, 1)))(w, x)
                for fn in (ours, control)]
            for a, b in zip(*got):
                torch.testing.assert_close(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dim", [1, 2], ids=["w_up", "w_down"])
def test_expert_matmul_gradients_match_the_gathered_product(tmp_path, dim):
    """``fsdp.matmul(..., experts=True)`` on an expert stack ``[E, K, N]``
    (``ezcd,edf->ezcf``) split on its rows (``w_up``) or columns
    (``w_down``): forward and gradients against autograd through the
    einsum of ``fsdp.gather``'s whole stack, plainly and under ``vmap``
    with the worker dim on ``x``, on ``w`` and on both, and under
    ``vmap(grad)``.  A one-rank gloo group with the split switched on
    (rank 1 of 2)."""
    import torch.distributed as dist
    from repro_torch.comm import fsdp
    from repro_torch.comm import tensor_parallel as TP
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        g = torch.Generator().manual_seed(2)
        n, E, K, N = 3, 4, 6, 5
        shape = (E, K // 2, N) if dim == 1 else (E, K, N // 2)
        w = torch.randn((n,) + shape, generator=g)
        x = torch.randn(n, E, 2, 3, K, generator=g)

        def ours(w, x):
            return fsdp.matmul(x, w, dim, experts=True)

        def control(w, x):
            return torch.einsum("ezcd,edf->ezcf", x, fsdp.gather(w, dim))
        with TP.axis_context(TP.AxisGroup("data", rank=1, size=2,
                                          group=dist.group.WORLD)):
            for fn_dims in ((None, None), (0, 0), (0, None), (None, 0)):
                got = []
                for fn in (ours, control):
                    ww = (w if fn_dims[0] is not None else w[0]).clone()
                    xx = (x if fn_dims[1] is not None else x[0]).clone()
                    ww.requires_grad_(True)
                    xx.requires_grad_(True)
                    y = (fn(ww, xx) if fn_dims == (None, None) else
                         torch.func.vmap(fn, in_dims=fn_dims)(ww, xx))
                    (y ** 2).sum().backward()
                    got.append((y.detach(), ww.grad, xx.grad))
                for a, b in zip(*got):
                    torch.testing.assert_close(a, b)
            got = [torch.func.vmap(torch.func.grad(
                lambda w, x: (fn(w, x) ** 2).sum(), argnums=(0, 1)))(w, x)
                for fn in (ours, control)]
            for a, b in zip(*got):
                torch.testing.assert_close(a, b)
    finally:
        dist.destroy_process_group()
