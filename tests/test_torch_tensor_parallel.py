"""Tensor-parallel weights over the mesh's ``model`` axis, against JAX.

Two gloo groups on the CPU run ``tests/torch_tp_cases.py`` side by side:
world 2 on the mesh ``(data=1, model=2)`` and world 4 on ``(data=2,
model=2)``, one thread a rank, the port only.  This process draws the
inputs from the JAX reference's init of the reduced llama3.2-3b,
chatglm3-6b (``qkv_bias``, RoPE on half the head dim, GQA 4:2) and
dbrx-132b (E 4, top-2, group 64: the experts split on each expert's
``d_ff``, the router whole on every rank), and of two head counts that
``model`` = 2 does not split cleanly (``C.SPLIT_ARCHS``: llama3.2-3b with
3 heads, context-parallel attention; chatglm3-6b with 6 heads over 3 KV
heads, whose groups a rank cannot read whole), stacked
over 4 workers that differ by seeded noise, hands them over as numpy
arrays, runs the reference while the ranks run, and holds the gathered
results against it:

* the Megatron operators under ``vmap(grad)`` against one process's
  autograd (checked in the ranks: 1e-5 of each gradient's largest entry);
* per-worker loss and gradients under ``vmap(grad)``: losses within
  ``rtol=1e-5``, each gradient leaf within 1e-4 of its largest entry
  (``tests/test_torch_lm_train.py``'s float32 bounds);
* the Moniqua round (8-bit stochastic, 1-bit nearest) and the ``full``
  round on the shards of the reference's pre-round params and seed:
  bitwise the reference's round, gathered; the replicated leaves bitwise
  equal over ``model`` (checked in the ranks);
* one ``train_step`` with the reference's per-step seed: the parameters
  within ``1e-6 + lr 1e-4 max|d|`` of each leaf, the loss within
  ``rtol=1e-5``, ``bytes_per_step`` equal to the reference's;
* two ``Trainer`` steps with a gathered checkpoint: its restore is the live
  state bitwise, step and seed generator included (in the ranks); the
  logged losses within ``rtol=1e-5`` of the port's one-process trainer and
  the checkpoint's params within two steps' float32 bound of it, elements
  up to Lemma 2's ``2 (1 - w_ii) delta B`` beyond it counted (a code can
  round the other way once step 1's gradients differ in the last bits);
* float32 prefill and 4 cached decode steps within 1e-4 x max|logit|
  (``tests/test_torch_llama.py``'s bound), the cache a rank holds the
  cut its specs name (checked in the ranks); for the head counts of
  ``C.SPLIT_ARCHS`` also 12 steps on a ring of 8 slots, past each rank's
  4 and past the ring's end, at the same bound;
* the head counts of ``C.SPLIT_ARCHS``: gradients, serving and a train
  step at the same bounds, the replicated gradients bitwise equal over
  ``model`` (checked in the ranks);
* 12 decode steps on a ring of 9 slots, which ``model`` = 2 does not
  divide (``C.RING_WHOLE``: its spec replicates the cache, every KV head
  over the whole ring on every rank), at the same bound;
* the eight other update rules (``torch_rule_cases.RULES``) on the
  shards of reduced llama3.2-3b: two isolated steps with the reference's
  uniforms handed in, bitwise the reference's steps (the biased 1-bit
  sign within ``SIGN_ULPS``, AllReduce's mean within ``SUM_RTOL``); with
  the port's own draw, bitwise the port's one process; two ``Trainer``
  steps against one process's (losses within 1e-4, the state within
  1e-4 or a code cell, flips counted); the bytes and extra memory equal;
  a D² checkpoint restored bitwise (in the ranks);
* the Moniqua 8-bit and ``full`` rounds under a presence mask on the
  shards: bitwise the reference's masked rounds and the port's one
  process's, the absent worker's rows untouched (in the ranks);
* every out-of-scope case refused at construction, naming #13e.
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

import torch_rule_cases as R
import torch_tp_cases as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "torch_tp_cases.py")
WORLDS = (2, 4)
ROUND_KEY = jax.random.PRNGKey(5)


def _jcfg(name):
    arch, over = C.arch_of(name)
    return dataclasses.replace(jget_config(arch).reduced(), dtype="float32",
                               flash_attention=False, **over)


def _inputs(path):
    """The reference's init, stacked over ``C.N`` workers with seeded
    noise, batches and serving tokens (``C.port_inputs``'s layout).
    Returns the jax trees."""
    rng = np.random.default_rng(0)
    key_step = jax.random.PRNGKey(0)
    out = {"seed_round": np.array(int(jops._key_to_seed(ROUND_KEY))),
           "seed_step": np.array(int(jops._key_to_seed(
               jax.random.split(key_step)[1])))}
    trees = {}
    for a in C.ALL_ARCHS:
        jm = jbuild(_jcfg(a))
        p = jm.init(jax.random.PRNGKey(0))
        X = jax.tree.map(lambda t: (np.asarray(t, np.float32)[None] + 0.02
                                    * rng.standard_normal((C.N,) + t.shape)
                                    ).astype(np.float32), p)
        for i, leaf in enumerate(jax.tree.leaves(X)):
            out[f"{a}/X/{i}"] = leaf
        if a == C.ARCHS[0]:
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
    out = os.path.join(tmp, f"out{world}")
    store = os.path.join(tmp, f"store{world}")
    return out, [subprocess.Popen(
        [sys.executable, SCRIPT, store, str(r), str(world), inputs, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _collect(out, procs, timeout=240):
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
            ref[f"ring{C.RING_WHOLE}-{a}"] = _decode_ref(
                jm, P, toks, C.RING_WHOLE, C.RING_STEPS)
    jm, jX = trees[C.ARCHS[0]]
    ref.update(R.reference(jm, jX, list(jnp.asarray(inp["rule_keys"])),
                           C.N, C.THETA))
    for wire, spec in list(C.ROUNDS.items()) + [("moniqua8-" + C.MOE_ARCH,
                                                  (8, True))]:
        if wire.endswith(C.MOE_ARCH):
            jX = trees[C.MOE_ARCH][1]
        # the reference's bucketed Moniqua round is its per-leaf round bit
        # for bit (its bucket invariants); one flat buffer costs a few
        # eager compiles instead of every leaf shape's
        hp = jalg.AlgoHyper(topo=jring(C.N), codec=JCodec(JSpec(
            *(spec or (8, True)))), theta=C.THETA, backend="jnp",
            path="auto" if wire == "full" else "bucketed")
        res = (hp.exact_engine().mix(jX) if wire == "full"
               else hp.engine().mix(jX, theta=C.THETA, key=ROUND_KEY))
        ref[f"round-{wire}"] = [np.asarray(x) for x in jax.tree.leaves(res.x)]
    hp = jalg.AlgoHyper(topo=jring(C.N), codec=JCodec(JSpec(8, True)),
                        theta=C.THETA, backend="jnp")
    for a, case in [(C.ARCHS[0], "step")] + [
            (a, f"step-{a}") for a in (C.MOE_ARCH,) + tuple(C.SPLIT_ARCHS)]:
        jm, jX = trees[a]
        step = jax.jit(jts.make_train_step(jm, hp, jts.TrainStepConfig(
            algo="moniqua", sgd=jsgd.SGDConfig(momentum=0.9,
                                               weight_decay=5e-4),
            lr=C.LR, theta=JTheta(value=C.THETA))))
        js = {"params": jX, "mom": jsgd.init_momentum(jX), "extra": {},
              "step": jnp.zeros((), jnp.int32),
              "g_inf": jnp.ones((), jnp.float32), "key": key_step}
        js, met = step(js, {k: jnp.asarray(inp[f"{a}/{k}"])
                            for k in ("tokens", "labels")})
        ref[case] = ([np.asarray(x) for x in jax.tree.leaves(js["params"])],
                     [np.asarray(d) for d in jax.tree.leaves(js["mom"])],
                     float(met["loss"]), int(met["wire_bytes"]))
    return ref


def _one_process_trainer(workdir):
    """The port's trainer of the ``trainer`` case in this process."""
    runner = C.Runner.__new__(C.Runner)
    runner.mesh, runner.rules, runner.device = None, None, "cpu"
    tr = C.Runner.trainer_of(runner, os.path.join(workdir, "one"))
    out = tr.run()
    return out, dict(np.load(os.path.join(workdir, "one.state.npz")))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    inputs = os.path.join(tmp, "inputs.npz")
    inp, trees, key_step = _inputs(inputs)
    runs = {w: _launch(tmp, w, inputs) for w in WORLDS}
    ref = _reference(inp, trees, key_step)
    one = _one_process_trainer(tmp)
    # the port's one process on the rule and masked cases
    rules = C.Runner(0, WORLDS[0], inputs, tmp, "cpu", split=False)
    rules.run(R.rule_names())
    ref["one"] = rules.arrays
    ref["one_checks"] = rules.checks
    return ref, one, {w: _collect(*runs[w]) for w in WORLDS}


def _leaves(arrays, case):
    keys = sorted((k for k in arrays if k.startswith(case + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [arrays[k] for k in keys]


@pytest.mark.parametrize("world", WORLDS)
def test_every_case_ran_in_the_ranks(results, world):
    _, _, res = results
    arrays, checks = res[world]
    assert sorted(checks) == sorted(C.case_names())
    for case, (ok, detail, _) in checks.items():
        assert ok, (case, detail)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", C.ALL_ARCHS)
def test_per_worker_loss_and_grads_match_reference(results, world, arch):
    ref, _, res = results
    arrays, _ = res[world]
    loss, grads = ref[f"grads-{arch}"]
    np.testing.assert_allclose(arrays[f"grads-{arch}/loss"], loss,
                               rtol=1e-5)
    got = _leaves(arrays, f"grads-{arch}/grads")
    assert len(got) == len(grads)
    for c, a in zip(got, grads):
        assert c.shape == a.shape
        np.testing.assert_allclose(c, a, rtol=0,
                                   atol=1e-4 * float(np.abs(a).max()))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("wire", list(C.ROUNDS))
def test_sharded_round_is_the_reference_round(results, world, wire):
    ref, _, res = results
    arrays, _ = res[world]
    got = _leaves(arrays, f"round-{wire}/x")
    want = ref[f"round-{wire}"]
    assert len(got) == len(want)
    for c, a in zip(got, want):
        np.testing.assert_array_equal(c, a)


def _step_matches_reference(arrays, ref, case, flips=False):
    """One train step's params within ``1e-6 + lr 1e-4 max|d|`` of each
    leaf, loss ``rtol=1e-5``, bytes equal.  ``flips``: an element may also
    lie within Lemma 2's one-round bound beyond it, counted (under 1e-4 of
    the elements): a code the step's round rounds the other way where the
    split's pre-round params differ from the reference's in the last
    bits.  Returns the count."""
    from repro_torch.core import modulo
    from repro_torch.core.quantizers import delta_for_bits
    params, mom, loss, wire_bytes = ref[case]
    got = _leaves(arrays, f"{case}/x")
    assert len(got) == len(params)
    cell = 2 * (1 - 1 / 3) * delta_for_bits(8, True) * float(
        modulo.b_theta(C.THETA, delta_for_bits(8, True), "cpu"))
    n_flips = total = 0
    for c, a, d in zip(got, params, mom):
        tol = 1e-6 + C.LR * 1e-4 * np.abs(d).max()
        err = np.abs(c - a)
        assert float(err.max()) <= tol + (cell * 1.001 if flips else 0)
        n_flips += int((err > tol).sum())
        total += err.size
    assert n_flips <= 1e-4 * total, (n_flips, total)
    np.testing.assert_allclose(float(arrays[f"{case}/loss"]), loss,
                               rtol=1e-5)
    assert int(arrays[f"{case}/wire_bytes"]) == wire_bytes
    return n_flips


@pytest.mark.parametrize("world", WORLDS)
def test_train_step_matches_reference(results, world):
    ref, _, res = results
    _step_matches_reference(res[world][0], ref, "step")


@pytest.mark.parametrize("world", WORLDS)
def test_moe_round_on_the_expert_shards_is_the_reference_round(results,
                                                               world):
    """Reduced dbrx-132b's experts split on each expert's ``d_ff`` over
    ``model``: the Moniqua 8-bit round of every leaf bitwise the
    reference's."""
    ref, _, res = results
    arrays, _ = res[world]
    case = f"round-moniqua8-{C.MOE_ARCH}"
    got, want = _leaves(arrays, f"{case}/x"), ref[case]
    assert len(got) == len(want)
    for c, a in zip(got, want):
        np.testing.assert_array_equal(c, a)


@pytest.mark.parametrize("world", WORLDS)
def test_moe_train_step_matches_reference(results, world):
    """Reduced dbrx-132b's train step on the expert shards.  Its round
    rounds a few codes of ``w_down`` (3 of its 4,194,304 elements on these
    inputs) one cell the other way: ``w_down``'s gradient, summed over the
    ranks' experts in another order, moves the pre-round params by ~1e-8;
    those are counted as the trainer test counts them."""
    ref, _, res = results
    _step_matches_reference(res[world][0], ref, f"step-{C.MOE_ARCH}",
                            flips=True)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", list(C.SPLIT_ARCHS))
def test_split_heads_train_step_matches_reference(results, world, arch):
    """A train step of each head count that ``model`` = 2 does not split
    cleanly: context-parallel attention (3 heads) and KV groups a rank
    cannot read whole (6 heads over 3 KV heads).  As in the MoE step, a
    code may round one cell the other way where the split's gradients
    (the shares' attention summed in another order) move the pre-round
    params in the last bits: counted, under 1e-4 of the elements."""
    ref, _, res = results
    _step_matches_reference(res[world][0], ref, f"step-{arch}", flips=True)


@pytest.mark.parametrize("world", WORLDS)
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
    # Lemma 2's bound on what one round's codes can move a worker: its own
    # and its neighbours' codes one cell off, 2 (1 - w_ii) delta B; only
    # the second step's round can see params that differ
    cell = 2 * (1 - 1 / 3) * delta_for_bits(8, True) * float(
        modulo.b_theta(C.THETA, delta_for_bits(8, True), "cpu"))
    moms = {k.replace("params", "mom", 1): one_ck[k.replace("params", "mom",
                                                              1)]
            for k in keys}
    flips = total = 0
    for k in keys:
        c, a = arrays[f"trainer/ckpt/{k}"], one_ck[k]
        assert c.shape == a.shape
        tol = 2 * (1e-6 + C.LR * 1e-4 * np.abs(moms[k.replace(
            "params", "mom", 1)]).max())
        err = np.abs(c - a)
        assert (err <= tol + cell * 1.001).all(), float(err.max())
        flips += int((err > tol).sum())
        total += err.size
    assert flips <= 1e-4 * total, (flips, total)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", C.ALL_ARCHS)
def test_prefill_and_decode_match_reference(results, world, arch):
    ref, _, res = results
    arrays, _ = res[world]
    for got, want in zip((arrays[f"serve-{arch}/prefill"],
                          arrays[f"serve-{arch}/decode"]),
                         ref[f"serve-{arch}"]):
        assert got.shape == want.shape and got.dtype == np.float32
        assert (np.abs(got - want).max() / np.abs(want).max()) <= 1e-4


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", list(C.SPLIT_ARCHS))
def test_ring_decode_past_each_ranks_slots_matches_reference(results, world,
                                                             arch):
    """``C.RING_STEPS`` decode steps on a ring of ``C.RING`` slots, the
    cache on its sequence dim (``C.RING / 2`` slots a rank): the steps
    past rank 0's slots, on both ranks' and past the ring's end attend the
    whole ring, as the reference's; the logits within 1e-4 x max|logit|."""
    ref, _, res = results
    arrays, checks = res[world]
    ok, detail, _ = checks[f"ring-{arch}"]
    assert ok, detail
    got, want = arrays[f"ring-{arch}/decode"], ref[f"ring-{arch}"]
    assert got.shape == want.shape and got.dtype == np.float32
    assert (np.abs(got - want).max() / np.abs(want).max()) <= 1e-4


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", list(C.SPLIT_ARCHS))
def test_ring_the_model_axis_does_not_divide_matches_reference(
        results, world, arch):
    """``C.RING_STEPS`` decode steps on a ring of ``C.RING_WHOLE`` = 9
    slots, which ``model`` = 2 does not divide: the cache's spec replicates
    it, every KV head over the whole ring on every rank (the cache a rank
    holds is that cut, checked in the ranks); past the ring's end, the
    logits within 1e-4 x max|logit| of the reference's."""
    ref, _, res = results
    arrays, checks = res[world]
    case = f"ring{C.RING_WHOLE}-{arch}"
    ok, detail, _ = checks[case]
    assert ok, detail
    got, want = arrays[f"{case}/decode"], ref[case]
    assert got.shape == want.shape and got.dtype == np.float32
    assert (np.abs(got - want).max() / np.abs(want).max()) <= 1e-4


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("rule", R.RULES)
def test_rule_on_shards_is_the_reference_step(results, world, rule):
    """Two isolated steps on the shards with the reference's uniforms cut
    alike: bitwise the reference's, gathered (``R.check_against_reference``),
    the bytes and extra memory the reference's."""
    ref, _, res = results
    R.check_against_reference(res[world][0], ref, rule)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("rule", R.RULES)
def test_rule_on_shards_is_the_one_process_step(results, world, rule):
    """The same steps, and with the port's own draw from a seed: bitwise
    the port's one process (``R.check_against_one_process``)."""
    ref, _, res = results
    assert ref["one_checks"][f"rule-{rule}"][0], ref["one_checks"][
        f"rule-{rule}"]
    R.check_against_one_process(res[world][0], ref["one"], rule,
                                worker_split=C.MESHES[world][0] > 1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("rule", R.RULES)
def test_rule_trainer_matches_one_process(results, world, rule):
    """Two ``Trainer`` steps under the split against one process's
    (``R.check_against_one_process``'s bound on the state, Lemma 2's cell
    for Moniqua-D²); its state held in the params' cut and, for D², its
    checkpoint restored bitwise (both in the ranks)."""
    ref, _, res = results
    arrays, checks = res[world]
    ok, detail, _ = checks[f"rule-{rule}"]
    assert ok, detail
    R.check_trainer(arrays, ref["one"], rule, C.lemma2_cell())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("wire", R.MASKED_WIRES)
def test_masked_round_on_shards_is_the_reference_round(results, world, wire):
    """The Moniqua 8-bit and ``full`` rounds under ``R.PRESENCE`` on the
    shards: bitwise the reference's masked round and the port's one
    process's, gathered."""
    ref, _, res = results
    arrays, checks = res[world]
    ok, detail, _ = checks["round-masked"]
    assert ok, detail
    got = R.leaves(arrays, f"round-masked/{wire}")
    R.assert_equal(got, ref[f"round-masked/{wire}"])
    R.assert_equal(got, R.leaves(ref["one"], f"round-masked/{wire}"))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("what", C.REFUSALS)
def test_out_of_scope_is_refused_naming_13e(results, world, what):
    _, _, res = results
    ok, detail, _ = res[world][1][f"refuse-{what}"]
    assert ok, detail
    assert "#13e" in detail


def test_sharded_replicated_and_whole_shapes():
    """``split_view`` lays a shard split on one dim out so that it hashes
    its elements' whole-leaf counters; ``axis_dims`` reads the split dims
    of resolved specs."""
    from repro_torch.comm import tensor_parallel as TP
    from repro_torch.models.sharding import P
    x = torch.arange(2 * 4 * 6 * 8, dtype=torch.float32).reshape(2, 4, 6, 8)
    m = 2
    for d in (1, 2, 3):
        k = x.shape[d] // m
        for r in range(m):
            s = TP.shard(x, d, r, m)
            view, off, stride, _, _ = TP.split_view(
                s, ((d, r * k, x.shape[d]),))
            rows, cols = view.shape[1:]
            idx = (off + stride * torch.arange(rows)[:, None]
                   + torch.arange(cols))
            # the whole leaf's flat position of each shard element
            want = torch.arange(x[0].numel()).reshape(x.shape[1:])
            want = TP.shard(want[None], d, r, m)[0].reshape(rows, cols)
            assert torch.equal(idx, want)
    assert TP.axis_dims({"a": P(None, "model"), "b": P("data", None),
                         "c": P(None, None, ("model",))},
                        "model") == (1, None, 2)


def test_operators_backward_outside_the_context(tmp_path):
    """The autograd engine runs a CUDA backward in a thread of its own,
    which sees no context variable: the operators carry their process
    group from the forward, so a backward run in another thread
    all-reduces as one in the forward's.  A one-rank gloo group with the
    model split switched on (its all-reduce sums one rank: the identity)."""
    import threading
    import torch.distributed as dist
    from repro_torch.comm import tensor_parallel as TP
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(3, 4, generator=g, requires_grad=True)
        w = torch.randn(4, 5, generator=g)
        with TP.axis_context(TP.AxisGroup("model", rank=0, size=2,
                                          group=dist.group.WORLD)):
            y = TP.reduce_sum(TP.copy_to(x, "model") @ w, "model").sum()
        out = {}

        def backward():
            try:
                out["grad"] = torch.autograd.grad(y, x)[0]
            except Exception as e:              # reported by the assert
                out["error"] = e
        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert "error" not in out, out.get("error")
        assert torch.equal(out["grad"], (torch.ones(3, 5) @ w.T))
    finally:
        dist.destroy_process_group()
