"""The update rules and presence masks on split weights, shared by
``tests/torch_tp_cases.py`` and ``tests/torch_fsdp_cases.py``.

The port's side runs in their ranks (and in one process, the same cases
with no mesh); the reference's side (:func:`reference`, which imports JAX)
runs in the test process only.

A ``rule-<name>`` case, on a runner's arch (its whole stacked params
``X``):

* ``x``: ``STEPS`` isolated steps of the rule from its ``init`` on this
  rank's shards, with the directions of :func:`directions` and the cut of
  the reference's rounding uniforms (``U0``, ``U1`` of the inputs) handed
  in, the Moniqua-D² wire hashing the reference's seeds (``seed_rule0``,
  ``seed_rule1``): X and the rule's state gathered whole;
* ``b1``: one such step at 1 bit for Choco and DeepSqueeze (the biased
  sign: its ``mean|v|`` is summed in another order than one process's, so
  the state comes out a few ulp apart, and a second step would flip the
  sign of any element that lies within those ulp of 0);
* ``own``: the same with the port's own draw from the seeds (the rules
  that round with uniforms);
* ``bytes`` / ``extra_mem``: ``bytes_per_step`` and
  ``extra_memory_bytes`` under the split;
* ``trainer``: ``STEPS`` steps of ``Trainer(mesh=, rules=)`` with the rule
  (its losses, bytes and gathered state); the state that mirrors the params
  held in their cut (checked in the ranks); for ``d2`` a checkpoint of the
  whole state restored under the split, bitwise the live one (in the
  ranks).

``round-masked``: the Moniqua 8-bit and the ``full`` round under the
presence mask ``PRESENCE`` on the shards, gathered; the absent worker's
rows untouched (in the ranks).
"""
from __future__ import annotations

import os

import numpy as np
import torch

RULES = ("allreduce", "naive", "choco", "deepsqueeze", "dcd", "ecd", "d2",
         "moniqua_d2")
D2_RULES = ("d2", "moniqua_d2")
SIGN_RULES = ("choco", "deepsqueeze")           # the biased 1-bit sign
DRAW_RULES = ("naive", "choco", "deepsqueeze", "dcd", "ecd")
GAMMA, SLACK, ALPHA, STEPS = 0.3, 0.75, 0.05, 2
PRESENCE = (1, 0, 1, 1)
MASKED_WIRES = ("moniqua8", "full")
# a worker split adds AllReduce's partial sums in the collective's order
SUM_RTOL = 1e-6
# the biased 1-bit sign's mean|v|: a sum in another order than one
# process's (tests/test_torch_algorithms.py's bound), in ulp of each leaf's
# largest value
SIGN_ULPS = 16


def rule_names():
    return [f"rule-{r}" for r in RULES] + ["round-masked"]


def variants(rule):
    """``(tag, bits, uniforms handed in, steps)`` of the isolated steps."""
    out = [("x", 8, True, STEPS)]
    if rule in DRAW_RULES:
        out.append(("own", 8, False, STEPS))
    if rule in SIGN_RULES:
        out.append(("b1", 1, False, 1))
    return out


def topology(rule, n):
    from repro_torch.core.topology import ring
    topo = ring(n)
    return topo.slack(SLACK) if rule in D2_RULES else topo


def hyper(rule, n, theta, bits=8):
    """The port's hyper-parameters of a rule case."""
    from repro_torch.core.algorithms import AlgoHyper
    from repro_torch.core.moniqua import MoniquaCodec
    from repro_torch.core.quantizers import QuantSpec
    return AlgoHyper(topo=topology(rule, n), codec=MoniquaCodec(QuantSpec(
        bits=bits, stochastic=bits > 1)), theta=theta, gamma=GAMMA)


def directions(shapes, k):
    """Step ``k``'s local directions, one float32 array a stacked leaf."""
    rng = np.random.default_rng(1000 + k)
    return [(0.1 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def port_inputs(out, arch, shapes, rng):
    """The rule cases' inputs without JAX (the NCCL runs): uniforms from
    ``rng`` and fixed hash seeds, laid out as :func:`reference_inputs`."""
    for k in range(STEPS):
        out[f"seed_rule{k}"] = np.array(0x5EED10 + k)
        for i, s in enumerate(shapes):
            out[f"{arch}/U{k}/{i}"] = rng.random(s, dtype=np.float32)


def reference_inputs(out, arch, jX):
    """The reference's rounding uniforms of each step's key (a tree shaped
    like ``jX``) and the hash seeds it derives from the keys; returns the
    keys."""
    import jax
    from repro.kernels import ops as jops
    keys = list(jax.random.split(jax.random.PRNGKey(11), STEPS))
    for k, key in enumerate(keys):
        out[f"seed_rule{k}"] = np.array(int(jops._key_to_seed(key)))
        for i, u in enumerate(_ref_uniforms(key, jX)):
            out[f"{arch}/U{k}/{i}"] = u
    return keys


def _ref_uniforms(key, X):
    """The reference's draws for a tree shaped like ``X``: one
    ``jax.random.uniform`` a leaf on ``jax.random.split(key, leaves)``
    (``tests/test_torch_algorithms.py``)."""
    import jax
    leaves = jax.tree.leaves(X)
    keys = jax.random.split(key, len(leaves))
    return [np.asarray(jax.random.uniform(k, l.shape))
            for k, l in zip(keys, leaves)]


# -- the port's side, in a runner ---------------------------------------------
# A runner gives: ``model(arch)``, ``whole(model, arch, key)`` (a stacked
# inputs tree, every worker), ``cut(model, tree)`` (this rank's rows and
# shards of it), ``context(model)``, ``gather(tree)``, ``rows()``,
# ``trainer_of(ckpt, **tc)``, ``arrays``, ``put``, ``workdir``, ``world``,
# ``mesh`` and ``inp``.

def _stacked_shapes(model, n):
    from repro_torch import tree
    from repro_torch.train.train_step import abstract_params
    return [(n,) + tuple(a.shape)
            for a in tree.leaves(abstract_params(model))]


def _gather_extra(r, algo, extra):
    """The rule's state whole: its mirrors of the params gathered."""
    return {k: r.gather(v) if k in algo.mirrors else v
            for k, v in extra.items()}


def _mirrors_in_cut(algo, X, extra) -> bool:
    """Whether every state leaf that mirrors a params leaf has that leaf's
    (cut) shape and structure."""
    from repro_torch import tree
    td = tree.flatten(X)[1]
    return all(tree.flatten(extra[k])[1] == td and all(
        a.shape == b.shape for a, b in zip(tree.leaves(extra[k]),
                                           tree.leaves(X)))
        for k in algo.mirrors)


def rule_case(r, rule, arch, n, theta):
    from repro_torch import tree
    from repro_torch.core.algorithms import get_algorithm
    algo = get_algorithm(rule)
    model = r.model(arch)
    td = tree.flatten(r.whole(model, arch, "X"))[1]
    X = r.cut(model, r.whole(model, arch, "X"))
    G = [r.cut(model, tree.unflatten(td, [torch.from_numpy(d) for d in
                                          directions(_stacked_shapes(
                                              model, n), k)]))
         for k in range(STEPS)]
    U = [r.cut(model, r.whole(model, arch, f"U{k}")) for k in range(STEPS)]
    seeds = [int(r.inp[f"seed_rule{k}"]) for k in range(STEPS)]
    case = f"rule-{rule}"
    in_cut = True
    with r.context(model):
        for tag, bits, handed, steps in variants(rule):
            hp = hyper(rule, n, theta, bits)
            Xk, ek = X, algo.init(X, hp)
            for k in range(steps):
                Xk, ek = algo.step(Xk, ek, G[k], ALPHA, k, seeds[k], hp,
                                   uniforms=U[k] if handed else None)
            in_cut = in_cut and _mirrors_in_cut(algo, Xk, ek)
            r.put(f"{case}/{tag}/x", r.gather(Xk))
            r.put(f"{case}/{tag}/extra", _gather_extra(r, algo, ek))
        hp = hyper(rule, n, theta)
        r.arrays[f"{case}/bytes"] = np.asarray(algo.bytes_per_step(X, hp))
        r.arrays[f"{case}/extra_mem"] = np.asarray(
            algo.extra_memory_bytes(X, hp))
    ok, notes = trainer_part(r, rule, case)
    return ok and in_cut, f"state in the params' cut {in_cut}; {notes}"


def trainer_part(r, rule, case):
    from repro_torch import tree
    ckpt = None
    if rule == "d2":
        ckpt = os.path.join(r.workdir, f"{r.world}-{rule}-"
                            f"{'split' if r.mesh is not None else 'one'}")
    tr = r.trainer_of(ckpt, algo=rule, gamma=GAMMA,
                      slack=SLACK if rule in D2_RULES else 1.0)
    out = tr.run()
    state = out["state"]
    in_cut = _mirrors_in_cut(tr.algo, state["params"], state["extra"])
    whole = tr.gather_state(state)
    r.arrays[f"{case}/trainer/losses"] = np.array(
        [h["loss"] for h in out["history"]])
    r.arrays[f"{case}/trainer/bytes"] = np.asarray(out["bytes_per_step"])
    r.put(f"{case}/trainer/extra", whole["extra"])
    notes = f"trainer's state in the params' cut {in_cut}"
    if ckpt is None:
        return in_cut, notes
    back = tr.restore_state()
    same = all(torch.equal(a, b) for a, b in zip(
        tree.leaves({k: back[k] for k in ("params", "mom", "extra",
                                          "g_inf")}),
        tree.leaves({k: state[k] for k in ("params", "mom", "extra",
                                           "g_inf")})))
    same = same and back["step"] == state["step"] and torch.equal(
        back["gen"].get_state(), state["gen"].get_state())
    return in_cut and same, notes + f"; the restored state bitwise {same}"


def masked_round_case(r, arch, n, theta):
    """The masked rounds on this rank's shards; the absent worker's rows
    come back untouched."""
    from repro_torch import tree
    from repro_torch.core.algorithms import AlgoHyper
    from repro_torch.core.moniqua import MoniquaCodec
    from repro_torch.core.quantizers import QuantSpec
    from repro_torch.core.topology import ring
    model = r.model(arch)
    X = r.cut(model, r.whole(model, arch, "X"))
    hp = AlgoHyper(topo=ring(n), codec=MoniquaCodec(QuantSpec(8, True)),
                   theta=theta)
    lo, hi = r.rows()
    absent = [w - lo for w in range(lo, hi) if not PRESENCE[w]]
    untouched = True
    with r.context(model):
        for wire in MASKED_WIRES:
            if wire == "full":
                out = hp.exact_engine().mix(X, presence=PRESENCE).x
            else:
                out = hp.engine().mix(X, theta=theta, seed=int(
                    r.inp["seed_round"]), presence=PRESENCE).x
            untouched = untouched and all(
                torch.equal(a[w], b[w]) for a, b in zip(tree.leaves(out),
                                                        tree.leaves(X))
                for w in absent)
            r.put(f"round-masked/{wire}", r.gather(out))
    return untouched, f"absent rows {absent} untouched {untouched}"


# -- the reference's side, in the test process --------------------------------

def reference(jm, jX, keys, n, theta):
    """The reference's rule steps (eager, as ``tests/test_torch_algorithms
    .py`` runs them) and masked rounds on the stacked ``jX``: ``{key:
    list of arrays}`` under the cases' array names (``rule-R/x``,
    ``rule-R/extra``, ``rule-R/b1/...``, ``rule-R/bytes``, ``round-masked/
    WIRE``)."""
    import jax
    import jax.numpy as jnp
    from repro.core import algorithms as jalg
    from repro.core.moniqua import MoniquaCodec as JCodec
    from repro.core.quantizers import QuantSpec as JSpec
    from repro.core.topology import ring as jring
    shapes = [tuple(a.shape) for a in jax.tree.leaves(jX)]
    td = jax.tree.structure(jX)
    G = [jax.tree.unflatten(td, [jnp.asarray(d) for d in
                                 directions(shapes, k)])
         for k in range(STEPS)]
    ref = {}
    for rule in RULES:
        ja = jalg.get_algorithm(rule)
        for tag, bits, handed, steps in variants(rule):
            if not handed and bits != 1:
                continue             # the port's own draw: not the reference's
            topo = jring(n)
            if rule in D2_RULES:
                topo = topo.slack(SLACK)
            # the reference's bucketed Moniqua round is its per-leaf round
            # bit for bit; its full wire takes its default
            hp = jalg.AlgoHyper(topo=topo, codec=JCodec(JSpec(
                bits=bits, stochastic=bits > 1)), theta=theta, gamma=GAMMA,
                backend="jnp",
                path="bucketed" if rule == "moniqua_d2" else "auto")
            Xk, ek = jX, ja.init(jX, hp)
            for k in range(steps):
                Xk, ek = ja.step(Xk, ek, G[k], ALPHA, k, keys[k], hp)
            ref[f"rule-{rule}/{tag}/x"] = [np.asarray(a) for a in
                                           jax.tree.leaves(Xk)]
            ref[f"rule-{rule}/{tag}/extra"] = [np.asarray(a) for a in
                                               jax.tree.leaves(ek)]
            if tag == "x":
                ref[f"rule-{rule}/bytes"] = int(ja.bytes_per_step(jX, hp))
                ref[f"rule-{rule}/extra_mem"] = int(
                    ja.extra_memory_bytes(jX, hp))
    for wire in MASKED_WIRES:
        # its masked full round takes its default path: its bucketed one
        # adds the gated diffs in another order (an ulp apart)
        hp = jalg.AlgoHyper(topo=jring(n), codec=JCodec(JSpec(8, True)),
                            theta=theta, backend="jnp",
                            path="auto" if wire == "full" else "bucketed")
        res = (hp.exact_engine().mix(jX, presence=PRESENCE) if wire == "full"
               else hp.engine().mix(jX, theta=theta, key=jax.random.PRNGKey(
                   5), presence=PRESENCE))
        ref[f"round-masked/{wire}"] = [np.asarray(a) for a in
                                       jax.tree.leaves(res.x)]
    return ref


# -- checks in the test process -----------------------------------------------

def leaves(arrays, prefix):
    keys = sorted((k for k in arrays if k.startswith(prefix + "/")
                   and k[len(prefix) + 1:].isdigit()),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [arrays[k] for k in keys]


def assert_equal(got, want):
    assert len(got) == len(want)
    for c, a in zip(got, want):
        assert c.shape == np.shape(a)
        np.testing.assert_array_equal(c, a)


def assert_ulps(got, want, ulps):
    assert len(got) == len(want)
    for c, a in zip(got, want):
        a = np.asarray(a)
        tol = ulps * np.finfo(np.float32).eps * max(1.0, np.abs(a).max())
        np.testing.assert_allclose(c, a, rtol=0, atol=tol)


def assert_sum_close(got, want):
    assert len(got) == len(want)
    for c, a in zip(got, want):
        np.testing.assert_allclose(c, a, rtol=SUM_RTOL,
                                   atol=SUM_RTOL * float(np.abs(a).max()))


def check_against_reference(arrays, ref, rule):
    """The split's isolated steps against the reference's: bitwise;
    AllReduce's mean within ``SUM_RTOL`` (the reference takes
    ``jnp.mean``, the port a sum over n, also in one process); the biased
    1-bit sign within ``SIGN_ULPS``; the bytes equal."""
    for tag, bits, handed, _ in variants(rule):
        if not handed and bits != 1:
            continue
        for part in ("x", "extra"):
            got = leaves(arrays, f"rule-{rule}/{tag}/{part}")
            want = ref[f"rule-{rule}/{tag}/{part}"]
            if rule == "allreduce":
                assert_sum_close(got, want)
            elif bits == 1:
                assert_ulps(got, want, SIGN_ULPS)
            else:
                assert_equal(got, want)
    assert int(arrays[f"rule-{rule}/bytes"]) == ref[f"rule-{rule}/bytes"]
    assert int(arrays[f"rule-{rule}/extra_mem"]) == \
        ref[f"rule-{rule}/extra_mem"]


def check_against_one_process(arrays, one, rule, worker_split):
    """The split's isolated steps against the port's one process: bitwise
    with the reference's uniforms and with the port's own draw, the 1-bit
    sign within ``SIGN_ULPS`` (its sum over the split axes); AllReduce
    within ``SUM_RTOL`` where the worker dim is split; the bytes and the
    extra memory equal."""
    for tag, bits, _, _ in variants(rule):
        for part in ("x", "extra"):
            got = leaves(arrays, f"rule-{rule}/{tag}/{part}")
            want = leaves(one, f"rule-{rule}/{tag}/{part}")
            if rule == "allreduce" and worker_split:
                assert_sum_close(got, want)
            elif bits == 1:
                assert_ulps(got, want, SIGN_ULPS)
            else:
                assert_equal(got, want)
    for k in ("bytes", "extra_mem", "trainer/bytes"):
        assert int(arrays[f"rule-{rule}/{k}"]) == int(one[f"rule-{rule}/{k}"])


def check_trainer(arrays, one, rule, cell):
    """Two trainer steps against one process's: the losses within 1e-4;
    each state leaf within 1e-4 of its largest entry, or a code cell
    beyond it (``cell``: one 8-bit level of the leaf, or Lemma 2's bound of
    a Moniqua round) where a code rounded the other way (counted, under
    1e-3 of the elements)."""
    case = f"rule-{rule}/trainer"
    np.testing.assert_allclose(arrays[f"{case}/losses"],
                               one[f"{case}/losses"], rtol=1e-4)
    got, want = leaves(arrays, f"{case}/extra"), leaves(one,
                                                        f"{case}/extra")
    assert len(got) == len(want)
    flips = total = 0
    for c, a in zip(got, want):
        assert c.shape == a.shape
        scale = float(np.abs(a).max()) if a.size else 0.0
        tol = 1e-4 * scale
        err = np.abs(c.astype(np.float64) - a)
        step = max(2 * scale / 255, cell) * 1.01
        assert float(err.max(initial=0.0)) <= tol + step
        flips += int((err > tol).sum())
        total += err.size
    assert flips <= 1e-3 * max(total, 1), (flips, total)


def compare_rule(got: dict, want: dict, case: str, tol: float,
                 worker_split: bool):
    """``(ok, detail)`` of a rule case's arrays on the cards against one
    process's (the NCCL runs): the isolated steps as
    :func:`check_against_one_process` holds them, the trainer's losses
    within ``tol``, its bytes equal (its state is held on the CPU)."""
    rule = case[len("rule-"):]
    try:
        for tag, bits, _, _ in variants(rule):
            for part in ("x", "extra"):
                a = leaves(got, f"{case}/{tag}/{part}")
                b = leaves(want, f"{case}/{tag}/{part}")
                if rule == "allreduce" and worker_split:
                    assert_sum_close(a, b)
                elif bits == 1:
                    assert_ulps(a, b, SIGN_ULPS)
                else:
                    assert_equal(a, b)
        for k in ("bytes", "extra_mem", "trainer/bytes"):
            assert int(got[f"{case}/{k}"]) == int(want[f"{case}/{k}"]), k
        np.testing.assert_allclose(got[f"{case}/trainer/losses"],
                                   want[f"{case}/trainer/losses"], rtol=tol)
    except (AssertionError, KeyError) as e:
        return False, f"{type(e).__name__}: {str(e)[:400]}"
    return True, "isolated steps held, trainer losses and bytes held"
