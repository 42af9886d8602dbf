"""One MoE layer split over ``model`` and ``data``, against JAX.

Three gloo groups of four processes run ``tests/torch_moe_split_cases.py``
side by side, one CPU thread a rank: ``models.moe.moe_layer`` (gated, E 4,
top-2, capacity factor 1.25, groups of 64, ``d_model`` 64, ``d_ff`` 128)
under ``ShardingRules("hierarchical")`` on ``(data=2, model=2)``,
``(data=1, model=4)`` and ``(data=4, model=1)``: the router and the
experts' ``d_model`` split over ``data``, each expert's ``d_ff`` over
``model``, each ``data`` rank holding its rows of ``x [4, 128, 64]``.  The
params come from the reference's ``init_moe``, ``x`` and the cotangent
``r`` from a numpy seed; the same go through the reference's
``moe_layer``.  Held:

* ``route`` bitwise: each rank's routing (gates, top-k, dispatch, combine)
  is the port's one-process routing of the same rows, and the same on
  every ``model`` rank (checked in the ranks); its top-k choices are the
  reference's ``lax.top_k`` on every token whose K-th and (K+1)-th gates
  lie more than ``GAP`` apart (``tests/test_torch_moe.py``'s premise, at
  least ``CLEAR`` of them);
* ``y`` and the aux within 1e-6 of the reference's (``y`` relative to its
  largest entry; the aux the same on every rank);
* the gradients of ``sum(y * r) + aux``: the router's bitwise the same on
  every ``model`` rank (in the ranks) and within 1e-4 of the reference's
  largest entry, the experts' too.
"""
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

import repro.models.moe as JM
from repro.configs.base import MoEConfig as JMoE

import torch_moe_split_cases as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "torch_moe_split_cases.py")
WORLDS = tuple(C.WORLDS)
GAP, CLEAR = 1e-4, 0.98


def _jcfg():
    return JMoE(num_experts=C.E, top_k=C.K, capacity_factor=C.CF,
                group_size=C.G)


def _inputs(path):
    p = JM.init_moe(jax.random.PRNGKey(0), C.D_MODEL, C.D_FF, _jcfg(), True,
                    jnp.float32)
    rng = np.random.default_rng(0)
    arrays = {k: np.asarray(v, np.float32) for k, v in p.items()}
    arrays["x"] = rng.standard_normal((C.B, C.S, C.D_MODEL)
                                      ).astype(np.float32)
    arrays["r"] = rng.standard_normal((C.B, C.S, C.D_MODEL)
                                      ).astype(np.float32)
    np.savez(path, **arrays)
    return arrays


def _reference(inp):
    p = {k: jnp.asarray(inp[k]) for k in C.SPLIT}
    x, r = jnp.asarray(inp["x"]), jnp.asarray(inp["r"])
    y, aux = JM.moe_layer(p, x, _jcfg(), True)

    def loss(q):
        y, aux = JM.moe_layer(q, x, _jcfg(), True)
        return jnp.sum(y * r) + aux
    grads = jax.grad(loss)(p)
    xg = x.reshape(-1, C.G, C.D_MODEL)
    gates = jax.nn.softmax(xg.astype(jnp.float32) @ p["router"], -1)
    return {"y": np.asarray(y), "aux": float(aux),
            "grads": {k: np.asarray(v) for k, v in grads.items()},
            "gates": np.asarray(gates),
            "topi": np.asarray(jax.lax.top_k(gates, C.K)[1])}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = str(tmp_path_factory.mktemp("moe_split"))
    inputs = os.path.join(tmp, "inputs.npz")
    inp = _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    runs = {}
    for w in WORLDS:
        out = os.path.join(tmp, f"out_{w}")
        runs[w] = (out, [subprocess.Popen(
            [sys.executable, SCRIPT, os.path.join(tmp, f"store_{w}"),
             str(r), w, inputs, out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(C.WORLDS[w][0])])
    ref = _reference(inp)
    got = {}
    deadline = time.monotonic() + 240
    for w, (out, procs) in runs.items():
        try:
            logs = [p.communicate(timeout=max(1.0, deadline -
                                              time.monotonic()))[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        with open(out + ".json") as f:
            checks = json.load(f)
        got[w] = (dict(np.load(out + ".npz")), checks)
    return inp, ref, got


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree_over_model(results, world):
    _, _, got = results
    checks = got[world][1]
    assert checks and all(checks.values()), checks


@pytest.mark.parametrize("world", WORLDS)
def test_route_is_bitwise_one_process(results, world):
    """The split's routing of every row is the port's one-process routing
    of the same input bitwise, and its choices the reference's on every
    token that clears the gap."""
    from repro_torch.models import moe as M
    inp, ref, got = results
    arrays = got[world][0]
    p = {k: torch.tensor(inp[k]) for k in C.SPLIT}
    xg = torch.tensor(inp["x"]).reshape(-1, C.G, C.D_MODEL)
    one = M.route(p, xg, C.moe_cfg())
    for name, t in zip(("topg", "topi", "dispatch", "combine"), one):
        assert np.array_equal(arrays[f"route/{name}"], t.numpy()), name
    s = np.sort(ref["gates"], axis=-1)[..., ::-1]
    clear = (s[..., C.K - 1] - s[..., C.K]) > GAP
    assert clear.mean() >= CLEAR, clear.mean()
    np.testing.assert_array_equal(arrays["route/topi"][clear],
                                  ref["topi"][clear])


@pytest.mark.parametrize("world", WORLDS)
def test_y_and_aux_match_reference(results, world):
    _, ref, got = results
    arrays = got[world][0]
    assert arrays["y"].shape == ref["y"].shape
    assert np.abs(arrays["y"] - ref["y"]).max() <= 1e-6 * np.abs(
        ref["y"]).max()
    assert abs(float(arrays["aux"]) - ref["aux"]) <= 1e-6 * abs(ref["aux"])


@pytest.mark.parametrize("world", WORLDS)
def test_gradients_match_reference(results, world):
    """The router's and every expert leaf's gradient within 1e-4 of the
    reference's largest entry."""
    _, ref, got = results
    arrays = got[world][0]
    for k, want in ref["grads"].items():
        g = arrays[f"grad/{k}"]
        assert g.shape == want.shape, k
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=k)
