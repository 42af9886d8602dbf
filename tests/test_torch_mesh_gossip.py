"""The worker dim split over processes (``repro_torch.comm.workers``).

Two process groups of gloo ranks on the CPU, R = 2 and R = 4, run
``tests/torch_mesh_cases.py`` side by side: every wire's ``CommEngine``
round (bucketed and per-leaf, K = 1 and 4, masked, stale, telemetry,
two-tier on ``make_two_tier_mesh``), DTensor placements and ``constrain``,
two ResNet Moniqua steps on ring(8) (the main path) and two reduced-llama
``Trainer`` steps with a gathered checkpoint, each all-gathered and held
against the single-process port: bitwise, except the ResNet step
(``RESNET_ATOL`` on the parameters; the case module says why), and the EF
residual norm of the telemetry and the AllReduce rule's mean
(``SUM_RTOL``: sums all-reduced in the collective's order).  The NCCL
version needs two cards and skips without them.
"""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import torch_mesh_cases as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "torch_mesh_cases.py")
WORLDS = (2, 4)


def _launch(tmp, world, extra=()):
    os.makedirs(tmp, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = os.path.join(tmp, "out.json")
    procs = [subprocess.Popen(
        [sys.executable, SCRIPT, os.path.join(tmp, "store"), str(r),
         str(world), out, *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return out, procs


def _collect(out, procs, timeout=240):
    """Each process's log, all of them done within ``timeout`` seconds
    (~25 s here): a rank that hangs fails the test, not the suite."""
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
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    runs = {w: _launch(str(tmp_path_factory.mktemp(f"gloo{w}")), w)
            for w in WORLDS}
    return {w: _collect(*runs[w]) for w in WORLDS}


@pytest.mark.parametrize("world,case", [(w, c) for w in WORLDS
                                        for c in C.case_names(w)])
def test_split_equals_one_process(results, world, case):
    ok, detail = results[world][case]
    assert ok, detail


def test_every_case_ran(results):
    for w in WORLDS:
        assert sorted(results[w]) == sorted(C.case_names(w))


@pytest.mark.gpu
def test_nccl_rounds_equal_the_cpu(tmp_path):
    world = C.nccl_worlds(torch.cuda.device_count())
    if not world:
        pytest.skip("the NCCL exchange needs two CUDA cards")
    res = _collect(*_launch(str(tmp_path), world, ("nccl",)))
    assert sorted(res) == sorted(C.nccl_case_names(world))
    for case, (ok, detail) in res.items():
        assert ok, (case, detail)
