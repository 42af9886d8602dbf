"""The port's training CLI (``repro_torch.launch.train``) on the CPU.

Its ``bytes/step/worker`` equals the reference's, computed shape-only: the
reference's ``get_algorithm(algo).bytes_per_step`` on its ``jax.eval_shape``
of the stacked parameters, with its trainer's hyper-parameters
(``repro.train.trainer.build_hyper``).  ``repro.launch.*`` is not imported
(its dry run sets ``XLA_FLAGS`` when imported).
"""
import re

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.algorithms import get_algorithm as jget_algorithm
from repro.models.model_factory import build_model as jbuild
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro.train.trainer import build_hyper as jbuild_hyper
from repro_torch.launch import train as LT

torch.set_num_threads(1)

ARGS = ["--device", "cpu", "--steps", "2", "--workers", "2", "--batch", "2",
        "--seq", "32"]


def _reference_bytes(arch, algo, workers, bits):
    model = jbuild(jget_config(arch).reduced())
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    X = jax.tree.map(lambda a: jax.ShapeDtypeStruct((workers,) + a.shape,
                                                    a.dtype), params)
    hp = jbuild_hyper(JTrainerConfig(algo=algo, topology="ring",
                                     n_workers=workers, bits=bits))
    return jget_algorithm(algo).bytes_per_step(X, hp)


@pytest.mark.parametrize("arch,algo,bits", [("llama3.2-3b", "moniqua", 8),
                                            ("llama3.2-3b", "dpsgd", 8),
                                            ("whisper-base", "moniqua", 2)])
def test_bytes_per_step_per_worker_equal_the_reference(capsys, arch, algo,
                                                       bits):
    assert LT.main(["--arch", arch, "--algo", algo, "--bits", str(bits)]
                   + ARGS) == 0
    out = capsys.readouterr().out
    steps = re.findall(r"^step\s+(\d+)\s+loss (\S+)", out, re.M)
    assert [int(k) for k, _ in steps] == [0, 1]
    assert all(float(v) == float(v) and abs(float(v)) < 1e3
               for _, v in steps)
    got = int(re.search(r"^bytes/step/worker = (\d+)$", out, re.M).group(1))
    assert got == _reference_bytes(arch, algo, 2, bits) > 0


def _cli_ranks(world, flags, timeout=240):
    """The CLI's ranks on ``world``'s small gloo mesh in place of the
    production mesh (``tests/torch_fsdp_cases.py --cli``): every rank's
    exit code, and rank 0's output and errors."""
    import os
    import subprocess
    import sys
    import tempfile
    import torch_fsdp_cases as C
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(repo, "tests",
                                          "torch_fsdp_cases.py"),
             "--cli", store, str(r), world] + flags, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(C.WORLDS[world][0])]
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return [p.returncode for p in procs], outs[0][0], outs[0][1]


@pytest.mark.parametrize("flags", [["--mesh", "production"],
                                   ["--mesh", "production", "--multi-pod"],
                                   ["--mesh", "production", "--arch",
                                    "dbrx-132b"],
                                   ["--mesh", "production", "--multi-pod",
                                    "--algo", "d2"]])
def test_production_mesh_waits_for_13d(flags):
    """``--mesh production [--multi-pod]``: the reference's mesh, rules
    and shape (the mesh swapped for a 4-rank gloo mesh, ``(data=2,
    model=2)`` or ``(pod=2, data=2)``, the shape for a small one) train
    reduced qwen2-72b, and reduced dbrx-132b (the MoE family: its experts
    split on ``d_model`` over ``data`` and on each expert's ``d_ff`` over
    ``model``), under the hierarchical rules for 2 steps, with the
    reference's bytes/step/worker; ``--algo d2``, the other update rules
    on the shards, the same."""
    world = "p2d2" if "--multi-pod" in flags else "d2m2"
    arch = "dbrx-132b" if "dbrx-132b" in flags else "qwen2-72b"
    algo = flags[flags.index("--algo") + 1] if "--algo" in flags \
        else "moniqua"
    argv = flags + ARGS
    if arch not in flags:
        argv += ["--arch", arch]
    rcs, out, err = _cli_ranks(world, argv)
    assert rcs == [0] * len(rcs), err[-3000:]
    steps = re.findall(r"^step\s+(\d+)\s+loss (\S+)", out, re.M)
    assert [int(k) for k, _ in steps] == [0, 1]
    assert all(float(v) == float(v) and abs(float(v)) < 1e3
               for _, v in steps)
    got = int(re.search(r"^bytes/step/worker = (\d+)$", out, re.M).group(1))
    assert got == _reference_bytes(arch, algo, 2, 8) > 0


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the CPU-only machine")
    with pytest.raises(RuntimeError, match="cuda"):
        LT.main(["--steps", "1"])
