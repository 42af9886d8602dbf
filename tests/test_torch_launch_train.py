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


@pytest.mark.parametrize("flags", [["--mesh", "production"],
                                   ["--multi-pod"],
                                   ["--mesh", "production", "--multi-pod",
                                    "--shape", "train_4k", "--full-size"]])
def test_production_mesh_waits_for_13d(capsys, flags):
    assert LT.main(flags + ARGS) != 0
    err = capsys.readouterr().err
    assert "#13d" in err


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the CPU-only machine")
    with pytest.raises(RuntimeError, match="cuda"):
        LT.main(["--steps", "1"])
