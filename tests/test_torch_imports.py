"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor any module of the JAX package ``repro``."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro")
             or m.startswith(("jax.", "jaxlib.", "repro.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.kernels.moniqua_encode" in res["modules"]
    assert "repro_torch.train.trainer" in res["modules"]
    for name in ("configs", "configs.base", "configs.llama3_2_3b",
                 "configs.chatglm3_6b", "configs.internlm2_20b",
                 "configs.qwen2_72b", "configs.resnet20", "configs.dbrx_132b",
                 "configs.grok_1_314b", "configs.zamba2_1_2b",
                 "configs.xlstm_125m", "configs.whisper_base",
                 "configs.phi_3_vision_4_2b",
                 "models.moe", "models.mamba2", "models.zamba",
                 "models.xlstm", "models.whisper", "models.vlm",
                 "train.train_step",
                 "models.layers", "models.transformer",
                 "models.model_factory", "train.serve_step", "data.pipeline",
                 "kernels.flash_attention", "kernels.moniqua_decode",
                 "core.adpsgd", "core.algorithms", "core.theta",
                 "data.synthetic", "checkpoint", "checkpoint.ckpt",
                 "sim", "sim.network", "sim.cluster", "sim.faults",
                 "sim.contention", "sim.events", "sim.scenarios",
                 "sim.calibrate", "obs", "obs.metrics", "obs.runlog",
                 "obs.trace", "kernels.cost", "analysis",
                 "analysis.roofline", "launch", "launch.train",
                 "launch.dryrun", "launch.calibrate", "launch.mesh",
                 "models.sharding", "comm.workers", "comm.tensor_parallel"):
        assert f"repro_torch.{name}" in res["modules"], name
    assert len(res["modules"]) >= 50
    assert res["bad"] == [], f"repro_torch pulled in: {res['bad']}"


_MESH_PROBE = r"""
import json, sys
import torch.distributed as dist
import repro_torch.launch.mesh, repro_torch.models.sharding
import repro_torch.comm.workers, repro_torch.comm.tensor_parallel
print(json.dumps({"initialized": dist.is_initialized(),
                  "jax": any(m == "jax" or m.startswith("jax.")
                             for m in sys.modules)}))
"""


def test_importing_the_meshes_makes_no_process_group():
    """``launch/mesh.py`` builds meshes in functions: importing it (and the
    sharding rules) starts no process group and touches no device."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _MESH_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"initialized": False, "jax": False}


def test_assigned_archs_equal_the_reference():
    from repro.configs import assigned_archs as j_assigned
    from repro_torch.configs import assigned_archs
    assert assigned_archs() == j_assigned()
    assert "resnet20" not in assigned_archs() and len(assigned_archs()) == 10
