"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

``skip_reason`` and ``input_specs`` against the reference's (read from its
source: importing ``repro.launch.dryrun`` would set ``XLA_FLAGS``); a
``--reduced`` row for one config of each family at ``train_4k`` and
``decode_32k`` (xlstm's sLSTM loop runs one step a position through the
Python dispatch modes, so its training row is counted at 256 positions,
the same kind of shape); the argument bytes against a real CPU state; the
``meta`` counts against the same reduced step run for real on the CPU
under the same counters; the kernel wrappers' ``meta`` contract.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import InputShape as JShape
from repro.models.model_factory import build_model as jbuild
from repro_torch import tree
from repro_torch.configs import assigned_archs, get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.core.algorithms import get_algorithm
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moniqua_decode as kdec
from repro_torch.kernels import moniqua_decode_reduce as kdr
from repro_torch.kernels import moniqua_encode as kenc
from repro_torch.launch import dryrun as DR
from repro_torch.models.model_factory import build_model
from repro_torch.train import train_step as TS
from torch_launch_ref import ref_defs

torch.set_num_threads(1)

REF = ref_defs("dryrun", ("skip_reason", "input_specs"), jax=jax,
               ArchConfig=JArch, InputShape=JShape)

FAMILY_ARCHS = {"dense": "llama3.2-3b", "moe": "dbrx-132b",
                "ssm": "xlstm-125m", "hybrid": "zamba2-1.2b",
                "audio": "whisper-base", "vlm": "phi-3-vision-4.2b"}
# xlstm: 4096 positions of the sLSTM loop through the dispatch modes take
# ~50 s on one CPU thread; the same kind of shape at 256 positions
SHORT_TRAIN = InputShape("train_256", 256, 256, "train")

ROOFLINE_KEYS = {"flops_per_chip", "bytes_per_chip",
                 "collective_bytes_per_chip", "compute_s", "memory_s",
                 "collective_s", "dominant", "bound_s", "model_flops",
                 "useful_ratio", "mfu_upper_bound"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_estimate_gb"}


def test_skip_reason_matches_reference():
    for arch in assigned_archs():
        for name in INPUT_SHAPES:
            assert DR.skip_reason(get_config(arch), INPUT_SHAPES[name]) == \
                REF["skip_reason"](jget_config(arch), J_SHAPES[name])
    assert DR.skip_reason(get_config("whisper-base"),
                          INPUT_SHAPES["long_500k"]) is not None


@pytest.mark.parametrize("arch", assigned_archs())
def test_input_specs_match_reference(arch):
    tm = build_model(get_config(arch), device="meta")
    jm = jbuild(jget_config(arch))
    for name in INPUT_SHAPES:
        shape = INPUT_SHAPES[name]
        for n, stacked in ((1, False), (8, True)):
            if shape.global_batch % n:
                continue
            got = DR.input_specs(tm, shape, n, stacked)
            want = REF["input_specs"](jm, J_SHAPES[name], n, stacked)
            assert list(got) == list(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (name, k)
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype)


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_reduced_rows_are_ok(family):
    arch = FAMILY_ARCHS[family]
    for shape in (SHORT_TRAIN if family == "ssm" else "train_4k",
                  "decode_32k"):
        r = DR.dryrun_one(arch, shape, override=DR.REDUCED, verbose=False)
        assert r.status == "ok", r.error
        assert r.mesh == DR.MESH and set(r.memory) == MEMORY_KEYS
        assert set(r.roofline) == ROOFLINE_KEYS
        m = r.memory
        assert m["peak_estimate_gb"] * 1e9 == pytest.approx(
            m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
            - m["alias_bytes"])
        assert m["peak_estimate_gb"] * 1e9 >= m["argument_bytes"] > 0
        assert r.roofline["flops_per_chip"] > 0
        assert r.roofline["bytes_per_chip"] > 0
        assert r.roofline["dominant"] in ("compute", "memory", "collective")
        # a hierarchical config trains one worker (one pod): no gossip
        gossip = (r.shape != "decode_32k"
                  and DR.n_workers_for(get_config(arch)) > 1)
        assert (r.collectives["summary"] != "none") == gossip
        assert (r.roofline["collective_s"] > 0) == gossip
        assert set(r.row()) == {"arch", "shape", "mesh", "status", "seconds",
                                "error", "memory", "roofline", "collectives",
                                "sim"}


def test_skipped_row_and_error_row():
    r = DR.dryrun_one("whisper-base", "long_500k", verbose=False)
    assert r.status == "skipped" and "quadratic" in r.error
    r = DR.dryrun_one("llama3.2-3b", "train_4k", n_workers=3,
                      override=DR.REDUCED, verbose=False)
    assert r.status == "error" and "split" in r.error


def test_hierarchical_configs_take_one_worker():
    for arch in assigned_archs():
        cfg = get_config(arch)
        want = 1 if cfg.dist_mode == "hierarchical" else 8
        assert DR.n_workers_for(cfg) == want
        assert DR.n_workers_for(cfg, 4) == 4
    assert {a for a in assigned_archs()
            if get_config(a).dist_mode == "hierarchical"} == {
        "dbrx-132b", "grok-1-314b", "qwen2-72b"}


SHAPE = InputShape("cli", 64, 4, "train")
N = 2


def _cpu_step(cfg, algo="moniqua"):
    """The reduced step for real on the CPU under the dry run's counters,
    with the dry run's hyper-parameters."""
    model = build_model(cfg, device="cpu")
    hp = DR._hyper(cfg, N, algo, 8)
    step = TS.make_train_step(model, hp, DR._train_config(algo))
    state = TS.init_state(model, get_algorithm(algo), hp, N)
    batch = SyntheticLMPipeline(model, SHAPE, N, seed=0).worker_batch(0)
    with DR.StepCounters((state, batch)) as ctr:
        new_state, metrics = step(state, batch)
    assert math.isfinite(float(metrics["loss"]))
    return ctr.counts, state, batch


def _reduced(arch):
    return dataclasses.replace(get_config(arch), **DR.REDUCED)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-base"])
def test_meta_counts_equal_a_real_cpu_step(arch):
    """FLOPs (PyTorch's ops and each kernel's formula), bytes accessed,
    argument bytes and the peak: on ``meta`` as for the same step on the
    CPU, where every kernel takes its plain version and is counted once,
    by its formula."""
    cfg = _reduced(arch)
    got, _, _, _, _ = DR.count_step(build_model(cfg, device="meta"), SHAPE,
                                    N)
    want, _, _ = _cpu_step(cfg)
    assert got.flops == want.flops > 0
    assert got.torch_flops == want.torch_flops > 0
    assert got.kernel.flops == want.kernel.flops
    assert got.kernel.calls == want.kernel.calls
    assert got.kernel.calls["moniqua_encode"] >= 1
    # one launch a layer (whisper: its decoder's), bfloat16 as registered
    assert cfg.dtype == "bfloat16"
    assert got.kernel.calls["flash_attention_tc"] == cfg.num_layers
    assert got.bytes_accessed == want.bytes_accessed
    assert got.argument_bytes == want.argument_bytes
    assert got.peak_bytes == pytest.approx(want.peak_bytes, rel=1 / 64)


def test_argument_bytes_are_a_real_states():
    """``argument_bytes`` of a ``--reduced`` row: the summed bytes of a real
    CPU ``init_state`` of the same config, and of its batch."""
    cfg = _reduced("llama3.2-3b")
    row = DR.dryrun_one("llama3.2-3b", SHAPE, n_workers=N,
                        override=DR.REDUCED, verbose=False)
    model = build_model(cfg, device="cpu")
    hp = DR._hyper(cfg, N, "moniqua", 8)
    state = TS.init_state(model, get_algorithm("moniqua"), hp, N)
    batch = DR.input_specs(model, SHAPE, N, stacked=True, device="cpu")
    real = sum(t.numel() * t.element_size()
               for t in tree.leaves((state, batch))
               if isinstance(t, torch.Tensor))
    assert row.memory["argument_bytes"] == real
    ab = TS.abstract_state(model, get_algorithm("moniqua"), hp, N)
    leaves = [t for t in tree.leaves(ab) if isinstance(t, torch.Tensor)]
    assert all(t.device.type == "meta" for t in leaves)
    for a, b in zip(leaves, [t for t in tree.leaves(state)
                             if isinstance(t, torch.Tensor)]):
        assert a.shape == b.shape and a.dtype == b.dtype


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _wrapper_calls():
    B = _meta()
    y = _meta(2, 3, 40)
    p = _meta(2, 3, 40, dtype=torch.uint8)
    q = _meta(4, 128, 64)
    return {
        "moniqua_encode": lambda: kenc.encode(y, B, 1, bits=8,
                                              stochastic=True),
        "moniqua_decode_reduce": lambda: kdr.decode_reduce(
            p, _meta(2, 2, 3, 40, dtype=torch.uint8), y, B, bits=8,
            weights=(0.25, 0.25)),
        "moniqua_decode": lambda: kdec.decode(p[0], y[0], B, bits=8),
        "flash_attention_tc": lambda: tfa.flash_attention_tc(
            q.bfloat16(), q[:2].bfloat16(), q[:2].bfloat16(), scale=0.125),
        "flash_attention_f32tc": lambda: tfa.flash_attention_f32tc(
            q, q, q, scale=0.125, causal=True, window=16),
        "flash_attention_simt": lambda: tfa.flash_attention_simt(
            _meta(4, 128, 32), _meta(4, 128, 32), _meta(4, 128, 32),
            scale=0.125, causal=False),
        "flash_attention": lambda: tfa.flash_attention(q, q, q, scale=0.1),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_meta_outside_the_cost_context_raises(name):
    with pytest.raises(ValueError, match="meta"):
        _wrapper_calls()[name]()


def test_meta_inside_the_cost_context_charges_by_formula():
    calls = _wrapper_calls()
    with kcost.counting() as c:
        outs = {k: f() for k, f in calls.items()}
    assert outs["moniqua_encode"].shape == (2, 3, 40)
    assert outs["moniqua_encode"].dtype == torch.uint8
    assert outs["moniqua_decode_reduce"].shape == (2, 3, 40)
    assert outs["flash_attention_tc"].dtype == torch.bfloat16
    assert all(o.device.type == "meta" for o in outs.values())
    n = 2 * 3 * 40
    assert c.flops["moniqua_encode"] == kcost.ENCODE_OPS * n
    assert c.bytes["moniqua_encode"] == 4 * n + n
    assert c.flops["moniqua_decode_reduce"] == kcost.decode_reduce_ops(2) * n
    assert c.bytes["moniqua_decode_reduce"] == 3 * n + 2 * 4 * n
    assert c.flops["moniqua_decode"] == kcost.DECODE_OPS * 120
    causal = 128 * 129 // 2
    windowed = sum(min(i + 1, 16) for i in range(128))
    assert c.flops["flash_attention_tc"] == 4 * 4 * 64 * causal
    assert c.bytes["flash_attention_tc"] == 2 * (2 * 4 + 2 * 2) * 128 * 64
    assert c.flops["flash_attention_f32tc"] == (4 * 4 * 64 * windowed
                                                + 4 * 4 * 64 * causal)
    assert c.calls["flash_attention_f32tc"] == 2
    assert c.flops["flash_attention_simt"] == 4 * 4 * 32 * 128 * 128
    # the serving shape PERF.md bounds: 206.2 GFLOP causal
    assert 4 * 48 * 128 * kcost.attended_pairs(4096, 4096, True, 0) == \
        pytest.approx(206.2e9, rel=1e-3)


def test_cpu_kernels_count_once_and_hide_their_plain_version():
    """On the CPU inside the counters a kernel is charged by its formula
    and its plain version's ops are not counted; outside them nothing
    changes."""
    q = torch.randn(4, 64, 64)
    want = tfa.flash_attention(q, q, q, scale=0.125)
    with DR.StepCounters((q,)) as ctr:
        got = tfa.flash_attention(q, q, q, scale=0.125)
    assert torch.equal(got, want)
    c = ctr.counts
    assert c.torch_flops == 0
    assert c.kernel.calls == {"flash_attention_f32tc": 1}
    assert c.flops == 4 * 4 * 64 * (64 * 65 // 2)
    assert c.bytes_accessed == 4 * 4 * 64 * 64 * 4
    assert np.isfinite(got.numpy()).all()
