"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) on the CPU.

``Trainer.run`` writes the params to ``checkpoint_path`` and the FULL state
(params, momentum, the rule's ``extra`` with the EF wires' WireState, step,
g_inf and the seed generator) to ``<checkpoint_path>.state``.  A run
restored from it and continued must equal the uninterrupted run bit for
bit, as ``tests/test_ckpt_state.py`` holds the reference; onebit's warmup
of 4 puts the cut (step 3) before the switch and the resumed leg across
it.  The file format is the reference's, so a params checkpoint written by
the reference restores into the port's tree.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.models import resnet as jresnet
from repro_torch import convert, tree
from repro_torch.checkpoint import ckpt
from repro_torch.data.synthetic import stacked_cifar_like
from repro_torch.models.resnet import ResNetModel, init_resnet
from repro_torch.train.trainer import Trainer, TrainerConfig

_to_cpu = functools.partial(convert.to_torch, device="cpu")


@functools.lru_cache(maxsize=None)
def _model():
    return ResNetModel(depth=8, width=8, device="cpu")


def _trainer(steps, **kw):
    batches = [stacked_cifar_like(k, 4, 2, seed=0, device="cpu")
               for k in range(6)]
    tc = TrainerConfig(algo="moniqua", n_workers=2, bits=4, theta=2.0,
                       lr=0.1, log_every=10, seed=3, steps=steps, **kw)
    return Trainer(_model(), tc, lambda k: batches[k])


def _assert_states_equal(a, b):
    la, ta = tree.flatten(a)
    lb, tb = tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("wire,warmup", [("ef_qsgd", 16), ("onebit", 4)])
def test_ef_wire_resume_is_bit_identical(tmp_path, wire, warmup):
    """3 steps + checkpoint + 3 resumed steps == 6 uninterrupted steps, for
    the whole state tree."""
    path = str(tmp_path / f"{wire}.npz")
    kw = dict(wire=wire, warmup=warmup)
    full = _trainer(6, **kw).run()
    _trainer(3, checkpoint_path=path, checkpoint_every=3, **kw).run()
    resumer = _trainer(3, checkpoint_path=path, **kw)
    state = resumer.restore_state()
    assert state["step"] == 3
    assert int(state["extra"]["wire"]["step"]) == 3
    resumed = resumer.run(state)
    _assert_states_equal(full["state"], resumed["state"])
    assert ([h["loss"] for h in full["history"]][-1]
            == resumed["history"][-1]["loss"])


def test_generator_roundtrips(tmp_path):
    """The step-seed generator is stored as its byte state: the restored
    one draws what the saved one draws next."""
    gen = torch.Generator().manual_seed(17)
    torch.randint(0, 2 ** 32, (5,), generator=gen)
    path = str(tmp_path / "g")
    ckpt.save(path, {"gen": gen, "step": 5})
    back = ckpt.restore(path, {"gen": torch.Generator(), "step": 0})
    assert back["step"] == 5 and isinstance(back["step"], int)
    assert torch.equal(torch.randint(0, 2 ** 32, (8,), generator=gen),
                       torch.randint(0, 2 ** 32, (8,), generator=back["gen"]))


def test_sidecar_written_next_to_artifact(tmp_path):
    path = str(tmp_path / "ck" / "p.npz")
    _trainer(2, checkpoint_path=path, checkpoint_every=1).run()
    for f in ("p.npz", "p.meta.json", "p.npz.state.npz",
              "p.npz.state.meta.json"):
        assert (tmp_path / "ck" / f).exists(), f
    assert ckpt.load_meta(path) == {"step": 2, "algo": "moniqua",
                                    "wire": "moniqua"}


def test_dtypes_and_sequences_roundtrip(tmp_path):
    t = {"a": [torch.arange(6, dtype=torch.int32).reshape(2, 3),
               torch.tensor([1.5, -2.25]).to(torch.bfloat16)],
         "b": (torch.tensor(True), torch.zeros((), dtype=torch.float32))}
    ckpt.save(str(tmp_path / "t"), t)
    with np.load(str(tmp_path / "t.npz")) as npz:
        assert sorted(npz.files) == ["a|#0", "a|#1", "b|#0", "b|#1"]
        assert npz["a|#1"].dtype == np.float32
    back = ckpt.restore(str(tmp_path / "t"), tree.map(torch.zeros_like, t))
    _assert_states_equal(t, back)


def test_reference_params_checkpoint_restores_into_port(tmp_path):
    params = jresnet.init_resnet(jax.random.PRNGKey(4), depth=8, width=8)
    path = str(tmp_path / "ref.npz")
    jckpt.save(path, params, {"step": 7})
    like = init_resnet(torch.Generator().manual_seed(0), depth=8, width=8)
    got = ckpt.restore(path, like)
    want = _to_cpu(jax.tree.map(np.asarray, params))
    _assert_states_equal(want, got)
    assert ckpt.load_meta(path) == {"step": 7}
