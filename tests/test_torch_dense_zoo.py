"""The dense configs chatglm3-6b, internlm2-20b and qwen2-72b in the port
against the JAX package.

Each at the reference's reduced size (2 layers, d 256, 4 query heads of
64, vocab 512): chatglm3-6b keeps 2 KV heads (a GQA group of 2), half-dim
RoPE and QKV bias; internlm2-20b RoPE theta 1e6; qwen2-72b QKV bias and
RoPE theta 1e6.  Weights come from the reference's init, carried across
with ``repro_torch.convert``; the QKV biases, zeros at init in both
packages, are first set to the same seeded non-zero values on both sides,
so that the bias path is exercised.  Tokens are numpy draws handed to both.

Tolerances, as ``tests/test_torch_llama.py``'s: logits within 1e-4 x
max|logit| in float32, 3e-2 x max|logit| in bfloat16 (the frameworks round
bfloat16 products and activations at other places).  A train step's
per-worker losses within ``rtol=1e-5`` and gradients within 1e-4 of each
leaf's largest entry (float32; ``tests/test_torch_lm_train.py``'s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_MODULES as J_ARCHS
from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JShape
from repro.models.model_factory import build_model as jbuild
from repro_torch import convert, tree
from repro_torch.configs import ARCH_MODULES as T_ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import InputShape as TShape
from repro_torch.models.model_factory import build_model as tbuild

ARCHS = ("chatglm3-6b", "internlm2-20b", "qwen2-72b")
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, S = 2, 48


def _models(arch, dtype="float32"):
    """Reference and port models of the reduced ``arch`` and one set of
    weights for both, with seeded non-zero QKV biases."""
    over = dict(dtype=dtype)
    jm = jbuild(dataclasses.replace(jget_config(arch).reduced(), **over))
    tm = tbuild(dataclasses.replace(tget_config(arch).reduced(), **over),
                device="cpu")
    params = jm.init(jax.random.PRNGKey(0))
    if jm.cfg.qkv_bias:
        rng = np.random.default_rng(7)
        attn = dict(params["blocks"]["attn"])
        for name in ("bq", "bk", "bv"):
            assert not np.asarray(attn[name], np.float32).any()
            attn[name] = jnp.asarray(0.1 * rng.standard_normal(
                attn[name].shape).astype(np.float32)).astype(dtype)
        params = dict(params, blocks=dict(params["blocks"], attn=attn))
    tp = convert.to_torch(jax.tree.map(np.asarray, params), device="cpu")
    return jm, tm, params, tp


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def _close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= tol, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits (all positions and ``last_only``), then 8 decode
    steps from an empty cache: logits each step, ``pos`` and the cache."""
    jm, tm, params, tp = _models(arch, dtype)
    toks = _tokens(jm.cfg.vocab_size, (B, S))
    for last_only in (False, True):
        ref = jm.prefill_logits(params, {"tokens": jnp.asarray(toks)},
                                last_only=last_only)
        got = tm.prefill_logits(tp, {"tokens": torch.from_numpy(toks)},
                                last_only=last_only)
        _close(ref, got, TOL[dtype])
    dec = _tokens(jm.cfg.vocab_size, (B, 8), seed=1)
    jc = jm.init_cache(B, JShape("d", 16, B, "decode"))
    tc = tm.init_cache(B, TShape("d", 16, B, "decode"))
    for s in range(8):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(dec[:, s:s + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(dec[:, s:s + 1]))
        _close(jl, tl, TOL[dtype])
        assert int(jc["pos"]) == int(tc["pos"]) == s + 1
    for name in ("k", "v"):
        assert tuple(tc["layers"][name].shape) == jc["layers"][name].shape
        np.testing.assert_allclose(
            tc["layers"][name].float().numpy(),
            np.asarray(jc["layers"][name].astype(jnp.float32)),
            rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_match_reference(arch):
    """Two workers' losses and gradients (the train step's ``vmap(grad)``)
    through the port's flash route, against the reference's."""
    jm, tm, params, _ = _models(arch)
    rng = np.random.default_rng(3)
    X = jax.tree.map(lambda a: (np.asarray(a)[None] + 0.02
                                * rng.standard_normal((2,) + a.shape))
                     .astype(np.float32), params)
    toks = _tokens(jm.cfg.vocab_size, (2, B, S + 1), seed=2)
    b = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jm.loss)))(
        jax.tree.map(jnp.asarray, X), jax.tree.map(jnp.asarray, b))
    assert tm.cfg.flash_attention
    tg, tl = torch.func.vmap(torch.func.grad_and_value(tm.loss))(
        convert.to_torch(X, device="cpu"),
        {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for a, c in zip(jax.tree.leaves(jg), tree.leaves(tg)):
        a = np.asarray(a)
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(c.numpy(), a, rtol=0,
                                   atol=1e-4 * float(np.abs(a).max()))


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_registry_matches_reference(arch):
    """Field for field (but for the port's flash default, which serves
    through its kernel unless the plain oracle is asked for by name), the
    reduced variant too, and the same parameter count at full size."""
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    assert tcfg.flash_attention and not jcfg.flash_attention
    as_ref = dataclasses.replace(tcfg, flash_attention=False)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(as_ref)
    assert dataclasses.asdict(jcfg.reduced()) == \
        dataclasses.asdict(as_ref.reduced())
    assert jcfg.param_count() == tcfg.param_count()


def test_unported_archs_raise_with_their_roadmap_item():
    """Nothing is left unported: the port's registry is the reference's,
    and ``Model`` builds every family of it.  A name or a family the port
    lacks still raises."""
    assert set(T_ARCHS) == set(J_ARCHS)
    families = {tget_config(a).family for a in T_ARCHS if a != "resnet20"}
    assert families == {"dense", "moe", "hybrid", "ssm", "audio", "vlm"}
    for name in T_ARCHS:
        if name != "resnet20":
            assert tbuild(tget_config(name), device="cpu").cfg.name == name
    with pytest.raises(ValueError, match="unknown arch"):
        tget_config("no-such-arch")
    with pytest.raises(ValueError, match="unknown family"):
        tbuild(dataclasses.replace(tget_config("llama3.2-3b"),
                                   family="no-such-family"), device="cpu")