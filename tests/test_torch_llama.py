"""The port's dense LM serving path (llama3.2-3b, reduced) against JAX.

The reference's reduced llama3.2-3b (2 layers, d 256, 4 heads of 64,
vocab 512, float32) with ``flash_attention=True``; its weights are carried
across with ``repro_torch.convert`` and the tokens are numpy draws handed
to both sides.  The reference runs its flash kernel in interpret mode; the
port's wrapper takes its plain version on the CPU.  A ``kv2`` variant
halves the KV heads to exercise grouped-query expansion, which the reduced
config (4 query and 4 KV heads) does not.

Tolerances: float32 logits within 1e-4 x max|logit| (the two frameworks sum
in other orders; measured ~1.3e-6).  bfloat16 within 3e-2 x max|logit|: the
frameworks round bfloat16 products and activations at other places
(measured ~1e-2 on this model and input).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JShape
from repro.models.model_factory import build_model as jbuild
from repro_torch import convert, tree
from repro_torch.configs import INPUT_SHAPES as T_SHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import InputShape as TShape
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.models import transformer as TT
from repro_torch.models.model_factory import build_model as tbuild
from repro_torch.train.serve_step import make_prefill_step, make_serve_step

ARCH = "llama3.2-3b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, S = 2, 96                   # 96: the reference's kernel pads to 128


def _cfgs(dtype="float32", kv=None, flash=True):
    over = dict(dtype=dtype, flash_attention=flash)
    if kv:
        over["num_kv_heads"] = kv
    return (dataclasses.replace(jget_config(ARCH).reduced(), **over),
            dataclasses.replace(tget_config(ARCH).reduced(), **over))


def _models(dtype="float32", kv=None):
    jcfg, tcfg = _cfgs(dtype, kv)
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    params = jm.init(jax.random.PRNGKey(0))
    tp = convert.to_torch(jax.tree.map(np.asarray, params), device="cpu")
    return jm, tm, params, tp


def _tokens(vocab, shape=(B, S), seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def _close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= tol, err


@pytest.mark.parametrize("kv", [None, 2], ids=["kv4", "kv2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_reference(dtype, kv):
    jm, tm, params, tp = _models(dtype, kv)
    toks = _tokens(jm.cfg.vocab_size)
    for last_only in (False, True):
        ref = jm.prefill_logits(params, {"tokens": jnp.asarray(toks)},
                                last_only=last_only)
        got = tm.prefill_logits(tp, {"tokens": torch.from_numpy(toks)},
                                last_only=last_only)
        _close(ref, got, TOL[dtype])


@pytest.mark.parametrize("kv", [None, 2], ids=["kv4", "kv2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(dtype, kv):
    """8 decode steps from init_cache: logits each step, pos, cache
    shapes and the cache contents."""
    jm, tm, params, tp = _models(dtype, kv)
    toks = _tokens(jm.cfg.vocab_size, (B, 8), seed=1)
    jc = jm.init_cache(B, JShape("d", 16, B, "decode"))
    tc = tm.init_cache(B, TShape("d", 16, B, "decode"))
    for s in range(8):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, s:s + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, s:s + 1]))
        _close(jl, tl, TOL[dtype])
        assert int(jc["pos"]) == int(tc["pos"]) == s + 1
    for name in ("k", "v"):
        assert tuple(tc["layers"][name].shape) == jc["layers"][name].shape
        np.testing.assert_allclose(
            tc["layers"][name].float().numpy(),
            np.asarray(jc["layers"][name].astype(jnp.float32)),
            rtol=TOL[dtype], atol=TOL[dtype])


def test_decode_ring_buffer_wraps_like_reference():
    """A cache shorter than the context is a sliding window of its own
    length: 7 tokens through a 4-slot ring."""
    jm, tm, params, tp = _models("float32", 2)
    toks = _tokens(jm.cfg.vocab_size, (B, 7), seed=2)
    jc = jm.init_cache(B, JShape("d", 4, B, "decode"))
    tc = tm.init_cache(B, TShape("d", 4, B, "decode"))
    for s in range(7):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, s:s + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, s:s + 1]))
        _close(jl, tl, TOL["float32"])


def test_decode_writes_the_cache_in_place():
    _, tm, _, tp = _models()
    tc = tm.init_cache(B, TShape("d", 8, B, "decode"))
    k0 = tc["layers"]["k"]
    _, tc2 = tm.decode_step(tp, tc, torch.zeros((B, 1), dtype=torch.int32))
    assert tc2["layers"]["k"] is k0 and k0[:, :, 0].abs().sum() > 0
    assert int(tc["pos"]) == 0 and int(tc2["pos"]) == 1


def test_serve_steps_are_the_model_calls():
    _, tm, _, tp = _models()
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size))
    prefill = make_prefill_step(tm)
    full = tm.prefill_logits(tp, {"tokens": toks})
    last = prefill(tp, {"tokens": toks})
    assert last.shape == (B, 1, TT.padded_vocab(tm.cfg))
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-5, atol=1e-5)
    assert torch.equal(TT.lm_logits(tp, tm.cfg, toks)[0], full)
    serve = make_serve_step(tm)
    shape = TShape("d", 8, B, "decode")
    c1, c2 = tm.init_cache(B, shape), tm.init_cache(B, shape)
    for s in range(3):
        l1, c1 = serve(tp, c1, toks[:, s:s + 1])
        l2, c2 = tm.decode_step(tp, c2, toks[:, s:s + 1])
        assert torch.equal(l1, l2)


def test_init_matches_reference_tree():
    """Model.init: the reference's tree, leaf shapes and dtypes; drawn from
    the generator (same seed, same weights); truncated at 2 scales."""
    jcfg, tcfg = _cfgs("bfloat16")
    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    tm = tbuild(tcfg, device="cpu")
    p1, p2 = tm.init(tm.generator(3)), tm.init(tm.generator(3))
    jl = jax.tree.leaves(shapes)
    tl = tree.leaves(p1)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, shapes)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, convert.to_numpy(p1)))
    assert [tuple(a.shape) for a in jl] == [tuple(t.shape) for t in tl]
    assert all(t.dtype == torch.bfloat16 for t in tl)
    assert all(torch.equal(a, b) for a, b in zip(tl, tree.leaves(p2)))
    emb = p1["embed"].float()
    # 2 scales of 0.02, plus one bfloat16 rounding; std 0.88 of a scale
    assert emb.abs().max() <= 0.04 * (1 + 2 ** -8)
    assert 0.015 < emb.std() < 0.02


def test_configs_match_reference():
    jcfg, tcfg = jget_config(ARCH), tget_config(ARCH)
    # field for field, but for one default: the port serves through its
    # flash kernel unless the plain oracle is asked for by name
    assert not jcfg.flash_attention and tcfg.flash_attention
    assert not jcfg.reduced().flash_attention and \
        tcfg.reduced().flash_attention
    tcfg_as_ref = dataclasses.replace(tcfg, flash_attention=False)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg_as_ref)
    assert dataclasses.asdict(jcfg.reduced()) == \
        dataclasses.asdict(tcfg_as_ref.reduced())
    assert jcfg.param_count() == tcfg.param_count()
    assert {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in T_SHAPES.items()}
    for name in ("phi-3-vision-4.2b", "xlstm-125m", "whisper-base"):
        assert tget_config(name).name == name
    with pytest.raises(ValueError, match="unknown family"):
        tbuild(dataclasses.replace(tcfg, family="no-such-family"),
               device="cpu")


def test_pipeline_batches():
    _, tcfg = _cfgs()
    tm = tbuild(tcfg, device="cpu")
    pipe = SyntheticLMPipeline(tm, TShape("p", 32, 4, "prefill"), 1, seed=5)
    b0, b0b, b1 = pipe.global_batch(0), pipe.global_batch(0), \
        pipe.global_batch(1)
    assert set(b0) == {"tokens"} and b0["tokens"].shape == (4, 32)
    assert b0["tokens"].dtype == torch.int32
    assert torch.equal(b0["tokens"], b0b["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert 0 <= int(b0["tokens"].min()) and \
        int(b0["tokens"].max()) < tcfg.vocab_size
    train = SyntheticLMPipeline(tm, TShape("t", 16, 2, "train"), 1)
    assert set(train.global_batch(0)) == {"tokens", "labels"}
    dec = SyntheticLMPipeline(tm, TShape("d", 16, 2, "decode"), 1)
    assert dec.global_batch(0)["token"].shape == (2, 1)


def test_convert_carries_bfloat16_bits():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((5, 7)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    t = convert.to_torch({"a": np.asarray(a)}, device="cpu")["a"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))
    back = convert.to_numpy({"a": t})["a"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(jnp.asarray(back).astype(
        jnp.bfloat16)).view(np.int16), np.asarray(a).view(np.int16))


def test_serving_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    tm = tbuild(tcfg)
    with pytest.raises(RuntimeError):
        tm.generator(0)
    with pytest.raises(RuntimeError):
        tm.init_cache(1, TShape("d", 8, 1, "decode"))
    with pytest.raises(RuntimeError):
        SyntheticLMPipeline(tm, TShape("p", 8, 1, "prefill"),
                            1).global_batch(0)
