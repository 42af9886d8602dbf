"""The audio family (the whisper encoder-decoder: whisper-base) in the port
against the JAX package, with the attention layers it brings: LayerNorm,
bidirectional and cross attention, cached cross-attention decode and the
band-wise windowed attention.

whisper-base at the reference's reduced size (2 encoder and 2 decoder
layers, d 256, 4 heads of 64, d_ff 512, vocab 512, 448 decoder
positions), 32 encoder frames and 16 decoder tokens.  Weights from the
reference's init, carried across with ``repro_torch.convert``; the
LayerNorm scales and biases (ones and zeros at init) first set to the same
seeded values on both sides.  Inputs are numpy draws handed to both.

Tolerances:

* ``layer_norm`` within 1e-6 x max in float32 and 1e-2 x max (a bf16
  rounding) in bfloat16; ``sinusoids`` within 1e-5 absolute (values in
  [-1, 1]; measured 3.8e-6, one float32 ulp of the largest angle, 63
  rad, as the frameworks' ``exp`` round the frequencies apart);
* attention on every route and ``attention_decode(cross=True)`` within
  1e-5 x max (float32); ``_banded_sdpa`` within ``rtol = atol = 2e-5`` of
  the full masked softmax and of the reference's (``tests/test_attention.py``'s);
* ``encode``, ``decoder_hidden`` and the cross caches within 1e-5 x max;
* the model: logits within 1e-4 x max|logit| in float32 and 3e-2 in
  bfloat16 (``tests/test_torch_llama.py``'s); losses, gradients and one
  Moniqua step as ``tests/torch_family_cases.py`` states.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JShape
from repro.models import layers as JL
from repro.models import whisper as JWH
from repro_torch import convert, tree
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import InputShape as TShape
from repro_torch.models import layers as TL
from repro_torch.models import whisper as TWH
from torch_family_cases import one_thread  # noqa: F401 (autouse fixture)
from torch_family_cases import (check_batch_spec, check_loss_and_grads,
                                check_moniqua_step, check_trainer_bytes,
                                models, rel, tokens)

ARCH = "whisper-base"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, ENC, DEC = 2, 32, 16


def _cfgs(dtype="float32", arch=ARCH, **over):
    over = dict(dtype=dtype, **over)
    return (dataclasses.replace(jget_config(arch).reduced(), **over),
            dataclasses.replace(tget_config(arch).reduced(), **over))


def _seeded_norms(params, rng):
    """Every LayerNorm scale and bias (``ln*``) set to seeded values."""
    def leaf(path, a):
        name = path[-1].key
        if not name.startswith("ln"):
            return a
        base = 1.0 if not name.endswith("b") else 0.0
        return jnp.asarray(base + 0.2 * rng.standard_normal(a.shape)
                           ).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, params)


def _models(dtype="float32"):
    jm, tm, params, _ = models(*_cfgs(dtype))
    params = _seeded_norms(params, np.random.default_rng(7))
    return jm, tm, params, convert.to_torch(jax.tree.map(np.asarray, params),
                                            device="cpu")


def _frames(d, n=B, seed=0):
    return np.random.default_rng(seed).standard_normal((n, ENC, d)
                                                       ).astype(np.float32)


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((3, 7, 64))).astype(np.float32)
    s, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = JL.layer_norm(*(jnp.asarray(a).astype(jdt) for a in (x, s, b)))
    got = TL.layer_norm(*(torch.from_numpy(a).to(tdt) for a in (x, s, b)))
    assert got.dtype == tdt
    assert rel(got, ref) <= (1e-6 if dtype == "float32" else 1e-2)


def test_sinusoids_match_reference():
    ref = np.asarray(JWH.sinusoids(64, 256))
    got = TWH.sinusoids(64, 256)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def _attn_case(cfg_over=None, arch=ARCH, S=24):
    jcfg, tcfg = _cfgs(arch=arch, **(cfg_over or {}))
    p = JL.init_attention(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    tp = convert.to_torch(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, tp, x, rng


@pytest.mark.parametrize("route", ["bidir", "cross", "causal"])
def test_attention_routes_match_reference(route, monkeypatch):
    """Self-attention bidirectional and causal (the flash route: its plain
    version on the CPU), and cross attention over 40 encoder positions
    (K/V ``[B, 40, H, D]``), against the reference's XLA attention; only
    causal self-attention reaches ``flash_sdpa``."""
    jcfg, tcfg, p, tp, x, rng = _attn_case()
    kw = {}
    if route == "bidir":
        kw = dict(bidir=True)
    elif route == "cross":
        kv = [rng.standard_normal((B, 40, jcfg.num_kv_heads, jcfg.hd))
              .astype(np.float32) for _ in range(2)]
        kw = dict(cross_kv=kv)
    flash = []
    orig = TL.kops.flash_sdpa
    monkeypatch.setattr(TL.kops, "flash_sdpa",
                        lambda *a, **k: flash.append(1) or orig(*a, **k))
    pos = np.broadcast_to(np.arange(x.shape[1]), x.shape[:2])
    ref = JL.attention(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                       **{k: (tuple(map(jnp.asarray, v)) if k == "cross_kv"
                              else v) for k, v in kw.items()})
    got = TL.attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(
        pos.copy()), **{k: (tuple(map(torch.from_numpy, v))
                            if k == "cross_kv" else v)
                        for k, v in kw.items()})
    assert len(flash) == (route == "causal")
    assert rel(got, ref) <= 1e-5


def _qkv(S, H=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, S, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("S,window,chunk", [(512, 128, 128), (512, 96, 128),
                                            (1024, 256, 128), (384, 64, 192)])
def test_banded_sdpa_matches_full_and_reference(S, window, chunk):
    """The band-wise evaluation of the windowed mask equals the full masked
    matrix and the reference's band-wise evaluation
    (``tests/test_attention.py``'s cases and tolerance)."""
    q, k, v = _qkv(S)
    scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = TL._banded_sdpa(tq, tk, tv, window, scale, q_chunk=chunk)
    full = TL._sdpa(tq, tk, tv, TL.causal_mask(S, S, window), scale)
    ref = JL._banded_sdpa(*map(jnp.asarray, (q, k, v)), window, scale,
                          q_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_banded_sdpa_falls_back_on_a_short_sequence():
    """S <= window + chunk: the full masked matrix, the same numbers."""
    q, k, v = map(torch.from_numpy, _qkv(128, seed=1))
    full = TL._sdpa(q, k, v, TL.causal_mask(128, 128, 64), 0.125)
    got = TL._banded_sdpa(q, k, v, 64, 0.125, q_chunk=512)
    assert torch.equal(got, full)


def test_plain_windowed_attention_goes_band_wise(monkeypatch):
    """``flash_attention=False`` and a window under half the sequence (64
    of 384): ``attention`` evaluates it band-wise (query chunks of 128), as
    the reference routes it, within 1e-5 x max of the reference."""
    jcfg, tcfg, p, tp, x, _ = _attn_case(
        dict(flash_attention=False), arch="llama3.2-3b", S=384)
    calls = []
    orig = TL._banded_sdpa
    monkeypatch.setattr(TL, "_banded_sdpa",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    pos = np.broadcast_to(np.arange(384), (B, 384)).copy()
    ref = JL.attention(p, jcfg, jnp.asarray(x), jnp.asarray(pos), window=64)
    got = TL.attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                       window=64)
    assert calls == [dict(q_chunk=128)]
    assert rel(got, ref) <= 1e-5


def test_attention_decode_cross_matches_reference():
    """One query against a pre-filled cache of 24 slots of which the first
    17 hold the encoder (``pos`` = 17): the same output as the reference,
    the cache untouched."""
    jcfg, tcfg, p, tp, x, rng = _attn_case()
    shape = (B, 24, jcfg.num_kv_heads, jcfg.hd)
    cache = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ref, _ = JL.attention_decode(p, jcfg, jnp.asarray(x[:, :1]),
                                 jax.tree.map(jnp.asarray, cache),
                                 jnp.asarray(17, jnp.int32), cross=True)
    got, out = TL.attention_decode(tp, tcfg, torch.from_numpy(x[:, :1]),
                                   tcache, torch.tensor(17, dtype=torch.int32),
                                   cross=True)
    assert out is tcache
    assert all(np.array_equal(tcache[k].numpy(), cache[k]) for k in cache)
    assert rel(got, ref) <= 1e-5


# -- whisper-base, reduced -----------------------------------------------------

def test_encoder_and_decoder_match_reference():
    jm, tm, params, tp = _models()
    cfg = tm.cfg
    f = _frames(cfg.d_model)
    toks = tokens(cfg.vocab_size, (B, DEC))
    ej = jax.jit(lambda p, f: JWH.encode(p, jm.cfg, f))(params, f)
    et = TWH.encode(tp, cfg, torch.from_numpy(f))
    assert rel(et, ej) <= 1e-5
    hj = jax.jit(lambda p, t, e: JWH.decoder_hidden(p, jm.cfg, t, e))(
        params, toks, ej)
    ht = TWH.decoder_hidden(tp, cfg, torch.from_numpy(toks), et)
    assert rel(ht, hj) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits (all decoder positions and ``last_only``); then
    ``whisper_prefill_cross`` into a cache of 64 self and 32 cross slots
    (cross caches and ``enc_len``), and 8 decode steps: logits, ``pos``
    and the self caches."""
    jm, tm, params, tp = _models(dtype)
    cfg = tm.cfg
    f = _frames(cfg.d_model)
    toks = tokens(cfg.vocab_size, (B, DEC))
    jb = {"enc_embeds": jnp.asarray(f).astype(jnp.dtype(dtype)),
          "tokens": jnp.asarray(toks)}
    tb = {"enc_embeds": torch.from_numpy(f).to(getattr(torch, dtype)),
          "tokens": torch.from_numpy(toks)}
    ref = np.asarray(jax.jit(jm.prefill_logits)(params, jb))
    for last_only in (False, True):
        got = tm.prefill_logits(tp, tb, last_only=last_only)
        assert got.dtype == torch.float32
        assert rel(got, ref[:, -1:] if last_only else ref) <= TOL[dtype]
    jc = jm.init_cache(B, JShape("d", 2 * ENC, B, "decode"))
    tc = tm.init_cache(B, TShape("d", 2 * ENC, B, "decode"))
    assert jax.tree.structure(jax.tree.map(np.asarray, jc)) == \
        jax.tree.structure(convert.to_numpy(tc))
    jc = JWH.whisper_prefill_cross(params, jm.cfg, jb["enc_embeds"], jc)
    cross = tc["cross"]
    tc = TWH.whisper_prefill_cross(tp, cfg, tb["enc_embeds"], tc)
    assert tc["cross"] is cross and tc["enc_len"].dim() == 0
    assert int(tc["enc_len"]) == int(jc["enc_len"]) == ENC
    for name in ("k", "v"):
        assert rel(tc["cross"][name], jc["cross"][name]) <= TOL[dtype]
    jdecode = jax.jit(jm.decode_step)
    dec = tokens(cfg.vocab_size, (B, 8), seed=1)
    for s in range(8):
        jl, jc = jdecode(params, jc, jnp.asarray(dec[:, s:s + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(dec[:, s:s + 1]))
        assert rel(tl, jl) <= TOL[dtype]
        assert int(jc["pos"]) == int(tc["pos"]) == s + 1
    for name in ("k", "v"):
        assert rel(tc["self"][name], jc["self"][name]) <= TOL[dtype]


def test_decode_matches_prefill():
    """Float32: after ``whisper_prefill_cross``, the decoder tokens fed one
    at a time give prefill's logits at every position, within 1e-4 x
    max|logit|."""
    _, tm, _, tp = _models()
    cfg = tm.cfg
    b = {"enc_embeds": torch.from_numpy(_frames(cfg.d_model, seed=4)),
         "tokens": torch.from_numpy(tokens(cfg.vocab_size, (B, DEC), 4))}
    want = tm.prefill_logits(tp, b)
    cache = TWH.whisper_prefill_cross(
        tp, cfg, b["enc_embeds"], tm.init_cache(B, TShape("d", 2 * ENC, B,
                                                          "decode")))
    got = []
    for s in range(DEC):
        lg, cache = tm.decode_step(tp, cache, b["tokens"][:, s:s + 1])
        got.append(lg)
    assert rel(torch.cat(got, 1), want.numpy()) <= 1e-4


def test_decode_position_clamps_at_the_cap():
    """A decode step at ``pos`` beyond ``decoder_len_cap`` (448) reads the
    last learned position, as the reference does: the same logits."""
    jm, tm, params, tp = _models()
    jc = jm.init_cache(B, JShape("d", 2 * ENC, B, "decode"))
    tc = tm.init_cache(B, TShape("d", 2 * ENC, B, "decode"))
    f = _frames(tm.cfg.d_model, seed=5)
    jc = JWH.whisper_prefill_cross(params, jm.cfg, jnp.asarray(f), jc)
    tc = TWH.whisper_prefill_cross(tp, tm.cfg, torch.from_numpy(f), tc)
    jc = dict(jc, pos=jnp.asarray(451, jnp.int32))
    tc = dict(tc, pos=torch.tensor(451, dtype=torch.int32))
    tok = tokens(tm.cfg.vocab_size, (B, 1), seed=6)
    jl, _ = jm.decode_step(params, jc, jnp.asarray(tok))
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
    assert int(tc["pos"]) == 452
    assert rel(tl, jl) <= TOL["float32"]


def _train_batch(vocab, d, n, seed):
    toks = tokens(vocab, (n, 1, DEC + 1), seed=seed)
    frames = np.random.default_rng(seed).standard_normal((n, 1, ENC, d))
    return {"enc_embeds": frames.astype(np.float32),
            "tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}


def test_batch_spec_matches_reference():
    jm, tm, _, _ = _models()
    check_batch_spec(jm, tm, 3000, 16)


def test_per_worker_loss_and_grads_match_reference():
    """Two workers' losses and gradients (``vmap(grad)``; the decoder's
    self-attention through ``flash_sdpa``) against the reference's."""
    jm, tm, params, _ = _models()
    check_loss_and_grads(jm, tm, params, _train_batch(
        tm.cfg.vocab_size, tm.cfg.d_model, 2, 2))
    assert len(tree.leaves(tm.init(tm.generator(0)))) == 32


def test_moniqua_train_step_matches_reference():
    jm, tm, params, _ = _models()
    check_moniqua_step(jm, tm, params, _train_batch(
        tm.cfg.vocab_size, tm.cfg.d_model, 2, 5))


def test_trainer_on_whisper_matches_reference_bytes():
    """``Trainer(model, tc, shape)`` on the reduced config in bf16, as
    published (``enc_embeds`` drawn by the pipeline): bytes per step equal
    the reference ``Trainer``'s."""
    check_trainer_bytes(*_cfgs("bfloat16"), ("tiny", 64, 4, "train"))
