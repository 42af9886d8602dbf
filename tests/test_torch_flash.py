"""The port's flash attention against the JAX package's, on the CPU.

On the CPU ``kernels.flash_attention.flash_attention`` takes its plain
version (the masked-softmax oracle on inputs upcast to float32), so this
pins the function the CUDA kernel is held to on the card.  The reference
side is its Pallas kernel in interpret mode (``flash_attention`` and
``ops.flash_sdpa`` with ``interpret=True``), on the same numpy inputs.

Tolerances are the reference tests' own (``tests/test_flash_attention.py``):
float32 ``rtol = atol = 2e-5`` (the two sum in other orders); bfloat16
``atol = 0.03`` against the float32 oracle of the same inputs; gradients
``rtol = atol = 1e-4``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL


def _qkv(S, H=2, D=64, B=2, seed=0, Sk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk or S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk or S, H, D)).astype(np.float32)
    return q, k, v


def _both(arrs, dtype):
    """numpy float32 -> (jax arrays, torch tensors) of one dtype, the same
    bits on both sides (both round to nearest even)."""
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    j = [jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
         for x in t]
    return j, t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


@pytest.mark.parametrize("S,window", [(256, 0), (384, 100), (128, 32),
                                      (130, 0)])   # 130: ragged edge
def test_flash_sdpa_matches_reference(S, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S), "float32")
    scale = 1.0 / math.sqrt(tq.shape[-1])
    out = tops.flash_sdpa(tq, tk, tv, scale=scale, window=window)
    ref = jops.flash_sdpa(jq, jk, jv, scale=scale, window=window,
                          interpret=True)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)


# 64, 96, 128: the head dims of the configs; 33, 80 (padded to 40 and run
# in the 96 instantiation on the card), 192 and 256 (the widest): the rest
@pytest.mark.parametrize("D", [64, 96, 128, 33, 80, 192, 256])
@pytest.mark.parametrize("causal,sq,sk,window", [
    (True, 256, 256, 0), (True, 384, 384, 100), (True, 130, 130, 0),
    (False, 130, 256, 0), (False, 130, 256, 50)])   # non-causal: no window
def test_flash_attention_plain_matches_reference_kernel(D, causal, sq, sk,
                                                        window):
    rng = np.random.default_rng(D + sq)
    arrs = [rng.standard_normal((3, s, D)).astype(np.float32)
            for s in (sq, sk, sk)]
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    scale = 1.0 / math.sqrt(D)
    out = tfa.flash_attention(tq, tk, tv, scale=scale, causal=causal,
                              window=window)
    ref = jflash(jq, jk, jv, scale=scale, causal=causal, window=window,
                 interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,Sk", [(True, None), (False, 200)])
def test_flash_bfloat16(causal, Sk):
    """bfloat16 in, bfloat16 out; within 0.03 of the float32 oracle of the
    same (bfloat16) inputs, like the reference's kernel."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(256, Sk=Sk), "bfloat16")
    scale = 0.125
    out = tops.flash_sdpa(tq, tk, tv, scale=scale, causal=causal)
    assert out.dtype == torch.bfloat16
    f32 = [x.float() for x in (tq, tk, tv)]
    oracle = TL._sdpa(*f32, torch.ones(256, Sk or 256, dtype=torch.bool)
                      if not causal else TL.causal_mask(256, 256), scale)
    np.testing.assert_allclose(_np(out), oracle.numpy(), rtol=0, atol=0.03)
    # and within one bfloat16 ulp of the oracle, plus the float32 test's
    # tolerance for the sums' order (the bound chip_smoke.py holds the
    # kernel to)
    _, e = torch.frexp(oracle)
    ulp = torch.where(oracle == 0, 0.0, torch.ldexp(torch.ones_like(oracle),
                                                    e - 8))
    err = (out.float() - oracle).abs()
    assert bool((err <= ulp + 2e-5 * (1 + oracle.abs())).all())
    ref = jops.flash_sdpa(jq, jk, jv, scale=scale, causal=causal,
                          interpret=True)
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=0.03)


@pytest.mark.parametrize("causal,Sk", [(True, None), (False, 200)])
def test_bfloat16_flash_vs_plain_gap_is_the_references(causal, Sk):
    """The gap between the flash route and the plain masked-softmax route
    in bfloat16 is bfloat16's, not the port's: on the same inputs as
    ``test_flash_bfloat16``, the port's flash function (what the card's
    kernel is held to) is no farther from its plain bfloat16 route
    (``sdpa_ref``: scores and softmax weights rounded to bfloat16) than the
    reference's interpret-mode kernel is from its ``_sdpa_ref``."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(256, Sk=Sk), "bfloat16")

    def fold(t):                           # [B, S, H, D] -> [B H, S, D]
        return t.movedim(2, 1).reshape(-1, t.shape[1], t.shape[3])

    def jfold(a):
        return jnp.moveaxis(a, 2, 1).reshape(-1, a.shape[1], a.shape[3])
    tq, tk, tv = map(fold, (tq, tk, tv))
    jq, jk, jv = map(jfold, (jq, jk, jv))
    scale = 0.125
    ref_gap = np.abs(_np(jflash(jq, jk, jv, scale=scale, causal=causal,
                                window=0, interpret=True))
                     - _np(jops._sdpa_ref(jq, jk, jv, scale, causal, 0))
                     ).max()
    port_gap = np.abs(_np(tfa.flash_attention(tq, tk, tv, scale=scale,
                                              causal=causal))
                      - _np(tfa.sdpa_ref(tq, tk, tv, scale, causal, 0))
                      ).max()
    assert 0 < port_gap <= ref_gap


@pytest.mark.parametrize("g,causal,sq,sk,window", [
    (1, True, 256, 256, 0), (4, True, 384, 384, 100), (1, True, 130, 130, 0),
    (4, False, 130, 200, 0)])
def test_flash_bfloat16_head_dim_96(g, causal, sq, sk, window):
    """phi-3-vision-4.2b's head dim, bfloat16 as published, through
    ops.flash_sdpa ([B, S, H, D], K/V at H / g heads) against the
    reference's interpret-mode ops.flash_sdpa on K/V repeated to H heads:
    within the reference tests' atol 0.03."""
    B, hkv, D = 1, 2, 96
    rng = np.random.default_rng(96 + sq + g)
    q = rng.standard_normal((B, sq, hkv * g, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, sk, hkv, D)).astype(np.float32)
            for _ in range(2))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], "bfloat16")
    kw = dict(scale=1.0 / math.sqrt(D), causal=causal, window=window)
    out = tops.flash_sdpa(tq, tk, tv, **kw)
    assert out.shape == tq.shape and out.dtype == torch.bfloat16
    ref = jops.flash_sdpa(jq, jnp.repeat(jk, g, axis=-2),
                          jnp.repeat(jv, g, axis=-2), interpret=True, **kw)
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=0.03)


def test_flash_sdpa_gradient_matches_reference():
    """The backward recomputes through the oracle, as the reference's
    custom_vjp does: gradients of sum(out**2) agree within 1e-4."""
    q, k, v = _qkv(192, H=1, B=1)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def jloss(q, k, v):
        return jnp.sum(jops.flash_sdpa(q, k, v, scale=scale, window=64,
                                       interpret=True) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tqkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tops.flash_sdpa(*tqkv, scale=scale, window=64) ** 2).sum().backward()
    for a, b in zip(jg, tqkv):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a),
                                   rtol=1e-4, atol=1e-4)


def test_model_attention_flash_flag():
    """cfg.flash_attention=True (the port's default) routes
    layers.attention through ops.flash_sdpa; both branches agree with each
    other and with the reference's attention (same weights)."""
    jcfg = dataclasses.replace(jget_config("llama3.2-3b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(tget_config("llama3.2-3b").reduced(),
                               dtype="float32")
    jp = JL.init_attention(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 128, jcfg.d_model)
                                                 ).astype(np.float32)
    pos = np.tile(np.arange(128), (2, 1))
    ref = np.asarray(JL.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos)))
    plain = TL.attention(tp, dataclasses.replace(tcfg, flash_attention=False),
                         torch.from_numpy(x), torch.from_numpy(pos))
    flash = TL.attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert tcfg.flash_attention                 # the port's default
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=3e-5, atol=3e-5)


def test_flash_counts_no_cpu_launch_and_rejects_bad_input():
    q = torch.zeros(2, 16, 64)
    routes = (tfa.flash_attention_tc, tfa.flash_attention_f32tc)
    for route in routes:
        route.launches = 0
    # each route, at an instantiated and at a padded head dim
    for x in (q, q.bfloat16(), torch.zeros(2, 16, 33),
              torch.zeros(2, 16, 33).bfloat16()):
        tfa.flash_attention(x, x, x, scale=0.125)
        for route in routes:
            route(x, x, x, scale=0.125)
    # plain version on the CPU: no route counts a launch
    assert [r.launches for r in routes] == [0, 0]
    with pytest.raises(ValueError):
        tfa.flash_attention(torch.zeros(2, 16, 300), torch.zeros(2, 16, 300),
                            torch.zeros(2, 16, 300), scale=0.1)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q[:, :8, :32], q[:, :8, :32], scale=0.1)
    with pytest.raises(ValueError):
        tfa.flash_attention(q[0], q[0], q[0], scale=0.1)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.double(), q.double(), q.double(), scale=0.1)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q.bfloat16(), q, scale=0.1)


def test_flash_route_is_fixed_by_dtype_and_head_dim():
    """At every head dim 1..256 both dtypes take the tensor cores: bfloat16
    the wgmma route, float32 the 3xTF32 route.  No other route exists."""
    def q(dtype, d):
        return torch.zeros(1, 4, d, dtype=dtype)
    for d in range(1, tfa.MAX_HEAD_DIM + 1):
        assert tfa.route(q(torch.bfloat16, d)) is tfa.flash_attention_tc
        assert tfa.route(q(torch.float32, d)) is tfa.flash_attention_f32tc
    assert not hasattr(tfa, "flash_attention_simt")


def test_padded_head_dim_is_the_smallest_instantiation_at_least_d():
    assert tfa.TC_HEAD_DIMS == (64, 96, 128, 192, 256)
    for d in range(1, tfa.MAX_HEAD_DIM + 1):
        want = min(dim for dim in tfa.TC_HEAD_DIMS if dim >= d)
        assert tfa.padded_head_dim(d) == want
    assert [tfa.padded_head_dim(d) for d in (1, 64, 65, 96, 97, 128, 129,
                                             192, 193, 256)] == \
        [64, 64, 96, 96, 128, 128, 192, 192, 256, 256]
    for d in (0, 257):
        with pytest.raises(ValueError):
            tfa.padded_head_dim(d)


@pytest.mark.parametrize("d", [33, 80, 160, 200])
@pytest.mark.parametrize("causal,sq,sk,window", [
    (True, 130, 130, 0), (True, 200, 200, 50), (False, 130, 200, 0)])
def test_zero_padded_head_dim_is_the_unpadded_function(d, causal, sq, sk,
                                                       window):
    """What the kernels compute at a padded head dim: q, k and v with zero
    columns up to :func:`padded_head_dim` (d), cut back to d columns, is
    the attention of the unpadded inputs, within 2e-5 (the zeros add
    exact zeros to every score; only the sums' order may differ), with
    grouped-query KV blocks (g = 2)."""
    rng = np.random.default_rng(d + sq + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((4, sq, d), (2, sk, d), (2, sk, d)))
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, window=window)
    pad = tfa.padded_head_dim(d) - d
    padded = tfa.flash_attention_plain(
        *(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v)), **kw)
    assert bool((padded[..., d:] == 0).all())
    np.testing.assert_allclose(padded[..., :d].numpy(),
                               tfa.flash_attention_plain(q, k, v, **kw)
                               .numpy(), rtol=2e-5, atol=2e-5)


def test_flash_rejects_bad_gqa_and_dtype():
    q = torch.zeros(6, 16, 64)
    with pytest.raises(ValueError):                # 4 KV blocks do not divide 6
        tfa.flash_attention(q, q[:4], q[:4], scale=0.1)
    with pytest.raises(ValueError):                # k and v head counts differ
        tfa.flash_attention(q, q[:3], q[:2], scale=0.1)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q[:0], q[:0], scale=0.1)
    with pytest.raises(TypeError):                 # mismatched dtype, GQA
        tfa.flash_attention(q, q[:3].bfloat16(), q[:3].bfloat16(), scale=0.1)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.bfloat16(), q[:2].bfloat16(), q[:2], scale=0.1)


def _expand_heads(a, g):
    """numpy [..., S, Hkv, D] -> [..., S, Hkv * g, D]: ``jnp.repeat`` on the
    head axis, as the reference's attention expands KV heads."""
    return np.repeat(a, g, axis=-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [3, 2])
@pytest.mark.parametrize("causal,sq,sk,window", [
    (True, 256, 256, 0), (True, 384, 384, 100), (True, 130, 130, 0),
    (False, 130, 256, 0)])
def test_flash_attention_gqa_matches_reference_kernel(dtype, g, causal, sq,
                                                      sk, window):
    """k, v at KV-head count [BH/g, Sk, D] through the port's plain version
    against the reference's interpret-mode kernel on the repeated K/V."""
    rng = np.random.default_rng(g + sq)
    B, hkv, D = 2, 2, 64
    q = rng.standard_normal((B * hkv * g, sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B * hkv, sk, D)).astype(np.float32)
            for _ in range(2))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], dtype)
    scale = 1.0 / math.sqrt(D)
    kw = dict(scale=scale, causal=causal, window=window)
    out = tfa.flash_attention(tq, tk, tv, **kw)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    ref = jflash(jq, jnp.repeat(jk, g, axis=0), jnp.repeat(jv, g, axis=0),
                 interpret=True, **kw)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else dict(
        rtol=0, atol=0.03)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,window", [(3, 0), (2, 100)])
def test_flash_sdpa_gqa_matches_reference(dtype, g, window):
    """ops.flash_sdpa on [B, S, H, D] q and [B, S, H/g, D] k, v against the
    reference's ops.flash_sdpa on K/V repeated to H heads."""
    B, S, hkv, D = 2, 192, 2, 64
    rng = np.random.default_rng(g)
    q = rng.standard_normal((B, S, hkv * g, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, hkv, D)).astype(np.float32)
            for _ in range(2))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], dtype)
    scale = 1.0 / math.sqrt(D)
    out = tops.flash_sdpa(tq, tk, tv, scale=scale, window=window)
    ref = jops.flash_sdpa(jq, jnp.repeat(jk, g, axis=-2),
                          jnp.repeat(jv, g, axis=-2), scale=scale,
                          window=window, interpret=True)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else dict(
        rtol=0, atol=0.03)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)


@pytest.mark.parametrize("g", [3, 2])
def test_flash_sdpa_gqa_gradient_matches_reference(g):
    """dK and dV come back at KV-head shape: the reference's VJP on the
    repeated K/V, summed over each group of g query heads, within 1e-4."""
    B, S, hkv, D = 1, 160, 2, 64
    rng = np.random.default_rng(10 + g)
    q = rng.standard_normal((B, S, hkv * g, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, hkv, D)).astype(np.float32)
            for _ in range(2))
    scale = 1.0 / math.sqrt(D)

    def jloss(q, k, v):
        return jnp.sum(jops.flash_sdpa(q, k, v, scale=scale, window=64,
                                       interpret=True) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, _expand_heads(k, g), _expand_heads(v, g))))
    tqkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tops.flash_sdpa(*tqkv, scale=scale, window=64) ** 2).sum().backward()
    assert tqkv[1].grad.shape == k.shape and tqkv[2].grad.shape == v.shape
    want = [np.asarray(jg[0])] + [
        np.asarray(a).reshape(B, S, hkv, g, D).sum(3) for a in jg[1:]]
    for a, b in zip(want, tqkv):
        np.testing.assert_allclose(b.grad.numpy(), a, rtol=1e-4, atol=1e-4)
