"""Context-parallel attention (the reference's ``kv_seq``) against JAX.

The flash kernels take a key offset ``k0`` (key 0's absolute position)
and return each row's log-sum-exp; on the CPU the port's
``flash_attention`` runs their plain version.  Held here against the
reference's Pallas kernel in interpret mode
(``repro.kernels.flash_attention.flash_attention``, which has neither:
it sees the whole sequence, K/V expanded to the query heads):

* the whole sequence at ``k0 = 0``: the output in float32 within 1e-6 of
  the reference's, ``lse`` within 1e-6 of a float64 log-sum-exp of the
  same scores;
* the keys cut into M shares (M in 2, 3, 4, shares of unequal length
  where M does not divide S), each at its offset, merged by
  ``exp(lse_r - lse)``: the reference's whole output within 1e-6, the
  merged ``lse`` the float64 one's, causal, windowed and grouped;
* a share with no valid key for any row: output 0, ``lse = -inf``, no
  NaN, and the merge with it the merge without it bitwise;
* ``ops.flash_sdpa``'s backward with ``k0`` and ``lse`` against
  ``torch.autograd`` through the float64 oracle;
* ``tensor_parallel.merge_attention`` over a gloo group of M ranks
  (``tests/torch_cp_cases.py``, M in 2, 3, 4) under
  ``torch.func.vmap(torch.func.grad)``: the output and gradients of the
  whole attention (the gradients within 1e-5 of each one's largest
  entry), bitwise equal on every rank;
* the cost model charges a share the pairs it attends.
"""
import json
import math
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

import torch_cp_cases as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
LSE_TOL = 1e-6


def _arrays(bh, g, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh // g, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh // g, sk, d)).astype(np.float32)
    return q, k, v


def _reference(q, k, v, g, scale, causal, window):
    """The reference's kernel on the whole sequence, K/V expanded."""
    ke, ve = (jnp.asarray(np.repeat(t, g, axis=0)) for t in (k, v))
    return np.asarray(jflash(jnp.asarray(q), ke, ve, scale=scale,
                             causal=causal, window=window, interpret=True))


def _lse64(q, k, g, scale, causal, window, k0=0):
    """The natural-log log-sum-exp of each row's valid scaled scores, in
    float64 (``-inf`` for a row with none)."""
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                  np.repeat(k, g, axis=0).astype(np.float64)) * scale
    if causal:
        i = np.arange(q.shape[1])[:, None]
        j = np.arange(k.shape[1])[None, :] + k0
        ok = j <= i
        if window:
            ok &= j > i - window
        s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


def _merge(outs, lses):
    """The merge of the shares' ``(out, lse)``, as ``merge_attention``
    computes it over ranks."""
    L = torch.stack(lses)
    m = L.amax(0)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(L - m)
    den = e.sum(0)
    out = (e[..., None] * torch.stack(outs).float()).sum(0) / den[..., None]
    return out, m + torch.log(den)


CASES = [  # bh, group, S, window, causal
    (6, 1, 130, 0, True), (6, 3, 130, 0, True), (4, 2, 200, 37, True),
    (6, 3, 96, 0, False)]


@pytest.mark.parametrize("bh,g,S,window,causal", CASES)
def test_whole_sequence_with_lse_matches_reference(bh, g, S, window,
                                                   causal):
    q, k, v = _arrays(bh, g, S, S, 64, seed=S + g)
    scale = 1.0 / math.sqrt(64)
    out, lse = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   scale=scale, causal=causal,
                                   window=window, k0=0, lse=True)
    want = _reference(q, k, v, g, scale, causal, window)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=ATOL)
    assert lse.dtype == torch.float32 and lse.shape == (bh, S)
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k, g, scale, causal,
                                                   window),
                               rtol=LSE_TOL, atol=LSE_TOL)
    # without lse: the output the route gave before k0 and lse existed
    assert torch.equal(tfa.flash_attention(
        *map(torch.from_numpy, (q, k, v)), scale=scale, causal=causal,
        window=window), tfa.flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), scale=scale, causal=causal,
        window=window))


@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("bh,g,S,window,causal", CASES)
def test_shares_merged_match_reference(M, bh, g, S, window, causal):
    q, k, v = _arrays(bh, g, S, S, 64, seed=S + g)
    scale = 1.0 / math.sqrt(64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    outs, lses = [], []
    for idx in np.array_split(np.arange(S), M):       # ragged where M ∤ S
        k0, n = int(idx[0]), len(idx)
        o, lse = tfa.flash_attention(tq, tk[:, k0:k0 + n], tv[:, k0:k0 + n],
                                     scale=scale, causal=causal,
                                     window=window, k0=k0, lse=True)
        assert not torch.isnan(o).any() and not torch.isnan(lse).any()
        np.testing.assert_allclose(
            lse.numpy(), _lse64(q, k[:, k0:k0 + n], g, scale, causal,
                                window, k0), rtol=LSE_TOL, atol=LSE_TOL)
        outs.append(o)
        lses.append(lse)
    out, lse = _merge(outs, lses)
    np.testing.assert_allclose(out.numpy(), _reference(
        q, k, v, g, scale, causal, window), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k, g, scale, causal,
                                                   window),
                               rtol=LSE_TOL, atol=LSE_TOL)


def test_all_masked_share_is_zero_and_merges_away():
    """The queries at positions 0..31 against a share of keys at 32..63:
    no row has a valid key."""
    q, k, v = _arrays(4, 2, 64, 64, 64, seed=1)
    scale = 0.125
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = tfa.flash_attention(tq[:, :32], tk[:, 32:], tv[:, 32:],
                                 scale=scale, k0=32, lse=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert bool((lse == -torch.inf).all())
    o0, l0 = tfa.flash_attention(tq[:, :32], tk[:, :32], tv[:, :32],
                                 scale=scale, k0=0, lse=True)
    out, lm = _merge([o0, o], [l0, lse])
    alone, la = _merge([o0], [l0])
    assert torch.equal(out, alone) and torch.equal(lm, la)
    np.testing.assert_allclose(out.numpy(), _reference(
        q[:, :32], k[:, :32], v[:, :32], 2, scale, True, 0), rtol=0,
        atol=ATOL)


@pytest.mark.parametrize("k0,window", [(0, 0), (24, 0), (40, 16)])
def test_flash_sdpa_backward_with_offset_and_lse(k0, window):
    """``_FlashSDPA``'s backward (the plain recompute, carrying ``lse``'s
    cotangent) against ``torch.autograd`` through the float64 oracle:
    rows without a valid key contribute nothing."""
    g = torch.Generator().manual_seed(k0)
    q = torch.randn(2, 48, 4, 32, generator=g)
    k = torch.randn(2, 24, 2, 32, generator=g)
    v = torch.randn(2, 24, 2, 32, generator=g)
    go = torch.randn(2, 48, 4, 32, generator=g)
    gl = torch.randn(2, 4, 48, generator=g)
    scale = 1.0 / math.sqrt(32)

    def oracle(q, k, v):
        ke, ve = (t.repeat_interleave(2, dim=-2) for t in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, ke) * scale
        mask = tfa.causal_mask(48, 24, window, k0=k0)
        s = torch.where(mask, s, -torch.inf)
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        e = torch.exp(s - m)
        den = e.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd",
                         e / torch.where(den > 0, den, 1.0), ve)
        return o, (m + torch.log(den))[..., 0]

    def loss(fn, *t):
        o, lse = fn(*t)
        lse = torch.where(torch.isfinite(lse), lse, 0.0)
        return (o * go.to(o.dtype)).sum() + (lse * gl.to(lse.dtype)).sum()
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(loss(lambda *t: tops.flash_sdpa(
        *t, scale=scale, window=window, k0=k0, lse=True), *args), args)
    args64 = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(loss(oracle, *args64), args64)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_attended_pairs_of_a_share():
    """The dry run's cost of a share: the pairs its offset leaves, summed
    over the shares the whole attention's."""
    for S, M, window in ((4096, 16, 0), (130, 3, 0), (200, 4, 37)):
        parts = [cost.attended_pairs(S, len(idx), True, window, int(idx[0]))
                 for idx in np.array_split(np.arange(S), M)]
        assert sum(parts) == cost.attended_pairs(S, S, True, window)
        brute = [int(tfa.causal_mask(S, len(idx), window,
                                     k0=int(idx[0])).sum())
                 for idx in np.array_split(np.arange(S), M)]
        assert parts == brute


def test_merge_over_ranks_under_vmap_grad(tmp_path):
    """``merge_attention`` over gloo groups of 2, 3 and 4 ranks, side by
    side (``tests/torch_cp_cases.py``): output, log-sum-exp and
    gradients of the whole attention, bitwise equal on every rank."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    script = os.path.join(REPO, "tests", "torch_cp_cases.py")
    procs = {M: [subprocess.Popen(
        [sys.executable, script, str(tmp_path / f"store{M}"), str(r), str(M),
         str(tmp_path / f"out{M}")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(M)]
        for M in (2, 3, 4)}
    deadline = time.monotonic() + 240
    try:
        for M, ps in procs.items():
            for p in ps:
                log = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0]
                assert p.returncode == 0, log[-3000:]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for M in procs:
        with open(tmp_path / f"out{M}.json") as f:
            checks = json.load(f)
        assert sorted(checks) == sorted(C.CASES)
        for name, (ok, detail) in checks.items():
            assert ok, (M, name, detail)
