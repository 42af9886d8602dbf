"""The numerics behind the bfloat16 tensor-core flash kernel, on the CPU.

``csrc/flash_attention_tc.cu`` takes S = Q K^T on ``wgmma`` from bfloat16
operands (each product exact in float32, float32 sums), runs the online
softmax in float32 in base 2 (``exp2`` of the score times ``scale *
log2(e)`` less the running max), and takes O += P V with P split into
``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``, both through the tensor
cores against the bfloat16 V.  Its loop: 128-row query blocks of two
64-row warpgroups, 128-key tiles (64-key past head dim 128) over the live
tiles the block walks, a warpgroup skipping the tiles with no live key for
its rows; the output is one bfloat16 rounding of ``acc / max(l, 1e-30)``.
A head dim between instantiations runs in the next one up with zero
columns (``flash_attention.padded_head_dim``).  These tests run on the
CPU, so this emulates that arithmetic in torch and holds it to the bound
the card's kernel is held to (``flash_attention.flash_close``: the
reference tests' atol 0.03 and, element by element, one bfloat16 ulp of
the float32 plain value plus rtol = atol = 2e-5), at head dims 64, 96,
128, 192 and 256, and at 80 padded to 96.  This is a model of the arithmetic, not of the kernel: the layout of
the tiles in shared memory, where the head dims differ, is not modelled,
and the kernel itself is held to the same bound only on the card
(``chip_smoke.py`` phases 7 and 11).  Rounding P to bfloat16 once,
without its lo half, misses that bound: the evidence that the split is
needed.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa

NEG_INF = -1e30
BLOCK_M = 128           # query rows of a CTA
WG_ROWS = 64            # query rows of a warpgroup
LOG2E = 1.4426950408889634


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bfloat16 (to nearest even) and back."""
    return x.bfloat16().float()


def block_n(d: int) -> int:
    """Keys of a tile in the instantiation at head dim d."""
    return 128 if d <= 128 else 64


def live_tiles(q0: int, sk: int, causal: bool, window: int, bn: int):
    """The key tiles of ``bn`` keys the CTA at query row q0 walks."""
    nk = -(-sk // bn)
    if not causal:
        return range(nk)
    end = min(nk, (q0 + BLOCK_M - 1) // bn + 1)
    begin = max(0, q0 - window + 1) // bn if window else 0
    return range(begin, end)


def flash_wgmma_emulated(q, k, v, *, scale, causal, window, split_p=True):
    """The kernel's loop on bfloat16 q [BH, Sq, D], k/v [BH/g, Sk, D] ->
    bfloat16 out; ``split_p=False`` rounds P to bfloat16 once instead."""
    bh, sq, d = q.shape
    g = bh // k.shape[0]
    sk = k.shape[1]
    bn = block_n(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    out = torch.empty(q.shape, dtype=torch.float32)
    for h in range(bh):
        kh, vh = kf[h // g], vf[h // g]
        for q0 in range(0, sq, BLOCK_M):
            tiles = live_tiles(q0, sk, causal, window, bn)
            for qa in range(q0, min(q0 + BLOCK_M, sq), WG_ROWS):
                qb = qa + WG_ROWS - 1
                rows = qf[h, qa:qa + WG_ROWS]
                iq = torch.arange(qa, qa + rows.shape[0])[:, None]
                m = torch.full((rows.shape[0], 1), NEG_INF)
                l = torch.zeros((rows.shape[0], 1))
                acc = torch.zeros_like(rows)
                for j in tiles:
                    k_lo, k_hi = j * bn, (j + 1) * bn - 1
                    if causal and not (k_lo <= qb and (
                            not window or k_hi > qa - window)):
                        continue                # no live key for these rows
                    jk = torch.arange(k_lo, min(sk, k_hi + 1))[None, :]
                    s = (rows @ kh[k_lo:k_hi + 1].T) * scale2
                    valid = jk < sk
                    if causal:
                        valid = valid & (jk <= iq)
                        if window:
                            valid = valid & (jk > iq - window)
                    s = torch.where(valid, s, NEG_INF)
                    m_new = torch.maximum(m, s.max(1, keepdim=True).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new)
                    l = l * alpha + p.sum(1, keepdim=True)
                    vt = vh[k_lo:k_hi + 1]
                    p_hi = bf16(p)
                    acc = acc * alpha + p_hi @ vt
                    if split_p:
                        acc = acc + bf16(p - p_hi) @ vt
                    m = m_new
                out[h, qa:qa + WG_ROWS] = acc / torch.clamp(l, min=1e-30)
    return out.bfloat16()


def _inputs(bh, bh_kv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((bh_kv, sk, d)).astype(np.float32)
            for _ in range(2))
    return tuple(torch.from_numpy(a).bfloat16() for a in (q, k, v))


CASES = [  # causal, sq, sk, window, bh, bh_kv
    (True, 256, 256, 0, 2, 2), (True, 384, 384, 100, 4, 1),
    (True, 130, 130, 0, 2, 1), (True, 200, 300, 0, 3, 3),
    (False, 130, 200, 0, 2, 1),
]


@pytest.mark.parametrize("d", [64, 96, 128, 192, 256])
@pytest.mark.parametrize("causal,sq,sk,window,bh,bh_kv", CASES)
def test_wgmma_attention_within_flash_close(causal, sq, sk, window, bh,
                                            bh_kv, d):
    q, k, v = _inputs(bh, bh_kv, sq, sk, d, seed=sq + d + bh)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, window=window)
    want = tfa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    got = flash_wgmma_emulated(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ok, err, ratio = tfa.flash_close(got, want)
    assert ok, (err, ratio)


@pytest.mark.parametrize("d", [64, 96, 128])
def test_one_bf16_rounding_of_p_misses_flash_close(d):
    """Without P's lo half (one bfloat16 rounding of each weight, up to
    2^-9 relative) the kernel would miss its bound: the evidence that the
    split is needed at every head dim."""
    q, k, v = _inputs(2, 2, 256, 256, d, seed=d)
    kw = dict(scale=1.0 / math.sqrt(d), causal=True, window=0)
    want = tfa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    split = tfa.flash_close(flash_wgmma_emulated(q, k, v, **kw), want)
    once = tfa.flash_close(
        flash_wgmma_emulated(q, k, v, split_p=False, **kw), want)
    assert split[0] and split[2] <= 1.0 < once[2]


@pytest.mark.parametrize("causal,sq,sk,window,bh,bh_kv", CASES)
def test_wgmma_attention_at_a_padded_head_dim(causal, sq, sk, window, bh,
                                              bh_kv):
    """Head dim 80 as the card runs it: q, k and v with 16 zero columns in
    the 96 instantiation (TMA fills them), the output cut back to 80
    columns, within ``flash_close`` of the plain version at 80."""
    d = 80
    q, k, v = _inputs(bh, bh_kv, sq, sk, d, seed=sq + d + bh)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, window=window)
    pad = tfa.padded_head_dim(d) - d
    got = flash_wgmma_emulated(
        *(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v)), **kw)
    assert bool((got[..., d:] == 0).all())
    want = tfa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    ok, err, ratio = tfa.flash_close(got[..., :d], want)
    assert ok, (err, ratio)
