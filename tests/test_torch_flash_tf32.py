"""The numerics behind the float32 tensor-core flash kernel, on the CPU.

``csrc/flash_attention_f32tc.cu`` takes both products of attention, S = Q
K^T and O += P V, as 3xTF32: each operand splits as ``hi = tf32(x)`` and
``lo = tf32(x - hi)`` (``cvt.rna.tf32.f32``: round to nearest, ties away
from zero, to 10 mantissa bits), and a product is ``lo_a hi_b + hi_a lo_b +
hi_a hi_b`` with float32 sums.  The card is not here, so this emulates the
kernel's arithmetic in torch: TF32 operands held in float32 (their products
are exact in float32: 11 x 11 significant bits), float32 sums, and the
kernel's loop: its query blocks and key tiles at each head dim
(:func:`tiles`) over the live tiles the kernel walks, and its online
softmax in base 2 (``exp2`` of the score times ``scale * log2(e)``,
rounded to float32, less the running max).  A head dim between
instantiations runs in the next one up with zero columns.

* The split reconstructs x within 2^-21 relative (where x - hi is not
  subnormal: TF32 keeps float32's exponent range, so a subnormal lo keeps
  fewer bits; in attention those are absolute errors below 1e-38).
* 3xTF32 attention stays within the float32 tolerance of the reference
  tests, rtol = atol = 2e-5, of ``flash_attention_plain`` (held to the JAX
  reference's kernel in ``tests/test_torch_flash.py``), at phase 7's shapes
  cut small.
* One TF32 pass does not: the evidence that float32 needs the three.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on finite float32: keep 10 of 23 mantissa bits,
    rounding the magnitude to nearest with ties away from zero (adding half
    of the dropped field to the sign-magnitude bits carries into the kept
    ones exactly when the dropped part is at least half)."""
    bits = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.int().view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel takes it: the small products first."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def tiles(d: int):
    """(query rows of a block, keys of a tile) of the instantiation at
    head dim d."""
    if d <= 128:
        return 64, 64
    return (128, 64) if d <= 192 else (128, 32)


def live_tiles(q0: int, sk: int, causal: bool, window: int, bm: int,
               bn: int):
    """The key tiles the kernel walks for the query block at row q0."""
    nk = -(-sk // bn)
    if not causal:
        return range(nk)
    q_hi = q0 + bm - 1
    first = q0 - window + 1
    begin = first // bn if window and first > 0 else 0
    return range(begin, min(nk, q_hi // bn + 1))


def flash_emulated(q, k, v, *, scale, causal, window, matmul):
    """The kernel's loop on float32 q [BH, Sq, D], k/v [BH/g, Sk, D]."""
    bh, sq, d = q.shape
    g = bh // k.shape[0]
    sk = k.shape[1]
    bm, bn = tiles(d)
    # the kernel's scale * log2(e), one float32 product
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    out = torch.empty_like(q)
    rows = torch.arange(sq)[:, None]
    for h in range(bh):
        kh, vh = k[h // g], v[h // g]
        for q0 in range(0, sq, bm):
            qb = q[h, q0:q0 + bm]
            iq = rows[q0:q0 + bm]
            m = torch.full((qb.shape[0], 1), NEG_INF)
            l = torch.zeros((qb.shape[0], 1))
            acc = torch.zeros_like(qb)
            for j in live_tiles(q0, sk, causal, window, bm, bn):
                jk = torch.arange(j * bn, min(sk, (j + 1) * bn))[None, :]
                s = matmul(qb, kh[j * bn:(j + 1) * bn].T) * scale2
                valid = torch.ones_like(s, dtype=torch.bool)
                if causal:
                    valid = jk <= iq
                    if window:
                        valid = valid & (jk > iq - window)
                s = torch.where(valid, s, NEG_INF)
                m_new = torch.maximum(m, s.max(1, keepdim=True).values)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new)
                l = l * alpha + p.sum(1, keepdim=True)
                acc = acc * alpha + matmul(p, vh[j * bn:(j + 1) * bn])
                m = m_new
            out[h, q0:q0 + bm] = acc / torch.clamp(l, min=1e-30)
    return out


def _inputs(bh, bh_kv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((bh_kv, sk, d)).astype(np.float32)
            for _ in range(2))
    return torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)


def _worst(got, want):
    """max |got - want| / (2e-5 (1 + |want|)): at most 1 within the float32
    tolerance rtol = atol = 2e-5."""
    return float(((got - want).abs() / (2e-5 * (1 + want.abs()))).max())


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 3.7e4, 1e30])
def test_tf32_split_reconstructs_x(scale):
    rng = np.random.default_rng(int(math.log10(scale)) + 40)
    x = torch.from_numpy((rng.standard_normal(100_000) * scale)
                         .astype(np.float32))
    hi, lo = split(x)
    # both parts are TF32: the 13 low mantissa bits are zero
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (x.double() - (hi.double() + lo.double())).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    # one part alone keeps 11 bits: up to 2^-11 relative
    assert float(((x.double() - hi.double()).abs()
                  / x.double().abs()).max()) > 2.0 ** -14


def test_tf32_rounds_to_nearest_ties_away():
    one = torch.tensor(1.0)
    ulp = 2.0 ** -10                        # TF32's step at 1
    xs = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                       1 + 1.5 * ulp, 1 + ulp / 4])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 1.0])
    assert torch.equal(tf32(xs), want)
    assert torch.equal(tf32(one), one)


CASES = [  # causal, sq, sk, window, bh, bh_kv, d
    (True, 256, 256, 0, 2, 2, 64), (True, 384, 384, 32, 3, 1, 64),
    (True, 128, 128, 32, 2, 1, 128), (True, 130, 130, 0, 3, 1, 128),
    (False, 130, 256, 0, 2, 1, 64), (True, 256, 256, 0, 4, 2, 128),
    (True, 200, 300, 0, 3, 3, 128), (True, 384, 384, 0, 1, 1, 128),
    # head dim 96 (phi-3-vision-4.2b): GQA with a window, ragged, non-causal
    (True, 384, 384, 100, 4, 1, 96), (True, 130, 130, 0, 2, 2, 96),
    (True, 200, 300, 0, 4, 1, 96), (False, 130, 200, 0, 2, 1, 96),
    # head dims 192 and 256, with the tiles the kernel takes there
    (True, 384, 384, 100, 4, 2, 192), (True, 200, 300, 0, 2, 2, 192),
    (False, 130, 200, 0, 2, 1, 192), (True, 256, 256, 0, 4, 2, 256),
    (True, 384, 384, 100, 2, 1, 256), (False, 130, 256, 0, 2, 2, 256),
]


@pytest.mark.parametrize("causal,sq,sk,window,bh,bh_kv,d", CASES)
def test_3xtf32_attention_within_float32_tolerance(causal, sq, sk, window,
                                                   bh, bh_kv, d):
    q, k, v = _inputs(bh, bh_kv, sq, sk, d, seed=sq + d + bh)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, window=window)
    want = tfa.flash_attention_plain(q, k, v, **kw)
    got = flash_emulated(q, k, v, matmul=matmul_3xtf32, **kw)
    assert _worst(got, want) <= 1.0


@pytest.mark.parametrize("d", [64, 96, 128])
def test_one_tf32_pass_misses_float32_tolerance(d):
    q, k, v = _inputs(2, 1, 256, 256, d, seed=d)
    kw = dict(scale=1.0 / math.sqrt(d), causal=True, window=0)
    want = tfa.flash_attention_plain(q, k, v, **kw)
    three = _worst(flash_emulated(q, k, v, matmul=matmul_3xtf32, **kw), want)
    one = _worst(flash_emulated(q, k, v, matmul=matmul_1xtf32, **kw), want)
    assert three <= 1.0 < one


@pytest.mark.parametrize("causal,sq,sk,window,bh,bh_kv", [
    (True, 384, 384, 100, 4, 1), (True, 200, 300, 0, 2, 2),
    (False, 130, 200, 0, 2, 1)])
def test_3xtf32_attention_at_a_padded_head_dim(causal, sq, sk, window, bh,
                                               bh_kv):
    """Head dim 80 as the card runs it: q, k and v with 16 zero columns in
    the 96 instantiation (``cp.async`` fills them), the output cut back to
    80 columns, within the float32 tolerance of the plain version at 80."""
    d = 80
    q, k, v = _inputs(bh, bh_kv, sq, sk, d, seed=sq + d + bh)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal, window=window)
    pad = tfa.padded_head_dim(d) - d
    got = flash_emulated(
        *(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v)),
        matmul=matmul_3xtf32, **kw)
    assert bool((got[..., d:] == 0).all())
    want = tfa.flash_attention_plain(q, k, v, **kw)
    assert _worst(got[..., :d], want) <= 1.0
