"""The arithmetic the CUDA codec kernels' bit-exactness rests on.

The encode and decode-reduce kernels (``kernels/csrc/moniqua_encode.cu``,
``moniqua_decode_reduce.cu``) cannot run on the CPU.  Decode-reduce does
not divide a code by ``2^bits``: it multiplies by ``2^-bits`` and reads a
code's value from a ``2^bits``-entry table built once per CTA.  This file
pins, in plain PyTorch on the CPU, that both give the reference's float:

* ``((c + 1/2) / 2^bits - 1/2) * B`` is the same float with the division
  replaced by a multiply by ``2^-bits``, for every code and a spread of B
  (``(c + 1/2) >= 1/2``, so the quotient is exact and no subnormal arises);
* the table, indexed by the codes the JAX package unpacks from a random
  payload, equals the JAX package's ``value_ref`` on that payload.

The kernels' row split and lane data movement are held on the card, where
they run: ``chip_smoke.py`` phase 2 checks both kernels bitwise against
their plain versions at rows of every alignment, payload views one to three
bytes in included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as jq
from repro.kernels import ref as jref
from repro_torch.core import modulo
from repro_torch.core.quantizers import delta_for_bits

BITS = [1, 2, 4, 8]
COLS = [1, 17, 1003, 4096, 272282]


def _B_values():
    """The B of every spec at theta 2.0 (the main path's and phase 2's),
    0.7 (phase 2's 1-bit stochastic stand-in), and a spread of magnitudes."""
    bs = [float(modulo.b_theta(2.0, delta_for_bits(b, s), "cpu"))
          for b in BITS for s in (True, False) if delta_for_bits(b, s) < 0.5]
    bs += [0.7, 1.0, 2.0 ** -20, 2.0 ** 20, 3.0e-7, 12345.678]
    rng = np.random.default_rng(0)
    bs += list(10.0 ** rng.uniform(-6, 6, 64))
    return torch.tensor(bs, dtype=torch.float32)


def _table(bits, B):
    """The kernel's table: ((c + 0.5) * 2^-bits - 0.5) * B, one float32 op
    at a time, for every code c (rows) and every B (columns)."""
    c = torch.arange(2 ** bits, dtype=torch.float32)[:, None]
    return ((c + 0.5) * (2.0 ** -bits) - 0.5) * B[None, :]


@pytest.mark.parametrize("bits", BITS)
def test_value_multiply_equals_divide(bits):
    B = _B_values()
    c = torch.arange(2 ** bits, dtype=torch.float32)[:, None]
    divided = ((c + 0.5) / (2 ** bits) - 0.5) * B[None, :]
    assert torch.equal(_table(bits, B).view(torch.int32),
                       divided.view(torch.int32))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("cols", COLS)
def test_value_table_equals_reference(bits, cols):
    """A row of ``cols`` codes, packed as the encode packs it: the table
    indexed by the reference's unpacked codes is the reference's value."""
    rng = np.random.default_rng(cols * 8 + bits)
    pcols = -(-cols // (8 // bits))
    packed = rng.integers(0, 256, (2, pcols), dtype=np.uint8)
    codes = np.asarray(jq.unpack_codes(jnp.asarray(packed), bits, cols))
    for B in _B_values()[::7]:
        want = np.asarray(jref.value_ref(jnp.asarray(packed), float(B),
                                         bits))[:, :cols]
        got = _table(bits, B[None])[:, 0][torch.from_numpy(
            codes.astype(np.int64))]
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
