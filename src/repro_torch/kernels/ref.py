"""Plain PyTorch versions of the Moniqua codec kernels.

The exact semantics the CUDA kernels reproduce bit for bit: ported from the
reference's ``kernels/ref.py`` (encode, point decode; packing is
``core.quantizers.pack_codes``/``unpack_codes``) and from
the math its fused decode-reduce shares between kernel and jnp path
(``moniqua_decode_reduce.py::unpack_values`` / ``decode_reduce_values``).
They are the CPU path of every wrapper and the oracle the card's kernels are
held against.

Bit-exactness rests on the same float32 operations in the same order: one
PyTorch op per reference op, never ``alpha=``, ``addcmul`` or ``lerp`` (which
may fuse a multiply and an add), and every divisor on the dividend's device
(CUDA multiplies by the reciprocal of a CPU scalar divisor).  Encode divides,
``x / B``, as the reference's jnp engine path does.
"""
from __future__ import annotations

import torch

from repro_torch.core.modulo import _scalar, cmod
from repro_torch.core.quantizers import _U32, pack_codes, unpack_codes
from repro_torch.core.quantizers import _counter_uniform as hash_uniform


def codes_ref(x: torch.Tensor, B, bits: int, stochastic: bool, seed,
              idx: torch.Tensor) -> torch.Tensor:
    """Quantization codes of ``Q_delta((x/B) mod 1)`` (Algorithm 1 line 3).
    ``idx`` (counter indices, uint32 values) broadcasts against ``x``."""
    levels = 2 ** bits
    xf = x.float()
    r = cmod(xf / _scalar(B, xf), 1.0)             # [-1/2, 1/2)
    lat = (r + 0.5) * levels - 0.5                  # midpoint lattice
    if stochastic:
        c = torch.floor(lat + hash_uniform(seed, idx))
    else:
        c = torch.floor(lat + 0.5)
    return torch.clamp(c, 0, levels - 1).to(torch.uint8)


def encode_ref(x: torch.Tensor, B, bits: int, stochastic: bool, seed,
               idx_base: int = 0) -> torch.Tensor:
    """Full encode: x -> packed uint8.  Last dim must divide values-per-byte.
    Element ``e`` (row-major) hashes ``(seed, idx_base + e)``."""
    idx = ((int(idx_base) + torch.arange(x.numel(), dtype=torch.int64,
                                         device=x.device)) & _U32)
    codes = codes_ref(x, B, bits, stochastic, seed, idx.reshape(x.shape))
    return pack_codes(codes, bits)


def value_ref(packed: torch.Tensor, B, bits: int) -> torch.Tensor:
    """Unpack + dequantize + rescale: the transmitted value ``q * B``."""
    levels = 2 ** bits
    c = unpack_codes(packed, bits, packed.shape[-1] * (8 // bits)).float()
    return ((c + 0.5) / levels - 0.5) * _scalar(B, c)


def decode_ref(packed: torch.Tensor, y: torch.Tensor, B, bits: int
               ) -> torch.Tensor:
    """Lemma 1 recovery against local reference ``y``."""
    qb = value_ref(packed, B, bits)
    yf = y.float()
    return cmod(qb - yf, B) + yf


def decode_self_ref(packed: torch.Tensor, x: torch.Tensor, B, bits: int
                    ) -> torch.Tensor:
    """Algorithm 1 line 4: sender-side biased reconstruction."""
    qb = value_ref(packed, B, bits)
    xf = x.float()
    return qb - cmod(xf, B) + xf


# ---------------------------------------------------------------------------
# Fused decode-reduce math (reference: moniqua_decode_reduce.py:57-85; its
# ``unpack_values`` is ``value_ref`` above).
# ---------------------------------------------------------------------------

def decode_reduce_values(qb_self: torch.Tensor, qb_nbrs, y: torch.Tensor, B,
                         weights) -> torch.Tensor:
    """Algorithm 1 lines 4-6 on dequantized payload values: neighbors are
    accumulated in offset order, ``acc = acc + w_s * (xhat_s - xhat_self)``,
    then ``out = y + acc``."""
    y = y.float()
    B = _scalar(B, y)
    ymod = y - B * torch.floor(y / B + 0.5)            # cmod(y, B)
    xhat_self = qb_self - ymod + y                      # line 4
    acc = torch.zeros_like(y)
    for qb, w in zip(qb_nbrs, weights):
        d = qb - y
        xhat = (d - B * torch.floor(d / B + 0.5)) + y   # line 5
        acc = acc + _scalar(w, y) * (xhat - xhat_self)
    return y + acc                                      # line 6
