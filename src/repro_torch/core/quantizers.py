"""Moniqua's quantizer: the midpoint lattice, bit packing and the counter hash.

The Moniqua half of ``repro.core.quantizers``.  A quantizer ``Q_delta`` obeys
``||Q(x) - x||_inf <= delta`` on ``x in [-1/2, 1/2]^d``; the ``L = 2**bits``
codes index the midpoints of the ``L`` cells tiling ``[-1/2, 1/2)``.  Codes
pack ``8/bits`` to a uint8 along the last axis, so the payload is exactly
``bits/8`` bytes per parameter.

The counter hash draws the stochastic-rounding uniform of element ``idx``
from ``(seed, idx)`` alone, so every worker draws the same uniform for the
same element (shared randomness, Supp. C) and the CUDA encode kernel and
its plain version agree bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

_U32 = 0xFFFFFFFF


def delta_for_bits(bits: int, stochastic: bool = True) -> float:
    """Worst-case error of a ``bits``-wide midpoint-lattice quantizer:
    ``1/L`` for stochastic rounding, ``1/(2L)`` for nearest."""
    levels = 2 ** bits
    if levels < 2:
        raise ValueError(f"need at least 1 bit, got {bits}")
    return (1.0 / levels) if stochastic else (1.0 / (2.0 * levels))


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a quantizer.

    Attributes:
      bits: code width per parameter (1, 2, 4 or 8 for packable widths).
      stochastic: unbiased stochastic rounding if True, nearest (biased) if False.
      shared_randomness: reuse one uniform draw across all workers (Supp. C).
    """
    bits: int = 8
    stochastic: bool = True
    shared_randomness: bool = True

    @property
    def levels(self) -> int:
        return 2 ** self.bits

    @property
    def delta(self) -> float:
        return delta_for_bits(self.bits, self.stochastic)

    @property
    def values_per_byte(self) -> int:
        if self.bits not in (1, 2, 4, 8):
            raise ValueError(f"unpackable bit width {self.bits}")
        return 8 // self.bits


def packed_last_dim(n: int, bits: int) -> int:
    vpb = 8 // bits
    return -(-n // vpb)  # ceil div


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer codes (< 2**bits) into uint8 along the last axis; the
    code at column ``b*vpb + s`` lands in bits ``[s*bits, (s+1)*bits)`` of
    byte ``b``.  Pads the last axis with zero codes to a multiple of vpb."""
    codes = codes.to(torch.uint8)
    if bits == 8:
        return codes
    vpb = 8 // bits
    pad = (-codes.shape[-1]) % vpb
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    grouped = codes.reshape(*codes.shape[:-1], -1, vpb)
    packed = torch.zeros(grouped.shape[:-1], dtype=torch.uint8,
                         device=codes.device)
    for j in range(vpb):
        packed = packed | (grouped[..., j] << (j * bits))
    return packed


def unpack_codes(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; ``n`` is the original last-axis length."""
    if bits == 8:
        return packed
    vpb = 8 // bits
    mask = 2 ** bits - 1
    parts = [(packed >> (j * bits)) & mask for j in range(vpb)]
    codes = torch.stack(parts, dim=-1).reshape(*packed.shape[:-1], -1)
    return codes[..., :n]


def _counter_uniform(seed, idx: torch.Tensor) -> torch.Tensor:
    """murmur3-finalizer hash of ``(seed, idx)`` -> uniform f32 in [0, 1).

    The reference hashes in uint32.  PyTorch has no right shift on uint32
    tensors on the CPU, so this computes in int64 holding uint32 values and
    masks to 32 bits after each multiply: int64 products wrap, and their
    low 32 bits are the uint32 product's.  ``idx`` is an integer tensor of
    uint32 values; ``seed`` an int or integer tensor.
    """
    h = ((idx.to(torch.int64) & _U32) * 0x9E3779B9) & _U32
    if isinstance(seed, torch.Tensor):
        h = h ^ (seed.to(torch.int64) & _U32)
    else:
        h = h ^ (int(seed) & _U32)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
