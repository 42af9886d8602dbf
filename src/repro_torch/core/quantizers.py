"""Quantizers: Moniqua's midpoint lattice, bit packing, the counter hash,
and the scale+codes and error-feedback codecs of the other wires.

A quantizer ``Q_delta`` obeys ``||Q(x) - x||_inf <= delta`` on
``x in [-1/2, 1/2]^d``; the ``L = 2**bits`` codes index the midpoints of the
``L`` cells tiling ``[-1/2, 1/2)``.  Codes pack ``8/bits`` to a uint8 along
the last axis, so the payload is exactly ``bits/8`` bytes per parameter.

The counter hash draws the stochastic-rounding uniform of element ``idx``
from ``(seed, idx)`` alone, so every worker draws the same uniform for the
same element (shared randomness, Supp. C) and the CUDA encode kernel and
its plain version agree bit for bit.

The ``qsgd`` / ``ef_qsgd`` / ``onebit`` codecs are plain PyTorch ops, the
same float32 operations in the same order as the reference's jnp ones; only
onebit's per-segment sums may take another order than XLA's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

_U32 = 0xFFFFFFFF


def delta_for_bits(bits: int, stochastic: bool = True) -> float:
    """Worst-case error of a ``bits``-wide midpoint-lattice quantizer:
    ``1/L`` for stochastic rounding, ``1/(2L)`` for nearest."""
    levels = 2 ** bits
    if levels < 2:
        raise ValueError(f"need at least 1 bit, got {bits}")
    return (1.0 / levels) if stochastic else (1.0 / (2.0 * levels))


def bits_for_delta(delta: float) -> int:
    """Paper Sec. 4: ``B <= ceil(log2(1/(2 delta) + 1))``."""
    return int(np.ceil(np.log2(1.0 / (2.0 * delta) + 1.0)))


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


# ---------------------------------------------------------------------------
# Code <-> value maps of the midpoint lattice: codes 0..L-1 index the
# midpoints of the L cells tiling [-1/2, 1/2).
# ---------------------------------------------------------------------------

def _to_lattice(x: torch.Tensor, levels: int) -> torch.Tensor:
    return (x.float() + 0.5) * levels - 0.5


def _from_lattice(c: torch.Tensor, levels: int) -> torch.Tensor:
    f = c.float()
    return (f + 0.5) / torch.as_tensor(float(levels), device=f.device) - 0.5


def quantize_codes(x: torch.Tensor, spec: QuantSpec,
                   uniforms: Optional[torch.Tensor] = None, *,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Quantize ``x`` in ``[-1/2, 1/2]`` to integer codes in ``[0, levels)``.

    Stochastic mode is ``floor(lattice(x) + u)`` with ``u`` in ``[0, 1)``:
    the handed-in ``uniforms`` (shaped like ``x``; the parity tests hand in
    the reference's ``jax.random.uniform`` draws), else one draw from
    ``generator`` (on ``x``'s device).  Nearest mode rounds half up.  Values
    outside the box clamp to the lattice ends.  Codes are uint8 (int64 for
    an unpackable width above 8 bits, where the reference uses uint32)."""
    lat = _to_lattice(x, spec.levels)
    if spec.stochastic:
        if uniforms is None:
            if generator is None:
                raise ValueError("stochastic rounding needs uniforms= or a "
                                 "torch.Generator")
            uniforms = torch.rand(x.shape, generator=generator,
                                  device=x.device)
        codes = torch.floor(lat + uniforms)
    else:
        codes = torch.floor(lat + 0.5)
    codes = torch.clamp(codes, 0, spec.levels - 1)
    return codes.to(torch.uint8 if spec.bits <= 8 else torch.int64)


def dequantize_codes(codes: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Codes -> lattice midpoints in ``[-1/2, 1/2)``, float32."""
    return _from_lattice(codes, spec.levels)


def quantize(x: torch.Tensor, spec: QuantSpec,
             uniforms: Optional[torch.Tensor] = None, *,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``Q_delta(x)``: quantize-then-dequantize (the value-space round
    trip)."""
    return dequantize_codes(quantize_codes(x, spec, uniforms,
                                           generator=generator), spec)


# ---------------------------------------------------------------------------
# QSGD-style scale + codes codec (Alistarh et al., 2017): the sender
# normalises by its own max-norm, quantizes on the same midpoint lattice and
# ships (packed codes, f32 scale): bits/8 bytes per parameter plus 4 bytes
# per tensor per worker.
# ---------------------------------------------------------------------------

def _lattice_codes(lat: torch.Tensor, levels: int, u) -> torch.Tensor:
    """``floor(lat + u)`` (``u`` the rounding uniforms, or ``None`` for
    nearest: ``floor(lat + 1/2)``) clipped to ``[0, levels)``, as uint8."""
    c = torch.floor(lat + (0.5 if u is None else u))
    return torch.clamp(c, 0, levels - 1).to(torch.uint8)


def qsgd_encode(x: torch.Tensor, spec: QuantSpec, seed=None,
                worker_axis: bool = True, row_base: int = 0):
    """Encode ``x`` -> (packed codes, scale).  With ``worker_axis`` the
    leading dim indexes workers and each row gets its own max-norm scale
    (shape ``[n, 1, ..., 1]``); otherwise one scale covers the tensor.  The
    uniform of element ``e`` (row-major over the whole tensor) hashes
    ``(seed, e)``; ``row_base`` is the global index of ``x``'s first row
    when ``x`` is a rank's block of the worker dim."""
    xf = x.float()
    a = torch.abs(xf)
    if worker_axis and x.dim() > 1:
        scale = torch.amax(a, dim=tuple(range(1, x.dim())), keepdim=True)
    else:
        scale = torch.amax(a).reshape((1,) * x.dim())
    scale = scale + 1e-12
    lat = _to_lattice(xf / (2.0 * scale), spec.levels)
    u = None
    if spec.stochastic:
        if seed is None:
            raise ValueError("stochastic QSGD rounding needs a seed")
        idx = torch.arange(x.numel(), dtype=torch.int64,
                           device=x.device).reshape(x.shape)
        if row_base:
            idx = idx + row_base * (x.numel() // max(x.shape[0], 1))
        u = _counter_uniform(seed, idx)
    return pack_codes(_lattice_codes(lat, spec.levels, u), spec.bits), scale


def qsgd_decode(packed: torch.Tensor, scale: torch.Tensor, spec: QuantSpec,
                last_dim: int) -> torch.Tensor:
    """Inverse of :func:`qsgd_encode`: codes -> values in [-scale, scale]."""
    codes = unpack_codes(packed, spec.bits, last_dim)
    return _from_lattice(codes, spec.levels) * (2.0 * scale)


@functools.lru_cache(maxsize=256)
def _segment_index(segments: Tuple[int, ...],
                   device: torch.device) -> torch.Tensor:
    """Segment id of every column of a flat bucket (int64 ``[D]``)."""
    sizes = torch.tensor(segments, dtype=torch.int64)
    ids = torch.repeat_interleave(torch.arange(len(segments)), sizes)
    return ids.to(device)


def _segment_scale_map(scales: torch.Tensor,
                       segments: Tuple[int, ...]) -> torch.Tensor:
    """Broadcast per-segment values ``[n, L]`` to element width ``[n, D]``
    (one gather; ``segments`` holds the static per-segment lengths)."""
    return scales.index_select(
        1, _segment_index(tuple(segments), scales.device))


def _segment_max_abs(xf: torch.Tensor, segments) -> torch.Tensor:
    """Per-segment max-norm ``[n, L]`` of a flat ``[n, D]`` buffer, plus
    the codec's 1e-12 (a max is exact in any order)."""
    a = torch.abs(xf)
    parts, off = [], 0
    for size in segments:
        parts.append(torch.amax(a[:, off:off + size], dim=1, keepdim=True))
        off += size
    return torch.cat(parts, dim=1) + 1e-12


def qsgd_encode_segmented(x: torch.Tensor, spec: QuantSpec, seed,
                          segments: Tuple[int, ...], idx_base: int = 0,
                          idx_stride: Optional[int] = None,
                          row_base: int = 0):
    """QSGD on a flat ``[n, D]`` bucket with one scale per *segment* (the
    tensors' contiguous ranges, ``BucketLayout.segment_sizes``).  Returns
    (packed codes ``[n, D*bits/8]``, scales ``[n, L]``).

    The uniform of element ``(w, e)`` hashes the counter
    ``w * idx_stride + idx_base + e`` mod 2^32; a chunked encode passes the
    chunk's buffer offset and the whole buffer's width, so every element
    hashes the pair it hashes in the one-shot encode.  ``w`` counts from
    ``row_base``, the global index of ``x``'s first row (a rank's block of
    a split worker dim)."""
    xf = x.float()
    scales = _segment_max_abs(xf, segments)
    smap = _segment_scale_map(scales, segments)
    lat = _to_lattice(xf / (2.0 * smap), spec.levels)
    u = None
    if spec.stochastic:
        if seed is None:
            raise ValueError("stochastic QSGD rounding needs a seed")
        n, d = x.shape
        stride = d if idx_stride is None else int(idx_stride)
        dev = x.device
        idx = ((torch.arange(n, dtype=torch.int64, device=dev)[:, None]
                + int(row_base))
               * stride + torch.arange(d, dtype=torch.int64, device=dev)
               + (int(idx_base) & _U32)) & _U32
        u = _counter_uniform(seed, idx)
    return (pack_codes(_lattice_codes(lat, spec.levels, u), spec.bits),
            scales)


def qsgd_decode_segmented(packed: torch.Tensor, scales: torch.Tensor,
                          spec: QuantSpec, segments) -> torch.Tensor:
    """Inverse of :func:`qsgd_encode_segmented` on the flat bucket."""
    codes = unpack_codes(packed, spec.bits, sum(segments))
    smap = _segment_scale_map(scales, segments)
    return _from_lattice(codes, spec.levels) * (2.0 * smap)


def qsgd_payload_bytes(x_shape: Tuple[int, ...], bits: int) -> int:
    """Wire bytes for one tensor: packed codes + one f32 scale."""
    if not x_shape:
        return 1 + 4
    inner = int(np.prod(x_shape[:-1], dtype=np.int64))
    return inner * packed_last_dim(x_shape[-1], bits) + 4


# ---------------------------------------------------------------------------
# Error-feedback codecs (EF-QSGD; the 1-bit Adam wire).  Their stochastic
# rounding draws one uniform per flat *row position* (``idx_base + e``),
# hashed worker-free: every worker, and both gossip paths, draw the same
# uniform for an element.
# ---------------------------------------------------------------------------

def _position_uniform(seed, idx_base: int, width: int,
                      device) -> torch.Tensor:
    """``[1, width]`` uniforms hashed from the flat row position only."""
    idx = (torch.arange(width, dtype=torch.int64, device=device)
           + (int(idx_base) & _U32)) & _U32
    return _counter_uniform(seed, idx)[None, :]


def ef_qsgd_encode_segmented(v: torch.Tensor, spec: QuantSpec, seed,
                             segments: Tuple[int, ...], idx_base: int = 0):
    """QSGD codes of an error-compensated flat ``[n, D]`` bucket ``v = x +
    residual``: the scale+codes wire of :func:`qsgd_encode_segmented`, its
    uniforms from the worker-free row-position hash."""
    vf = v.float()
    scales = _segment_max_abs(vf, segments)
    smap = _segment_scale_map(scales, segments)
    lat = _to_lattice(vf / (2.0 * smap), spec.levels)
    u = None
    if spec.stochastic:
        if seed is None:
            raise ValueError("stochastic EF-QSGD rounding needs a seed")
        u = _position_uniform(seed, idx_base, vf.shape[-1], vf.device)
    return (pack_codes(_lattice_codes(lat, spec.levels, u), spec.bits),
            scales)


def onebit_encode_segmented(v: torch.Tensor, seed,
                            segments: Tuple[int, ...], idx_base: int = 0,
                            stochastic: bool = False):
    """1-bit sign codes with per-segment cluster-mean levels: ``lo`` the
    mean of a segment's negative values, ``hi`` of its non-negative ones;
    code 1 decodes to exactly ``hi``, code 0 to ``lo``.  Nearest mode codes
    the sign; stochastic mode picks ``hi`` with probability
    ``(v - lo) / (hi - lo)`` (clipped), from the row-position hash.
    Returns ``(packed bits, lo [n, L], hi [n, L])``.

    Each segment's three sums (count, positive sum, negative sum) are one
    ``torch.sum`` over a contiguous ``[3, n, size]`` stack, so a segment
    sums in the same order whichever buffer it was cut from."""
    vf = v.float()
    pos = vf >= 0.0
    stack = torch.stack([pos.float(), torch.where(pos, vf, 0.0),
                         torch.where(pos, 0.0, vf)])
    los, his, off = [], [], 0
    for size in segments:
        s = torch.sum(stack[:, :, off:off + size].contiguous(), dim=2,
                      keepdim=True)
        n_pos, pos_sum, neg_sum = s[0], s[1], s[2]
        his.append(pos_sum / torch.clamp(n_pos, min=1.0))
        los.append(neg_sum / torch.clamp(size - n_pos, min=1.0))
        off += size
    lo = torch.cat(los, dim=1)
    hi = torch.cat(his, dim=1)
    if stochastic:
        if seed is None:
            raise ValueError("stochastic 1-bit rounding needs a seed")
        lomap = _segment_scale_map(lo, segments)
        span = _segment_scale_map(hi, segments) - lomap
        lat = torch.clamp((vf - lomap) / torch.where(span > 0, span, 1.0),
                          0.0, 1.0)
        u = _position_uniform(seed, idx_base, vf.shape[-1], vf.device)
        codes = torch.clamp(torch.floor(lat + u), 0, 1).to(torch.uint8)
    else:
        codes = pos.to(torch.uint8)
    return pack_codes(codes, 1), lo, hi


def onebit_decode_segmented(packed: torch.Tensor, lo: torch.Tensor,
                            hi: torch.Tensor, segments) -> torch.Tensor:
    """Inverse of :func:`onebit_encode_segmented`: select lo/hi per bit."""
    codes = unpack_codes(packed, 1, sum(segments))
    return torch.where(codes.bool(), _segment_scale_map(hi, segments),
                       _segment_scale_map(lo, segments))


def onebit_payload_bytes(x_shape: Tuple[int, ...]) -> int:
    """Steady-state wire bytes for one tensor: 1 bit/param + lo/hi words."""
    if not x_shape:
        return 1 + 8
    inner = int(np.prod(x_shape[:-1], dtype=np.int64))
    return inner * packed_last_dim(x_shape[-1], 1) + 8
