"""Moniqua encode (rescale -> mod -> round -> bit-pack) on a stacked buffer.

The counterpart of the reference's Pallas ``kernels/moniqua_encode.py``:
``encode`` launches the CUDA kernel ``csrc/moniqua_encode.cu`` for a CUDA
tensor and runs :func:`encode_plain` for a CPU tensor.

The buffer is ``[workers, rows, cols]``: the worker axis is written out (the
reference vmaps its tile layout over it).  The counter index of element
``(r, c)`` is ``idx_base + (r // rows_per_block) * block_stride + (r %
rows_per_block) * idx_row_stride + c (mod 2^32)`` for every worker; the
stride defaults to ``cols_padded``, ``cols`` rounded up to values-per-byte
(each worker's row is zero-padded to a byte boundary, and all workers
share one uniform per element, Supp. C), and one block holds every row
(``rows_per_block = rows``, ``block_stride = 0``), so the index is
``idx_base + r * idx_row_stride + c``.  Another stride and blocks let a
shard of a leaf split on one or two dims hash the indices the whole leaf
hashes in one process (``comm/tensor_parallel.split_view``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.quantizers import _U32, pack_codes
from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels import ref as kref

_DTYPES = (torch.float32, torch.bfloat16)


def row_bases(rows: int, idx_base: int, stride: int,
              rows_per_block: Optional[int], block_stride: int,
              device=None) -> torch.Tensor:
    """The counter index of column 0 of each row, int64 ``[rows, 1]``
    (not yet reduced mod 2^32)."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    if rows_per_block is None or rows_per_block >= rows:
        return int(idx_base) + stride * r
    rpb = int(rows_per_block)
    return (int(idx_base) + int(block_stride) * torch.div(
        r, rpb, rounding_mode="floor") + stride * torch.remainder(r, rpb))


def encode_plain(x: torch.Tensor, B: torch.Tensor, seed: int, *, bits: int,
                 stochastic: bool, idx_base: int = 0,
                 idx_row_stride: Optional[int] = None,
                 rows_per_block: Optional[int] = None,
                 block_stride: int = 0) -> torch.Tensor:
    """Plain PyTorch encode of ``x [n, rows, cols]`` -> uint8
    ``[n, rows, ceil(cols / vpb)]`` (the kernel's exact semantics)."""
    n, rows, cols = x.shape
    vpb = 8 // bits
    pad = (-cols) % vpb
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    stride = cols + pad if idx_row_stride is None else int(idx_row_stride)
    idx = (row_bases(rows, idx_base, stride, rows_per_block, block_stride,
                     x.device)
           + torch.arange(cols + pad, dtype=torch.int64,
                          device=x.device)) & _U32
    return pack_codes(kref.codes_ref(x, B, bits, stochastic, seed, idx), bits)


def encode(x: torch.Tensor, B: torch.Tensor, seed: int, *, bits: int,
           stochastic: bool, idx_base: int = 0,
           idx_row_stride: Optional[int] = None,
           rows_per_block: Optional[int] = None,
           block_stride: int = 0) -> torch.Tensor:
    """Encode ``x [n, rows, cols]`` (float32 or bfloat16, contiguous) with
    the 0-dim float32 ``B`` on ``x``'s device; ``idx_row_stride`` (default
    ``cols_padded``) is the counter step from one row to the next within a
    block of ``rows_per_block`` rows (default: every row), ``block_stride``
    from one block to the next (module docstring).
    Returns packed uint8 ``[n, rows, ceil(cols / vpb)]``.  A CUDA tensor
    launches the kernel (one launch, counted in ``encode.launches``); a CPU
    tensor takes :func:`encode_plain`.  Under ``cost.counting`` each call charges the
    kernel's FLOPs and bytes, and a ``meta`` tensor gets an empty payload."""
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"unpackable bit width {bits}")
    if x.dim() != 3:
        raise ValueError(f"encode takes [workers, rows, cols], got {x.shape}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"encode takes float32 or bfloat16, got {x.dtype}")
    n, rows, cols = x.shape
    pshape = (n, rows, -(-cols // (8 // bits)))
    cost.charge("moniqua_encode", cost.ENCODE_OPS * x.numel(),
                cost.nbytes(x) + n * rows * pshape[2])
    if x.device.type == "meta":
        return cost.meta_output("moniqua_encode", pshape, torch.uint8)
    if x.device.type == "cpu":
        with cost.plain():
            return encode_plain(x, B, seed, bits=bits, stochastic=stochastic,
                                idx_base=idx_base,
                                idx_row_stride=idx_row_stride,
                                rows_per_block=rows_per_block,
                                block_stride=block_stride)
    if x.device.type != "cuda":
        raise ValueError(f"no encode for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("encode needs a contiguous x")
    if (B.device != x.device or B.dtype != torch.float32 or B.numel() != 1):
        raise ValueError("B must be one float32 on x's device")
    stride = (pshape[2] * (8 // bits) if idx_row_stride is None
              else int(idx_row_stride))
    rpb = rows if rows_per_block is None else int(rows_per_block)
    if rpb < 1:
        raise ValueError(f"rows_per_block {rpb} < 1")
    out = torch.empty(pshape, dtype=torch.uint8, device=x.device)
    lib = build.load("moniqua_encode")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moniqua_encode(
            ctypes.c_void_p(x.data_ptr()), int(x.dtype == torch.bfloat16),
            ctypes.c_void_p(out.data_ptr()), n * rows, rows, cols,
            ctypes.c_void_p(B.data_ptr()), int(seed) & _U32,
            int(idx_base) & _U32, stride & _U32, rpb,
            int(block_stride) & _U32, bits,
            int(bool(stochastic)), ctypes.c_void_p(stream))
    build.check(err, "moniqua_encode")
    encode.launches += 1
    return out


encode.launches = 0
