"""Moniqua single-payload decode: unpack, dequantize, modulo-recover.

The counterpart of the reference's Pallas ``kernels/moniqua_decode.py``:
:func:`decode` launches the CUDA kernel ``csrc/moniqua_decode.cu`` for CUDA
tensors and runs :func:`decode_plain` for CPU tensors.  Given a packed
payload ``[rows, ceil(cols / vpb)]`` and the local reference ``y [rows,
cols]``, with ``q * B`` the payload's dequantized value:

    mode="remote":  x_hat = cmod(q*B - y, B) + y      (Algorithm 1 line 5)
    mode="self":    x_hat = q*B - cmod(y, B) + y      (line 4)

in ``y``'s dtype.  Columns past a row's end are neither read nor written.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels import ref as kref

MODES = ("remote", "self")
_DTYPES = (torch.float32, torch.bfloat16)


def decode_plain(packed: torch.Tensor, y: torch.Tensor, B: torch.Tensor, *,
                 bits: int, mode: str = "remote") -> torch.Tensor:
    """Plain PyTorch decode (the kernel's exact semantics): the reference's
    ``decode_ref`` / ``decode_self_ref`` on ``y`` zero-padded to whole
    bytes, cut back to ``y``'s columns and cast to ``y``'s dtype."""
    cols = y.shape[-1]
    pad = packed.shape[-1] * (8 // bits) - cols
    yp = F.pad(y, (0, pad)) if pad else y
    fn = kref.decode_ref if mode == "remote" else kref.decode_self_ref
    return fn(packed, yp, B, bits)[..., :cols].to(y.dtype)


def decode(packed: torch.Tensor, y: torch.Tensor, B: torch.Tensor, *,
           bits: int, mode: str = "remote") -> torch.Tensor:
    """Decode ``packed [rows, ceil(cols/vpb)]`` against ``y [rows, cols]``.

    A CUDA tensor launches the kernel (one launch, counted in
    ``decode.launches``); CPU tensors take :func:`decode_plain`.  Under
    ``cost.counting`` each call charges the kernel's FLOPs and bytes, and
    ``meta`` tensors get an empty output."""
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"unpackable bit width {bits}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if y.dim() != 2:
        raise ValueError(f"y must be [rows, cols], got {tuple(y.shape)}")
    rows, cols = y.shape
    pshape = (rows, -(-cols // (8 // bits)))
    if tuple(packed.shape) != pshape:
        raise ValueError(f"payload shape {tuple(packed.shape)} does not "
                         f"match y {tuple(y.shape)} at {bits} bits")
    if packed.dtype != torch.uint8:
        raise TypeError("payload must be uint8")
    if y.dtype not in _DTYPES:
        raise TypeError(f"y must be float32 or bfloat16, got {y.dtype}")
    cost.charge("moniqua_decode", cost.DECODE_OPS * y.numel(),
                cost.nbytes(packed, y) + cost.nbytes(y))
    if y.device.type == "meta":
        return cost.meta_output("moniqua_decode", y.shape, y.dtype)
    if y.device.type == "cpu":
        with cost.plain():
            return decode_plain(packed, y, B, bits=bits, mode=mode)
    if y.device.type != "cuda":
        raise ValueError(f"no decode for device {y.device}")
    for name, t in (("packed", packed), ("y", y)):
        if t.device != y.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {y.device}")
    if B.device != y.device or B.dtype != torch.float32 or B.numel() != 1:
        raise ValueError("B must be one float32 on y's device")
    out = torch.empty_like(y)
    lib = build.load("moniqua_decode")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moniqua_decode(
            ctypes.c_void_p(packed.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            int(y.dtype == torch.bfloat16), ctypes.c_void_p(out.data_ptr()),
            rows, cols, ctypes.c_void_p(B.data_ptr()), bits,
            int(mode == "self"), ctypes.c_void_p(stream))
    build.check(err, "moniqua_decode")
    decode.launches += 1
    return out


decode.launches = 0
