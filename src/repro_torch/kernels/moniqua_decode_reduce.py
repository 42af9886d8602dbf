"""Moniqua fused decode-reduce: one gossip round's mixing in one pass.

The counterpart of the reference's Pallas ``kernels/moniqua_decode_reduce.py``:
``decode_reduce`` launches the CUDA kernel ``csrc/moniqua_decode_reduce.cu``
for CUDA tensors and runs :func:`decode_reduce_plain` for CPU tensors.
Given a worker's own packed payload, the stack of its neighbors' payloads
(already rolled along the worker axis) and its local model ``y``:

    out = y + sum_s  w_s * (x_hat_s - x_hat_self)

with ``x_hat_s = cmod(q_s - y, B) + y`` (line 5) and
``x_hat_self = q_self - cmod(y, B) + y`` (line 4).

:func:`unpack_values` (the dequantizing unpack the kernel math shares) and
:func:`alias_band_mask` (the telemetry's alias sentinel) are plain PyTorch,
as they are plain jnp in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.modulo import _scalar
from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels import ref as kref

MAX_NEIGHBORS = 8
_DTYPES = (torch.float32, torch.bfloat16)


def unpack_values(p: torch.Tensor, bits: int, B) -> torch.Tensor:
    """packed uint8 ``[..., P]`` -> dequantized float32 values scaled by
    ``B`` (``q * B``), ``[..., P * vpb]``: the kernels' shared unpack
    (``ref.value_ref``)."""
    return kref.value_ref(p, B, bits)


def alias_band_mask(qb: torch.Tensor, y: torch.Tensor, B, theta
                    ) -> torch.Tensor:
    """Modulo alias sentinel on one dequantized neighbor payload.

    The Lemma-1 recovered neighbor difference is ``dhat = cmod(qb - y, B)``
    (line 5, before adding ``y`` back).  Under the lemma's hypothesis
    ``|x_j - x_i| < theta`` the decode never wraps and
    ``|dhat| <= |x_j - x_i| + delta*B < theta + delta*B = B/2``, so the
    outer band ``|dhat| >= theta`` is reached only when the true distance
    is already within ``delta*B`` of the bound: True there.

    An element with true distance ``d`` fires iff ``d mod B`` lands in the
    window ``[theta, B - theta]`` around the wrap point ``B/2``: distances
    crossing the bound transit it deterministically, and a gross, wrapped
    violation fires at a per-element rate of ~``2*delta`` a neighbor, so
    over a model's worth of elements a sustained violation counts in the
    thousands a round while a safe run stays at exactly zero.  Observational
    only: it feeds nothing back into the mix.
    """
    d = qb - y.float()
    Bt = _scalar(B, d)
    dhat = d - Bt * torch.floor(d / Bt + 0.5)              # cmod(d, B)
    return torch.abs(dhat) >= _scalar(theta, d)


def decode_reduce_plain(p_self: torch.Tensor, p_nbrs: torch.Tensor,
                        y: torch.Tensor, B: torch.Tensor, *, bits: int,
                        weights) -> torch.Tensor:
    """Plain PyTorch decode-reduce (the kernel's exact semantics).
    Shapes: ``p_self [n, rows, pcols]``, ``p_nbrs [m, n, rows, pcols]``,
    ``y [n, rows, cols]``; the result has ``y``'s shape and dtype."""
    cols = y.shape[-1]

    def val(p):
        return unpack_values(p, bits, B)[..., :cols]

    qb_nbrs = [val(p_nbrs[s]) for s in range(p_nbrs.shape[0])]
    out = kref.decode_reduce_values(val(p_self), qb_nbrs, y, B, weights)
    return out.to(y.dtype)


def decode_reduce(p_self: torch.Tensor, p_nbrs: torch.Tensor,
                  y: torch.Tensor, B: torch.Tensor, *, bits: int,
                  weights) -> torch.Tensor:
    """Fused mix of ``m = len(weights)`` neighbor payloads into ``y``.

    ``weights`` are the neighbor weights in topology offset order, matching
    ``p_nbrs``.  A CUDA tensor launches the kernel (one launch, counted in
    ``decode_reduce.launches``); CPU tensors take
    :func:`decode_reduce_plain`.  Under ``cost.counting`` each call charges
    the kernel's FLOPs and bytes, and ``meta`` tensors get an empty
    output."""
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"unpackable bit width {bits}")
    if y.dim() != 3:
        raise ValueError(f"y must be [workers, rows, cols], got {y.shape}")
    n, rows, cols = y.shape
    m = len(weights)
    pshape = (n, rows, -(-cols // (8 // bits)))
    if tuple(p_self.shape) != pshape or tuple(p_nbrs.shape) != (m,) + pshape:
        raise ValueError(f"payload shapes {tuple(p_self.shape)}, "
                         f"{tuple(p_nbrs.shape)} do not match y {tuple(y.shape)}"
                         f" with {m} weights at {bits} bits")
    if p_self.dtype != torch.uint8 or p_nbrs.dtype != torch.uint8:
        raise TypeError("payloads must be uint8")
    if y.dtype not in _DTYPES:
        raise TypeError(f"y must be float32 or bfloat16, got {y.dtype}")
    cost.charge("moniqua_decode_reduce", cost.decode_reduce_ops(m) * y.numel(),
                cost.nbytes(p_self, p_nbrs, y) + cost.nbytes(y))
    if y.device.type == "meta":
        return cost.meta_output("moniqua_decode_reduce", y.shape, y.dtype)
    if y.device.type == "cpu":
        with cost.plain():
            return decode_reduce_plain(p_self, p_nbrs, y, B, bits=bits,
                                       weights=weights)
    if y.device.type != "cuda":
        raise ValueError(f"no decode_reduce for device {y.device}")
    if not 1 <= m <= MAX_NEIGHBORS:
        raise ValueError(f"the kernel takes 1..{MAX_NEIGHBORS} neighbors, "
                         f"got {m}")
    for name, t in (("p_self", p_self), ("p_nbrs", p_nbrs), ("y", y)):
        if t.device != y.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {y.device}")
    if (B.device != y.device or B.dtype != torch.float32 or B.numel() != 1):
        raise ValueError("B must be one float32 on y's device")
    out = torch.empty_like(y)
    w = (ctypes.c_float * m)(*[float(v) for v in weights])
    lib = build.load("moniqua_decode_reduce")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moniqua_decode_reduce(
            ctypes.c_void_p(p_self.data_ptr()),
            ctypes.c_void_p(p_nbrs.data_ptr()),
            ctypes.c_void_p(y.data_ptr()), int(y.dtype == torch.bfloat16),
            ctypes.c_void_p(out.data_ptr()), n * rows, cols, m,
            ctypes.cast(w, ctypes.c_void_p), ctypes.c_void_p(B.data_ptr()),
            bits, ctypes.c_void_p(stream))
    build.check(err, "moniqua_decode_reduce")
    decode_reduce.launches += 1
    return out


decode_reduce.launches = 0
