"""Flash-attention forward: online softmax over K/V tiles, scores on chip.

The counterpart of the reference's Pallas ``kernels/flash_attention.py``:
:func:`flash_attention` launches the CUDA kernel
``csrc/flash_attention.cu`` for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors.  On ``[BH, S, D]`` inputs it
computes causal (optionally sliding-window) or non-causal attention with
float32 scores from inputs upcast to float32, times ``scale``, and returns
q's dtype.  The window applies only when ``causal``; ``Sq != Sk`` is allowed.

:func:`sdpa` with :func:`causal_mask` is the one masked-softmax oracle of
the port: ``models.layers`` runs it as the plain attention path and for
cached decode, and :func:`sdpa_ref` runs it on ``[BH, S, D]`` (the
reference's ``ops._sdpa_ref``), in the inputs' dtype, for the backward of
``ops.flash_sdpa``, which recomputes through it as the reference's
``custom_vjp`` does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def sdpa(q, k, v, mask, scale):
    """q [.., Sq, H, D], k/v [.., Sk, H, D], mask bool broadcast to
    [.., H, Sq, Sk].  Scores in the inputs' dtype, then float32 times
    ``scale``; masked scores are the finite ``NEG_INF``; the softmax weights
    are cast to ``v``'s dtype, as in the reference."""
    scores = torch.einsum("...qhd,...khd->...hqk", q, k).float() * scale
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("...hqk,...khd->...qhd", w, v)


def causal_mask(sq, sk, window=0, device=None):
    """bool [sq, sk]; query i attends keys j with j <= i and
    (window == 0 or j > i - window)."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window:
        m = m & (kj > qi - window)
    return m


def sdpa_ref(q, k, v, scale: float, causal: bool, window: int):
    """:func:`sdpa` on ``[BH, S, D]`` (the reference's ``_sdpa_ref``): the
    causal (windowed) mask, or none when not ``causal``."""
    sq, sk = q.shape[1], k.shape[1]
    mask = (causal_mask(sq, sk, window, device=q.device) if causal else
            torch.ones((sq, sk), dtype=torch.bool, device=q.device))
    return sdpa(q[:, :, None], k[:, :, None], v[:, :, None], mask,
                scale)[:, :, 0]


def flash_attention_plain(q, k, v, *, scale: float, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """What the kernel computes, up to float32 summation order: the oracle
    on the inputs upcast to float32, cast to q's dtype."""
    return sdpa_ref(q.float(), k.float(), v.float(), scale, causal,
                    window).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be [BH, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: [BH, Sq, D]; k, v: [BH, Sk, D] -> o [BH, Sq, D] in q's dtype.

    A CUDA tensor launches the kernel (one launch, counted in
    ``flash_attention.launches``); CPU tensors take
    :func:`flash_attention_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            int(q.dtype == torch.bfloat16), bh, sq, sk, d,
            ctypes.c_float(scale), int(bool(causal)), int(window),
            ctypes.c_void_p(stream))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
