"""Flash-attention forward: online softmax over K/V tiles, scores on chip.

The counterpart of the reference's Pallas ``kernels/flash_attention.py``.
On ``q [BH, Sq, D]`` and ``k, v [BH/g, Sk, D]`` it computes causal
(optionally sliding-window) or non-causal attention with float32 scores,
times ``scale``, and returns q's dtype; query row block ``bh`` reads KV
block ``bh // g``, which is the reference's ``jnp.repeat`` of the KV heads
when heads are folded ``(lead..., H)``.  The window applies only when
``causal``; ``Sq != Sk`` is allowed.

:func:`flash_attention` picks one of three CUDA kernels by dtype and head
dim (:func:`route`), never by trying.  At a head dim in
:data:`TC_HEAD_DIMS` (64, 96 and 128: every head dim at which a config of
the reference's model zoo runs attention) both dtypes run on the tensor
cores: bfloat16 through :func:`flash_attention_tc`
(``csrc/flash_attention_tc.cu``: ``wgmma`` and TMA), float32 through
:func:`flash_attention_f32tc`
(``csrc/flash_attention_f32tc.cu``: 3xTF32 ``mma.sync``, each operand split
into two TF32 parts, which keeps float32's tolerance where one TF32 pass
cannot).  Every other head dim up to :data:`MAX_HEAD_DIM`, which no config
has, goes to :func:`flash_attention_simt` (``csrc/flash_attention.cu``:
CUDA cores).  Each keeps its own count of
launches.  CPU tensors take :func:`flash_attention_plain`.  Under
``kernels.cost.counting`` every route charges its kernel's FLOPs (causal
work halved: the attended pairs only) and bytes, and takes ``meta``
tensors.

:func:`sdpa` with :func:`causal_mask` is the one masked-softmax oracle of
the port: ``models.layers`` runs it as the plain attention path and for
cached decode, and :func:`sdpa_ref` runs it on ``[BH, S, D]`` (the
reference's ``ops._sdpa_ref``), in the inputs' dtype; :func:`sdpa_ref_vjp`
is its VJP written out as tensor ops, the backward of ``ops.flash_sdpa``,
which recomputes as the reference's ``custom_vjp`` does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost

NEG_INF = -1e30
MAX_HEAD_DIM = 256
# head dims that the tensor-core kernels instantiate (both dtypes)
TC_HEAD_DIMS = (64, 96, 128)
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


def sdpa_ref_vjp(q, k, v, g, scale: float, causal: bool, window: int):
    """The VJP of :func:`sdpa_ref` at ``q [BH, Sq, D]``, ``k, v [BH/G, Sk,
    D]`` (KV blocks read by groups of G query blocks) for the cotangent
    ``g [BH, Sq, D]`` -> ``(dq, dk, dv)`` at the inputs' shapes and dtypes.

    Written out as tensor ops, step for step what the reference's
    ``jax.vjp(_sdpa_ref)`` computes: P recomputed (scores in the inputs'
    dtype, then float32 times ``scale``, masked, softmax), cast to v's
    dtype for ``dV = P^T dO``; ``dP = dO V^T`` in float32; the softmax VJP
    ``dS = P * (dP - rowsum(P * dP))`` with masked entries zero; ``dq =
    scale dS K``, ``dk = scale dS^T Q`` in the inputs' dtype; dk and dv
    summed over each group of G query blocks (the VJP of the KV expansion).
    No ``torch.autograd`` inside, so it runs under ``torch.func``
    transforms as well as in a plain backward."""
    group = q.shape[0] // k.shape[0] if k.shape[0] else 1
    ke, ve = expand_kv(k, group), expand_kv(v, group)
    sq, sk = q.shape[1], k.shape[1]
    mask = (causal_mask(sq, sk, window, device=q.device) if causal else
            torch.ones((sq, sk), dtype=torch.bool, device=q.device))
    scores = torch.einsum("bqd,bkd->bqk", q, ke).float() * scale
    p = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    dv = torch.einsum("bqk,bqd->bkd", p.to(v.dtype), g)
    dp = torch.einsum("bqd,bkd->bqk", g, ve).float()
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    ds = (torch.where(mask, ds, 0.0) * scale).to(q.dtype)
    dq = torch.einsum("bqk,bkd->bqd", ds, ke)
    dk = torch.einsum("bqk,bqd->bkd", ds, q)

    def fold(t):
        return t if group == 1 else t.unflatten(0, (-1, group)).sum(1)
    return dq, fold(dk), fold(dv)


def expand_kv(t: torch.Tensor, group: int) -> torch.Tensor:
    """``[BH/g, S, D]`` KV blocks -> ``[BH, S, D]``: block ``bh`` is KV
    block ``bh // g`` (``jnp.repeat`` on the folded head axis)."""
    return t if group == 1 else torch.repeat_interleave(t, group, dim=0)


def flash_attention_plain(q, k, v, *, scale: float, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """What the kernels compute, up to float32 summation order: the oracle
    on the inputs upcast to float32, the KV blocks expanded to q's, cast
    to q's dtype."""
    g = q.shape[0] // k.shape[0] if k.shape[0] else 1
    return sdpa_ref(q.float(), expand_kv(k.float(), g),
                    expand_kv(v.float(), g), scale, causal,
                    window).to(q.dtype)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (8 significant bits): 2^(e - 8) for
    |x| = m 2^e, m in [0.5, 1); 0 at x = 0."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def flash_close(got: torch.Tensor, want: torch.Tensor):
    """A flash kernel's output against its plain version in float32 on
    the same inputs -> (ok, max abs error, worst error / tolerance).
    float32: within rtol = atol = 2e-5 (the two sum in other orders).
    bfloat16: within the reference tests' atol 0.03 and, element by
    element, within one bfloat16 ulp of |want| plus the float32 tolerance,
    since the kernel's output is one rounding of a float32 result."""
    err = (got.float() - want).abs()
    tol = 2e-5 * (1 + want.abs())
    if got.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(want)
    max_err = float(err.max())
    ok = bool((err <= tol).all())
    if got.dtype == torch.bfloat16:
        ok = ok and max_err <= 0.03
    return ok, max_err, float((err / tol).max())


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be [BH, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, _, d = q.shape
    bh_kv = k.shape[0]
    if (k.shape != v.shape or k.shape[2] != d
            or (bh_kv == 0 and bh != 0) or (bh_kv and bh % bh_kv)):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match: k and v must be "
                         f"[BH/g, Sk, D] with g dividing BH")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")


def _off_card(name, q, k, v, scale, causal, window):
    """The part of every route before its launch: charge kernel ``name``'s
    FLOPs (two matmuls over the attended pairs) and bytes to the active
    cost context, then the output of a ``meta`` (an empty one) or CPU call
    (the plain version); None for a CUDA tensor."""
    bh, sq, d = q.shape
    pairs = cost.attended_pairs(sq, k.shape[1], causal, window)
    cost.charge(name, 4 * bh * d * pairs, cost.nbytes(q, k, v, q))
    if q.device.type == "meta":
        return cost.meta_output(name, q.shape, q.dtype)
    if q.device.type == "cpu":
        with cost.plain():
            return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                         window=window)
    return None


def _check_cuda(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _launch(name, q, k, v, args):
    """Run kernel ``name`` on q's stream -> o; ``args`` follow the four
    pointers and precede the stream."""
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.load(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            *args, ctypes.c_void_p(stream))
    build.check(err, name)
    return out


def flash_attention_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, causal: bool = True,
                       window: int = 0) -> torch.Tensor:
    """The tensor-core route: bfloat16, head dim in :data:`TC_HEAD_DIMS`,
    every base 16-byte aligned (TMA).  A CUDA tensor launches
    ``csrc/flash_attention_tc.cu`` (counted in
    ``flash_attention_tc.launches``) or raises; CPU tensors take
    :func:`flash_attention_plain`."""
    _check(q, k, v)
    out = _off_card("flash_attention_tc", q, k, v, scale, causal, window)
    if out is not None:
        return out
    _check_cuda(q, k, v)
    bh, sq, d = q.shape
    if q.dtype != torch.bfloat16 or d not in TC_HEAD_DIMS:
        raise ValueError(f"the tensor-core route takes bfloat16 at head dims "
                         f"{TC_HEAD_DIMS}, got {q.dtype}, d={d}")
    if k.shape[1] == 0:
        raise ValueError("the tensor-core route needs Sk >= 1")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("TMA needs 16-byte aligned q, k, v")
    out = _launch("flash_attention_tc", q, k, v,
                  (bh, k.shape[0], sq, k.shape[1], d, ctypes.c_float(scale),
                   int(bool(causal)), int(window)))
    if out.numel():
        flash_attention_tc.launches += 1
    return out


def flash_attention_f32tc(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, scale: float,
                          causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The float32 tensor-core route: float32, head dim in
    :data:`TC_HEAD_DIMS`, every base 16-byte aligned (``cp.async``).  A
    CUDA tensor launches ``csrc/flash_attention_f32tc.cu`` (counted in
    ``flash_attention_f32tc.launches``) or raises; CPU tensors take
    :func:`flash_attention_plain`."""
    _check(q, k, v)
    out = _off_card("flash_attention_f32tc", q, k, v, scale, causal, window)
    if out is not None:
        return out
    _check_cuda(q, k, v)
    bh, sq, d = q.shape
    if q.dtype != torch.float32 or d not in TC_HEAD_DIMS:
        raise ValueError(f"the float32 tensor-core route takes float32 at "
                         f"head dims {TC_HEAD_DIMS}, got {q.dtype}, d={d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("cp.async needs 16-byte aligned q, k, v")
    out = _launch("flash_attention_f32tc", q, k, v,
                  (bh, k.shape[0], sq, k.shape[1], d, ctypes.c_float(scale),
                   int(bool(causal)), int(window)))
    if out.numel():
        flash_attention_f32tc.launches += 1
    return out


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """The CUDA-core route: float32 or bfloat16, any head dim up to
    :data:`MAX_HEAD_DIM` (:func:`route` sends it those outside
    :data:`TC_HEAD_DIMS`).  A CUDA tensor launches ``csrc/flash_attention.cu``
    (counted in ``flash_attention_simt.launches``); CPU tensors take
    :func:`flash_attention_plain`."""
    _check(q, k, v)
    out = _off_card("flash_attention_simt", q, k, v, scale, causal, window)
    if out is not None:
        return out
    _check_cuda(q, k, v)
    bh, sq, d = q.shape
    out = _launch("flash_attention", q, k, v,
                  (int(q.dtype == torch.bfloat16), bh, k.shape[0], sq,
                   k.shape[1], d, ctypes.c_float(scale), int(bool(causal)),
                   int(window)))
    if out.numel():
        flash_attention_simt.launches += 1
    return out


def route(q: torch.Tensor):
    """The kernel wrapper :func:`flash_attention` calls, fixed by dtype and
    head dim: the tensor cores at :data:`TC_HEAD_DIMS` = 64, 96, 128
    (bfloat16 :func:`flash_attention_tc`, float32
    :func:`flash_attention_f32tc`), the CUDA cores
    (:func:`flash_attention_simt`) at any other head dim."""
    if q.shape[-1] in TC_HEAD_DIMS:
        return (flash_attention_tc if q.dtype == torch.bfloat16
                else flash_attention_f32tc)
    return flash_attention_simt


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: [BH, Sq, D]; k, v: [BH/g, Sk, D] -> o [BH, Sq, D] in q's dtype.

    CUDA tensors launch the kernel of :func:`route`; CPU tensors take
    :func:`flash_attention_plain`."""
    return route(q)(q, k, v, scale=scale, causal=causal, window=window)


flash_attention_tc.launches = 0
flash_attention_f32tc.launches = 0
flash_attention_simt.launches = 0
