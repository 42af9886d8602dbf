"""Flash-attention forward: online softmax over K/V tiles, scores on chip.

The counterpart of the reference's Pallas ``kernels/flash_attention.py``.
On ``q [BH, Sq, D]`` and ``k, v [BH/g, Sk, D]`` it computes causal
(optionally sliding-window) or non-causal attention with float32 scores,
times ``scale``, and returns q's dtype; query row block ``bh`` reads KV
block ``bh // g``, which is the reference's ``jnp.repeat`` of the KV heads
when heads are folded ``(lead..., H)``.  The window applies only when
``causal``; ``Sq != Sk`` is allowed.  ``k0`` (default 0) is the absolute
position of key 0: under ``causal`` key ``j`` is valid for query row ``i``
iff ``j + k0 <= i`` (and ``j + k0 > i - window``), so a context-parallel
rank attends its share ``[k0, k0 + Sk)`` of the keys at their positions;
a row with no valid key (only at ``k0 > 0``) comes out 0.  With
``lse=True`` every route also returns ``lse [BH, Sq]``, float32, the
natural-log log-sum-exp of each row's valid scaled scores (``-inf`` for a
row with none), which ``comm.tensor_parallel.merge_attention`` merges the
shares by.  ``k0 = 0`` without ``lse`` computes what the kernels and the
plain version computed before either existed, bit for bit.

:func:`flash_attention` picks one of two CUDA kernels by dtype
(:func:`route`), never by trying, and both run on the tensor cores at
every head dim 1..:data:`MAX_HEAD_DIM`: bfloat16 through
:func:`flash_attention_tc` (``csrc/flash_attention_tc.cu``: ``wgmma`` and
TMA), float32 through :func:`flash_attention_f32tc`
(``csrc/flash_attention_f32tc.cu``: 3xTF32 ``mma.sync``, each operand split
into two TF32 parts, which keeps float32's tolerance where one TF32 pass
cannot).  Each kernel is instantiated at the head dims of
:data:`TC_HEAD_DIMS` and runs a head dim d at :func:`padded_head_dim`
(d): columns d and past of its tiles are zeros, filled as the tiles are
loaded where 8 divides d; for any other d the wrapper pads q, k and v
with zero columns to the next multiple of 8 and cuts the output back.
Each keeps its own count of launches.  CPU tensors take
:func:`flash_attention_plain`.  Under ``kernels.cost.counting`` every
route charges its kernel's FLOPs (causal work halved: the attended pairs
only) and bytes at the real head dim d, and takes ``meta`` tensors.

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
TC_HEAD_DIMS = (64, 96, 128, 192, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def padded_head_dim(d: int) -> int:
    """The instantiation a head dim d in 1..:data:`MAX_HEAD_DIM` runs at:
    the smallest of :data:`TC_HEAD_DIMS` that is at least d."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    return next(dim for dim in TC_HEAD_DIMS if d <= dim)


def sdpa(q, k, v, mask, scale):
    """q [.., Sq, H, D], k/v [.., Sk, H, D], mask bool broadcast to
    [.., H, Sq, Sk].  Scores in the inputs' dtype, then float32 times
    ``scale``; masked scores are the finite ``NEG_INF``; the softmax weights
    are cast to ``v``'s dtype, as in the reference."""
    scores = torch.einsum("...qhd,...khd->...hqk", q, k).float() * scale
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("...hqk,...khd->...qhd", w, v)


def sdpa_lse(q, k, v, mask, scale):
    """:func:`sdpa` that also returns each row's log-sum-exp: ``(out [..,
    Sq, H, D], lse [.., H, Sq])``, ``lse`` float32 in natural log over the
    valid scaled scores.  A row with no valid key gets ``out`` 0 and
    ``lse`` ``-inf`` (not :func:`sdpa`'s uniform weights over the
    sentinel): the share of the keys that a context-parallel rank holds
    may have none for some rows, and the merge weights it by
    ``exp(lse)`` = 0."""
    scores = torch.einsum("...qhd,...khd->...hqk", q, k).float() * scale
    scores = torch.where(mask, scores, -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(scores - m)
    den = e.sum(dim=-1, keepdim=True)
    w = (e / torch.where(den > 0, den, 1.0)).to(v.dtype)
    out = torch.einsum("...hqk,...khd->...qhd", w, v)
    return out, (m + torch.log(den))[..., 0]


def causal_mask(sq, sk, window=0, device=None, k0=0):
    """bool [sq, sk]; query i attends keys j with j + k0 <= i and
    (window == 0 or j + k0 > i - window): key j sits at position j + k0."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    if k0:
        kj = kj + k0
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


def sdpa_ref_vjp(q, k, v, g, scale: float, causal: bool, window: int,
                 k0: int = 0, g_lse=None):
    """The VJP of :func:`sdpa_ref` at ``q [BH, Sq, D]``, ``k, v [BH/G, Sk,
    D]`` (KV blocks read by groups of G query blocks) for the cotangent
    ``g [BH, Sq, D]`` -> ``(dq, dk, dv)`` at the inputs' shapes and dtypes.
    With key 0 at position ``k0`` (:func:`causal_mask`) a row with no valid
    key has P = 0 (its output is the constant 0); ``g_lse [BH, Sq]``, the
    cotangent of the log-sum-exp output, adds ``g_lse_i P_ij`` to dS
    (d lse_i / d s_ij = P_ij).

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
    mask = (causal_mask(sq, sk, window, device=q.device, k0=k0) if causal
            else torch.ones((sq, sk), dtype=torch.bool, device=q.device))
    scores = torch.einsum("bqd,bkd->bqk", q, ke).float() * scale
    p = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    if k0 and causal:
        p = p * mask.any(-1, keepdim=True)
    dv = torch.einsum("bqk,bqd->bkd", p.to(v.dtype), g)
    dp = torch.einsum("bqd,bkd->bqk", g, ve).float()
    ds = dp - (p * dp).sum(-1, keepdim=True)
    if g_lse is not None:
        ds = ds + g_lse.float()[..., None]
    ds = p * ds
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
                          window: int = 0, k0: int = 0, lse: bool = False):
    """What the kernels compute, up to float32 summation order: the oracle
    on the inputs upcast to float32, the KV blocks expanded to q's, cast
    to q's dtype; with ``k0`` or ``lse`` through :func:`sdpa_lse` (rows
    with no valid key 0), returning ``(out, lse)`` when ``lse``."""
    g = q.shape[0] // k.shape[0] if k.shape[0] else 1
    kf, vf = expand_kv(k.float(), g), expand_kv(v.float(), g)
    k0 = k0 if causal else 0
    if not k0 and not lse:
        return sdpa_ref(q.float(), kf, vf, scale, causal, window).to(q.dtype)
    sq, sk = q.shape[1], k.shape[1]
    mask = (causal_mask(sq, sk, window, device=q.device, k0=k0) if causal
            else torch.ones((sq, sk), dtype=torch.bool, device=q.device))
    out, l = sdpa_lse(q.float()[:, :, None], kf[:, :, None], vf[:, :, None],
                      mask, scale)
    out = out[:, :, 0].to(q.dtype)
    return (out, l[:, 0]) if lse else out


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


def _off_card(name, q, k, v, scale, causal, window, k0, lse):
    """The part of every route before its launch: charge kernel ``name``'s
    FLOPs (two matmuls over the attended pairs) and bytes (with ``lse``,
    its float32 ``[BH, Sq]`` too) to the active cost context, then the
    output of a ``meta`` (an empty one) or CPU call (the plain version);
    None for a CUDA tensor."""
    bh, sq, d = q.shape
    pairs = cost.attended_pairs(sq, k.shape[1], causal, window, k0)
    cost.charge(name, 4 * bh * d * pairs,
                cost.nbytes(q, k, v, q) + (4 * bh * sq if lse else 0))
    if q.device.type == "meta":
        out = cost.meta_output(name, q.shape, q.dtype)
        return (out, torch.empty((bh, sq), device="meta")) if lse else out
    if q.device.type == "cpu":
        with cost.plain():
            return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                         window=window, k0=k0, lse=lse)
    return None


def _check_cuda(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _launch(name, q, k, v, scale, causal, window, wide_out, k0, lse):
    """Run kernel ``name`` on q's stream -> o, or ``(o, lse)`` with
    ``lse``.  A head dim that 8 does not divide runs on copies of q, k and
    v padded with zero columns to the next multiple of 8.  A kernel with
    ``wide_out`` writes all :func:`padded_head_dim` columns of its output;
    the first d are kept."""
    d = q.shape[-1]
    pad = -d % 8
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    cols = padded_head_dim(d) if wide_out else q.shape[-1]
    out = q.new_empty(q.shape[:2] + (cols,))
    l = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
         if lse else None)
    if out.numel():
        lib = build.load(name)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, name)(
                ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
                ctypes.c_void_p(v.data_ptr()),
                ctypes.c_void_p(out.data_ptr()), q.shape[0], k.shape[0],
                q.shape[1], k.shape[1], q.shape[2], ctypes.c_float(scale),
                int(bool(causal)), int(window), int(k0),
                ctypes.c_void_p(l.data_ptr() if lse else None),
                ctypes.c_void_p(stream))
        build.check(err, name)
    out = out[..., :d].contiguous() if cols != d else out
    return (out, l) if lse else out


def _check_k0(k0):
    if k0 < 0:
        raise ValueError(f"key offset k0 must be >= 0, got {k0}")


def flash_attention_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, causal: bool = True, window: int = 0,
                       k0: int = 0, lse: bool = False):
    """The bfloat16 route, at any head dim up to :data:`MAX_HEAD_DIM`,
    every base 16-byte aligned (TMA).  A CUDA tensor launches
    ``csrc/flash_attention_tc.cu`` (counted in
    ``flash_attention_tc.launches``) or raises; CPU tensors take
    :func:`flash_attention_plain`."""
    _check(q, k, v)
    _check_k0(k0)
    out = _off_card("flash_attention_tc", q, k, v, scale, causal, window, k0,
                    lse)
    if out is not None:
        return out
    _check_cuda(q, k, v)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core route takes bfloat16, got "
                         f"{q.dtype}")
    if k.shape[1] == 0:
        raise ValueError("the tensor-core route needs Sk >= 1")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("TMA needs 16-byte aligned q, k, v")
    out = _launch("flash_attention_tc", q, k, v, scale, causal, window,
                  True, k0, lse)
    if q.numel():
        flash_attention_tc.launches += 1
    return out


def flash_attention_f32tc(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, scale: float,
                          causal: bool = True, window: int = 0, k0: int = 0,
                          lse: bool = False):
    """The float32 route, at any head dim up to :data:`MAX_HEAD_DIM`,
    every base 16-byte aligned (``cp.async``).  A CUDA tensor launches
    ``csrc/flash_attention_f32tc.cu`` (counted in
    ``flash_attention_f32tc.launches``) or raises; CPU tensors take
    :func:`flash_attention_plain`."""
    _check(q, k, v)
    _check_k0(k0)
    out = _off_card("flash_attention_f32tc", q, k, v, scale, causal, window,
                    k0, lse)
    if out is not None:
        return out
    _check_cuda(q, k, v)
    if q.dtype != torch.float32:
        raise ValueError(f"the float32 tensor-core route takes float32, got "
                         f"{q.dtype}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("cp.async needs 16-byte aligned q, k, v")
    out = _launch("flash_attention_f32tc", q, k, v, scale, causal, window,
                  False, k0, lse)
    if q.numel():
        flash_attention_f32tc.launches += 1
    return out


def route(q: torch.Tensor):
    """The kernel wrapper :func:`flash_attention` calls, fixed by dtype:
    bfloat16 :func:`flash_attention_tc`, float32
    :func:`flash_attention_f32tc`, at every head dim."""
    return (flash_attention_tc if q.dtype == torch.bfloat16
            else flash_attention_f32tc)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0,
                    k0: int = 0, lse: bool = False):
    """q: [BH, Sq, D]; k, v: [BH/g, Sk, D] -> o [BH, Sq, D] in q's dtype,
    or ``(o, lse [BH, Sq] float32)`` with ``lse``; key 0 at position
    ``k0``.

    CUDA tensors launch the kernel of :func:`route`; CPU tensors take
    :func:`flash_attention_plain`."""
    return route(q)(q, k, v, scale=scale, causal=causal, window=window,
                    k0=k0, lse=lse)


flash_attention_tc.launches = 0
flash_attention_f32tc.launches = 0
