"""Wrappers around the kernels: stacked-worker and chunk-window codec calls,
point decodes of any shape, and differentiable flash attention.

The reference's ``kernels/ops.py`` pads every array to a 256x1024 tile grid
and vmaps that layout over the worker axis.  The grid only ever appends
padding that is sliced off again before the payload is rolled, so the port
has no grid: one launch covers the whole ``[n, ...]`` leaf or ``[n, D]``
bucket.  Only a row of ``_MAX_COLS`` (2^31) columns or more, which the
kernels refuse, goes in column windows, one launch each.  Two things of the
reference layout fix the payload bits and are kept:

* each leaf's last dim is zero-padded to values-per-byte (the kernels do it
  in place: columns past the end encode as zeros);
* the counter index is ``idx_base`` plus the position in the worker's padded
  row and restarts at 0 for every worker (Supp. C shared randomness).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import modulo
from repro_torch.core.modulo import _scalar
from repro_torch.core.quantizers import QuantSpec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moniqua_decode as _dec
from repro_torch.kernels import moniqua_decode_reduce as _dr
from repro_torch.kernels import moniqua_encode as _enc
from repro_torch.kernels import ref as kref

# Hash seed of a round without one: only nearest rounding may omit the seed
# (it never draws a uniform); the engine rejects a missing seed otherwise.
NO_KEY_SEED = 0


def _rows_view(x: torch.Tensor) -> torch.Tensor:
    """``[n, ..., last]`` as a contiguous ``[n, rows, last]``."""
    if x.dim() < 2:
        raise ValueError(f"stacked leaves are [n, ...] with ndim >= 2, "
                         f"got {tuple(x.shape)}")
    return x.contiguous().reshape(x.shape[0], -1, x.shape[-1])


# A launch takes rows of fewer than this many columns (the kernels keep
# offsets inside a row in 32 bits).  A longer row goes in column windows.
_MAX_COLS = 2 ** 31


def _windows(cols: int, vpb: int):
    """Column windows ``[a, b)`` of a row, each below ``_MAX_COLS`` and
    starting on a multiple of values-per-byte, so that its payload starts
    on a whole byte: payload columns ``[a // vpb, ceil(b / vpb))``."""
    step = (_MAX_COLS - 1) // vpb * vpb
    return [(a, min(a + step, cols)) for a in range(0, cols, step)]


def _pwin(a: int, b: int, vpb: int) -> slice:
    return slice(a // vpb, -(-b // vpb))


def moniqua_encode_stacked(x: torch.Tensor, B, spec: QuantSpec, seed: int, *,
                           idx_base: int = 0,
                           idx_row_stride: Optional[int] = None,
                           rows_per_block: Optional[int] = None,
                           block_stride: int = 0) -> torch.Tensor:
    """Encode a stacked ``[n, ...]`` leaf -> packed uint8
    ``[n, ..., ceil(last / vpb)]``, in one launch unless a row is too long.
    ``idx_base`` is shared by every worker; ``idx_row_stride`` (default
    ``cols_padded``) is the counter step from one row of the ``[n, rows,
    last]`` view to the next within a block of ``rows_per_block`` rows
    (default: all of them), ``block_stride`` from one block to the next
    (``kernels/moniqua_encode.py``).  Each window of a long row is
    launched with the counter base its first column has in the whole row,
    ``idx_base + (r // rows_per_block) * block_stride + (r %
    rows_per_block) * stride + a`` (the kernel takes it mod 2^32), so the
    payload bits are those of one launch over the row."""
    x3 = _rows_view(x)
    n, rows, cols = x3.shape
    vpb = spec.values_per_byte
    kw = dict(bits=spec.bits, stochastic=spec.stochastic)
    if cols < _MAX_COLS:
        p = _enc.encode(x3, B, seed, idx_base=idx_base,
                        idx_row_stride=idx_row_stride,
                        rows_per_block=rows_per_block,
                        block_stride=block_stride, **kw)
    else:
        p = torch.empty((n, rows, -(-cols // vpb)), dtype=torch.uint8,
                        device=x.device)
        stride = (-(-cols // vpb) * vpb if idx_row_stride is None
                  else int(idx_row_stride))
        bases = _enc.row_bases(rows, idx_base, stride, rows_per_block,
                               block_stride)[:, 0].tolist()
        for w in range(n):
            for r in range(rows):
                for a, b in _windows(cols, vpb):
                    p[w, r, _pwin(a, b, vpb)] = _enc.encode(
                        x3[w:w + 1, r:r + 1, a:b], B, seed,
                        idx_base=bases[r] + a, **kw)[0, 0]
    return p.reshape(*x.shape[:-1], p.shape[-1])


def moniqua_decode_reduce_stacked(p_self: torch.Tensor, p_nbrs: torch.Tensor,
                                  y: torch.Tensor, B, weights,
                                  spec: QuantSpec) -> torch.Tensor:
    """Fused decode-reduce over a stacked leaf, in one launch unless a row
    is too long (then one launch a column window).  ``p_self`` and ``y``
    carry the worker axis at 0; ``p_nbrs`` stacks the neighbor payloads at
    axis 0 with the worker axis at 1 (one roll per offset)."""
    y3 = _rows_view(y)
    n, rows, cols = y3.shape
    ps = p_self.contiguous().reshape(n, rows, -1)
    pn = p_nbrs.contiguous().reshape(p_nbrs.shape[0], n, rows, -1)
    kw = dict(bits=spec.bits, weights=tuple(weights))
    if cols < _MAX_COLS:
        out = _dr.decode_reduce(ps, pn, y3, B, **kw)
    else:
        vpb = spec.values_per_byte
        out = torch.empty_like(y3)
        for w in range(n):
            for r in range(rows):
                for a, b in _windows(cols, vpb):
                    pw = _pwin(a, b, vpb)
                    out[w, r, a:b] = _dr.decode_reduce(
                        ps[w:w + 1, r:r + 1, pw],
                        pn[:, w:w + 1, r:r + 1, pw].contiguous(),
                        y3[w:w + 1, r:r + 1, a:b], B, **kw)[0, 0]
    return out.reshape(y.shape)


def moniqua_encode_chunk(flat: torch.Tensor, offset: int, size: int, B,
                         spec: QuantSpec, seed: int, *,
                         idx_base: Optional[int] = None) -> torch.Tensor:
    """Encode the window ``flat[:, offset:offset+size]`` of a stacked flat
    buffer with globally indexed uniforms (``idx_base = offset``).

    ``idx_base`` overrides the counter base when ``flat`` is itself a
    window of a larger buffer: a shard plan slices at shard-local offsets
    but must hash the global element indices."""
    return moniqua_encode_stacked(flat[:, offset:offset + size], B, spec,
                                  seed, idx_base=offset if idx_base is None
                                  else idx_base)


def moniqua_decode_reduce_chunk(p_self: torch.Tensor, p_nbrs: torch.Tensor,
                                flat: torch.Tensor, offset: int, size: int, B,
                                weights, spec: QuantSpec) -> torch.Tensor:
    """Fused decode-reduce of one chunk's payloads against the matching
    window of the local flat buffer."""
    return moniqua_decode_reduce_stacked(p_self, p_nbrs,
                                         flat[:, offset:offset + size], B,
                                         weights, spec)


# ---------------------------------------------------------------------------
# Point decode of one payload (the reference's moniqua_decode_remote/_self)
# ---------------------------------------------------------------------------

def _decode_common(packed: torch.Tensor, y: torch.Tensor, B,
                   spec: QuantSpec, mode: str) -> torch.Tensor:
    """``y [..., last]`` against ``packed [..., ceil(last / vpb)]`` in one
    launch over ``[prod(...), last]`` rows, unless a row is too long (then
    one launch a column window)."""
    cols = y.shape[-1]
    y2 = y.contiguous().reshape(-1, cols)
    p2 = packed.contiguous().reshape(y2.shape[0], -1)
    Bt = _scalar(B, y)
    if cols < _MAX_COLS:
        out = _dec.decode(p2, y2, Bt, bits=spec.bits, mode=mode)
    else:
        vpb = spec.values_per_byte
        out = torch.empty_like(y2)
        for r in range(y2.shape[0]):
            for a, b in _windows(cols, vpb):
                out[r, a:b] = _dec.decode(p2[r:r + 1, _pwin(a, b, vpb)],
                                          y2[r:r + 1, a:b], Bt,
                                          bits=spec.bits, mode=mode)[0]
    return out.reshape(y.shape)


def moniqua_decode_remote(packed, y, B, spec: QuantSpec) -> torch.Tensor:
    """Algorithm 1 line 5: ``cmod(q*B - y, B) + y``, in ``y``'s dtype."""
    return _decode_common(packed, y, B, spec, "remote")


def moniqua_decode_self(packed, x, B, spec: QuantSpec) -> torch.Tensor:
    """Algorithm 1 line 4: ``q*B - cmod(x, B) + x``, in ``x``'s dtype."""
    return _decode_common(packed, x, B, spec, "self")


# Plain conveniences (the reference's ``ops.moniqua_unpack_value`` /
# ``moniqua_recover``): the kernels' own unpack and Lemma 1's recovery.

def moniqua_unpack_value(packed: torch.Tensor, B, spec: QuantSpec,
                         last_dim: int) -> torch.Tensor:
    """Unpack + dequantize + rescale, ``q * B``, cut to ``last_dim``."""
    return kref.value_ref(packed, B, spec.bits)[..., :last_dim]


moniqua_recover = modulo.recover


# ---------------------------------------------------------------------------
# Flash attention: kernel forward + plain recompute backward
# ---------------------------------------------------------------------------

class _FlashSDPA(torch.autograd.Function):
    """Forward through the flash kernel (scores never leave the chip; K/V
    at KV-head count); backward recomputes through the masked-softmax
    oracle, as the reference's ``custom_vjp`` does, by the VJP written out
    as tensor ops (``flash_attention.sdpa_ref_vjp``), so dK and dV come back
    summed over each group at KV-head shape.  With ``lse`` the forward
    returns ``(o, lse)`` and the backward carries ``lse``'s cotangent too;
    ``k0`` is key 0's position (a context-parallel share of the keys).

    In the ``forward`` / ``setup_context`` form with its own ``vmap`` rule,
    so that ``torch.func.vmap(torch.func.grad(loss))`` (the train step's
    per-worker gradients) runs through it: the rule folds the vmapped dim
    into the kernel's leading ``[BH]`` dim, one launch for all workers.
    The backward needs no rule: its tensor ops batch under ``vmap``."""

    @staticmethod
    def forward(q, k, v, scale, causal, window, k0, lse):
        return _fa.flash_attention(q, k, v, scale=scale, causal=causal,
                                   window=window, k0=k0, lse=lse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, causal, window, k0, lse = inputs
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (scale, causal, window, k0)
        ctx.lse = lse

    @staticmethod
    def backward(ctx, g, *g_lse):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _fa.sdpa_ref_vjp(q, k, v, g, *ctx.cfg,
                                      g_lse=g_lse[0] if ctx.lse else None)
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale, causal, window, k0, lse):
        """``q [n, BH, S, D]``, ``k, v [n, BHkv, Sk, D]`` -> one launch on
        ``[n BH, S, D]`` and ``[n BHkv, Sk, D]`` (an unbatched operand is
        expanded first).  Query block ``w BH + b`` reads KV block ``(w BH +
        b) // G = w BHkv + b // G``: worker ``w``'s own, as in the loop."""
        n = info.batch_size

        def fold(t, d):
            t = t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
            return t.reshape(-1, *t.shape[2:]).contiguous()

        out = _FlashSDPA.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                               fold(v, in_dims[2]), scale, causal, window,
                               k0, lse)
        if lse:
            return (out[0].unflatten(0, (n, -1)),
                    out[1].unflatten(0, (n, -1))), (0, 0)
        return out.unflatten(0, (n, -1)), 0


def flash_sdpa(q, k, v, *, scale: float, causal: bool = True,
               window: int = 0, k0: int = 0, lse: bool = False):
    """Differentiable flash attention on ``q [..., S, H, D]`` and
    ``k, v [..., Sk, Hkv, D]`` with ``Hkv`` dividing ``H`` (grouped-query
    attention: query head ``h`` reads KV head ``h // (H / Hkv)``, with no
    copy): heads are folded into ``[B*H, S, D]`` and ``[B*Hkv, Sk, D]`` for
    the kernel and unfolded after.  ``k0``: key 0's position (under
    ``causal`` key ``j`` is valid for query ``i`` iff ``j + k0 <= i``).
    With ``lse`` returns ``(out, lse [..., H, S] float32)``."""
    *lead, S, H, D = q.shape
    Sk = k.shape[-3]

    def fold(t, s):
        return t.movedim(-2, -3).reshape(-1, s, D).contiguous()

    o = _FlashSDPA.apply(fold(q, S), fold(k, Sk), fold(v, Sk), scale,
                         causal, window, k0, lse)
    if lse:
        o, l = o
        return (o.reshape(*lead, H, S, D).movedim(-3, -2),
                l.reshape(*lead, H, S))
    return o.reshape(*lead, H, S, D).movedim(-3, -2)
