"""Building blocks of the port's models, as plain functions on tensors.

The counterpart of the reference's ``repro.models.layers``.  Parameters
are nested dicts of tensors with the reference's keys and leaf shapes (QKV
weights ``[d, heads, head_dim]``, O ``[heads, head_dim, d]``), so
``repro_torch.convert`` carries a tree across leaf for leaf.  Every
``init_*`` draws from an explicit ``torch.Generator`` on the generator's
device and takes ``stack=``: leading dims of a layer stack, drawn in one go
(the reference ``vmap``s its init over the layer keys).

Attention routes as the reference's does: causal self-attention through
the flash kernel (``cfg.flash_attention``, the port's default); cross and
bidirectional attention (whisper) through the plain masked softmax with an
all-true mask; with ``flash_attention=False`` a windowed self-attention
longer than twice its window band-wise (``_banded_sdpa``), the rest
through the full masked matrix.

Not here: ``_context_parallel_kv``, a sharding constraint that is a no-op
outside a JAX mesh.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
# the masked-softmax oracle (the reference's ``_sdpa`` and ``causal_mask``)
# lives beside the kernel it checks, so that the plain path and the oracle
# are one function
from repro_torch.kernels.flash_attention import causal_mask
from repro_torch.kernels.flash_attention import sdpa as _sdpa


def truncated_normal(gen: torch.Generator, shape, scale, dtype
                     ) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``, drawn in
    float32 on ``gen``'s device by inverse CDF (as ``jax.random`` does; the
    bits differ from JAX's)."""
    sqrt2 = math.sqrt(2.0)
    lo, hi = math.erf(-2.0 / sqrt2), math.erf(2.0 / sqrt2)
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    u.uniform_(lo, hi, generator=gen)
    out = u.erfinv_().mul_(sqrt2)
    lim = math.nextafter(2.0, 0.0)
    return out.clamp_(-lim, lim).mul_(scale).to(dtype)


def dense_init(gen, d_in, d_out, dtype, scale=None, stack=()):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return truncated_normal(gen, (*stack, d_in, d_out), scale, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    """The reference's all-float32 chain, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm with float32 statistics (population variance), cast back
    to ``x``'s dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding (the reference's interleaved pair layout)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions, head_dim, theta, fraction=1.0):
    """cos/sin tables for (possibly partial) RoPE: ``[..., S, rot/2]``."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = -torch.arange(0, rot, 2, dtype=torch.float32,
                         device=positions.device) / rot
    # torch.full, not torch.tensor: under a dispatch mode (the dry run's
    # counters) torch.tensor detaches in place, which grad transforms refuse
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x, cos, sin, rot):
    """x: [..., S, H, D]; cos/sin: [..., S, rot/2] broadcast over heads.
    Rotates the pairs ``(x[2i], x[2i+1])`` (not the rotate-half layout),
    in float32, and casts back to ``x``'s dtype."""
    xr, xp = x[..., :rot], x[..., rot:]
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp.to(yr.dtype)], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (causal / sliding window, cross, bidirectional, cached decode)
# ---------------------------------------------------------------------------

def init_attention(gen, cfg, dtype=torch.bfloat16, stack=()):
    """QKV/O weights kept 3-D ``[d, heads, head_dim]`` (O: ``[h, hd, d]``),
    the reference's layout."""
    d = cfg.d_model
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, d, nh * hd, dtype, stack=stack
                         ).reshape(*stack, d, nh, hd),
        "wk": dense_init(gen, d, nkv * hd, dtype, stack=stack
                         ).reshape(*stack, d, nkv, hd),
        "wv": dense_init(gen, d, nkv * hd, dtype, stack=stack
                         ).reshape(*stack, d, nkv, hd),
        "wo": dense_init(gen, nh * hd, d, dtype, scale=1.0 / math.sqrt(nh * hd),
                         stack=stack).reshape(*stack, nh, hd, d),
    }
    if cfg.qkv_bias:
        for name, h in (("bq", nh), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((*stack, h, hd), dtype=dtype,
                                  device=gen.device)
    return p


def _proj_heads(x, w):
    """``einsum("...d,dnh->...nh", x, w)`` as one matrix product."""
    d, n, h = w.shape
    return torch.matmul(x, w.reshape(d, n * h)).unflatten(-1, (n, h))


def _project_qkv(p, cfg, x):
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _out_proj(out, wo):
    """``einsum("...nh,nhd->...d", out, wo)`` as one matrix product."""
    n, h, d = wo.shape
    return torch.matmul(out.flatten(-2), wo.reshape(n * h, d))


def _gqa_expand(k, nh):
    """KV heads -> query heads: query head ``h`` reads KV head
    ``h // (nh / nkv)`` (``jnp.repeat`` on the head axis)."""
    nkv = k.shape[-2]
    if nkv == nh:
        return k
    return torch.repeat_interleave(k, nh // nkv, dim=-2)


def _banded_sdpa(q, k, v, window, scale, q_chunk=1024):
    """Causal sliding-window attention evaluated band-wise: the query chunk
    ``[q0, q0 + c)`` can attend only keys in ``(q0 - window, q0 + c)``, so
    each chunk's scores are ``[c, window + c]`` instead of ``[c, S]``.  The
    same mask as ``causal_mask(S, S, window)``; falls back to it where the
    chunks do not tile ``S`` or the band would cover it.

    q, k, v: [.., S, H, D] self-attention at aligned positions.
    """
    S = q.shape[-3]
    c = min(q_chunk, S)
    if S % c or window <= 0 or S <= window + c:
        return _sdpa(q, k, v, causal_mask(S, S, window, device=q.device),
                     scale)
    band = window + c
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    # query t = q0 + ti attends key j = q0 - window + ki iff ki <= ti +
    # window (causal), ki > ti (window) and j >= 0 (not left padding)
    ti = torch.arange(c, device=q.device)[:, None]
    ki = torch.arange(band, device=q.device)[None, :]
    rel_ok = (ki <= ti + window) & (ki > ti)
    outs = []
    for i in range(S // c):
        q0 = i * c
        valid = rel_ok & (ki + q0 - window >= 0)
        outs.append(_sdpa(q[..., q0:q0 + c, :, :], kp[..., q0:q0 + band, :, :],
                          vp[..., q0:q0 + band, :, :], valid, scale))
    return torch.cat(outs, dim=-3)


def attention(p, cfg, x, positions, *, window=0, cross_kv=None, bidir=False):
    """Self (causal, windowed or bidirectional) or cross attention.
    x: [..., S, d]; positions: [..., S] absolute (unused without RoPE);
    ``cross_kv``: ``(k, v)`` already projected from the encoder (whisper's
    decoder).  Causal self-attention goes through the flash kernel
    (``kernels.ops.flash_sdpa``) when ``cfg.flash_attention`` (the port's
    default); ``flash_attention=False`` asks for the plain masked softmax,
    the oracle.  Cross and bidirectional attention take the plain route
    with an all-true mask, as in the reference."""
    nh, hd = cfg.num_heads, cfg.hd
    q, k, v = _project_qkv(p, cfg, x)
    if cross_kv is not None:
        k, v = cross_kv
    elif cfg.rope_fraction > 0:
        cos, sin, rot = rope_cos_sin(positions, hd, cfg.rope_theta,
                                     cfg.rope_fraction)
        q = apply_rope(q, cos, sin, rot)
        k = apply_rope(k, cos, sin, rot)
    sq, sk = q.shape[-3], k.shape[-3]
    scale = 1.0 / math.sqrt(hd)
    if cfg.flash_attention and cross_kv is None and not bidir:
        # the kernel reads the KV heads itself
        out = kops.flash_sdpa(q, k, v, scale=scale, causal=True,
                              window=window)
        return _out_proj(out, p["wo"])
    k, v = _gqa_expand(k, nh), _gqa_expand(v, nh)
    if cross_kv is not None or bidir:
        out = _sdpa(q, k, v, torch.ones((sq, sk), dtype=torch.bool,
                                        device=x.device), scale)
    elif window and sq == sk and sq > 2 * window:
        out = _banded_sdpa(q, k, v, window, scale,
                           q_chunk=max(min(window, 1024), 128))
    else:
        out = _sdpa(q, k, v, causal_mask(sq, sk, window, device=x.device),
                    scale)
    return _out_proj(out, p["wo"])


def attention_decode(p, cfg, x, cache, pos, *, window=0, cross=False):
    """Single-token cached decode.  x: [..., 1, d]; pos: 0-dim int tensor
    on x's device (count of tokens already in the cache; the new token's
    absolute position).

    cache: {"k","v": [..., W, nkv, hd]} with W = ring-buffer length.  Unlike
    the reference, which returns a new cache, the new token's K/V are
    written into ``cache`` IN PLACE (``index_copy_`` at slot ``pos % W``,
    a device index, so there is no host sync): copying a multi-GB cache per
    token is not affordable.  ``cross=True``: attend over a pre-filled
    cache and write nothing (whisper's cross-attention; ``pos`` is then the
    encoder length, slots ``>= pos`` masked).  Returns ``(out, cache)``,
    the same dict.
    """
    nh, hd = cfg.num_heads, cfg.hd
    q, k, v = _project_qkv(p, cfg, x)
    ck, cv = cache["k"], cache["v"]
    W = ck.shape[-3]
    slot_ids = torch.arange(W, device=ck.device)
    if cross:
        valid = slot_ids < pos
    else:
        if cfg.rope_fraction > 0:
            cos, sin, rot = rope_cos_sin(pos.reshape(1), hd, cfg.rope_theta,
                                         cfg.rope_fraction)
            q = apply_rope(q, cos, sin, rot)
            k = apply_rope(k, cos, sin, rot)
        dim = ck.dim() - 3
        slot = torch.remainder(pos, W).reshape(1).long()
        ck.index_copy_(dim, slot, k.to(ck.dtype))
        cv.index_copy_(dim, slot, v.to(cv.dtype))
        # absolute position currently stored in each slot
        slot_pos = pos - torch.remainder(pos - slot_ids, W)
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        if window:
            valid &= slot_pos > pos - window
    kk = _gqa_expand(ck, nh)
    vv = _gqa_expand(cv, nh)
    out = _sdpa(q, kk, vv, valid[None, None, :], 1.0 / math.sqrt(hd))
    return _out_proj(out, p["wo"]), cache


def init_attn_cache(batch_dims, cfg, length, dtype, device, stack=()):
    shape = (*stack, *batch_dims, length, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d, f, gated, dtype, stack=()):
    p = {"w_up": dense_init(gen, d, f, dtype, stack=stack),
         "w_down": dense_init(gen, f, d, dtype, scale=1.0 / math.sqrt(f),
                              stack=stack)}
    if gated:
        p["w_gate"] = dense_init(gen, d, f, dtype, stack=stack)
    return p


def mlp(p, x, gated):
    h = x @ p["w_up"]
    if gated:
        h = F.silu(x @ p["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_down"]
