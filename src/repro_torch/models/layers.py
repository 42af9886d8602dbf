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

Each ``*_pspecs`` gives the tree of *logical axis tuples* of the matching
``init_*`` tree, leaf for leaf the reference's; ``models/sharding.py``
resolves them into mesh axes.

Tensor parallelism (``comm/tensor_parallel.py``, the mesh's ``model``
axis): a rank's attention weights hold its share of the query and KV heads
(Q/K/V column-parallel, O row-parallel) and its MLP weights its share of
``d_ff`` (up and gate column-parallel, down row-parallel; an MoE layer's
experts alike, each expert's ``d_ff`` split, ``models/moe.py``).  The
split runs for the dense and MoE families (``sharding.SPLIT_FAMILIES``).
The head counts are read from the tensors, never from ``cfg``; the input
goes through ``copy_to`` and the output through ``reduce_sum`` on
``model``, both the identity without a ``model`` split.  Where ``model``
divides the KV heads GQA's head mapping stays local; where it does not
(replicated-KV GQA) ``wk``/``wv``/``bk``/``bv`` are whole on every rank,
each rank projects the run of KV heads its query heads read
(:func:`kv_span`; where they do not read whole groups of one KV head,
``sharding.kv_groups`` is ``None``, expanded to its query heads, group 1,
before the kernel) and the weights' gradients are all-reduced over
``model`` (``copy_to`` on the weight).

Context parallelism (the reference's ``kv_seq``): where ``model`` does
not divide the query heads, every attention weight is whole on every rank
(``safe_pspec`` replicates ``heads`` and ``kv``) and each rank projects
Q, K and V whole, attends its share ``[r S/M, (r+1) S/M)`` of the keys
through the flash kernel at key offset ``k0 = r S/M`` with the rows'
log-sum-exp, and the shares merge over ``model``
(``tensor_parallel.merge_attention``): the output is whole and bitwise
equal on every rank, so ``wo`` takes no ``reduce_sum``; Q, K and V go
through ``copy_to``, so their gradients, and every attention weight's,
are summed over the shares and whole on every rank
(:func:`_context_parallel_kv`).  Decode, wherever ``model`` does not
divide the KV heads (the reference's ``kv_div`` false): each rank's cache
holds every KV head over its ``W/M`` slots of the ring
(:func:`init_attn_cache`), the new token's K/V are written by the rank
that owns slot ``pos % W``, and each rank attends its slots for every
query head (the one-token Q all-gathered where the heads are split) with
the plain masked softmax and its log-sum-exp, merged, then keeps its
heads for ``wo``.  Where ``model`` divides neither the KV heads nor the
ring, the cache's spec replicates it: every rank holds every KV head over
the whole ring, writes every token and attends alone.  Which of the three
layouts a cache has (:func:`cache_layout`) is read from its resolved
specs (``train.serve_step.cache_pspecs``), never from a rank's slot count.

FSDP (``comm/fsdp.py``, the hierarchical rules' ``data`` axis): a rank
holds its shard of each weight's ``embed`` dim and gathers the weight
where it multiplies by it (``fsdp.matmul``, which keeps only the shard
for the backward pass and gathers again there), so only the weight at
hand is whole; a weight without an ``embed`` dim (biases, norms) is whole
on every rank, its gradient all-reduced over ``data`` (``fsdp.gather``
with ``dim=None``).  Both are one process's products without the split.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

from repro_torch.comm import fsdp as FS
from repro_torch.comm import tensor_parallel as TP
from repro_torch.kernels import ops as kops
from repro_torch.models import sharding as SH
# the masked-softmax oracle (the reference's ``_sdpa`` and ``causal_mask``)
# lives beside the kernel it checks, so that the plain path and the oracle
# are one function
from repro_torch.kernels.flash_attention import causal_mask
from repro_torch.kernels.flash_attention import sdpa as _sdpa
from repro_torch.kernels.flash_attention import sdpa_lse as _sdpa_lse


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


def attention_pspecs(cfg):
    s = {"wq": ("embed", "heads", None), "wk": ("embed", "kv", None),
         "wv": ("embed", "kv", None), "wo": ("heads", None, "embed")}
    if cfg.qkv_bias:
        s.update({"bq": ("heads", None), "bk": ("kv", None),
                  "bv": ("kv", None)})
    return s


def context_parallel(cfg) -> bool:
    """Whether attention runs context-parallel: a ``model`` split that does
    not divide the query heads (the reference's ``_context_parallel_kv``
    fallback)."""
    m = TP.size("model")
    return m > 1 and cfg.num_heads % m != 0


def _context_parallel_kv(q, k, v, nh):
    """The reference's fallback when the heads do not divide the model
    axis: K/V's sequence dim on it.  Returns ``(q, k, v, k0)``: where the
    resolved ``kv_seq`` spec splits the keys, the whole Q through
    ``copy_to`` and this rank's share ``[k0, k0 + S/M)`` of the whole K
    and V through ``copy_to`` (each rank's share adds its part to their
    gradients); else the inputs and ``k0 = None`` (no ``model`` split,
    heads that divide it, or ``S % M != 0``, which ``safe_pspec``
    replicates: every rank attends the whole sequence, as the
    reference)."""
    m = TP.size("model")
    if m == 1 or nh % m == 0:
        return q, k, v, None              # heads shard cleanly: leave it
    k = SH.constrain(k, None, "kv_seq", None, None)
    v = SH.constrain(v, None, "kv_seq", None, None)
    s = k.shape[-3]
    if s % m:
        return q, k, v, None
    q, k, v = (TP.copy_to(t, "model") for t in (q, k, v))
    n = s // m
    k0 = TP.rank("model") * n
    return q, k.narrow(-3, k0, n), v.narrow(-3, k0, n), k0


def kv_span(cfg):
    """Replicated-KV GQA: the KV heads ``(k0, k1)`` this rank's query
    heads read (a contiguous run), or ``None`` when the KV heads split
    over ``model`` like the query heads, there is no ``model`` split, or
    attention runs context-parallel (every weight whole)."""
    m = TP.size("model")
    if m == 1 or cfg.num_kv_heads % m == 0 or context_parallel(cfg):
        return None
    nh_l = cfg.num_heads // m
    g = cfg.num_heads // cfg.num_kv_heads
    r = TP.rank("model")
    return r * nh_l // g, ((r + 1) * nh_l - 1) // g + 1


def _kv_index(cfg, span, device):
    """Where a rank's query heads do not read whole groups of one KV head
    (``sharding.kv_groups`` is ``None``): the index into the span's KV
    heads of each of its query heads, which expands K and V to group 1;
    ``None`` otherwise."""
    m = TP.size("model")
    if span is None or SH.kv_groups(cfg.num_heads, cfg.num_kv_heads,
                                    m) is not None:
        return None
    nh_l = cfg.num_heads // m
    h0 = TP.rank("model") * nh_l
    heads = torch.arange(h0, h0 + nh_l, device=device)
    return torch.div(heads, cfg.num_heads // cfg.num_kv_heads,
                     rounding_mode="floor") - span[0]


def _proj_heads(x, w, **kw):
    """``einsum("...d,dnh->...nh", x, w)`` as one matrix product (``w``
    gathered over ``data`` under FSDP; ``kw`` of ``fsdp.matmul``)."""
    return FS.matmul(x, w, 0, **kw).unflatten(-1, (-1, w.shape[-1]))


def _project_qkv(p, cfg, x, all_kv=False):
    """Q, K and V of ``x``.  Replicated-KV GQA: K and V of the run of KV
    heads this rank's query heads read (:func:`kv_span`; expanded to its
    query heads, group 1, where they do not read whole groups), or of
    every KV head with ``all_kv``."""
    span = kv_span(cfg)
    kw = {}
    if span is not None:
        kw = dict(copy_model=True,
                  heads=None if all_kv else (1, span[0], span[1]))

    def kv_bias(name):
        b = FS.gather(p[name], None)
        if span is None:
            return b
        b = TP.copy_to(b, "model")
        return b if all_kv else b.narrow(-2, span[0], span[1] - span[0])
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"], **kw)
    v = _proj_heads(x, p["wv"], **kw)
    if cfg.qkv_bias:
        q, k, v = (q + FS.gather(p["bq"], None), k + kv_bias("bk"),
                   v + kv_bias("bv"))
    idx = None if all_kv else _kv_index(cfg, span, k.device)
    if idx is not None:
        k, v = k.index_select(-2, idx), v.index_select(-2, idx)
    return q, k, v


def _out_proj(out, wo, whole=False):
    """``einsum("...nh,nhd->...d", out, wo)`` as one matrix product, the
    partial sums added over ``model`` unless ``whole`` (context-parallel
    attention: every head's output and ``wo`` whole on every rank; ``wo``
    gathered over ``data`` under FSDP)."""
    y = FS.matmul(out.flatten(-2), wo, 2, k=2)
    return y if whole else TP.reduce_sum(y, "model")


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
    with an all-true mask, as in the reference.  Under a ``model`` split
    the heads are this rank's, the output its partial sum all-reduced;
    context-parallel (:func:`context_parallel`), every head whole and the
    flash route over this rank's share of the keys, merged (the plain
    route attends the whole sequence on every rank)."""
    hd = cfg.hd
    cp = context_parallel(cfg)
    q, k, v = _project_qkv(p, cfg, x if cp else TP.copy_to(x, "model"))
    nh = q.shape[-2]                     # this rank's query heads
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
        q, k, v, k0 = _context_parallel_kv(q, k, v, cfg.num_heads)
        if k0 is None:
            out = kops.flash_sdpa(q, k, v, scale=scale, causal=True,
                                  window=window)
        else:
            out, lse = kops.flash_sdpa(q, k, v, scale=scale, causal=True,
                                       window=window, k0=k0, lse=True)
            out, _ = TP.merge_attention(out, lse.transpose(-1, -2), "model")
        return _out_proj(out, p["wo"], whole=cp)
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
    return _out_proj(out, p["wo"], whole=cp)


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
    the same dict.  Under a ``model`` split the cache has one of the
    layouts of :func:`cache_layout`: this rank's KV heads (``"heads"``);
    every KV head over this rank's ``W/M`` slots (``"seq"``, the
    reference's ``kv_seq`` cache): the rank that owns slot ``pos % W``
    writes the new token, every rank attends its slots for every query
    head, and the shares merge over ``model``; or every KV head over the
    whole ring on every rank (``"whole"``): every rank writes the token
    and attends the whole ring for every query head, then keeps its heads.
    """
    hd = cfg.hd
    cp = context_parallel(cfg)
    q, k, v = _project_qkv(p, cfg, x if cp else TP.copy_to(x, "model"),
                           all_kv=True)
    nh = q.shape[-2]
    ck, cv = cache["k"], cache["v"]
    scale = 1.0 / math.sqrt(hd)
    if cross:
        valid = torch.arange(ck.shape[-3], device=ck.device) < pos
        out = _sdpa(q, _gqa_expand(ck, nh), _gqa_expand(cv, nh),
                    valid[None, None, :], scale)
        return _out_proj(out, p["wo"], whole=cp), cache
    if cfg.rope_fraction > 0:
        cos, sin, rot = rope_cos_sin(pos.reshape(1), hd, cfg.rope_theta,
                                     cfg.rope_fraction)
        q = apply_rope(q, cos, sin, rot)
        k = apply_rope(k, cos, sin, rot)
    layout = cache_layout(cfg)
    seq = layout == "seq"
    r = TP.rank("model") if seq else 0
    wl = ck.shape[-3]                             # this rank's slots
    W = cache_ring(cfg, ck)
    dim = ck.dim() - 3
    slot = torch.remainder(pos, W).reshape(1).long()
    k, v = k.to(ck.dtype), v.to(cv.dtype)
    if seq:
        # only the slot's owner writes the new token (a select on the
        # device: no host sync)
        local = slot - r * wl
        own = (local >= 0) & (local < wl)
        slot = local.clamp(0, wl - 1)
        k = torch.where(own, k, ck.index_select(dim, slot))
        v = torch.where(own, v, cv.index_select(dim, slot))
    ck.index_copy_(dim, slot, k)
    cv.index_copy_(dim, slot, v)
    # absolute position currently stored in each of this rank's slots
    slot_ids = r * wl + torch.arange(wl, device=ck.device)
    slot_pos = pos - torch.remainder(pos - slot_ids, W)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid &= slot_pos > pos - window
    if layout == "heads":
        out = _sdpa(q, _gqa_expand(ck, nh), _gqa_expand(cv, nh),
                    valid[None, None, :], scale)
        return _out_proj(out, p["wo"]), cache
    if not cp:
        q = TP.gather_dim(q, -2, "model")         # every query head
    kk = _gqa_expand(ck, q.shape[-2])
    vv = _gqa_expand(cv, q.shape[-2])
    if seq:
        out, lse = _sdpa_lse(q, kk, vv, valid[None, None, :], scale)
        out, _ = TP.merge_attention(out, lse.transpose(-1, -2), "model")
    else:                                         # the whole ring here
        out = _sdpa(q, kk, vv, valid[None, None, :], scale)
    if not cp:
        out = out.narrow(-2, TP.rank("model") * nh, nh)   # this rank's heads
    return _out_proj(out, p["wo"], whole=cp), cache


# the decode cache's layout named by its specs (train.serve_step), while a
# serving step or a cache built for a mesh runs
_CACHE_LAYOUT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cache_layout", default=None)


@contextlib.contextmanager
def cache_layout_context(layout):
    """Inside, the decode caches have ``layout`` (:func:`cache_layout`;
    ``None``: derived as outside)."""
    token = _CACHE_LAYOUT.set(layout)
    try:
        yield
    finally:
        _CACHE_LAYOUT.reset(token)


def cache_layout(cfg, length=None) -> str:
    """A decode cache's layout under the ``model`` split in force:
    ``"heads"`` (no split, or ``model`` divides the KV heads: this rank's
    KV heads), else ``"seq"`` (every KV head over this rank's ``1/M`` of
    the ring: the reference's ``kv_seq`` cache) or ``"whole"`` (every KV
    head over the whole ring: a ring ``model`` does not divide, which the
    cache's spec replicates).  The last two as the cache's resolved specs
    name them (``cache_layout_context``, entered by ``train.serve_step``);
    without that context, by the specs' rule on a ring of ``length``
    slots.  A rank's slots do not tell the two apart, so with neither a
    ``ValueError``: decode such a cache through
    ``train.serve_step.make_serve_step(..., shape=)``."""
    m = TP.size("model")
    if m == 1 or cfg.num_kv_heads % m == 0:
        return "heads"
    layout = _CACHE_LAYOUT.get()
    if layout is not None:
        return layout
    if length is None:
        raise ValueError(
            f"{cfg.num_kv_heads} KV heads do not split over model={m}: the "
            f"decode cache holds a share of the ring or the whole of it, "
            f"which its specs name; decode through "
            f"train.serve_step.make_serve_step(..., shape=)")
    return "whole" if length % m else "seq"


def cache_ring(cfg, k: torch.Tensor) -> int:
    """The ring's length W from a rank's K cache ``[..., slots, nkv, hd]``:
    its slots, times M on the ``kv_seq`` cache (:func:`cache_layout`
    ``"seq"``)."""
    return k.shape[-3] * (TP.size("model") if cache_layout(cfg) == "seq"
                          else 1)


def init_attn_cache(batch_dims, cfg, length, dtype, device, stack=()):
    """Zeroed K/V ``[*stack, *batch_dims, length, nkv, hd]``, under a
    ``model`` split of M this rank's cut of the :func:`cache_layout` of a
    ring of ``length`` slots: ``nkv / M`` KV heads (``"heads"``), every KV
    head over ``length / M`` slots (``"seq"``), or the whole cache
    (``"whole"``)."""
    nkv = cfg.num_kv_heads
    m = TP.size("model")
    layout = cache_layout(cfg, length)
    if layout == "seq":
        if length % m:
            raise ValueError(f"a kv_seq cache of {length} slots does not "
                             f"split over model={m}")
        length //= m
    elif layout == "heads":
        nkv //= m
    shape = (*stack, *batch_dims, length, nkv, cfg.hd)
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


def mlp_pspecs(gated):
    s = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if gated:
        s["w_gate"] = ("embed", "mlp")
    return s


def mlp(p, x, gated):
    """Under a ``model`` split: this rank's columns of ``d_ff``, the output
    its partial sum all-reduced; under an FSDP split the weights gathered
    over ``data``."""
    x = TP.copy_to(x, "model")
    h = FS.matmul(x, p["w_up"], 0)
    if gated:
        h = F.silu(FS.matmul(x, p["w_gate"], 0)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return TP.reduce_sum(FS.matmul(h, p["w_down"], 1), "model")
