"""Decoder-only transformer LM (dense and MoE) over a stacked layer tree.

The counterpart of the reference's ``repro.models.transformer``.  A block
holds an MLP (``dense``) or an MoE layer (``moe``, ``models/moe.py``),
whose router adds a load-balancing aux term to the loss.  Layer parameters are stacked along a leading layer dim, as
the reference's ``vmap``'d init leaves them, so a converted tree matches leaf
for leaf; the reference's ``lax.scan`` over the stack is a Python loop over
layer views here.  ``remat`` is not honoured: the backward keeps every
layer's activations instead of recomputing them, which costs memory only,
not numbers.

Training: ``lm_loss`` / ``xent``, the mean token cross-entropy over the
valid labels (plus ``aux_loss_weight`` times the summed MoE aux for the
``moe`` family), which ``Model.loss`` differentiates.

Serving: ``init_cache`` / ``decode_step`` over a ring-buffer KV cache.  The
cache's K/V tensors are updated in place (see ``layers.attention_decode``).

Tensor parallelism (``comm/tensor_parallel.py``): a rank's ``embed`` holds
its rows of the padded vocabulary and its ``head`` the same columns.  The
embedding looks up the tokens it owns, zeroes the rest and all-reduces;
the logits are this rank's columns (column-parallel); ``xent`` is
vocab-parallel: a max all-reduced without gradient, the sum of exponentials
all-reduced, the target logit taken from the rank that owns it, the padded
columns masked by their global index.  Serving gathers the logits whole
(``Model.prefill_logits`` / ``decode_step``).

FSDP (``comm/fsdp.py``): ``embed`` and ``head`` are gathered over
``data`` where used (the head's product through ``fsdp.matmul``, which
keeps only the shard for the backward pass), the norms' gradients
all-reduced over it (``fsdp.gather``); each rank holds its rows of the
batch, and ``xent`` is the mean over the whole batch: the sums of the
token losses and the counts of valid labels added over ``data`` before
the division.  The MoE aux is the same on every rank: its means over
every ``data`` rank's groups (``models/moe.py``).
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.comm import fsdp as FS
from repro_torch.comm import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import sharding as SH


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab_size // 256) * 256


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# One decoder block
# ---------------------------------------------------------------------------

def init_block(gen, cfg, stack=()):
    dt = dtype_of(cfg)
    ones = torch.ones((*stack, cfg.d_model), dtype=dt, device=gen.device)
    p = {"ln1": ones, "ln2": ones.clone(),
         "attn": L.init_attention(gen, cfg, dtype=dt, stack=stack)}
    if cfg.family == "moe":
        p["moe"] = M.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.moe,
                              cfg.gated_mlp, dt, stack=stack)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt,
                              stack=stack)
    return p


def block_apply(p, cfg, x, positions, *, window=0):
    """Pre-norm block.  Returns ``(x, aux)``: the MoE router's aux loss, a
    float32 scalar, or ``None`` for a dense block (which has none)."""
    h = L.attention(p["attn"], cfg,
                    L.rms_norm(x, FS.gather(p["ln1"], None)), positions,
                    window=window)
    x = x + h
    xn = L.rms_norm(x, FS.gather(p["ln2"], None))
    if cfg.family == "moe":
        y, aux = M.moe_layer(p["moe"], xn, cfg.moe, cfg.gated_mlp)
        return x + y, aux
    return x + L.mlp(p["mlp"], xn, cfg.gated_mlp), None


def block_decode(p, cfg, x, cache, pos, *, window=0):
    """One token through a block.  An MoE block routes it alone (a group of
    one token, capacity 1 for every shipped config)."""
    h, cache = L.attention_decode(p["attn"], cfg,
                                  L.rms_norm(x, FS.gather(p["ln1"], None)),
                                  cache, pos, window=window)
    x = x + h
    xn = L.rms_norm(x, FS.gather(p["ln2"], None))
    if cfg.family == "moe":
        y, _ = M.moe_layer(p["moe"], xn, cfg.moe, cfg.gated_mlp)
    else:
        y = L.mlp(p["mlp"], xn, cfg.gated_mlp)
    return x + y, cache


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def init_lm(gen, cfg):
    """Random LM weights on ``gen``'s device, blocks stacked on a leading
    ``num_layers`` dim."""
    dt = dtype_of(cfg)
    V = padded_vocab(cfg)
    p = {
        "embed": L.truncated_normal(gen, (V, cfg.d_model), 0.02, dt),
        "blocks": init_block(gen, cfg, stack=(cfg.num_layers,)),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, cfg.d_model, V, dt)
    return p


def block_pspecs(cfg):
    s = {"ln1": (None,), "ln2": (None,),
         "attn": L.attention_pspecs(cfg)}
    if cfg.family == "moe":
        s["moe"] = M.moe_pspecs(cfg.gated_mlp)
    else:
        s["mlp"] = L.mlp_pspecs(cfg.gated_mlp)
    return s


def lm_pspecs(cfg):
    s = {"embed": ("vocab", "embed"),
         "blocks": SH.stacked(block_pspecs(cfg), "stack"), "ln_f": (None,)}
    if not cfg.tie_embeddings:
        s["head"] = ("embed", "vocab")
    return s


def layer(blocks, i: int):
    """Layer ``i``'s parameters: views into the stacked tree."""
    return tree.map(lambda a: a[i], blocks)


def hidden_states(p, cfg, x, positions, *, window=0):
    """Run embedded inputs through the stack.  x: [B, S, d].  Returns
    ``(h, aux)`` as the reference does: aux is the MoE load balance summed
    over the layers in float32, 0 for a dense stack."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a = block_apply(layer(p["blocks"], i), cfg, x, positions,
                           window=window)
        if a is not None:
            aux = aux + a
    return L.rms_norm(x, FS.gather(p["ln_f"], None)), aux


def logits_from_hidden(p, cfg, h):
    """``(h @ w)`` in the working dtype, then float32: under a ``model``
    split this rank's columns of the padded vocabulary."""
    h = TP.copy_to(h, "model")
    if cfg.tie_embeddings:
        return FS.matmul(h, p["embed"], 1, k=-1).float()
    return FS.matmul(h, p["head"], 0).float()


def embed_tokens(p, cfg, tokens):
    """``embed[tokens]``; under a ``model`` split the rows this rank owns
    (the others zero), summed over the ranks: exact, one rank adds each
    row to zeros."""
    E = FS.gather(p["embed"], 1)
    if TP.current("model") is None:
        return E[tokens]
    n = E.shape[0]
    local = tokens.long() - TP.rank("model") * n
    own = (local >= 0) & (local < n)
    x = E[local.clamp(0, n - 1)]
    x = torch.where(own[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return TP.reduce_sum(x, "model")


def lm_logits(p, cfg, tokens, *, window=0):
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    h, aux = hidden_states(p, cfg, embed_tokens(p, cfg, tokens), positions,
                           window=window)
    return logits_from_hidden(p, cfg, h), aux


def lm_loss(p, cfg, tokens, labels, *, window=0):
    """Mean token cross-entropy, plus ``cfg.moe.aux_loss_weight`` times
    the summed router aux for the ``moe`` family."""
    logits, aux = lm_logits(p, cfg, tokens, window=window)
    loss = xent(logits, labels, cfg.vocab_size)
    if cfg.family == "moe":
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss


def xent(logits, labels, vocab_size):
    """Mean token cross-entropy; positions with label < 0 are masked.  The
    padded vocabulary columns (``>= vocab_size``) are set to ``-1e30``
    before the float32 ``log_softmax``; the sum over valid positions is
    divided by ``max(#valid, 1)``.  Under a ``model`` split ``logits`` are
    this rank's columns (:func:`_xent_vocab_parallel`)."""
    if TP.current("model") is not None:
        return _xent_vocab_parallel(logits, labels, vocab_size)
    V = logits.shape[-1]
    pad = torch.arange(V, device=logits.device) < vocab_size
    lp = torch.log_softmax(torch.where(pad, logits, -1e30), dim=-1)
    valid = labels >= 0
    ll = torch.gather(lp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return _mean_loss(ll, valid)


def _mean_loss(ll, valid):
    """``-sum(ll over valid) / max(#valid, 1)``; under an FSDP split the
    sum and the count over every ``data`` rank's rows."""
    total = TP.reduce_sum(-torch.where(valid, ll, 0.0).sum(), FS.AXIS)
    count = TP.reduce_sum(valid.sum().to(total.dtype), FS.AXIS)
    return total / count.clamp(min=1)


def _xent_vocab_parallel(logits, labels, vocab_size):
    """``xent`` over this rank's columns ``[r n, (r + 1) n)`` of the padded
    vocabulary: ``log p_t = z_t - m - log sum exp(z - m)`` with ``m`` the
    max over every rank (no gradient), the sum of exponentials and the
    target logit ``z_t`` (from the rank that owns the label) each summed
    over the ranks.  The same loss on every rank."""
    n = logits.shape[-1]
    v0 = TP.rank("model") * n
    cols = v0 + torch.arange(n, device=logits.device)
    z = torch.where(cols < vocab_size, logits, -1e30)
    m = TP.max_over(z.detach().amax(dim=-1, keepdim=True), "model")
    sumexp = TP.reduce_sum(torch.exp(z - m).sum(-1), "model")
    valid = labels >= 0
    local = labels.long() - v0
    own = (local >= 0) & (local < n)
    zt = torch.gather(z, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    zt = TP.reduce_sum(torch.where(own, zt, 0.0), "model")
    ll = zt - m[..., 0] - torch.log(sumexp)
    return _mean_loss(ll, valid)


# ---------------------------------------------------------------------------
# Serving: cache init / decode
# ---------------------------------------------------------------------------

def cache_len(cfg, shape) -> int:
    """Ring-buffer length for a decode workload."""
    if cfg.sliding_window or shape.seq_len > 32_768:
        return min(cfg.long_context_window, shape.seq_len)
    return shape.seq_len


def init_cache(cfg, batch, length, device):
    """Zeroed K/V ring buffers ``[num_layers, batch, length, nkv, hd]`` and
    ``pos``, a 0-dim int32 tensor on ``device``; under a ``model`` split
    this rank's cut (``layers.init_attn_cache``: its KV heads, or every KV
    head over its ``length / M`` slots)."""
    dev = torch.device(device)
    return {"layers": L.init_attn_cache((batch,), cfg, length, dtype_of(cfg),
                                        dev, stack=(cfg.num_layers,)),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def cache_pspecs(cfg):
    return {"layers": {"k": ("stack", "batch", None, "kv", None),
                       "v": ("stack", "batch", None, "kv", None)},
            "pos": ()}


def decode_step(p, cfg, cache, token, *, window=0):
    """token: [B, 1] int -> (logits [B, 1, V], cache).  The returned cache
    holds the same K/V tensors, written in place, and ``pos + 1``."""
    x = embed_tokens(p, cfg, token)
    pos = cache["pos"]
    layers = cache["layers"]
    for i in range(cfg.num_layers):
        x, _ = block_decode(layer(p["blocks"], i), cfg, x,
                            {"k": layers["k"][i], "v": layers["v"][i]}, pos,
                            window=window)
    h = L.rms_norm(x, p["ln_f"])
    return logits_from_hidden(p, cfg, h), {"layers": layers, "pos": pos + 1}
