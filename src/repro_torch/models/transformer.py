"""Decoder-only transformer LM (dense) over a stacked layer tree.

The counterpart of the reference's ``repro.models.transformer`` for the
dense family.  Layer parameters are stacked along a leading layer dim, as
the reference's ``vmap``'d init leaves them, so a converted tree matches leaf
for leaf; the reference's ``lax.scan`` over the stack is a Python loop over
layer views here.  ``remat`` is not honoured: the backward keeps every
layer's activations instead of recomputing them, which costs memory only,
not numbers.

Training: ``lm_loss`` / ``xent``, the mean token cross-entropy over the
valid labels, which ``Model.loss`` differentiates.

Serving: ``init_cache`` / ``decode_step`` over a ring-buffer KV cache.  The
cache's K/V tensors are updated in place (see ``layers.attention_decode``).
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.models import layers as L


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
    return {"ln1": ones, "ln2": ones.clone(),
            "attn": L.init_attention(gen, cfg, dtype=dt, stack=stack),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt,
                              stack=stack)}


def block_apply(p, cfg, x, positions, *, window=0):
    """Pre-norm block.  (The reference also returns an MoE aux loss; a
    dense block has none.)"""
    h = L.attention(p["attn"], cfg, L.rms_norm(x, p["ln1"]), positions,
                    window=window)
    x = x + h
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]), cfg.gated_mlp)


def block_decode(p, cfg, x, cache, pos, *, window=0):
    h, cache = L.attention_decode(p["attn"], cfg, L.rms_norm(x, p["ln1"]),
                                  cache, pos, window=window)
    x = x + h
    y = L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]), cfg.gated_mlp)
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


def layer(blocks, i: int):
    """Layer ``i``'s parameters: views into the stacked tree."""
    return tree.map(lambda a: a[i], blocks)


def hidden_states(p, cfg, x, positions, *, window=0):
    """Run embedded inputs through the stack.  x: [B, S, d].  Returns
    ``(h, aux)`` as the reference does; aux (MoE load balance) is 0."""
    for i in range(cfg.num_layers):
        x = block_apply(layer(p["blocks"], i), cfg, x, positions,
                        window=window)
    return (L.rms_norm(x, p["ln_f"]),
            torch.zeros((), dtype=torch.float32, device=x.device))


def logits_from_hidden(p, cfg, h):
    """``(h @ w)`` in the working dtype, then float32."""
    w = p["embed"].T if cfg.tie_embeddings else p["head"]
    return (h @ w).float()


def embed_tokens(p, cfg, tokens):
    return p["embed"][tokens]


def lm_logits(p, cfg, tokens, *, window=0):
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    h, aux = hidden_states(p, cfg, embed_tokens(p, cfg, tokens), positions,
                           window=window)
    return logits_from_hidden(p, cfg, h), aux


def lm_loss(p, cfg, tokens, labels, *, window=0):
    """Mean token cross-entropy of the dense LM (no MoE aux term)."""
    logits, _ = lm_logits(p, cfg, tokens, window=window)
    return xent(logits, labels, cfg.vocab_size)


def xent(logits, labels, vocab_size):
    """Mean token cross-entropy; positions with label < 0 are masked.  The
    padded vocabulary columns (``>= vocab_size``) are set to ``-1e30``
    before the float32 ``log_softmax``; the sum over valid positions is
    divided by ``max(#valid, 1)``."""
    V = logits.shape[-1]
    pad = torch.arange(V, device=logits.device) < vocab_size
    lp = torch.log_softmax(torch.where(pad, logits, -1e30), dim=-1)
    valid = labels >= 0
    ll = torch.gather(lp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return -torch.where(valid, ll, 0.0).sum() / valid.sum().clamp(min=1)


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
    ``pos``, a 0-dim int32 tensor on ``device``."""
    dev = torch.device(device)
    return {"layers": L.init_attn_cache((batch,), cfg, length, dtype_of(cfg),
                                        dev, stack=(cfg.num_layers,)),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


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
