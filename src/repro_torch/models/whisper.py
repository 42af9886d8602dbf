"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

The counterpart of the reference's ``repro.models.whisper``.  The modality
frontend (log-mel and two conv layers) is a stub there too: the inputs are
post-conv frame embeddings ``[B, enc_len, d_model]``.  Downstream of it:
sinusoidal encoder positions, a bidirectional encoder, a causal decoder
with cross-attention, learned decoder positions and a head tied to the
token embedding.  Encoder and decoder blocks are stacked on a leading layer
dim, as the reference's ``vmap``'d init leaves them; its ``lax.scan`` over
the stack is a Python loop over layer views here.

Routes (``layers.attention``): the decoder's causal self-attention through
the flash kernel; the encoder's bidirectional attention and the decoder's
cross-attention through the plain masked softmax, as in the reference.

Serving: ``init_whisper_cache``, then ``whisper_prefill_cross`` (the
encoder, and each layer's cross K/V written into the cache in place), then
``whisper_decode_step`` a token at a time, whose self-attention K/V are
written in place (``layers.attention_decode``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """``[length, channels]`` float32: sines then cosines of ``position x
    10000^(-i / (channels/2 - 1))``."""
    half = channels // 2
    scale = torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                      * math.log(10000.0) / max(half - 1, 1))
    ang = (torch.arange(length, dtype=torch.float32, device=device)[:, None]
           * scale[None, :])
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _norms(names, d, dt, device, stack):
    """LayerNorm scales (``lnX``: ones) and biases (``lnXb``: zeros)."""
    out = {}
    for name in names:
        out[name] = torch.ones((*stack, d), dtype=dt, device=device)
        out[name + "b"] = torch.zeros((*stack, d), dtype=dt, device=device)
    return out


def init_enc_block(gen, cfg, stack=()):
    dt = T.dtype_of(cfg)
    return {**_norms(("ln1", "ln2"), cfg.d_model, dt, gen.device, stack),
            "attn": L.init_attention(gen, cfg, dtype=dt, stack=stack),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, False, dt,
                              stack=stack)}


def init_dec_block(gen, cfg, stack=()):
    dt = T.dtype_of(cfg)
    return {**_norms(("ln1", "lnx", "ln2"), cfg.d_model, dt, gen.device,
                     stack),
            "self_attn": L.init_attention(gen, cfg, dtype=dt, stack=stack),
            "cross_attn": L.init_attention(gen, cfg, dtype=dt, stack=stack),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, False, dt,
                              stack=stack)}


def init_whisper(gen, cfg):
    """Random weights on ``gen``'s device: ``encoder_layers`` encoder and
    ``num_layers`` decoder blocks, each stack drawn in one go."""
    dt = T.dtype_of(cfg)
    d = cfg.d_model
    return {
        "enc_blocks": init_enc_block(gen, cfg, stack=(cfg.encoder_layers,)),
        "dec_blocks": init_dec_block(gen, cfg, stack=(cfg.num_layers,)),
        "tok_embed": L.truncated_normal(gen, (T.padded_vocab(cfg), d), 0.02,
                                        dt),
        "dec_pos": L.truncated_normal(gen, (cfg.decoder_len_cap, d), 0.01,
                                      dt),
        **_norms(("ln_enc", "ln_f"), d, dt, gen.device, ()),
    }


def whisper_pspecs(cfg):
    norm = (None,)
    eb = SH.stacked({"ln1": norm, "ln1b": norm, "ln2": norm, "ln2b": norm,
                     "attn": L.attention_pspecs(cfg),
                     "mlp": L.mlp_pspecs(False)}, "stack")
    db = SH.stacked({"ln1": norm, "ln1b": norm, "lnx": norm, "lnxb": norm,
                     "ln2": norm, "ln2b": norm,
                     "self_attn": L.attention_pspecs(cfg),
                     "cross_attn": L.attention_pspecs(cfg),
                     "mlp": L.mlp_pspecs(False)}, "stack")
    return {"enc_blocks": eb, "dec_blocks": db,
            "tok_embed": ("vocab", "embed"), "dec_pos": (None, "embed"),
            "ln_enc": norm, "ln_encb": norm, "ln_f": norm, "ln_fb": norm}


def _enc_block(bp, cfg, x):
    h = L.attention(bp["attn"], cfg, L.layer_norm(x, bp["ln1"], bp["ln1b"]),
                    None, bidir=True)
    x = x + h
    return x + L.mlp(bp["mlp"], L.layer_norm(x, bp["ln2"], bp["ln2b"]), False)


def encode(p, cfg, enc_embeds):
    """enc_embeds: [B, enc_len, d] (the conv frontend's stub output) ->
    the encoder's output, [B, enc_len, d]."""
    x = enc_embeds + sinusoids(enc_embeds.shape[-2], cfg.d_model,
                               enc_embeds.device).to(enc_embeds.dtype)
    for i in range(cfg.encoder_layers):
        x = _enc_block(T.layer(p["enc_blocks"], i), cfg, x)
    return L.layer_norm(x, p["ln_enc"], p["ln_encb"])


def _dec_block(bp, cfg, x, enc_kv):
    h = L.attention(bp["self_attn"], cfg,
                    L.layer_norm(x, bp["ln1"], bp["ln1b"]), None)
    x = x + h
    h = L.attention(bp["cross_attn"], cfg,
                    L.layer_norm(x, bp["lnx"], bp["lnxb"]), None,
                    cross_kv=enc_kv)
    x = x + h
    return x + L.mlp(bp["mlp"], L.layer_norm(x, bp["ln2"], bp["ln2b"]), False)


def _cross_kv(bp, cfg, enc_out):
    """One decoder layer's cross-attention K and V of the encoder output."""
    return (L._proj_heads(enc_out, bp["cross_attn"]["wk"]),
            L._proj_heads(enc_out, bp["cross_attn"]["wv"]))


def decoder_hidden(p, cfg, tokens, enc_out):
    """tokens: [B, S] (S <= decoder_len_cap) -> final hidden [B, S, d]."""
    S = tokens.shape[-1]
    x = p["tok_embed"][tokens] + p["dec_pos"][:S][None]
    for i in range(cfg.num_layers):
        bp = T.layer(p["dec_blocks"], i)
        x = _dec_block(bp, cfg, x, _cross_kv(bp, cfg, enc_out))
    return L.layer_norm(x, p["ln_f"], p["ln_fb"])


def whisper_logits(p, h):
    """The tied head: ``(h @ tok_embed^T)`` in the working dtype, then
    float32."""
    return (h @ p["tok_embed"].T).float()


def whisper_loss(p, cfg, enc_embeds, tokens, labels):
    enc_out = encode(p, cfg, enc_embeds)
    h = decoder_hidden(p, cfg, tokens, enc_out)
    return T.xent(whisper_logits(p, h), labels, cfg.vocab_size)


# -- serving ----------------------------------------------------------------

def init_whisper_cache(cfg, batch, self_len, enc_len, device):
    """Zeroed self-attention ring buffers ``[num_layers, batch, self_len,
    nkv, hd]``, cross caches ``[num_layers, batch, enc_len, nkv, hd]``,
    and 0-dim int32 ``pos`` and ``enc_len`` on ``device``."""
    dev = torch.device(device)
    dt = T.dtype_of(cfg)
    stack = (cfg.num_layers,)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return {"self": L.init_attn_cache((batch,), cfg, self_len, dt, dev,
                                      stack=stack),
            "cross": L.init_attn_cache((batch,), cfg, enc_len, dt, dev,
                                       stack=stack),
            "pos": zero, "enc_len": zero.clone()}


def whisper_prefill_cross(p, cfg, enc_embeds, cache):
    """Run the encoder and write each decoder layer's cross K/V into the
    cache's first ``enc_len`` slots, in place.  Returns the cache with
    ``enc_len`` set (a 0-dim device tensor)."""
    enc_out = encode(p, cfg, enc_embeds)
    ck, cv = cache["cross"]["k"], cache["cross"]["v"]
    E = enc_out.shape[-2]
    for i in range(cfg.num_layers):
        k, v = _cross_kv(T.layer(p["dec_blocks"], i), cfg, enc_out)
        ck[i, ..., :E, :, :].copy_(k)
        cv[i, ..., :E, :, :].copy_(v)
    return {**cache, "enc_len": torch.full((), E, dtype=torch.int32,
                                           device=ck.device)}


def whisper_decode_step(p, cfg, cache, token):
    """token: [B, 1] -> (logits [B, 1, V] float32, cache with ``pos +
    1``).  The decoder position is ``min(pos, decoder_len_cap - 1)``,
    indexed on the device (no host read)."""
    pos = cache["pos"]
    idx = torch.clamp(pos, max=cfg.decoder_len_cap - 1).reshape(1).long()
    h = p["tok_embed"][token] + p["dec_pos"].index_select(0, idx)[None]
    sk, sv = cache["self"]["k"], cache["self"]["v"]
    xk, xv = cache["cross"]["k"], cache["cross"]["v"]
    for i in range(cfg.num_layers):
        bp = T.layer(p["dec_blocks"], i)
        a, _ = L.attention_decode(bp["self_attn"], cfg,
                                  L.layer_norm(h, bp["ln1"], bp["ln1b"]),
                                  {"k": sk[i], "v": sv[i]}, pos)
        h = h + a
        a, _ = L.attention_decode(bp["cross_attn"], cfg,
                                  L.layer_norm(h, bp["lnx"], bp["lnxb"]),
                                  {"k": xk[i], "v": xv[i]}, cache["enc_len"],
                                  cross=True)
        h = h + a
        h = h + L.mlp(bp["mlp"], L.layer_norm(h, bp["ln2"], bp["ln2b"]),
                      False)
    h = L.layer_norm(h, p["ln_f"], p["ln_fb"])
    return whisper_logits(p, h), {**cache, "pos": pos + 1}
