"""Zamba2-style hybrid backbone (arXiv:2411.15242): a Mamba2 stack and one
*shared* attention block re-entered after every ``shared_attn_every``-th
layer.

The counterpart of the reference's ``repro.models.zamba``, with its
simplifications: the shared block reads the current hidden state (Zamba2
concatenates the original embedding and applies a LoRA per invocation;
both are omitted).  The Mamba layers are stacked on a leading layer dim, as
the reference's ``vmap``'d init leaves them, so a converted tree matches
leaf for leaf; the layer loop is a Python loop over views, as there.

Decode: one Mamba state per layer and one KV cache per invocation of the
shared block, stacked.  Unlike the reference, which returns new caches,
``zamba_decode`` writes the new Mamba states and the new token's K/V into
the cache's tensors IN PLACE (``layers.attention_decode`` does so for K/V)
and returns the same dict.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as MB
from repro_torch.models import sharding as SH


def n_shared_invocations(cfg) -> int:
    k = cfg.shared_attn_every
    return 0 if not k else cfg.num_layers // k


def init_zamba(gen, cfg):
    dt = getattr(torch, cfg.dtype)
    p = {"mamba": MB.init_mamba(gen, cfg, stack=(cfg.num_layers,))}
    if cfg.shared_attn_every:
        ones = torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
        p["shared_attn"] = {
            "ln1": ones,
            "ln2": ones.clone(),
            "attn": L.init_attention(gen, cfg, dtype=dt),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt),
        }
    return p


def zamba_pspecs(cfg):
    s = {"mamba": SH.stacked(MB.mamba_pspecs(), "stack")}
    if cfg.shared_attn_every:
        s["shared_attn"] = {"ln1": (None,), "ln2": (None,),
                            "attn": L.attention_pspecs(cfg),
                            "mlp": L.mlp_pspecs(cfg.gated_mlp)}
    return s


def _shared_block(p, cfg, x, positions, window):
    h = L.attention(p["attn"], cfg, L.rms_norm(x, p["ln1"]), positions,
                    window=window)
    x = x + h
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]), cfg.gated_mlp)


def zamba_hidden(p, cfg, x, positions, *, window=0):
    """x: [B, S, d] -> hidden [B, S, d].  The shared block attends within
    ``window or cfg.long_context_window``."""
    k = cfg.shared_attn_every
    for i in range(cfg.num_layers):
        x = MB.mamba_block(tree.map(lambda a: a[i], p["mamba"]), cfg, x)
        if k and (i + 1) % k == 0:
            x = _shared_block(p["shared_attn"], cfg, x, positions,
                              window or cfg.long_context_window)
    return x


def init_zamba_cache(cfg, batch, attn_len, device):
    """Mamba states ``[num_layers, batch, ...]`` and, with a shared block,
    K/V ring buffers ``[n_shared_invocations, batch, attn_len, nkv, hd]``."""
    dev = torch.device(device)
    caches = {"mamba": MB.init_mamba_state(batch, cfg, dev,
                                           stack=(cfg.num_layers,))}
    ninv = n_shared_invocations(cfg)
    if ninv:
        caches["attn"] = L.init_attn_cache((batch,), cfg, attn_len,
                                           getattr(torch, cfg.dtype), dev,
                                           stack=(ninv,))
    return caches


def zamba_decode(p, cfg, x, caches, pos, *, window):
    """x: [B, 1, d]; returns (h, caches), ``caches`` written in place."""
    k = cfg.shared_attn_every
    st, inv = caches["mamba"], 0
    for i in range(cfg.num_layers):
        x, new = MB.mamba_decode(tree.map(lambda a: a[i], p["mamba"]), cfg,
                                 x, {"h": st["h"][i], "conv": st["conv"][i]})
        st["h"][i].copy_(new["h"])
        st["conv"][i].copy_(new["conv"])
        if k and (i + 1) % k == 0:
            sp = p["shared_attn"]
            sc = {"k": caches["attn"]["k"][inv], "v": caches["attn"]["v"][inv]}
            h, _ = L.attention_decode(sp["attn"], cfg,
                                      L.rms_norm(x, sp["ln1"]), sc, pos,
                                      window=window)
            x = x + h
            x = x + L.mlp(sp["mlp"], L.rms_norm(x, sp["ln2"]), cfg.gated_mlp)
            inv += 1
    return x, caches
