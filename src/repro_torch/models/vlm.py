"""Phi-3-vision style VLM backbone (hf:microsoft/Phi-3-vision-128k-instruct).

The counterpart of the reference's ``repro.models.vlm``.  The ViT/CLIP
image encoder is a stub there too: the inputs are patch embeddings ``[B,
vision_tokens, vision_embed_dim]``.  The projector (linear vision ->
d_model) and the phi-3-mini decoder over the sequence

    [ projected patch tokens | text tokens ]

are implemented, the loss taken over the text positions only.  Serving
decodes as the dense LM does (``transformer.decode_step``).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init_vlm(gen, cfg):
    """The dense LM's weights and a projector ``[vision_embed_dim,
    d_model]``."""
    p = T.init_lm(gen, cfg)
    p["projector"] = L.dense_init(gen, cfg.vision_embed_dim, cfg.d_model,
                                  T.dtype_of(cfg))
    return p


def vlm_pspecs(cfg):
    s = T.lm_pspecs(cfg)
    s["projector"] = (None, "embed")
    return s


def vlm_hidden(p, cfg, tokens, patch_embeds, *, window=0):
    """tokens: [B, S_text]; patch_embeds: [B, Nv, vision_dim] -> (hidden
    [B, Nv + S_text, d], aux), at positions ``0 .. Nv + S_text - 1``."""
    img = (patch_embeds @ p["projector"]).to(T.dtype_of(cfg))
    txt = T.embed_tokens(p, cfg, tokens)
    x = torch.cat([img, txt], dim=-2)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    return T.hidden_states(p, cfg, x, positions, window=window)


def vlm_loss(p, cfg, tokens, labels, patch_embeds, *, window=0):
    """Mean cross-entropy of the text positions (labels ``[B, S_text]``);
    the image positions carry no label."""
    h, _ = vlm_hidden(p, cfg, tokens, patch_embeds, window=window)
    nv = patch_embeds.shape[-2]
    return T.xent(T.logits_from_hidden(p, cfg, h[:, nv:]), labels,
                  cfg.vocab_size)
