"""Uniform Model interface, the counterpart of ``repro.models.model_factory``.

A ``Model`` bundles, for one ``ArchConfig`` of any family of the reference
(``dense`` and ``moe``: ``models/transformer.py``; ``vlm``:
``models/vlm.py``; ``audio``: ``models/whisper.py``; ``ssm``:
``models/xlstm.py``; ``hybrid``: ``models/zamba.py``):

  init(gen)                        -> params on the model's device
  loss(params, batch)              -> scalar training loss
  prefill_logits(params, batch)    -> forward at full length
  init_cache(batch, shape)         -> decode cache
  decode_step(params, cache, tok)  -> (logits, cache)
  batch_spec(shape)                -> {name: (shape, torch dtype)}

whisper's decode reads its cross caches, which
``whisper.whisper_prefill_cross`` fills from the encoder first, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import vlm as VLM
from repro_torch.models import whisper as WH
from repro_torch.models import xlstm as XL
from repro_torch.models import zamba as ZB

PyTree = Any

LM_FAMILIES = ("dense", "moe")
FAMILIES = LM_FAMILIES + ("vlm", "audio", "ssm", "hybrid")


class MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``.  The inits build their
    leaves on ``gen.device`` and draw into them from ``gen``; a draw into a
    ``meta`` tensor accepts a CPU generator and reads nothing from it, so
    with this one a whole init runs on ``meta`` and allocates nothing (the
    dry run's ``abstract_state``)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: str = "cuda"

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {self.cfg.family!r} "
                             f"({self.cfg.name}); the port has {FAMILIES}")

    @property
    def dev(self) -> torch.device:
        return resolve_device(self.device)

    def generator(self, seed: int) -> torch.Generator:
        """A ``torch.Generator`` on the model's device, seeded.  The
        ``meta`` device has no generator: a meta model gets a CPU one that
        reports ``meta`` (:class:`MetaGenerator`), so ``init`` builds every
        leaf on ``meta`` and draws nothing."""
        if self.dev.type == "meta":
            return MetaGenerator().manual_seed(seed)
        return torch.Generator(device=self.dev).manual_seed(seed)

    # ---------------- init ----------------
    def init(self, gen: torch.Generator) -> PyTree:
        """Random weights drawn from ``gen``, which must live on the model's
        device (``Model.generator``): a full-width model is drawn there, not
        on the host."""
        dev = self.dev
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        cfg = self.cfg
        if cfg.family in LM_FAMILIES:
            return T.init_lm(gen, cfg)
        if cfg.family == "vlm":
            return VLM.init_vlm(gen, cfg)
        if cfg.family == "audio":
            return WH.init_whisper(gen, cfg)
        dt = T.dtype_of(cfg)
        V = T.padded_vocab(cfg)
        embed = L.truncated_normal(gen, (V, cfg.d_model), 0.02, dt)
        if cfg.family == "ssm":
            body = {"layers": [
                {"slstm": XL.init_slstm(gen, cfg)} if self._is_slstm(i)
                else {"mlstm": XL.init_mlstm(gen, cfg)}
                for i in range(cfg.num_layers)]}
        else:
            body = {"body": ZB.init_zamba(gen, cfg)}
        return {"embed": embed, **body,
                "ln_f": torch.ones((cfg.d_model,), dtype=dt,
                                   device=gen.device),
                "head": L.dense_init(gen, cfg.d_model, V, dt)}

    def _is_slstm(self, i: int) -> bool:
        """xlstm: layer ``i`` is an sLSTM block iff ``i % slstm_every ==
        0`` (``slstm_every > 0``), else an mLSTM block."""
        k = self.cfg.ssm.slstm_every if self.cfg.ssm else 0
        return bool(k) and i % k == 0

    # ---------------- training loss ----------------
    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Mean token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (``batch_spec``'s ``train`` kind), attention
        windowed by ``cfg.sliding_window``; plus the router aux term for
        ``moe``.  ``vlm`` also reads ``patch_embeds`` (its loss over the
        text positions only), ``audio`` ``enc_embeds``."""
        cfg = self.cfg
        if cfg.family in LM_FAMILIES:
            return T.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                             window=cfg.sliding_window)
        if cfg.family == "vlm":
            return VLM.vlm_loss(params, cfg, batch["tokens"], batch["labels"],
                                batch["patch_embeds"],
                                window=cfg.sliding_window)
        if cfg.family == "audio":
            return WH.whisper_loss(params, cfg, batch["enc_embeds"],
                                   batch["tokens"], batch["labels"])
        h = self._body_hidden(params, batch["tokens"])
        return T.xent(T.logits_from_hidden(params, cfg, h), batch["labels"],
                      cfg.vocab_size)

    def _body_hidden(self, params, tokens):
        """The ``ssm`` or ``hybrid`` stack's final hidden state.  The
        hybrid's shared attention windows as decode does, by
        ``long_context_window`` (the window ``zamba_hidden`` falls back to
        when given none)."""
        cfg = self.cfg
        x = params["embed"][tokens]
        if cfg.family == "ssm":
            for i, bp in enumerate(params["layers"]):
                if self._is_slstm(i):
                    x = XL.slstm_block(bp["slstm"], cfg, x)
                else:
                    x = XL.mlstm_block(bp["mlstm"], cfg, x)
            return L.rms_norm(x, params["ln_f"])
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        window = cfg.sliding_window
        if cfg.long_context_window and S > cfg.long_context_window:
            window = cfg.long_context_window
        x = ZB.zamba_hidden(params["body"], cfg, x, positions, window=window)
        return L.rms_norm(x, params["ln_f"])

    # ---------------- serving ----------------
    def prefill_logits(self, params, batch, *, last_only: bool = False
                       ) -> torch.Tensor:
        """Forward at full length -> float32 logits ``[B, S, V]``.
        ``last_only=True`` projects only the final position through the LM
        head (``[B, 1, V]``), what a next-token sampler needs."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family in ("ssm", "hybrid"):
            h = self._body_hidden(params, tokens)
        elif cfg.family == "audio":
            h = WH.decoder_hidden(params, cfg, tokens, WH.encode(
                params, cfg, batch["enc_embeds"]))
        elif cfg.family == "vlm":
            h, _ = VLM.vlm_hidden(params, cfg, tokens, batch["patch_embeds"],
                                  window=cfg.sliding_window)
        else:
            B, S = tokens.shape
            positions = torch.arange(S, device=tokens.device).expand(B, S)
            h, _ = T.hidden_states(params, cfg,
                                   T.embed_tokens(params, cfg, tokens),
                                   positions, window=cfg.sliding_window)
        if last_only:
            h = h[:, -1:]
        if cfg.family == "audio":               # the head tied to tok_embed
            return WH.whisper_logits(params, h)
        return T.logits_from_hidden(params, cfg, h)

    def init_cache(self, batch: int, shape: InputShape) -> PyTree:
        cfg = self.cfg
        if cfg.family in LM_FAMILIES + ("vlm",):
            return T.init_cache(cfg, batch, T.cache_len(cfg, shape),
                                self.dev)
        if cfg.family == "audio":
            enc_len = min(shape.seq_len // cfg.encoder_downsample, 8192)
            return WH.init_whisper_cache(cfg, batch, shape.seq_len, enc_len,
                                         self.dev)
        pos = torch.zeros((), dtype=torch.int32, device=self.dev)
        if cfg.family == "ssm":
            return {"layers": [
                {"slstm": XL.init_slstm_state(batch, cfg, self.dev)}
                if self._is_slstm(i)
                else {"mlstm": XL.init_mlstm_state(batch, cfg, self.dev)}
                for i in range(cfg.num_layers)], "pos": pos}
        attn_len = min(shape.seq_len, cfg.long_context_window)
        return {"body": ZB.init_zamba_cache(cfg, batch, attn_len, self.dev),
                "pos": pos}

    def decode_step(self, params, cache, token) -> Tuple[torch.Tensor,
                                                         PyTree]:
        """One token against ``cache``; returns the logits and the cache
        with ``pos + 1``.  K/V caches and the hybrid's Mamba states are
        written in place; xlstm's recurrent states come back as new
        tensors, as in the reference."""
        cfg = self.cfg
        if cfg.family in LM_FAMILIES + ("vlm",):
            # ring-buffer semantics: a cache shorter than the context is a
            # sliding window of exactly its own length
            ring = cache["layers"]["k"].shape[-3]
            return T.decode_step(params, cfg, cache, token, window=ring)
        if cfg.family == "audio":
            return WH.whisper_decode_step(params, cfg, cache, token)
        x = params["embed"][token]
        if cfg.family == "ssm":
            states = []
            for i, (bp, st) in enumerate(zip(params["layers"],
                                             cache["layers"])):
                kind = "slstm" if self._is_slstm(i) else "mlstm"
                fn = XL.slstm_decode if kind == "slstm" else XL.mlstm_decode
                x, new = fn(bp[kind], cfg, x, st[kind])
                states.append({kind: new})
            h = L.rms_norm(x, params["ln_f"])
            return T.logits_from_hidden(params, cfg, h), {
                "layers": states, "pos": cache["pos"] + 1}
        body = cache["body"]
        attn_len = body["attn"]["k"].shape[-3] if "attn" in body else 0
        x, body = ZB.zamba_decode(params["body"], cfg, x, body, cache["pos"],
                                  window=attn_len)
        h = L.rms_norm(x, params["ln_f"])
        return T.logits_from_hidden(params, cfg, h), {
            "body": body, "pos": cache["pos"] + 1}

    # ---------------- batch specs ----------------
    def batch_spec(self, shape: InputShape) -> Dict[str, Tuple[tuple,
                                                               torch.dtype]]:
        """The reference's: tokens (and labels to train); ``vlm`` text of
        ``max(S - vision_tokens, 8)`` tokens beside the patch embeddings;
        ``audio`` frame embeddings ``[GB, S / encoder_downsample, d]`` and
        ``min(decoder_len_cap, max(S / 8, 16))`` decoder tokens."""
        cfg = self.cfg
        GB, S = shape.global_batch, shape.seq_len
        dt = T.dtype_of(cfg)
        i32 = torch.int32
        if shape.kind == "decode":
            return {"token": ((GB, 1), i32)}
        if cfg.family == "vlm":
            S = max(S - cfg.vision_tokens, 8)
            spec = {"tokens": ((GB, S), i32),
                    "patch_embeds": ((GB, cfg.vision_tokens,
                                      cfg.vision_embed_dim), dt)}
        elif cfg.family == "audio":
            enc_len = S // cfg.encoder_downsample
            S = min(cfg.decoder_len_cap, max(S // 8, 16))
            spec = {"enc_embeds": ((GB, enc_len, cfg.d_model), dt),
                    "tokens": ((GB, S), i32)}
        else:
            spec = {"tokens": ((GB, S), i32)}
        if shape.kind == "train":
            spec["labels"] = ((GB, S), i32)
        return spec


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    return Model(cfg, device)
