"""Uniform Model interface, the counterpart of ``repro.models.model_factory``.

A ``Model`` bundles, for one ``ArchConfig`` of a ported family (``dense``
and ``moe``: ``models/transformer.py``; ``hybrid``: ``models/zamba.py``,
a Mamba2 stack with a shared attention block):

  init(gen)                        -> params on the model's device
  loss(params, batch)              -> scalar training loss
  prefill_logits(params, batch)    -> forward at full length
  init_cache(batch, shape)         -> decode cache
  decode_step(params, cache, tok)  -> (logits, cache)
  batch_spec(shape)                -> {name: (shape, torch dtype)}

Other families raise with the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import zamba as ZB

PyTree = Any


def _unported(cfg) -> NotImplementedError:
    return NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet "
        f"(ROADMAP Queue 1 #12)")


LM_FAMILIES = ("dense", "moe")
PORTED_FAMILIES = LM_FAMILIES + ("hybrid",)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: str = "cuda"

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise _unported(self.cfg)

    @property
    def dev(self) -> torch.device:
        return resolve_device(self.device)

    def generator(self, seed: int) -> torch.Generator:
        """A ``torch.Generator`` on the model's device, seeded."""
        return torch.Generator(device=self.dev).manual_seed(seed)

    # ---------------- init ----------------
    def init(self, gen: torch.Generator) -> PyTree:
        """Random weights drawn from ``gen``, which must live on the model's
        device (``Model.generator``): a full-width model is drawn there, not
        on the host."""
        dev = self.dev
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        if self.cfg.family in LM_FAMILIES:
            return T.init_lm(gen, self.cfg)
        return self._init_zamba(gen)

    def _init_zamba(self, gen):
        cfg = self.cfg
        dt = T.dtype_of(cfg)
        V = T.padded_vocab(cfg)
        return {"embed": L.truncated_normal(gen, (V, cfg.d_model), 0.02, dt),
                "body": ZB.init_zamba(gen, cfg),
                "ln_f": torch.ones((cfg.d_model,), dtype=dt,
                                   device=gen.device),
                "head": L.dense_init(gen, cfg.d_model, V, dt)}

    # ---------------- training loss ----------------
    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Mean token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (``batch_spec``'s ``train`` kind), attention
        windowed by ``cfg.sliding_window``; plus the router aux term for
        ``moe``."""
        cfg = self.cfg
        if cfg.family in LM_FAMILIES:
            return T.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                             window=cfg.sliding_window)
        h = self._body_hidden(params, batch["tokens"])
        return T.xent((h @ params["head"]).float(), batch["labels"],
                      cfg.vocab_size)

    def _body_hidden(self, params, tokens):
        """The hybrid stack's final hidden state.  Its shared attention
        windows as decode does, by ``long_context_window`` (the window
        ``zamba_hidden`` falls back to when given none)."""
        cfg = self.cfg
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        window = cfg.sliding_window
        if cfg.long_context_window and S > cfg.long_context_window:
            window = cfg.long_context_window
        x = ZB.zamba_hidden(params["body"], cfg, params["embed"][tokens],
                            positions, window=window)
        return L.rms_norm(x, params["ln_f"])

    # ---------------- serving ----------------
    def prefill_logits(self, params, batch, *, last_only: bool = False
                       ) -> torch.Tensor:
        """Forward at full length -> float32 logits ``[B, S, V]``.
        ``last_only=True`` projects only the final position through the LM
        head (``[B, 1, V]``), what a next-token sampler needs."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family not in LM_FAMILIES:
            h = self._body_hidden(params, tokens)
            if last_only:
                h = h[:, -1:]
            return (h @ params["head"]).float()
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        h, _ = T.hidden_states(params, cfg, T.embed_tokens(params, cfg, tokens),
                               positions, window=cfg.sliding_window)
        if last_only:
            h = h[:, -1:]
        return T.logits_from_hidden(params, cfg, h)

    def init_cache(self, batch: int, shape: InputShape) -> PyTree:
        cfg = self.cfg
        if cfg.family in LM_FAMILIES:
            return T.init_cache(cfg, batch, T.cache_len(cfg, shape),
                                self.dev)
        attn_len = min(shape.seq_len, cfg.long_context_window)
        return {"body": ZB.init_zamba_cache(cfg, batch, attn_len, self.dev),
                "pos": torch.zeros((), dtype=torch.int32, device=self.dev)}

    def decode_step(self, params, cache, token) -> Tuple[torch.Tensor,
                                                         PyTree]:
        """One token against ``cache``, whose tensors are written in place;
        returns the logits and the cache with ``pos + 1``."""
        cfg = self.cfg
        if cfg.family in LM_FAMILIES:
            # ring-buffer semantics: a cache shorter than the context is a
            # sliding window of exactly its own length
            ring = cache["layers"]["k"].shape[-3]
            return T.decode_step(params, cfg, cache, token, window=ring)
        body = cache["body"]
        attn_len = body["attn"]["k"].shape[-3] if "attn" in body else 0
        x, body = ZB.zamba_decode(params["body"], cfg, params["embed"][token],
                                  body, cache["pos"], window=attn_len)
        h = L.rms_norm(x, params["ln_f"])
        return (h @ params["head"]).float(), {"body": body,
                                              "pos": cache["pos"] + 1}

    # ---------------- batch specs ----------------
    def batch_spec(self, shape: InputShape) -> Dict[str, Tuple[tuple,
                                                               torch.dtype]]:
        GB, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"token": ((GB, 1), torch.int32)}
        spec = {"tokens": ((GB, S), torch.int32)}
        if shape.kind == "train":
            spec["labels"] = ((GB, S), torch.int32)
        return spec


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    return Model(cfg, device)
