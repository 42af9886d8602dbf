"""Uniform Model interface, the counterpart of ``repro.models.model_factory``.

A ``Model`` bundles, for one ``ArchConfig`` of a ported family (``dense``):

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
from repro_torch.models import transformer as T

PyTree = Any


def _unported(cfg) -> NotImplementedError:
    return NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet "
        f"(ROADMAP Queue 1 #12)")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: str = "cuda"

    def __post_init__(self):
        if self.cfg.family != "dense":
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
        return T.init_lm(gen, self.cfg)

    # ---------------- training loss ----------------
    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Mean token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (``batch_spec``'s ``train`` kind), attention
        windowed by ``cfg.sliding_window``."""
        return T.lm_loss(params, self.cfg, batch["tokens"], batch["labels"],
                         window=self.cfg.sliding_window)

    # ---------------- serving ----------------
    def prefill_logits(self, params, batch, *, last_only: bool = False
                       ) -> torch.Tensor:
        """Forward at full length -> float32 logits ``[B, S, V]``.
        ``last_only=True`` projects only the final position through the LM
        head (``[B, 1, V]``), what a next-token sampler needs."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        h, _ = T.hidden_states(params, cfg, T.embed_tokens(params, cfg, tokens),
                               positions, window=cfg.sliding_window)
        if last_only:
            h = h[:, -1:]
        return T.logits_from_hidden(params, cfg, h)

    def init_cache(self, batch: int, shape: InputShape) -> PyTree:
        return T.init_cache(self.cfg, batch, T.cache_len(self.cfg, shape),
                            self.dev)

    def decode_step(self, params, cache, token) -> Tuple[torch.Tensor,
                                                         PyTree]:
        # ring-buffer semantics: a cache shorter than the context is a
        # sliding window of exactly its own length
        ring = cache["layers"]["k"].shape[-3]
        return T.decode_step(params, self.cfg, cache, token, window=ring)

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
