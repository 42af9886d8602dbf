"""Serving steps (prefill forward + cached single-token decode).

The counterpart of the reference's ``repro.train.serve_step``.  Serving
carries no decentralized worker dim: at inference there is one model.
Prefill returns logits and fills no cache, as in the reference; decode runs
ONE new token against a cache from ``Model.init_cache``.  Each step runs
under ``torch.no_grad`` inside a profiler range (``serve.prefill`` /
``serve.decode``), the reference's named scopes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import InputShape
from repro_torch.models.model_factory import Model
from repro_torch.models.sharding import ShardingRules, resolve_tree, safe_pspec

PyTree = Any


def make_prefill_step(model: Model, *, last_only: bool = True
                      ) -> Callable[[PyTree, PyTree], torch.Tensor]:
    """Prefill forward.  last_only=True returns ``[B, 1, V]`` logits for the
    final position only, what a serving sampler consumes."""
    def prefill_step(params, batch):
        with torch.no_grad(), torch.profiler.record_function("serve.prefill"):
            return model.prefill_logits(params, batch, last_only=last_only)
    return prefill_step


def make_serve_step(model: Model
                    ) -> Callable[..., Tuple[torch.Tensor, PyTree]]:
    def serve_step(params, cache, token):
        with torch.no_grad(), torch.profiler.record_function("serve.decode"):
            return model.decode_step(params, cache, token)
    return serve_step


def abstract_cache(model: Model, shape: InputShape) -> PyTree:
    """``model.init_cache(shape.global_batch, shape)`` on
    ``torch.device("meta")``: the KV or recurrent caches at their shapes
    and dtypes, nothing allocated."""
    return dataclasses.replace(model, device="meta").init_cache(
        shape.global_batch, shape)


def cache_pspecs(model: Model, shape: InputShape, rules: ShardingRules,
                 mesh_shape) -> PyTree:
    """The cache's resolved specs: KV heads on the model axis when they
    divide it, else the sequence dim (``Model.cache_logical``)."""
    kv_div = model.cfg.num_kv_heads % max(mesh_shape.get("model", 1), 1) == 0
    def resolve(names, leaf):
        return safe_pspec(tuple(leaf.shape), rules.pspec(*names), mesh_shape)
    return resolve_tree(model.cache_logical(kv_div=kv_div),
                        abstract_cache(model, shape), resolve)
