"""Serving steps (prefill forward + cached single-token decode).

The counterpart of the reference's ``repro.train.serve_step``.  Serving
carries no decentralized worker dim: at inference there is one model.
Prefill returns logits and fills no cache, as in the reference; decode runs
ONE new token against a cache from ``Model.init_cache``.  Each step runs
under ``torch.no_grad`` inside a profiler range (``serve.prefill`` /
``serve.decode``), the reference's named scopes.

With ``mesh=`` and ``rules=`` the steps run under ``mesh_context``: the
params are this rank's shards over ``model`` (``shard_serving_params``),
the cache is this rank's cut of what :func:`cache_pspecs` names
(``make_cache``: its KV heads where ``model`` divides them, else every KV
head over its ``1/M`` of the ring's slots, the context-parallel ``kv_seq``
cache, or over the whole ring where ``model`` does not divide it either),
and the logits come back whole over the vocabulary on every rank.  The
decode reads which of those layouts the cache has from the same specs
(:func:`cache_layout`), so a step whose layout the model alone does not
fix takes the cache's ``InputShape``.  The batch is the caller's rows.
Under the hierarchical rules the params are also cut over ``data``
(FSDP: each layer gathers its weights where it uses them) and
``global_batch`` lies on ``data``: each
``data`` rank serves its rows of the global batch (:func:`batch_rows`),
its cache holds those rows, and its logits are theirs.  What the port does
not run (``models.sharding.tensor_parallel_refusal``) raises
``NotImplementedError`` naming #13e when the step is built.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import convert
from repro_torch.configs.base import InputShape
from repro_torch.launch.mesh import (mesh_context, mesh_shape_dict,
                                     split_groups)
from repro_torch.models import layers as L
from repro_torch.models.model_factory import Model
from repro_torch.models.sharding import (ShardingRules, check_runnable,
                                         resolve_tree, safe_pspec)

PyTree = Any


def _mesh(model: Model, mesh, rules: Optional[ShardingRules]
          ) -> Callable[[], Any]:
    """Check the model runnable on the mesh (#13e otherwise), once, and
    return what makes the context a step runs under: ``mesh_context``, or
    none without a mesh."""
    if mesh is None:
        return contextlib.nullcontext
    if rules is None:
        raise ValueError("a serving step on a mesh needs its ShardingRules")
    shape = mesh_shape_dict(mesh)
    check_runnable(serving_pspecs(model, rules, shape), rules, shape,
                   what="serving params", cfg=model.cfg)
    return lambda: mesh_context(mesh, rules)


def make_prefill_step(model: Model, *, last_only: bool = True, mesh=None,
                      rules: Optional[ShardingRules] = None
                      ) -> Callable[[PyTree, PyTree], torch.Tensor]:
    """Prefill forward.  last_only=True returns ``[B, 1, V]`` logits for the
    final position only, what a serving sampler consumes."""
    context = _mesh(model, mesh, rules)

    def prefill_step(params, batch):
        with context(), torch.no_grad(), \
                torch.profiler.record_function("serve.prefill"):
            return model.prefill_logits(params, batch, last_only=last_only)
    return prefill_step


def make_serve_step(model: Model, *, mesh=None,
                    rules: Optional[ShardingRules] = None,
                    shape: Optional[InputShape] = None
                    ) -> Callable[..., Tuple[torch.Tensor, PyTree]]:
    """One cached decode step.  On a mesh whose ``model`` axis does not
    divide the KV heads, ``shape`` (the cache's ``InputShape``, as
    :func:`make_cache` took it) tells the ``kv_seq`` cache from the
    replicated one (:func:`cache_layout`); without it a ``ValueError``."""
    context = _mesh(model, mesh, rules)
    layout = None
    if mesh is not None and _ambiguous(model, mesh):
        if shape is None:
            raise ValueError(
                f"{model.cfg.name}'s {model.cfg.num_kv_heads} KV heads do "
                f"not split over model: the decode cache's layout follows "
                f"its specs, pass make_serve_step(..., shape=) the cache's "
                f"InputShape")
        layout = cache_layout(model, shape, rules, mesh_shape_dict(mesh))

    def serve_step(params, cache, token):
        with context(), L.cache_layout_context(layout), torch.no_grad(), \
                torch.profiler.record_function("serve.decode"):
            return model.decode_step(params, cache, token)
    return serve_step


def make_cache(model: Model, batch: int, shape: InputShape, *, mesh=None,
               rules: Optional[ShardingRules] = None) -> PyTree:
    """``model.init_cache(batch, shape)``, on a mesh this rank's cut of
    what :func:`cache_pspecs` names (its KV heads, its share of the
    slots, or the whole ring); ``batch`` is this rank's rows
    (:func:`batch_rows`)."""
    layout = (cache_layout(model, shape, rules, mesh_shape_dict(mesh))
              if mesh is not None and _ambiguous(model, mesh) else None)
    with _mesh(model, mesh, rules)(), L.cache_layout_context(layout):
        return model.init_cache(batch, shape)


def _ambiguous(model: Model, mesh) -> bool:
    """Whether the cache's layout depends on the ring's length: a
    ``model`` axis > 1 that does not divide the KV heads."""
    m = mesh_shape_dict(mesh).get("model", 1)
    return m > 1 and model.cfg.num_kv_heads % m != 0


def cache_layout(model: Model, shape: InputShape, rules: ShardingRules,
                 mesh_shape) -> str:
    """``layers.cache_layout``'s name of the layout that
    :func:`cache_pspecs` gives the K cache: ``"heads"`` where its spec
    puts ``model`` on the KV heads, ``"seq"`` where on the ring's slots,
    ``"whole"`` where on neither."""
    k = cache_pspecs(model, shape, rules, mesh_shape)["layers"]["k"]

    def names(entry):
        return entry == "model" or (isinstance(entry, tuple)
                                    and "model" in entry)
    return ("heads" if names(k[-2]) else "seq" if names(k[-3])
            else "whole")


def serving_pspecs(model: Model, rules: ShardingRules, mesh_shape) -> PyTree:
    """The resolved specs of the (unstacked) serving params."""
    from repro_torch.train.train_step import params_pspecs
    return params_pspecs(model, rules, mesh_shape, stacked=False)


def shard_serving_params(model: Model, params: PyTree, mesh,
                         rules: ShardingRules) -> PyTree:
    """This rank's shards over ``model`` (and, under the hierarchical
    rules, over ``data``) of a whole serving params tree (every rank draws
    or loads the whole tree and keeps its cut)."""
    shape = mesh_shape_dict(mesh)
    _mesh(model, mesh, rules)                   # refuses what is not run
    return convert.shard_params(params, serving_pspecs(model, rules, shape),
                                split_groups(mesh, rules))


def batch_rows(n: int, mesh=None, rules: Optional[ShardingRules] = None
               ) -> Tuple[int, int]:
    """This rank's ``[lo, hi)`` of a global serving batch of ``n`` rows:
    its ``data`` share under the hierarchical rules' FSDP split, all of
    them otherwise."""
    from repro_torch.comm import fsdp
    from repro_torch.comm import tensor_parallel as TP
    if mesh is None:
        return 0, n
    return fsdp.rows(n, TP.AxisGroup.of(mesh, rules.fsdp_axis))


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


def cache_cut(model: Model, shape: InputShape, rules: ShardingRules,
              mesh_shape, axes=None) -> PyTree:
    """A rank's cut of each leaf of :func:`abstract_cache` by
    :func:`cache_pspecs`, as ``meta`` tensors: every dim divided by the
    sizes of the mesh axes its spec entry names (only those in ``axes``,
    if given)."""
    from repro_torch import tree
    specs = cache_pspecs(model, shape, rules, mesh_shape)

    def cut(leaf, spec):
        dims = list(leaf.shape)
        for i, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None and (axes is None or a in axes):
                    dims[i] //= mesh_shape[a]
        return torch.empty(dims, dtype=leaf.dtype, device="meta")
    ab = abstract_cache(model, shape)
    leaves, td = tree.flatten(ab)
    return tree.unflatten(td, [cut(a, s) for a, s in
                               zip(leaves, tree.leaves(specs))])
