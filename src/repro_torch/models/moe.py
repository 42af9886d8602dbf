"""Mixture-of-Experts layer (GShard-style grouped capacity dispatch).

The counterpart of the reference's ``repro.models.moe``.  Top-k softmax
routing with per-group capacity: the sequence is split into groups of
``group_size`` tokens; each expert accepts at most ``C = ceil(group_size *
top_k * capacity_factor / E)`` tokens a group.  Dispatch and combine are
one-hot products of size ``[G, g, E, C]``, as in the reference (a
gather/scatter dispatch would move fewer bytes; it is not this module).

Expert weights are stacked ``[E, d, f]`` (``[*stack, E, d, f]`` in a layer
stack), the router ``[d, E]`` is float32: the reference's tree and keys,
so ``repro_torch.convert`` carries a tree across leaf for leaf.

Three things differ in form, not in value, from the reference:

* top-k is a stable descending sort cut to its first K columns, which
  breaks ties by the lower expert index as ``jax.lax.top_k`` does
  (``torch.topk`` does not);
* each one-hot is a comparison against ``arange`` (``F.one_hot`` reads its
  maximum with ``.item()``, which ``torch.func.vmap`` refuses);
* dispatch, combine and the fill counts accumulate out of place, as the
  reference's do (an in-place add into an unbatched buffer fails under
  ``vmap``).

The router aux loss is the load-balancing term ``E * sum_e f_e * P_e``
(Switch/GShard).

Under a split (``comm/tensor_parallel.py``, ``comm/fsdp.py``; the
reference's rules: the expert dim replicated, each expert's ``d_ff`` on
``model``, ``d_model`` on ``data``):

* the router is whole on every ``model`` rank (gathered over ``data``),
  and each rank routes the same input, so its logits, choices and slots
  are one process's given the same ``x``;
* the experts' input goes through ``copy_to`` on ``model`` and each rank
  runs its columns of every expert's ``d_ff`` (rows of ``w_down``); the
  expert weights are gathered over ``data`` where used
  (``fsdp.matmul(..., experts=True)``); the combined output, one process's
  ``[G, g, d]`` in part on each rank, is summed over ``model`` once (not
  the ``K * cf`` times larger ``ye``);
* ``combine`` goes through ``copy_to`` on ``model``: its gradient, from
  each rank's part of the output, is summed over the ranks, so that the
  router's gradient is whole and the same on every rank; the aux term's,
  computed alike on every rank, is not (counted once);
* a ``data`` rank holds its rows of the batch, and a group never
  straddles a row (``S % g == 0``), so its groups, capacities and fills
  are one process's; the aux's ``me`` and ``ce`` are means over every
  ``data`` rank's groups (summed over ``data`` / D) before their product,
  the reference's means over the global batch.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm import fsdp as FS
from repro_torch.comm import tensor_parallel as TP
from repro_torch.models import layers as L


def init_moe(gen, d, f, moe_cfg, gated, dtype, stack=()):
    """Router ``[*stack, d, E]`` float32; experts ``[*stack, E, d, f]`` (and
    ``w_down [*stack, E, f, d]``) drawn as standard normals over
    ``sqrt(fan_in)`` in float32, cast to ``dtype``."""
    E = moe_cfg.num_experts

    def ew(a, b):
        w = torch.randn((*stack, E, a, b), generator=gen, device=gen.device,
                        dtype=torch.float32)
        return w.div_(math.sqrt(a)).to(dtype)

    p = {"router": L.dense_init(gen, d, E, torch.float32, stack=stack),
         "w_up": ew(d, f),
         "w_down": ew(f, d)}
    if gated:
        p["w_gate"] = ew(d, f)
    return p


def moe_pspecs(gated):
    s = {"router": ("embed", None),
         "w_up": ("experts", "embed", "mlp"),
         "w_down": ("experts", "mlp", "embed")}
    if gated:
        s["w_gate"] = ("experts", "embed", "mlp")
    return s


def capacity(group_size: int, top_k: int, cf: float, E: int) -> int:
    return max(1, int(math.ceil(group_size * top_k * cf / E)))


def _one_hot(idx, n):
    """``jax.nn.one_hot(idx, n)``: float32 ``[..., n]``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(gates, k):
    """``jax.lax.top_k`` along the last dim: the k largest, ties to the
    lower index first."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, xg, moe_cfg):
    """Routing of grouped tokens ``xg [G, g, d]``.

    Returns ``(topg [G, g, K] float32, topi [G, g, K] int64, dispatch
    [G, g, E, C] in xg's dtype, combine [G, g, E, C] float32, aux)``.
    A token's choice ``kk`` went to expert ``topi[..., kk]`` and was kept
    when that expert's slot row holds a one in ``dispatch``.  Under an
    FSDP split the router is gathered whole and the aux's means are over
    every ``data`` rank's groups (module docstring)."""
    G, g, _ = xg.shape
    E, K = moe_cfg.num_experts, moe_cfg.top_k
    C = capacity(g, K, moe_cfg.capacity_factor, E)
    logits = xg.float() @ FS.gather(p["router"], 0)         # [G, g, E]
    gates = torch.softmax(logits, dim=-1)

    # -- load-balance aux (computed on the full softmax) -------------------
    D = TP.size(FS.AXIS)
    me = gates.mean(dim=(0, 1))                             # mean router prob
    topg, topi = top_k(gates, K)                            # [G, g, K]
    ce = _one_hot(topi[..., 0], E).mean(dim=(0, 1))         # fraction routed
    if D > 1:
        me = TP.reduce_sum(me, FS.AXIS) / D
        ce = TP.reduce_sum(ce, FS.AXIS) / D
    aux = E * torch.sum(me * ce)

    # -- capacity-limited dispatch: the K choices in priority order --------
    dispatch = torch.zeros((G, g, E, C), dtype=xg.dtype, device=xg.device)
    combine = torch.zeros((G, g, E, C), dtype=torch.float32,
                          device=xg.device)
    fill = torch.zeros((G, E), dtype=torch.int32, device=xg.device)
    for kk in range(K):
        oh = _one_hot(topi[..., kk], E)                      # [G, g, E]
        pos = fill[:, None, :] + torch.cumsum(oh, dim=1).int() - 1
        keep = (oh > 0) & (pos < C)
        posc = pos.clamp(0, C - 1)
        slot = _one_hot(posc, C) * keep[..., None]           # [G, g, E, C]
        dispatch = dispatch + slot.to(xg.dtype)
        combine = combine + slot * topg[..., kk, None, None]
        fill = fill + oh.sum(dim=1).int()
    return topg, topi, dispatch, combine, aux


def moe_layer(p, x, moe_cfg, gated) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss, a float32 scalar).  Under
    a ``model`` split each rank runs its columns of every expert's
    ``d_ff`` and ``y`` is summed over the ranks (module docstring)."""
    B, S, d = x.shape
    g = min(moe_cfg.group_size, S)
    assert S % g == 0, (S, g)
    xg = x.reshape(B * (S // g), g, d)                       # [G, g, d]
    _, _, dispatch, combine, aux = route(p, xg, moe_cfg)

    # -- expert computation: this rank's d_ff columns of every expert ------
    xe = torch.einsum("zgec,zgd->ezcd", dispatch,
                      TP.copy_to(xg, "model"))                 # [E, G, C, d]
    h = FS.matmul(xe, p["w_up"], 1, experts=True)              # ezcd,edf
    if gated:
        h = F.silu(FS.matmul(xe, p["w_gate"], 1, experts=True)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    ye = FS.matmul(h, p["w_down"], 2, experts=True)            # [E, G, C, d]
    y = torch.einsum("zgec,ezcd->zgd",
                     TP.copy_to(combine, "model").to(x.dtype), ye)
    return TP.reduce_sum(y, "model").reshape(B, S, d), aux
