"""Fully sharded weights over the mesh's ``data`` axis (FSDP).

The port's explicit form of what GSPMD inserts in the reference under the
hierarchical rules (``models/sharding.py``), which put a weight's
``embed`` dim on ``data``: every rank that differs from another only in
its ``data`` coordinate holds the same workers, its ``1/D`` shard of each
weight's ``embed`` dim and its ``1/D`` of every worker's batch rows
(:func:`rows`).  The split is a ``tensor_parallel.AxisGroup`` of ``data``,
installed by ``launch.mesh.mesh_context`` when the rules' ``fsdp_axis`` is
``data``; the loss's sums and ``g_inf`` go through that module's
``reduce_sum`` and ``max_over`` on ``data``.

A layer gathers each weight where it uses it, one layer at a time, and
keeps only the shard for the backward pass:

* :func:`matmul`, ``x @ W`` with ``W`` the weight gathered whole: forward,
  an all-gather of the shards along the split dim, the product, and the
  whole freed; backward, the whole gathered again for ``x``'s gradient,
  and ``W``'s gradient reduce-scattered (summed: every rank's rows add
  their share to it).  So at most one weight is whole at a time, forward
  and backward.  An MoE layer's expert weights ``[E, d, f]`` go through
  it as one weight, a stack of one matrix an expert (``experts=True``:
  ``ezcd,edf->ezcf``, a batched product over ``E``).
* :func:`gather` for a weight read otherwise (the embedding's rows, whose
  backward reads no weight; the norms and biases, whole on every rank,
  ``dim=None``: the identity forward, the gradient all-reduced).

Both collectives are written as all-reduces, so that the same code runs on
an NCCL group of cards and on a gloo group whose ranks share one card
(gloo has no CUDA all-gather and no reduce-scatter): the all-gather is an
all-reduce of a zero-filled whole (exact: every entry is one rank's value
plus zeros), the reduce-scatter an all-reduce followed by this rank's cut.
The operators are ``torch.autograd.Function`` s with their own ``vmap``
rule, and take the process group as an argument (the autograd engine runs
a CUDA backward in a thread of its own, which does not see the context),
as ``comm/tensor_parallel.py``'s do.

Outside a context, or with ``D = 1``, every function here is what it is in
one process and touches no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm import tensor_parallel as TP

AXIS = "data"


def rows(n: int, group: Optional[TP.AxisGroup] = None) -> Tuple[int, int]:
    """The ``[lo, hi)`` of ``n`` batch rows of ``group``'s rank (the
    hierarchical rules' ``batch`` and ``global_batch`` on ``data``; by
    default the ``data`` split in force): all of them without a split."""
    g = TP.current(AXIS) if group is None else group
    if g is None or g.size == 1:
        return 0, n
    if n % g.size:
        raise ValueError(f"{n} batch rows do not split over "
                         f"data={g.size}")
    b = n // g.size
    return g.rank * b, (g.rank + 1) * b


class _Gather(torch.autograd.Function):
    """All-gather forward along ``dim``; backward, the gradient summed
    over the ranks (an all-reduce through ``_AllReduce``, whose ``vmap``
    rule unwraps a batched gradient) and cut to this rank's shard."""

    @staticmethod
    def forward(x, dim, r, d, group):
        return TP.whole_of(x, dim, r, d, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.dim, ctx.r, ctx.d, ctx.group = inputs

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.r, ctx.d, ctx.group), None, None, \
            None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, r, d, group):
        b = in_dims[0]
        if b is None:
            return _Gather.apply(x, dim, r, d, group), None
        x = x.movedim(b, 0)
        return _Gather.apply(x, dim + 1, r, d, group), 0


def _scatter(g, dim, r, d, group):
    """The reduce-scatter of a whole gradient: summed over the ranks, and
    a copy of this rank's cut, so that the whole sum is freed."""
    n = g.shape[dim] // d
    full = TP._AllReduce.apply(g, "sum", group)
    return full.narrow(dim, r * n, n).clone()


def gather(w: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """Weight ``w`` where a layer reads it other than through
    :func:`matmul`: under an FSDP split, whole along ``dim`` (its shard
    all-gathered; its gradient reduce-scattered), or, with ``dim=None`` (a
    weight whole on every rank), ``w`` with its gradient all-reduced over
    ``data``.  The identity without a split."""
    g = TP.current(AXIS)
    if g is None:
        return w
    if dim is None:
        return TP._Copy.apply(w, g.group)
    return _Gather.apply(w, dim % w.dim(), g.rank, g.size, g.group)


# ---------------------------------------------------------------------------
# x @ W, with W gathered where it is used
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Mat:
    """How a weight becomes the matrix ``M`` of ``x @ M``: narrowed to
    ``heads = (dim, lo, hi)`` if given, then its first ``k`` dims are the
    rows (``k > 0``), or its last ``-k`` dims the columns of its
    transpose (``k < 0``).  ``experts``: the weight's first dim is a stack
    of matrices, one an expert, multiplied by ``x``'s first dim expert by
    expert.  ``bw``: the weight has a worker dim in front (a ``vmap``
    rule's batch, kept as the matrices' batch)."""
    k: int
    heads: Optional[Tuple[int, int, int]] = None
    bw: bool = False
    experts: bool = False

    def of(self, w):
        b = int(self.bw)
        if self.heads is not None:
            d, lo, hi = self.heads
            w = w.narrow(d + b, lo, hi - lo)
        b += int(self.experts)
        lead, core = w.shape[:b], w.shape[b:]
        if self.k > 0:
            return w.reshape(*lead, math.prod(core[:self.k]), -1)
        return w.reshape(*lead, -1, math.prod(core[self.k:])).mT

    def grad(self, gM, shape):
        """The gradient of the weight of ``shape`` from ``M``'s."""
        b = int(self.bw)
        shape = list(shape)
        if self.heads is None:
            return (gM if self.k > 0 else gM.mT).reshape(shape)
        d, lo, hi = self.heads
        whole = shape[d + b]
        shape[d + b] = hi - lo
        gW = (gM if self.k > 0 else gM.mT).reshape(shape)
        pad = [0, 0] * (len(shape) - 1 - (d + b)) + [lo, whole - hi]
        return F.pad(gW, pad)


@dataclasses.dataclass(frozen=True)
class _Spec:
    """A :func:`matmul`'s split: shard ``dim`` of rank ``r`` of ``d`` in
    ``group``; ``model_group``, if any, the ranks over which the whole
    weight's gradient is also summed; ``mat`` the weight's matrix; ``bx``:
    ``x`` has a worker dim in front (a ``vmap`` rule's batch)."""
    dim: int
    r: int
    d: int
    group: Any
    model_group: Any
    mat: _Mat
    bx: bool = False


class _GatheredMatmul(torch.autograd.Function):
    """``x @ M(W)`` with ``W`` the all-gather of shard ``w`` over
    ``data``; saves ``x`` and the shard, and gathers again in the
    backward, which is not differentiated again (no double backward).
    With ``spec.model_group``, ``W`` is whole on the ``model`` ranks, each
    using its part, so its gradient is also summed over them
    (``copy_to``)."""

    @staticmethod
    def forward(x, w, spec):
        mat = spec.mat
        M = mat.of(TP.whole_of(w, spec.dim + mat.bw, spec.r, spec.d,
                               spec.group))
        return _mm(x, M, mat.bw, spec.bx, mat.experts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, ctx.spec = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        # torch.func.grad differentiates with create_graph=True: recorded,
        # this backward's products would keep every gathered weight alive
        # until the whole backward pass ends; it is not differentiated
        # again
        with torch.no_grad():
            return _GatheredMatmul._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        x, w = ctx.saved_tensors
        sp = ctx.spec
        mat, dim = sp.mat, sp.dim + sp.mat.bw
        M = mat.of(_Gather.apply(w, dim, sp.r, sp.d, sp.group))
        K, N = M.shape[-2:]
        if mat.bw or mat.experts:
            # g carries the worker dim if x or w does, x's if x does
            gx = _mm(g, M.mT, mat.bw, mat.bw or sp.bx, mat.experts)
            gx = (gx if sp.bx or not mat.bw else gx.sum(0)).reshape(x.shape)
            del M
            gM = _rows(x, sp.bx, mat.experts).mT @ _rows(
                g, mat.bw or sp.bx, mat.experts)
            if sp.bx and not mat.bw:
                gM = gM.sum(0)
        else:
            gx = g @ M.mT
            del M
            gM = x.reshape(-1, K).mT @ g.reshape(-1, N)
        shape = list(w.shape)
        shape[dim] *= sp.d
        gW = mat.grad(gM, shape)
        del gM
        if sp.model_group is not None:
            gW = TP._AllReduce.apply(gW, "sum", sp.model_group)
        return gx, _scatter(gW, dim, sp.r, sp.d, sp.group), None

    @staticmethod
    def vmap(info, in_dims, x, w, spec):
        bx, bw = in_dims[0] is not None, in_dims[1] is not None
        if spec.mat.bw or spec.bx:
            raise NotImplementedError("fsdp.matmul under nested vmap")
        if bx:
            x = x.movedim(in_dims[0], 0)
        if bw:
            w = w.movedim(in_dims[1], 0)
        out = _GatheredMatmul.apply(x, w, dataclasses.replace(
            spec, mat=dataclasses.replace(spec.mat, bw=bw), bx=bx))
        return out, 0 if bx or bw else None


def _rows(x, bx, experts):
    """``x`` as a stack of row blocks ``[*lead, rows, K]``: ``lead`` its
    worker dim (``bx``) and expert dim (``experts``), a worker dim of 1
    where it has none."""
    lead = x.shape[:int(bx) + int(experts)]
    x = x.reshape(*lead, -1, x.shape[-1])
    return x if bx else x.unsqueeze(0)


def _mm(x, M, bw, bx, experts=False):
    """``x @ M``, with ``M`` a stack of matrices when ``bw`` (one a
    worker; ``x`` a stack too when ``bx``, else the same for each) or
    ``experts`` (one an expert, against ``x``'s expert dim, which follows
    its worker dim)."""
    if not (bw or experts):
        return x @ M
    out = _rows(x, bx, experts) @ (M if bw else M.unsqueeze(0))
    lead = out.shape[:-2] if bw or bx else out.shape[1:-2]
    return out.reshape(*lead, *x.shape[int(bx) + int(experts):-1],
                       M.shape[-1])


def matmul(x: torch.Tensor, w: torch.Tensor, dim: int, k: int = 1,
           heads: Optional[Tuple[int, int, int]] = None,
           copy_model: bool = False, experts: bool = False
           ) -> torch.Tensor:
    """``x @ M``, ``M`` weight ``w`` as a matrix: narrowed to ``heads =
    (dim, lo, hi)`` if given, its first ``k`` dims the rows (``k < 0``: the
    transpose of ``w`` with its last ``-k`` dims the columns).  With
    ``experts``, ``w`` is a stack of one such weight an expert on its first
    dim, and ``x [E, ..., K]`` is multiplied expert by expert (``ezcd,edf
    ->ezcf``).  Under an FSDP split ``w`` is this rank's shard of its
    ``dim`` and only the shard is kept for the backward pass (module
    docstring).  ``copy_model``: ``w`` is whole on every ``model`` rank,
    each using its part, so its gradient is summed over ``model``
    (``TP.copy_to``)."""
    mat = _Mat(k, heads, experts=experts)
    g = TP.current(AXIS)
    if g is None:
        if copy_model:
            w = TP.copy_to(w, "model")
        return _mm(x, mat.of(w), False, False, experts)
    tg = TP.current("model") if copy_model else None
    return _GatheredMatmul.apply(x, w, _Spec(
        dim % w.dim(), g.rank, g.size, g.group,
        None if tg is None else tg.group, mat))
