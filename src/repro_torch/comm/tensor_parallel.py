"""Tensor parallelism over the mesh's ``model`` axis, and the split axes'
shared machinery.

The port's explicit form of what GSPMD inserts in the reference when a
resolved spec puts a weight's heads, MLP or vocabulary dim on ``model``.
Under ``launch.mesh.mesh_context(mesh, rules, params=...)`` with a
``model`` axis of size ``M > 1``, every rank that differs from another
only in its ``model`` coordinate holds the same block of workers
(``comm/workers.py``) and its ``1/M`` shard of each tensor-parallel leaf.
An :class:`AxisGroup` describes such a split of one mesh axis, ``model``
or the hierarchical rules' FSDP ``data`` (``comm/fsdp.py``);
:func:`axis_context` installs the splits in force.

Every collective over a split axis is an all-reduce (a sum, or a max taken
without gradient), so the same code runs on an NCCL group of cards and on
a gloo group whose ranks share one card.  Over ``model`` they sit inside
Megatron's two operators:

* :func:`copy_to` (``copy_to_model``): the identity forward, an all-reduce
  of the gradient backward (before a column-parallel matmul);
* :func:`reduce_sum` (``reduce_from_model``): an all-reduce forward, the
  identity backward (after a row-parallel matmul, the vocab-parallel
  embedding and loss).

Context-parallel attention (``models/layers.py``, where the query heads
do not divide ``model``: the reference's ``kv_seq``) adds a third,
:func:`merge_attention`: each rank's attention over its share of the keys,
``(out_r, lse_r)``, merged into the whole attention's ``(out, lse)`` by
two all-reduces (the max of ``lse``, then the weighted sums), its
backward local.

Each is a ``torch.autograd.Function`` in the ``forward`` /
``setup_context`` form with its own ``vmap`` rule: under
``torch.func.vmap(torch.func.grad(loss))`` the rule all-reduces the whole
batched tensor, so one collective serves every worker of the rank.  A
c10d call takes no ``BatchedTensor``: a backward that needs a collective
calls the other operator's ``apply``, never ``dist.all_reduce`` itself.

The gossip of a sharded tree (``comm/engine.py``) reads each leaf's splits
from here too: :func:`leaf_splits` gives, for every leaf of the params
tree, the stacked tensor dims split over each axis (none for a replicated
leaf), :func:`split_view` the encode's view of such a shard, and
:func:`whole` the tree at one process's shapes (``meta`` tensors), from
which the layout, the counter offsets and the byte ledger come.

Outside a context, or where an axis has one rank, every function here is
the identity and touches no process group.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch import tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """A mesh axis that splits tensors: ``model`` (this module) or the
    hierarchical rules' FSDP ``data`` (``comm/fsdp.py``).  This process is
    ``rank`` of ``size`` on ``axis``; ``group`` is the process group of the
    ranks that differ from it only there; ``dims`` the stacked tensor dim
    of each params leaf split over the axis (flatten order, ``None`` for a
    leaf whole on every rank), or ``None`` when no tree was given."""
    axis: Optional[str] = None
    rank: int = 0
    size: int = 1
    group: Any = None
    dims: Optional[Tuple[Optional[int], ...]] = None

    @classmethod
    def of(cls, mesh, axis: Optional[str], specs: PyTree = None
           ) -> "AxisGroup":
        """This rank's coordinate on ``mesh``'s ``axis`` (size 1 if the
        mesh has none, or ``axis`` is ``None``), with the split dims of
        the resolved params ``specs`` if given."""
        dims = None if specs is None or axis is None else axis_dims(specs,
                                                                    axis)
        names = tuple(mesh.mesh_dim_names)
        if axis is None or axis not in names \
                or mesh.shape[names.index(axis)] == 1:
            return cls(axis=axis, dims=dims)
        return cls(axis=axis, rank=int(mesh.get_local_rank(axis)),
                   size=int(mesh.shape[names.index(axis)]),
                   group=mesh.get_group(axis), dims=dims)

    def cut(self, X: PyTree, dims=None) -> PyTree:
        """Every leaf of ``X`` cut to this rank's shard of its split dim
        (``dims``, by default the group's)."""
        return shard_tree(X, self.dims if dims is None else dims, self.rank,
                          self.size)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_axis_groups", default=())


@contextlib.contextmanager
def axis_context(*groups: AxisGroup):
    """Install ``groups`` (and no other) as the splits in force."""
    token = _CURRENT.set(tuple(g for g in groups if g.axis is not None))
    try:
        yield groups
    finally:
        _CURRENT.reset(token)


def groups() -> Tuple[AxisGroup, ...]:
    """The splits in force with more than one rank."""
    return tuple(g for g in _CURRENT.get() if g.size > 1)


def current(axis: str) -> Optional[AxisGroup]:
    """The split of ``axis`` in force if it has more than one rank."""
    for g in groups():
        if g.axis == axis:
            return g
    return None


def size(axis: str) -> int:
    g = current(axis)
    return 1 if g is None else g.size


def rank(axis: str) -> int:
    g = current(axis)
    return 0 if g is None else g.rank


# ---------------------------------------------------------------------------
# Which params leaves are split, and how
# ---------------------------------------------------------------------------

def axis_dims(specs: PyTree, axis: str) -> Tuple[Optional[int], ...]:
    """The tensor dim of each resolved spec (flatten order) that names the
    mesh axis ``axis``, or ``None``.  A spec that puts the axis on two
    dims is refused (``models/sharding.py`` never resolves one)."""
    out = []
    for spec in tree.leaves(specs):
        hits = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        if len(hits) > 1:
            raise ValueError(f"{spec!r} splits two dims over {axis!r}")
        out.append(hits[0] if hits else None)
    return tuple(out)


def leaf_dims(X: PyTree, axis: str
              ) -> Optional[Tuple[Optional[int], ...]]:
    """The split over ``axis`` of ``X``'s leaves (a tree shaped like the
    params) in force, or ``None`` outside a split of ``axis``."""
    g = current(axis)
    return None if g is None else _dims_for(g, X)


def _dims_for(g: AxisGroup, X: PyTree) -> Tuple[Optional[int], ...]:
    if g.dims is None:
        raise ValueError(f"a split of {g.axis!r} without the params' specs:"
                         f" enter mesh_context(mesh, rules, params=specs)")
    n = len(tree.leaves(X))
    if n != len(g.dims):
        raise ValueError(f"a tree of {n} leaves under a split of "
                         f"{len(g.dims)} params leaves")
    return g.dims


def leaf_splits(X: PyTree
                ) -> Optional[Tuple[Tuple[Tuple[int, int, int], ...], ...]]:
    """Every split in force of ``X``'s leaves (a tree shaped like the
    params), or ``None`` in one process's layout: for each leaf, a tuple
    of ``(dim, offset, whole)`` in dim order, one for each split (``model``,
    FSDP ``data``) of the leaf, where ``offset`` is this rank's first index
    on ``dim`` and ``whole`` the dim's size in one process."""
    gs = groups()
    if not gs:
        return None
    dims = [_dims_for(g, X) for g in gs]
    out = []
    for i, a in enumerate(tree.leaves(X)):
        out.append(tuple(sorted(
            (ds[i], g.rank * a.shape[ds[i]], g.size * a.shape[ds[i]])
            for g, ds in zip(gs, dims) if ds[i] is not None)))
    return tuple(out)


def whole(X: PyTree) -> PyTree:
    """``X`` at one process's shapes: outside a split ``X`` itself;
    inside one (``model`` or FSDP ``data``), ``meta`` tensors with each
    split dim at its whole size."""
    splits = leaf_splits(X)
    if splits is None:
        return X
    leaves, td = tree.flatten(X)
    out = []
    for a, sp in zip(leaves, splits):
        shape = list(a.shape)
        for d, _, full in sp:
            shape[d] = full
        out.append(torch.empty(shape, dtype=a.dtype, device="meta"))
    return tree.unflatten(td, out)


def split_view(x: torch.Tensor, splits: Sequence[Tuple[int, int, int]],
               align: int = 1
               ) -> Tuple[torch.Tensor, int, Optional[int], Optional[int],
                          int]:
    """A stacked leaf shard as the encode's ``[n, rows, cols]`` with the
    counter offset and row strides under which it hashes the same ``(seed,
    index)`` pairs as the whole leaf in one process (bucket invariant 2).
    ``splits``: ``(dim, offset, whole)`` in dim order, as
    :func:`leaf_splits` gives them.  No split: the natural rows view at
    offset 0 with the default stride (``None``).  Split on one stacked dim
    ``d`` at ``k0``, the shard is ``[n, prod(before), shard * prod(after)]``,
    element ``(r, c)`` of it the whole leaf's ``r * whole * prod(after) +
    k0 * prod(after) + c``.  Split on ``a`` and ``b > a``, the
    shard ``[n, pre..., s_a, mid..., s_b, post...]`` is viewed as ``[n,
    P s_a M, s_b Q]`` (``P``, ``M``, ``Q`` the products of the whole dims
    before, between and after) in blocks of ``s_a M`` rows, one a ``pre``
    index: element ``(r, c)`` hashes the whole leaf's index ``offset + (r
    // (s_a M)) * block_stride + (r % (s_a M)) * stride + c`` with
    ``block_stride = S_a M S_b Q``, ``stride = S_b Q`` and ``offset = o_a
    M S_b Q + o_b Q``.  Returns ``(view, offset, stride, rows_per_block,
    block_stride)``; one split (or none) keeps one block, the encode's
    default (``rows_per_block=None``, ``block_stride=0``).

    ``align``: the codes a byte.  One process pads each row of a leaf
    whose last dim is not a multiple of it to one (its counters skip the
    padding), so such a shard keeps its last dim as the columns, at the
    padded row stride ``cp``: split on one earlier dim ``a`` at ``o_a``,
    ``[n, P s_a M, last]`` in blocks of ``s_a M`` rows (``M`` the whole
    dims between), ``offset = o_a M cp``, ``stride = cp``,
    ``block_stride = S_a M cp`` (an MoE router ``[n, L, d/D, E]``).  A
    split of such a last dim, or two splits, raise ``ValueError``."""
    splits = tuple(splits)
    if not splits:
        return (x.contiguous().reshape(x.shape[0], -1, x.shape[-1]), 0,
                None, None, 0)
    last = x.shape[-1]
    if last % align:
        (a, oa, Sa), = splits if len(splits) == 1 else ((None,) * 3,)
        if a is None or a == x.dim() - 1:
            raise ValueError(f"a shard split on {splits} with a last dim "
                             f"of {last}, not a whole number of code bytes "
                             f"({align} values)")
        cp = -(-last // align) * align
        pre = math.prod(x.shape[1:a])
        mid = math.prod(x.shape[a + 1:-1])
        view = x.contiguous().reshape(x.shape[0], -1, last)
        return (view, oa * mid * cp, cp,
                x.shape[a] * mid if pre > 1 else None,
                Sa * mid * cp if pre > 1 else 0)
    if len(splits) == 1:
        (d, k0, full), = splits
        after = math.prod(x.shape[d + 1:])
        before = math.prod(x.shape[1:d])
        view = x.contiguous().reshape(x.shape[0], before,
                                      x.shape[d] * after)
        return view, k0 * after, full * after, None, 0
    if len(splits) != 2:
        raise ValueError(f"{len(splits)} split dims: at most two")
    (a, oa, Sa), (b, ob, Sb) = splits
    if not 0 < a < b:
        raise ValueError(f"split dims {a}, {b} out of order")
    pre = math.prod(x.shape[1:a])
    mid = math.prod(x.shape[a + 1:b])
    post = math.prod(x.shape[b + 1:])
    rpb = x.shape[a] * mid
    view = x.contiguous().reshape(x.shape[0], pre * rpb, x.shape[b] * post)
    stride = Sb * post
    return (view, oa * mid * stride + ob * post, stride,
            rpb if pre > 1 else None, Sa * mid * stride if pre > 1 else 0)


# ---------------------------------------------------------------------------
# Collectives over a split axis
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return out


def whole_of(x: torch.Tensor, dim: int, r: int, m: int, group
             ) -> torch.Tensor:
    """The whole tensor from every rank's shard of ``dim`` (rank ``r`` of
    ``m`` holding ``x``, in rank order), as an all-reduce of a zero-filled
    whole: exact, every entry is one rank's value plus zeros."""
    import torch.distributed as dist
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * m
    full = x.new_zeros(shape)
    full.narrow(dim, r * n, n).copy_(x)
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)   # in place
    return full


# The operators take the process group as an argument, read from the
# context where the forward runs: the autograd engine runs a CUDA backward
# in a thread of its own, which does not see the context.

class _AllReduce(torch.autograd.Function):
    """All-reduce forward (a sum or a max); the identity backward for the
    sum (every rank's loss is the same replicated value); a max carries no
    gradient."""

    @staticmethod
    def forward(x, op, group):
        return _all_reduce(x, op, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op = inputs[1]

    @staticmethod
    def backward(ctx, g):
        if ctx.op != "sum":
            return None, None, None
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, x, op, group):
        return _AllReduce.apply(x, op, group), in_dims[0]


class _Copy(torch.autograd.Function):
    """The identity forward; backward, the gradient all-reduced through
    ``_AllReduce`` (whose ``vmap`` rule unwraps a batched gradient)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, "sum", ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Copy.apply(x, group), in_dims[0]


def copy_to(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` (whole on every rank of ``axis``) where each rank uses it for
    its share (Megatron's ``copy_to_model`` before a column-parallel
    matmul): the identity forward, its gradient summed over the ranks."""
    g = current(axis)
    return x if g is None else _Copy.apply(x, g.group)


def reduce_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of each rank's partial ``x`` (Megatron's
    ``reduce_from_model`` after a row-parallel matmul; a loss's partial
    sums over ``data``); the identity backward."""
    g = current(axis)
    return x if g is None else _AllReduce.apply(x, "sum", g.group)


def merge_shares(out: torch.Tensor, lse: torch.Tensor, amax, total):
    """The arithmetic of the merge of attention over shares of the keys:
    ``m`` = the max of ``lse_r`` over the shares (0 where every share is
    ``-inf``), ``e_r = exp(lse_r - m)``, and one sum of ``[e_r out_r,
    e_r]`` in float32: ``out = sum_r e_r out_r / sum_r e_r`` (each share's
    output weighted by ``exp(lse_r - lse)``) and ``lse = m + ln sum_r
    e_r``.  ``amax`` and ``total`` reduce over the shares: all-reduces over
    ranks (:func:`merge_attention`), or ``amax(0)`` and ``sum(0)`` over
    shares stacked on dim 0.  Returns ``(out in out_r's dtype, lse, out in
    float32)``."""
    m = amax(lse)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(lse - m)[..., None]
    tot = total(torch.cat([e * out.float(), e], dim=-1))
    den = tot[..., -1:]
    merged = tot[..., :-1] / torch.where(den > 0, den, 1.0)
    return merged.to(out.dtype), m + torch.log(den[..., 0]), merged


class _MergeAttention(torch.autograd.Function):
    """The merge of the ranks' attention over their shares of the keys.
    Forward: :func:`merge_shares` with the max and the sum all-reduced
    over ``group``.  Every rank holds the same all-reduced sums, so the
    result is bitwise equal on every rank.  Backward, with no collective:
    ``w_r = exp(lse_r - lse)``, ``d out_r = w_r g_out`` and ``d lse_r =
    w_r (g_lse + <g_out, out_r - out>)``."""

    @staticmethod
    def forward(out, lse, group):
        return merge_shares(out, lse,
                            lambda t: _all_reduce(t, "max", group),
                            lambda t: _all_reduce(t, "sum", group))

    @staticmethod
    def setup_context(ctx, inputs, output):
        out, lse, _ = inputs
        ctx.save_for_backward(out, lse, output[1], output[2])
        ctx.set_materialize_grads(True)
        ctx.mark_non_differentiable(output[2])

    @staticmethod
    def backward(ctx, g_out, g_lse, _):
        out, lse, lse_m, merged = ctx.saved_tensors
        w = torch.where(torch.isfinite(lse), torch.exp(lse - lse_m), 0.0)
        dot = (g_out.float() * (out.float() - merged)).sum(-1)
        return ((w[..., None] * g_out.float()).to(out.dtype),
                w * (g_lse + dot), None)

    @staticmethod
    def vmap(info, in_dims, out, lse, group):
        n = info.batch_size

        def lead(t, d):
            return t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
        return (_MergeAttention.apply(lead(out, in_dims[0]),
                                      lead(lse, in_dims[1]), group),
                (0, 0, 0))


def merge_attention(out: torch.Tensor, lse: torch.Tensor, axis: str):
    """The whole attention ``(out, lse)`` from every rank of ``axis``'s
    attention over its share of the keys: ``out [..., D]`` (any float
    dtype) and ``lse [...]`` (``out.shape[:-1]``, float32, natural log,
    ``-inf`` where a rank's share has no valid key for the row).  Outside
    a split of ``axis`` the inputs themselves."""
    g = current(axis)
    if g is None:
        return out, lse
    merged, lse_m, _ = _MergeAttention.apply(out, lse, g.group)
    return merged, lse_m


def max_over(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The elementwise max over ``axis``, without gradient (exact)."""
    x = x.detach()
    g = current(axis)
    return x if g is None else _AllReduce.apply(x, "max", g.group)


def gather_dim(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The whole tensor from each rank's shard of dim ``dim`` over
    ``axis`` (:func:`whole_of`), outside the autograd graph (serving's
    logits, the checkpoint's gather)."""
    g = current(axis)
    return x if g is None else whole_of(x, dim, g.rank, g.size, g.group)


def barrier(axis: str) -> None:
    """Every rank of ``axis`` reaches this point before any goes on."""
    g = current(axis)
    if g is not None:
        import torch.distributed as dist
        dist.barrier(group=g.group)


def shard(a: torch.Tensor, dim: Optional[int], r: int, m: int
          ) -> torch.Tensor:
    """Rank ``r``'s of ``m`` equal shards of ``a`` on ``dim`` (``None``:
    ``a`` whole)."""
    if dim is None or m == 1:
        return a
    if a.shape[dim] % m:
        raise ValueError(f"dim {dim} of {tuple(a.shape)} does not split "
                         f"into {m}")
    n = a.shape[dim] // m
    return a.narrow(dim, r * n, n)


def shard_tree(X: PyTree, dims: Sequence[Optional[int]], r: int, m: int
               ) -> PyTree:
    """Every leaf of ``X`` cut to rank ``r``'s shard of its split dim."""
    leaves, td = tree.flatten(X)
    return tree.unflatten(td, [shard(a, d, r, m).clone()
                               if d is not None and m > 1 else a
                               for a, d in zip(leaves, dims)])
