"""Tensor parallelism over the mesh's ``model`` axis.

The port's explicit form of what GSPMD inserts in the reference when a
resolved spec puts a weight's heads, MLP or vocabulary dim on ``model``.
Under ``launch.mesh.mesh_context(mesh, rules, params=...)`` with a
``model`` axis of size ``M > 1``, every rank that differs from another
only in its ``model`` coordinate holds the same block of workers
(``comm/workers.py``) and its ``1/M`` shard of each tensor-parallel leaf.
A :class:`ModelGroup` describes that split; :func:`model_context`
installs it.

Every collective over ``model`` is an all-reduce (a sum, or a max taken
without gradient), so the same code runs on an NCCL group of cards and on
a gloo group whose ranks share one card.  The collectives sit inside
Megatron's two operators:

* :func:`copy_to_model`: the identity forward, an all-reduce of the
  gradient backward (before a column-parallel matmul);
* :func:`reduce_from_model`: an all-reduce forward, the identity backward
  (after a row-parallel matmul, the vocab-parallel embedding and loss).

Each is a ``torch.autograd.Function`` in the ``forward`` /
``setup_context`` form with its own ``vmap`` rule: under
``torch.func.vmap(torch.func.grad(loss))`` the rule all-reduces the whole
batched tensor, so one collective serves every worker of the rank.  A
c10d call takes no ``BatchedTensor``: a backward that needs a collective
calls the other operator's ``apply``, never ``dist.all_reduce`` itself.

The gossip of a sharded tree (``comm/engine.py``) reads each leaf's split
from here too: :func:`leaf_dims` is the stacked tensor dim of every leaf of
the params tree on ``model`` (or ``None``, a replicated leaf), and
:func:`whole` the tree at one process's shapes (``meta`` tensors), from
which the layout, the counter offsets and the byte ledger come.

Outside a context, or with ``M = 1``, every function here is the identity
and touches no process group.
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
class ModelGroup:
    """The ``model`` axis: this process is ``rank`` of ``size``; ``group``
    is the process group of the ranks that share its block of workers;
    ``dims`` the stacked tensor dim of each params leaf split over the axis
    (flatten order, ``None`` for a replicated leaf), or ``None`` when no
    tree was given."""
    rank: int = 0
    size: int = 1
    group: Any = None
    dims: Optional[Tuple[Optional[int], ...]] = None

    @classmethod
    def of(cls, mesh, dims=None) -> "ModelGroup":
        """This rank's coordinate on ``mesh``'s ``model`` axis (size 1 if
        the mesh has none)."""
        names = tuple(mesh.mesh_dim_names)
        if "model" not in names or mesh.shape[names.index("model")] == 1:
            return cls(dims=dims)
        return cls(rank=int(mesh.get_local_rank("model")),
                   size=int(mesh.shape[names.index("model")]),
                   group=mesh.get_group("model"), dims=dims)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_model_group", default=None)


@contextlib.contextmanager
def model_context(group: ModelGroup):
    token = _CURRENT.set(group)
    try:
        yield group
    finally:
        _CURRENT.reset(token)


def current() -> Optional[ModelGroup]:
    """The ``model`` split in force if it has more than one rank."""
    g = _CURRENT.get()
    return g if g is not None and g.size > 1 else None


def size() -> int:
    g = current()
    return 1 if g is None else g.size


def rank() -> int:
    g = current()
    return 0 if g is None else g.rank


# ---------------------------------------------------------------------------
# Which params leaves are split, and how
# ---------------------------------------------------------------------------

def dims_of(specs: PyTree) -> Tuple[Optional[int], ...]:
    """The tensor dim of each resolved spec (flatten order) that names the
    ``model`` axis, or ``None``.  A spec that puts ``model`` on two dims
    is refused (``models/sharding.py`` never resolves one)."""
    out = []
    for spec in tree.leaves(specs):
        hits = [d for d, entry in enumerate(spec)
                if entry == "model" or (isinstance(entry, tuple)
                                        and "model" in entry)]
        if len(hits) > 1:
            raise ValueError(f"{spec!r} splits two dims over 'model'")
        out.append(hits[0] if hits else None)
    return tuple(out)


def leaf_dims(X: PyTree) -> Optional[Tuple[Optional[int], ...]]:
    """The split of ``X``'s leaves (a tree shaped like the params) in
    force, or ``None`` outside a ``model`` split."""
    g = current()
    if g is None:
        return None
    if g.dims is None:
        raise ValueError("a model split without the params' specs: enter "
                         "mesh_context(mesh, rules, params=specs)")
    n = len(tree.leaves(X))
    if n != len(g.dims):
        raise ValueError(f"a tree of {n} leaves under a model split of "
                         f"{len(g.dims)} params leaves")
    return g.dims


def whole(X: PyTree) -> PyTree:
    """``X`` at one process's shapes: outside a ``model`` split ``X``
    itself; inside it, ``meta`` tensors with each split dim ``size()``
    times the shard's."""
    dims = leaf_dims(X)
    if dims is None:
        return X
    m = size()
    leaves, td = tree.flatten(X)
    out = []
    for a, d in zip(leaves, dims):
        shape = list(a.shape)
        if d is not None:
            shape[d] *= m
        out.append(torch.empty(shape, dtype=a.dtype, device="meta"))
    return tree.unflatten(td, out)


def counter_view(x: torch.Tensor, dim: Optional[int], k0: int,
                 full: int) -> Tuple[torch.Tensor, int, int]:
    """A stacked leaf shard as the encode's ``[n, rows, cols]`` with the
    counter offset and row stride under which it hashes the same
    ``(seed, index)`` pairs as the whole leaf ``[n, ..., full, ...]`` in one
    process (bucket invariant 2): split on stacked dim ``dim`` at ``k0``,
    the shard is ``[n, prod(before), shard * prod(after)]``, element
    ``(r, c)`` of it the whole leaf's ``r * full * prod(after) + k0 *
    prod(after) + c``.  Returns ``(view, offset, stride)``; ``dim=None``
    (a replicated leaf) is the natural rows view at offset 0 with the
    default stride (``None``)."""
    if dim is None:
        return (x.contiguous().reshape(x.shape[0], -1, x.shape[-1]), 0,
                None)
    after = math.prod(x.shape[dim + 1:])
    before = math.prod(x.shape[1:dim])
    view = x.contiguous().reshape(x.shape[0], before, x.shape[dim] * after)
    return view, k0 * after, full * after


# ---------------------------------------------------------------------------
# Collectives over the model axis
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM,
                    group=current().group if group is None else group)
    return out


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


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated over ``model``) as the input of a column-parallel
    matmul: the identity forward, its gradient summed over the ranks."""
    g = current()
    return x if g is None else _Copy.apply(x, g.group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of each rank's partial ``x`` (a row-parallel
    matmul's output); the identity backward."""
    g = current()
    return x if g is None else _AllReduce.apply(x, "sum", g.group)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model``, without gradient (exact)."""
    x = x.detach()
    g = current()
    return x if g is None else _AllReduce.apply(x, "max", g.group)


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor from each rank's shard of dim ``dim`` (in rank
    order), as an all-reduce of a zero-filled whole: exact, every entry is
    one rank's value plus zeros.  Outside the autograd graph (serving's
    logits, the checkpoint's gather)."""
    g = current()
    if g is None:
        return x
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * g.size
    full = x.new_zeros(shape)
    full.narrow(dim, g.rank * n, n).copy_(x)
    return _all_reduce(full, "sum")


def barrier() -> None:
    """Every rank of the ``model`` axis reaches this point before any goes
    on."""
    g = current()
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
