"""The decentralized worker dim split over processes.

Every training-state leaf carries a leading worker dim ``[n, ...]``.  Under
``launch.mesh.mesh_context(mesh, rules)`` that dim is split over the
mesh's worker axes (``data``, ``(pod, data)`` or ``(inter, intra)``): the
worker axes flatten major first into ``R`` blocks, and rank ``ranks[i]``
holds block ``i``, the contiguous workers ``[i n/R, (i+1) n/R)``, as JAX
splits a sharded axis (a tuple axis major first).  A :class:`WorkerGroup`
describes that split; :func:`worker_context` installs it for the
functions below, which every cross-worker operation of the port goes
through:

* :func:`permute` / :func:`roll`: rows of the global stacked tensor moved
  to other rows (``gossip._roll``, the tiered round's intra reduce and
  all-gather), as one ``dist.batch_isend_irecv`` of the rows a rank needs
  from each peer; rows it holds itself are copied.  Only rows cross, and
  only to the rank that reads them: a Moniqua round ships the packed
  payload and nothing else.
* :func:`all_max`, :func:`all_sum`, :func:`gather_rows`: the global
  reductions of a step (``g_inf``, the logged loss, the telemetry).

Outside a context, or with one block (``R = 1``), each is the
single-process operation (``torch.roll``, the identity) and touches no
process group.  A rank's blocks must be of equal size: ``n`` divisible by
``R`` (the trainer checks).
"""
from __future__ import annotations

import bisect
import contextlib
import contextvars
import dataclasses
import functools
from typing import Any, Optional, Sequence, Tuple

import torch

Bounds = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class WorkerGroup:
    """The worker dim split into ``len(ranks)`` blocks: block ``i`` on
    global rank ``ranks[i]``; this process holds block ``index``.
    ``groups`` are the process groups of the worker mesh dims, major
    first (the reductions run over each in turn)."""
    ranks: Tuple[int, ...]
    index: int
    groups: Tuple[Any, ...] = ()

    @property
    def size(self) -> int:
        return len(self.ranks)

    @classmethod
    def of(cls, mesh, axes: Sequence[str],
           fsdp_axis: Optional[str] = None) -> "WorkerGroup":
        """This rank's split of the worker dim over ``axes`` of ``mesh``
        (axes the mesh lacks count as size 1).  Ranks that differ only in
        their ``model`` coordinate, or in their ``fsdp_axis`` one (the
        hierarchical rules' ``data``), hold the same block of workers, each
        its shard of the tensor-parallel and FSDP weights
        (``comm/tensor_parallel.py``, ``comm/fsdp.py``); the blocks are
        those of this rank's coordinates on those axes.  Raises
        ``NotImplementedError`` (ROADMAP #13e) if any other mesh dim has
        size > 1."""
        import torch.distributed as dist
        from repro_torch.models.sharding import TODO_13E
        names = tuple(mesh.mesh_dim_names)
        axes = tuple(a for a in axes if a in names)
        others = {a: s for a, s in zip(names, mesh.shape)
                  if a not in axes and a not in ("model", fsdp_axis)
                  and s > 1}
        if others:
            raise NotImplementedError(
                f"mesh {dict(zip(names, mesh.shape))}: the dims {others} "
                f"besides the worker axes {axes} split each worker's "
                f"weights; {TODO_13E}")
        grid = mesh.mesh
        me = dist.get_rank()
        coord = [int(c[0]) for c in torch.nonzero(grid == me,
                                                  as_tuple=True)]
        # this rank's coordinate on every other dim, the worker axes free
        index = tuple(slice(None) if a in axes else coord[i]
                      for i, a in enumerate(names))
        sub = grid[index]
        kept = [a for a in names if a in axes]
        order = [kept.index(a) for a in axes]
        ranks = tuple(int(r) for r in sub.permute(order).reshape(-1))
        return cls(ranks=ranks, index=ranks.index(me),
                   groups=tuple(mesh.get_group(a) for a in axes))


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_worker_group", default=None)


@contextlib.contextmanager
def worker_context(group: WorkerGroup):
    token = _CURRENT.set(group)
    try:
        yield group
    finally:
        _CURRENT.reset(token)


def current() -> Optional[WorkerGroup]:
    """The worker split in force, or ``None`` (single process)."""
    return _CURRENT.get()


def _split() -> Optional[WorkerGroup]:
    """The split in force if it has more than one block."""
    wg = _CURRENT.get()
    return wg if wg is not None and wg.size > 1 else None


def blocks() -> int:
    """``R``: the number of blocks the worker dim is split into."""
    wg = _split()
    return 1 if wg is None else wg.size


_BOUNDS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_row_bounds", default=None)


@contextlib.contextmanager
def row_bounds(bounds: Optional[Bounds]):
    """Inside, the stacked tensors the functions below take lie over the
    ranks as ``bounds`` says (every rank's ``[lo, hi)`` of the global
    rows; a tiered shard's inter-tier nodes), not in the worker dim's even
    blocks (``None``)."""
    token = _BOUNDS.set(bounds)
    try:
        yield
    finally:
        _BOUNDS.reset(token)


def _bounds(local_rows: int) -> Bounds:
    b = _BOUNDS.get()
    return even_bounds(local_rows) if b is None else b


def row_base(local_rows: int) -> int:
    """Global index of this rank's first row of a stacked tensor whose
    local block has ``local_rows`` rows (0 in one process).  Every global
    row index of the port comes from here."""
    wg = _split()
    return 0 if wg is None else _bounds(local_rows)[wg.index][0]


def even_bounds(local_rows: int) -> Bounds:
    """``[lo, hi)`` of every block of an evenly split dim."""
    R = blocks()
    return tuple((i * local_rows, (i + 1) * local_rows) for i in range(R))


@functools.lru_cache(maxsize=1024)
def _plan(src: Tuple[int, ...], bounds: Bounds, index: int):
    """Who sends which rows to whom for ``out[d] = X[src[d]]``: the local
    copies ``(dst, src)`` and, per peer block, the local rows to send and
    the local rows its message fills (both in destination order)."""
    starts = [lo for lo, _ in bounds]
    lo, hi = bounds[index]

    def owner(s):
        return bisect.bisect_right(starts, s) - 1

    local_dst, local_src = [], []
    recv = {}
    for d in range(lo, hi):
        s = src[d]
        p = owner(s)
        if p == index:
            local_dst.append(d - lo)
            local_src.append(s - lo)
        else:
            recv.setdefault(p, []).append(d - lo)
    send = {}
    for p, (plo, phi) in enumerate(bounds):
        if p == index:
            continue
        rows = [src[d] - lo for d in range(plo, phi) if lo <= src[d] < hi]
        if rows:
            send[p] = rows
    peers = sorted(set(send) | set(recv))
    return (tuple(local_dst), tuple(local_src),
            tuple((p, tuple(send.get(p, ())), tuple(recv.get(p, ())))
                  for p in peers))


@functools.lru_cache(maxsize=4096)
def _index(rows: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int64, device=device)


def permute(x: torch.Tensor, src: Sequence[int]) -> torch.Tensor:
    """Rows of the global tensor ``X`` moved: this rank's block of
    ``out[d] = X[src[d]]``.  ``x`` is this rank's block of ``X``;
    ``src`` lists the source row of every global row.  Each rank sends the
    rows its peers need in one ``batch_isend_irecv``."""
    src = tuple(int(s) for s in src)
    wg = _split()
    if wg is None:
        return x.index_select(0, _index(src, x.device))
    import torch.distributed as dist
    local_dst, local_src, peers = _plan(src, _bounds(x.shape[0]), wg.index)
    out = torch.empty_like(x)
    if local_dst:
        out.index_copy_(0, _index(local_dst, x.device),
                        x.index_select(0, _index(local_src, x.device)))
    ops, recvs = [], []
    for p, send_rows, recv_rows in peers:
        if send_rows:
            ops.append(dist.P2POp(dist.isend, x.index_select(
                0, _index(send_rows, x.device)), wg.ranks[p]))
        if recv_rows:
            buf = torch.empty((len(recv_rows),) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            ops.append(dist.P2POp(dist.irecv, buf, wg.ranks[p]))
            recvs.append((recv_rows, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for rows, buf in recvs:
        out.index_copy_(0, _index(rows, x.device), buf)
    return out


def roll(x: torch.Tensor, offset: int) -> torch.Tensor:
    """``torch.roll(X, -offset, 0)`` of the global tensor: row ``i`` gets
    row ``(i + offset) mod N``.  One block: ``torch.roll`` itself."""
    wg = _split()
    if wg is None:
        return torch.roll(x, -offset, 0) if offset % x.shape[0] else x
    n = _bounds(x.shape[0])[-1][1]
    if offset % n == 0:
        return x
    return permute(x, [(i + offset) % n for i in range(n)])


def _reduce(t: torch.Tensor, op) -> torch.Tensor:
    import torch.distributed as dist
    out = t.clone()
    for g in _split().groups:
        dist.all_reduce(out, op=op, group=g)
    return out


def all_max(t: torch.Tensor) -> torch.Tensor:
    """Elementwise max of ``t`` over the blocks (exact in any order)."""
    if _split() is None:
        return t
    import torch.distributed as dist
    return _reduce(t, dist.ReduceOp.MAX)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of ``t`` over the blocks; every rank gets the same
    value (exact for integers; for floats the order is the collective's)."""
    if _split() is None:
        return t
    import torch.distributed as dist
    return _reduce(t, dist.ReduceOp.SUM)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global tensor on every rank from every rank's block of rows, in
    block order (gathered over the minor worker dim first, then the major
    ones).  Blocks of unequal size (``row_bounds``) are each padded to the
    largest for the collective and cut back after it."""
    wg = _split()
    if wg is None:
        return x
    import torch.distributed as dist
    out = x.contiguous()
    bounds = _BOUNDS.get()
    if bounds is not None:
        m = max(hi - lo for lo, hi in bounds)
        out = torch.cat([out, out.new_zeros((m - out.shape[0],)
                                            + tuple(out.shape[1:]))])
    for g in reversed(wg.groups):
        parts = [torch.empty_like(out)
                 for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, out, group=g)
        out = torch.cat(parts, dim=0)
    if bounds is not None:
        out = torch.cat([out[i * m:i * m + hi - lo]
                         for i, (lo, hi) in enumerate(bounds)])
    return out


def barrier() -> None:
    """Every rank of the split reaches this point before any goes on."""
    wg = _split()
    if wg is not None:
        import torch.distributed as dist
        for g in wg.groups:
            dist.barrier(group=g)
