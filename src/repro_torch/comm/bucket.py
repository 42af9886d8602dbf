"""Bucketed flat-buffer gossip: one staging buffer for the whole model.

:class:`BucketLayout` flattens a stacked ``[n, ...]`` pytree into one
``[n, D]`` buffer and scatters the mixed result back, so a gossip round is
one encode launch, one payload roll per offset and one fused decode-reduce.
Two invariants make the bucketed round bit-exact against the per-leaf path:

1. **Per-leaf vpb row alignment.**  Each leaf's segment is the leaf
   flattened with its last axis zero-padded to the values-per-byte
   boundary, so the concatenation of per-leaf payload bytes IS the bucketed
   payload.
2. **Global element indexing.**  Element ``e`` of leaf ``i`` sits at flat
   position ``offset_i + e``, and the per-leaf path passes ``offset_i`` as
   the encode's ``idx_base``: both paths hash the same ``(seed, index)``.

Leaves are taken in JAX's order (dict keys sorted, :mod:`repro_torch.tree`),
so offsets, and with them the payload bits, equal the reference's.

Staging dtype: leaves sharing one floating dtype stage natively; mixed
trees stage in float32 (widening casts are exact).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import torch

from repro_torch import tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Static placement of one stacked leaf inside the flat buffer."""
    shape: Tuple[int, ...]   # per-worker shape (leaf.shape[1:])
    dtype: torch.dtype       # original leaf dtype (restored on scatter)
    rows: int                # prod(shape[:-1]); 1 for scalar-per-worker
    last: int                # shape[-1]; 1 for scalar-per-worker
    last_padded: int         # last rounded up to the alignment
    size: int                # rows * last (real elements)
    padded_size: int         # rows * last_padded (elements in the buffer)
    offset: int              # element offset of this segment in the buffer


@dataclasses.dataclass(frozen=True)
class BucketChunk:
    """One contiguous window of the flat buffer, covering whole leaf slots."""
    index: int               # position in the chunk sequence
    offset: int              # element offset of the window in the buffer
    size: int                # padded elements in the window
    slots: Tuple[LeafSlot, ...]   # the (contiguous) slots covered

    @property
    def segment_sizes(self) -> Tuple[int, ...]:
        """Per-tensor segment lengths inside this chunk (row padding
        included): the statistics windows of the scale+codes and 1-bit
        codecs, which never straddle a chunk."""
        return tuple(s.padded_size for s in self.slots)

    def chunks(self, k: int) -> Tuple["BucketChunk", ...]:
        """Sub-partition this window into (at most) ``k`` slot-aligned
        chunks with the greedy sweep of :meth:`BucketLayout.chunks`.
        Offsets stay global buffer offsets (the encode's ``idx_base``); an
        empty window yields no chunks."""
        if not self.slots:
            return ()
        return _partition_slots(self.slots, max(int(k), 1))


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Cached flat-buffer layout for one stacked pytree structure."""
    treedef: Any
    slots: Tuple[LeafSlot, ...]
    n_workers: int
    align: int               # values-per-byte row alignment (1 = none)
    stage_dtype: torch.dtype  # staging dtype of the flat buffer

    @property
    def num_leaves(self) -> int:
        return len(self.slots)

    @property
    def total_elems(self) -> int:
        """Real elements per worker (no padding)."""
        return sum(s.size for s in self.slots)

    @property
    def padded_elems(self) -> int:
        """Flat-buffer elements per worker (row padding included)."""
        return sum(s.padded_size for s in self.slots)

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Per-leaf element offsets — the encode kernel's ``idx_base``."""
        return tuple(s.offset for s in self.slots)

    @property
    def uniform_dtype(self) -> bool:
        """True when every leaf already has the staging dtype."""
        return all(s.dtype == self.stage_dtype for s in self.slots)

    @property
    def segment_sizes(self) -> Tuple[int, ...]:
        """Per-leaf contiguous segment lengths (row padding included): one
        max-norm scale (qsgd) or lo/hi level pair (onebit) each."""
        return tuple(s.padded_size for s in self.slots)

    def chunks(self, k: int) -> Tuple[BucketChunk, ...]:
        """Partition the buffer into (at most) ``k`` contiguous slot-aligned
        chunks, balanced by padded element count (the reference's greedy
        sweep).  ``chunks(1)`` is the whole buffer."""
        return _partition_slots(self.slots, max(int(k), 1))

    def shard(self, axis_size: int, axis_index: int) -> BucketChunk:
        """The slot-aligned window that worker ``axis_index`` of an
        ``axis_size``-way intra axis owns: the shards partition
        ``[0, padded_elems)`` in order, balanced by the same greedy sweep as
        :meth:`chunks` but with a fixed count, so with fewer slots than
        ``axis_size`` the trailing shards are empty windows at the buffer's
        end.  ``shard(1, 0)`` is the whole buffer."""
        if axis_size < 1:
            raise ValueError(f"axis_size must be >= 1, got {axis_size}")
        if not 0 <= axis_index < axis_size:
            raise ValueError(
                f"axis_index {axis_index} out of range for "
                f"axis_size {axis_size}")
        return _shards_of(self, int(axis_size))[axis_index]

    def flatten(self, X: PyTree) -> torch.Tensor:
        """Stacked pytree -> one ``[n, padded_elems]`` staging buffer."""
        leaves, td = tree.flatten(X)
        if td != self.treedef:
            raise ValueError("pytree structure differs from the layout's")
        dev = leaves[0].device
        buf = torch.zeros((self.n_workers, self.padded_elems),
                          dtype=self.stage_dtype, device=dev)
        for leaf, s in zip(leaves, self.slots):
            seg = buf[:, s.offset:s.offset + s.padded_size]
            seg.view(self.n_workers, s.rows, s.last_padded)[..., :s.last] = (
                leaf.reshape(self.n_workers, s.rows, s.last))
        return buf

    def unflatten(self, flat: torch.Tensor) -> PyTree:
        """Inverse of :meth:`flatten`: slice segments, drop row padding,
        restore each leaf's shape and dtype."""
        out = []
        for s in self.slots:
            seg = flat[:, s.offset:s.offset + s.padded_size]
            if s.last_padded != s.last:
                seg = seg.reshape(self.n_workers, s.rows,
                                  s.last_padded)[..., :s.last]
            out.append(seg.reshape((self.n_workers,) + s.shape).to(s.dtype))
        return tree.unflatten(self.treedef, out)


@functools.lru_cache(maxsize=1024)
def _partition_slots(slots: Tuple[LeafSlot, ...],
                     k: int) -> Tuple[BucketChunk, ...]:
    """Greedy slot-aligned partition of a contiguous slot window into
    ``min(k, len(slots))`` balanced chunks."""
    k = min(k, len(slots))
    chunks, start = [], 0
    remaining = sum(s.padded_size for s in slots)
    for i in range(k):
        target = remaining / (k - i)
        end, acc = start, 0
        # take slots until the chunk reaches the remaining-average target;
        # every chunk takes at least one slot so all k chunks are non-empty
        while end < len(slots) and (end == start or acc < target):
            nxt = acc + slots[end].padded_size
            # stop before overshooting past the target by more than the
            # undershoot — keeps chunk sizes balanced around the target
            if end > start and nxt - target > target - acc:
                break
            acc = nxt
            end += 1
        # leave enough slots for the chunks still to come
        end = min(end, len(slots) - (k - i - 1))
        end = max(end, start + 1)
        window = slots[start:end]
        chunks.append(BucketChunk(index=i, offset=window[0].offset,
                                  size=sum(s.padded_size for s in window),
                                  slots=tuple(window)))
        remaining -= chunks[-1].size
        start = end
    return tuple(chunks)


@functools.lru_cache(maxsize=1024)
def _shards_of(layout: BucketLayout,
               axis_size: int) -> Tuple[BucketChunk, ...]:
    """Exactly ``axis_size`` shard windows covering the buffer in order:
    the greedy partition, then empty windows pinned to the buffer's end
    when there are more workers than slots (memoized: a tiered round asks
    for the same windows every round)."""
    real = _partition_slots(layout.slots, axis_size)
    end = layout.padded_elems
    return real + tuple(BucketChunk(index=i, offset=end, size=0, slots=())
                        for i in range(len(real), axis_size))


def _common_stage_dtype(dtypes) -> torch.dtype:
    """One shared floating dtype stages natively; anything mixed -> f32."""
    uniq = set(dtypes)
    if len(uniq) == 1:
        d = uniq.pop()
        if d.is_floating_point:
            return d
    return torch.float32


@functools.lru_cache(maxsize=256)
def _build(treedef, descs: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...],
           align: int) -> BucketLayout:
    if align < 1:
        raise ValueError(f"alignment must be >= 1, got {align}")
    if not descs:
        raise ValueError("cannot bucket an empty pytree")
    n = descs[0][0][0] if descs[0][0] else 0
    slots = []
    offset = 0
    for shape, dtype in descs:
        if not shape or shape[0] != n:
            raise ValueError(
                f"stacked leaves need a shared worker axis: {shape} vs n={n}")
        inner = shape[1:]
        last = inner[-1] if inner else 1
        rows = 1
        for d in inner[:-1]:
            rows *= d
        last_p = -(-last // align) * align
        slots.append(LeafSlot(shape=inner, dtype=dtype, rows=rows,
                              last=last, last_padded=last_p,
                              size=rows * last,
                              padded_size=rows * last_p, offset=offset))
        offset += rows * last_p
    return BucketLayout(treedef=treedef, slots=tuple(slots), n_workers=n,
                        align=align,
                        stage_dtype=_common_stage_dtype(d for _, d in descs))


def layout_of(X: PyTree, align: int = 1) -> BucketLayout:
    """The (memoized) flat-buffer layout for a stacked pytree; only the
    leaves' shapes and dtypes are read."""
    leaves, treedef = tree.flatten(X)
    descs = tuple((tuple(l.shape), l.dtype) for l in leaves)
    return _build(treedef, descs, int(align))
