"""Logical-axis sharding rules, the counterpart of ``repro.models.sharding``.

Params and activations are annotated with *logical* axis names; a
``ShardingRules`` table maps logical names to mesh axes per distribution
mode:

  decentralized:  leading ``worker`` param axis -> the worker mesh axes
                  (``data`` single-pod, ``('pod','data')`` multi-pod,
                  ``('inter','intra')`` two-tier); tensor-parallel dims
                  (heads/mlp/vocab) -> ``model``; embed dim replicated.
  hierarchical:   no worker param axis on single-pod (workers = pods);
                  2-D weight sharding: embed dim -> ``data`` (FSDP), TP dims
                  -> ``model``; batch -> ``data``.

``ShardingRules.pspec`` turns logical names into a :class:`PartitionSpec`;
unknown / None names are unsharded, and ``safe_pspec`` replicates a dim
that does not divide its mesh axes.  ``placements`` turns a resolved spec
into the DTensor placements of a ``DeviceMesh``.

What the port runs of it: the worker axes, as blocks of workers on ranks
(``comm/workers.py``), and for the dense and MoE decoder families the
``model`` axis (``comm/tensor_parallel.py``: heads, MLP or each expert's
``d_ff``, and vocabulary split, Megatron's all-reduces; KV heads
replicated where ``model`` does not divide them, each rank projecting the
run its query heads read; the expert dim and the router whole on every
rank; where ``model`` does not divide the query heads, the reference's
context-parallel ``kv_seq``: the attention weights whole on every rank,
each rank attending its share of the keys and the shares merged, and the
decode caches split on their sequence dim wherever the KV heads do not
divide ``model``, ``models/layers.py``) under either rules, and the
hierarchical rules' FSDP ``embed -> data`` (``comm/fsdp.py``: weights
gathered where used, gradients reduce-scattered).  Any other spec over a
mesh axis of size > 1 (``model`` or ``data`` on another family) raises
``NotImplementedError`` (:func:`check_runnable`,
:func:`tensor_parallel_refusal`): those are ROADMAP Queue 1 #13e.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import sys
from typing import Iterator, Optional, Sequence, Tuple

# the families whose weights split over ``model`` and FSDP ``data``
SPLIT_FAMILIES = ("dense", "moe")
TODO_13E = ("sharding weights or activations over a mesh axis other than "
            "the worker axes (tensor-parallel 'model', hierarchical "
            "'embed -> data') is not ported yet: ROADMAP Queue 1 #13e")


def _normalize(entry):
    """One entry as ``jax.sharding.PartitionSpec`` stores it: a list is a
    tuple, an empty tuple is None, a 1-tuple is its one name."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec:
    """An immutable tuple of mesh-axis names (or tuples of them, or None),
    one entry per tensor dim, normalized as ``jax.sharding.PartitionSpec``
    normalizes them.  Not a ``tuple`` subclass, so ``repro_torch.tree``
    takes a spec for a leaf; it compares equal to the tuple of its
    entries."""
    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(_normalize(p) for p in parts)

    def __iter__(self) -> Iterator:
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + repr(self._parts)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mode: str                       # "decentralized" | "hierarchical"
    multi_pod: bool = False
    tiers: int = 1                  # >1: worker dim spans (inter, intra)
    intra_axis: str = "intra"       # fast tier (make_two_tier_mesh)
    inter_axis: str = "inter"       # slow tier

    @property
    def worker_axes(self) -> Tuple[str, ...]:
        """Mesh axes forming the decentralized-worker dimension.

        Two-tier runs (``tiers > 1``) split it into ``(inter, intra)``:
        inter major, intra minor, matching ``HierarchicalTopology``'s flat
        worker index ``w = g * n_intra + j``.
        """
        if self.mode == "decentralized":
            if self.tiers > 1:
                return (self.inter_axis, self.intra_axis)
            return ("pod", "data") if self.multi_pod else ("data",)
        # hierarchical: workers are pods (leading replica dim only multi-pod)
        return ("pod",) if self.multi_pod else ()

    @property
    def fsdp_axis(self) -> Optional[str]:
        return "data" if self.mode == "hierarchical" else None

    def table(self) -> dict:
        fsdp = self.fsdp_axis
        return {
            "worker": self.worker_axes or None,
            # inner (per-worker) batch dim of a stacked training batch
            "batch": ("data",) if self.mode == "hierarchical" else None,
            # leading batch dim of an (unstacked) serving workload
            "global_batch": ((self.worker_axes or ("data",))
                             if self.tiers > 1
                             else (("pod", "data") if self.multi_pod
                                   else ("data",))),
            "embed": fsdp,           # residual / d_model dim
            "heads": "model",        # nh * hd flattened or nh
            "kv": "model",           # kv heads (safe_pspec guards divisibility)
            "head_dim": "model",     # per-head dim (2-D TP fallback for GQA)
            "mlp": "model",          # d_ff
            "vocab": "model",
            "experts": None,         # expert dim: replicate, shard ff inside
            "ssm_inner": "model",
            "seq": None,
            "kv_seq": "model",       # context-parallel KV (attention fallback)
            "stack": None,           # layer-stack dim
        }

    def pspec(self, *logical: Optional[str]) -> PartitionSpec:
        t = self.table()
        return P(*[t.get(name) if name else None for name in logical])


def stacked(logical, *names: Optional[str]):
    """Every logical-axis tuple of the nested dicts / lists ``logical``
    with ``names`` in front (a layer stack's leading dims)."""
    if isinstance(logical, dict):
        return {k: stacked(v, *names) for k, v in logical.items()}
    if isinstance(logical, list):
        return [stacked(v, *names) for v in logical]
    return tuple(names) + tuple(logical)


def resolve_tree(logical, abstract, fn):
    """``fn(names, leaf)`` for every tensor leaf of ``abstract`` and its
    logical-axis tuple in ``logical`` (a tree of the same dicts and
    lists), as a tree shaped like ``abstract``."""
    if isinstance(abstract, dict):
        return {k: resolve_tree(logical[k], v, fn)
                for k, v in abstract.items()}
    if isinstance(abstract, (list, tuple)):
        if len(logical) != len(abstract):
            raise ValueError(f"logical tree of {len(logical)} entries for "
                             f"{len(abstract)} leaves")
        return type(abstract)(resolve_tree(lg, v, fn)
                              for lg, v in zip(logical, abstract))
    return fn(tuple(logical), abstract)


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple of them)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def dim_divides(dim: int, mesh_shape: dict, axis) -> bool:
    total = 1
    for a in _axes(axis):
        total *= mesh_shape[a]
    return dim % total == 0


def safe_pspec(shape: Sequence[int], spec: PartitionSpec,
               mesh_shape: dict) -> PartitionSpec:
    """Replicate any dim whose size does not divide its assigned axes."""
    out = []
    for i, ax in enumerate(spec):
        if i < len(shape) and dim_divides(shape[i], mesh_shape, ax):
            out.append(ax)
        else:
            out.append(None)
    return P(*out)


def on_worker_dim(spec: PartitionSpec, rules: ShardingRules) -> bool:
    """Whether a resolved spec splits its leaf's leading dim over the
    worker axes of ``rules``: the leaves a worker split holds in blocks of
    rows."""
    return (isinstance(spec, PartitionSpec) and len(spec) > 0
            and bool(set(_axes(spec[0])) & set(rules.worker_axes)))


def unrunnable_axes(spec: PartitionSpec, rules: ShardingRules,
                    mesh_shape: dict, allowed: Tuple[str, ...] = ()
                    ) -> Tuple[str, ...]:
    """The mesh axes of size > 1 that ``spec`` shards a dim over and that
    are neither worker axes of ``rules`` nor ``allowed``: what this port
    cannot run."""
    ok = set(rules.worker_axes) | set(allowed)
    return tuple(a for entry in spec for a in _axes(entry)
                 if a not in ok and mesh_shape.get(a, 1) > 1)


def kv_groups(num_heads: int, num_kv_heads: int, m: int
              ) -> Optional[Tuple[int, int]]:
    """Replicated-KV GQA on a ``model`` axis of ``m`` that divides the
    query heads but not the KV heads: ``(nkv_local, group)``, the KV heads
    a rank's query heads read (a contiguous run of them) and the query
    heads of one; ``None`` when each rank's query heads do not read whole
    groups of one KV head each (neither divides the other)."""
    nh_l, g = num_heads // m, num_heads // num_kv_heads
    if nh_l % g == 0:
        return nh_l // g, g
    if g % nh_l == 0:
        return 1, nh_l
    return None


def fsdp_size(rules: ShardingRules, mesh_shape: dict) -> int:
    """The size of the rules' FSDP axis on the mesh (1 without one)."""
    a = rules.fsdp_axis
    return 1 if a is None else mesh_shape.get(a, 1)


def tensor_parallel_refusal(cfg, rules: ShardingRules,
                            mesh_shape: dict) -> Optional[str]:
    """Why the port cannot split ``cfg``'s weights over the mesh's
    ``model`` axis or the rules' FSDP ``data`` axis (a message naming
    #13e), or ``None`` when it can: the dense decoder family and the MoE
    family (the expert dim whole on every rank, as the reference's
    ``"experts": None``), under either rules; any head counts (where
    ``model`` does not divide the KV heads, replicated-KV GQA; where it
    does not divide the query heads, context-parallel attention,
    ``models/layers.py``); ``model`` dividing the MLP or each expert's
    ``d_ff`` and the padded vocabulary; ``data`` dividing
    ``d_model``; and every split leaf's code rows a whole number of bytes
    at any width (a multiple of 8): ``head_dim``, ``d_model / data`` and
    ``d_ff / model``, of which the columns of every split leaf's view
    (``tensor_parallel.split_view``) are multiples (the router's ``d_model
    / data * E``, an expert's ``d_ff / model`` or ``d_model / data``; the
    padded vocabulary is one of 256).  ``cfg`` may be ``None`` (a model
    without an ``ArchConfig``, such as the ResNet)."""
    m = mesh_shape.get("model", 1)
    dn = fsdp_size(rules, mesh_shape)
    if m <= 1 and dn <= 1:
        return None
    why = None
    if cfg is None or getattr(cfg, "family", None) not in SPLIT_FAMILIES:
        why = (f"tensor-parallel and FSDP weights are ported for the "
               f"{' and '.join(SPLIT_FAMILIES)} families only, not "
               f"{getattr(cfg, 'family', type(cfg).__name__)!r}")
    else:
        vocab = -(-cfg.vocab_size // 256) * 256
        for name, v, axis, k in (("d_ff", cfg.d_ff, "model", m),
                                 ("padded vocabulary", vocab, "model", m),
                                 ("d_model", cfg.d_model, "data", dn)):
            if v % k:
                why = f"{name} {v} does not split over {axis}={k}"
                break
        for name, v in (("head_dim", cfg.hd), ("d_model", cfg.d_model // dn),
                        ("d_ff", cfg.d_ff // m)):
            if why is None and v % 8:
                why = (f"{name} {v} a rank is not a multiple of 8: a split "
                       f"leaf's codes would not fill whole bytes")
    if why is None:
        return None
    return f"{getattr(cfg, 'name', cfg)!s} on mesh {mesh_shape}: {why}; " \
        f"{TODO_13E}"


def check_runnable(specs, rules: ShardingRules, mesh_shape: dict,
                   what: str = "state", cfg=None) -> None:
    """Raise ``NotImplementedError`` (ROADMAP #13e) if any spec in the tree
    ``specs`` shards a mesh axis of size > 1 that the port does not run:
    the worker axes always run; ``model`` and the rules' FSDP axis
    (``data`` under the hierarchical rules) run when
    :func:`tensor_parallel_refusal` admits ``cfg`` (the model's
    ``ArchConfig``, or ``None``).  A ``model`` or FSDP axis > 1 with a
    refused ``cfg`` raises even where no spec names it: nothing is
    replicated silently."""
    from repro_torch import tree
    refusal = tensor_parallel_refusal(cfg, rules, mesh_shape)
    if refusal is not None:
        raise NotImplementedError(f"{what}: {refusal}")
    allowed = tuple(a for a in ("model", rules.fsdp_axis)
                    if a is not None and mesh_shape.get(a, 1) > 1)
    for i, spec in enumerate(tree.leaves(specs)):
        bad = unrunnable_axes(spec, rules, mesh_shape, allowed)
        if bad:
            raise NotImplementedError(
                f"{what} leaf {i} resolves to {spec!r}, sharded over "
                f"{bad} of mesh {mesh_shape}: {TODO_13E}")


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of a resolved spec on a ``DeviceMesh``: for each
    mesh dim, ``Shard(d)`` if tensor dim ``d`` is split over it, else
    ``Replicate()``.  A dim split over several mesh dims (``('pod',
    'data')``) is split over them major first, as JAX splits a tuple axis,
    which is DTensor's order when the names come in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    dim_of = {}
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{spec!r}: axes {axes} not in mesh order "
                             f"{names}")
        for a in axes:
            dim_of[a] = d
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]


# ---------------------------------------------------------------------------
# In-model sharding constraints (activation level).
#
# Model code is mesh-agnostic; where it calls ``constrain(x, *logical)``
# the call is the identity unless a launcher installed a constraint
# context, as in the reference.
# ---------------------------------------------------------------------------

_CONSTRAINT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_constraint_ctx", default=None)


@contextlib.contextmanager
def constraint_context(rules: ShardingRules, mesh_shape: dict):
    token = _CONSTRAINT_CTX.set((rules, dict(mesh_shape)))
    try:
        yield
    finally:
        _CONSTRAINT_CTX.reset(token)


def mesh_axis_size(name: str, default: int = 1) -> int:
    ctx = _CONSTRAINT_CTX.get()
    if ctx is None:
        return default
    return ctx[1].get(name, default)


def constrain(x, *logical: Optional[str]):
    """The identity outside a constraint context.  Inside one the names
    resolve (``safe_pspec``) against the context's mesh; a spec over a
    non-worker axis of size > 1 raises (ROADMAP #13e), except the
    context-parallel ``kv_seq`` on ``model``; a DTensor is redistributed
    to the spec's placements on its own mesh; a plain tensor is already
    the rank's block of the worker axes (or, inside the vmapped step, one
    worker's) and comes back as it is.  The tensor-parallel layers call no
    other ``constrain`` over ``model``: their collectives are written out
    (``comm/tensor_parallel.py``), and ``models.layers._context_parallel_kv``
    cuts this rank's share of a ``kv_seq`` dim itself, where the resolved
    spec splits it."""
    ctx = _CONSTRAINT_CTX.get()
    if ctx is None:
        return x
    rules, ms = ctx
    spec = safe_pspec(tuple(x.shape), rules.pspec(*logical), ms)
    bad = unrunnable_axes(spec, rules, ms,
                          ("model",) if "kv_seq" in logical else ())
    if bad:
        raise NotImplementedError(
            f"constrain to {spec!r} over {bad} of mesh {ms}: {TODO_13E}")
    # a DTensor exists only once its module is loaded: a plain tensor does
    # not pay that import (seconds, on a host shared by many ranks)
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is not None and isinstance(x, dt.DTensor):
        return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))
    return x
