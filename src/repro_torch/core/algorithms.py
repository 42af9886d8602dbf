"""Decentralized training update rules on stacked worker pytrees.

Every rule takes the stacked model ``X`` (leaves ``[n, ...]``), its algorithm
state ``extra``, the local directions ``g`` and the step size ``alpha``, and
routes its communication through :class:`~repro_torch.comm.engine.CommEngine`.
The rules of the reference's zoo (paper Table 1 and the baselines of Sec. 6):

  allreduce    exact centralized SGD (the AllReduce analog)
  dpsgd        Lian et al. 2017, full-precision gossip
  naive        direct quantization of exchanged models (Theorem 1: diverges)
  moniqua      Algorithm 1 (modulo-quantized gossip, zero extra memory)
  choco        ChocoSGD (Koloskova et al. 2019): local estimators x_hat
  deepsqueeze  Tang et al. 2019: error-compensated compression
  dcd          DCD-PSGD (Tang et al. 2018): difference compression + replicas
  ecd          ECD-PSGD: extrapolated difference compression + replicas
  d2 / moniqua_d2   D^2 (Tang et al. 2018) variance reduction, Algorithm 2

Randomness: ``seed`` is the step's uint32 seed.  Moniqua's wire hashes it
(the reference's ``kops._key_to_seed(key)``); the norm-scaled and naive
quantizers draw their rounding uniforms from it (:func:`draw_uniforms`: a
counter-based uniform of ``(seed, worker, leaf, element)``), unless the
caller hands in ``uniforms``, a tree shaped like ``X`` (the parity tests
hand in the reference's ``jax.random.uniform`` draws).  ``seed=None`` with
no ``uniforms`` rounds to nearest, as the reference does for ``key=None``.

Under a split of the weights over ``model`` and/or FSDP ``data``
(``comm/tensor_parallel.py``) every rule runs on this rank's shards and
gives the cut of one process's step: the draw hashes each element's index
in its whole leaf, the norm-scaled quantizer's per-worker ``amax`` is a
max over the split axes (exact), and the biased 1-bit sign's ``mean|v|``
a sum over them divided by the whole leaf's count (the sum in another
order than one process's); the gossip is the engine's per-leaf round on
the shards, and the byte and memory accounting is one process's.

Telemetry (``AlgoHyper.telemetry``): the rules the reference instruments,
D-PSGD, Moniqua, D² and Moniqua-D², carry the accumulated round-health
dict of their engine's rounds under ``extra["health"]``
(``repro_torch.obs.metrics``); the trajectory does not change.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.comm import tensor_parallel as TP
from repro_torch.comm import workers
from repro_torch.comm.engine import CommEngine, FullPrecisionWire, make_wire
from repro_torch.comm.gossip import as_weight
from repro_torch.core.modulo import _scalar
from repro_torch.core.moniqua import MoniquaCodec
from repro_torch.core.quantizers import _U32, _counter_uniform
from repro_torch.core import topology
from repro_torch.core.topology import Topology
from repro_torch.obs import metrics as obs_metrics

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AlgoHyper:
    """Static hyper-parameters of the update rules.

    ``engine()`` builds the configured wire (``wire`` x ``codec.spec``) for
    quantized gossip, ``exact_engine()`` the full-precision engine the
    baselines (and replica mixing) use, both on ``comm_topo()``: ``topo``
    itself, or with ``tiers = k > 1`` the two-tier hierarchy of nodes of k
    workers.  ``path`` defaults to ``"auto"``, the reference's default.

    Elastic rounds: ``presence`` is a 0/1 worker mask that D-PSGD, Moniqua
    (every branch), D² and Moniqua-D² hand to the engine's
    ``mix(presence=...)`` every round; ``None`` or all-ones is the unmasked
    gossip.  ``deadline`` is the round deadline in seconds that the
    simulator enforces (``sim.faults.FaultSpec.deadline_s``); no step reads
    it, it rides here so one hyper object carries the elastic setup.

    ``telemetry`` turns on the engines' round health: the instrumented
    rules (Moniqua, Moniqua-D², and the full-precision D-PSGD and D²)
    carry it under ``extra["health"]`` and the trainer reports it as
    ``obs_*`` metrics.
    """
    topo: Topology
    codec: MoniquaCodec = MoniquaCodec()
    theta: Any = 2.0              # Moniqua a-priori bound (paper used 2.0)
    gamma: float = 1.0            # consensus step size (Choco/DeepSqueeze)
    naive_delta: float = 0.05     # absolute lattice pitch of the naive rule
    wire: str = "moniqua"         # wire codec for quantized gossip (engine())
    path: str = "auto"            # gossip path: bucketed | per_leaf | auto
    chunks: int = 1               # staged-round chunk count (1 = barrier)
    overlap: str = "none"         # step-level overlap: none | stale (Moniqua)
    warmup: int = 16              # onebit wire: fp32 rounds before 1-bit+EF
    tiers: int = 1                # 1 = flat gossip; k>1 = two-tier, nodes of k
    presence: Optional[Tuple[int, ...]] = None   # elastic 0/1 worker mask
    deadline: Optional[float] = None             # sim round deadline (s)
    telemetry: bool = False       # round-health observability (obs)

    def comm_topo(self):
        """The topology the engines gossip on: ``topo`` for flat runs
        (``tiers=1``), else the two-tier hierarchy with ``topo``'s family
        as the inter graph over ``n // tiers`` nodes and a fully connected
        intra tier of ``tiers`` workers.  A ``HierarchicalTopology`` given
        as ``topo`` wins over ``tiers``."""
        if isinstance(self.topo, topology.HierarchicalTopology):
            return self.topo
        if self.tiers <= 1:
            return self.topo
        # replay the slack factors the flat name carries ("ring-slack0.9")
        # onto the inter tier, the only quantized one
        parts = self.topo.name.split("-slack")
        hier = topology.two_tier(self.topo.n, self.tiers,
                                 inter_name=parts[0])
        for g in parts[1:]:
            hier = hier.slack(float(g))
        return hier

    def engine(self) -> CommEngine:
        return CommEngine(self.comm_topo(),
                          make_wire(self.wire, self.codec.spec,
                                    warmup=self.warmup),
                          path=self.path, chunks=self.chunks,
                          telemetry=self.telemetry)

    def exact_engine(self, telemetry: bool = False) -> CommEngine:
        """Full-precision engine.  ``telemetry`` is opt-in per call site:
        the instrumented baselines (D-PSGD, D²) pass ``self.telemetry``;
        replica mixing never observes."""
        return CommEngine(self.comm_topo(), FullPrecisionWire(),
                          path=self.path, chunks=self.chunks,
                          telemetry=telemetry)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _sgd(X: PyTree, g: PyTree, alpha) -> PyTree:
    return tree.map(lambda x, d: (x - alpha * d).to(x.dtype), X, g)


def _mix64(z: int) -> int:
    """splitmix64's finalizer."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2 ** 64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2 ** 64
    return z ^ (z >> 31)


def _stream_seed(seed: int, worker: int, leaf: int) -> int:
    """The uint32 hash seed of worker ``worker``'s rounding stream of leaf
    ``leaf`` in the draw ``seed`` (splitmix64 of the triple)."""
    z = _mix64((int(seed) * 0x9E3779B97F4A7C15 + worker + 1) % 2 ** 64)
    return _mix64((z + leaf + 1) % 2 ** 64) & _U32


# elements hashed at once: bounds the int64 temporaries of a draw
_DRAW_CHUNK = 1 << 22


def _draw_group(group, n: int, seed: int, lo: int, dev) -> list:
    """Uniforms for the stacked leaves of ``group`` (``(x, count, leaf,
    splits)`` each: ``count`` elements a worker in the whole leaf,
    ``splits`` as ``tensor_parallel.leaf_splits`` gives them).  Row ``r``
    of a leaf is worker ``lo + r``'s; its element in place ``(i, j)`` of
    the encode's view of the shard (``TP.split_view``) has the index ``e``
    in the whole leaf that the view's offset and strides give, and draws
    the counter uniform of ``e`` under ``_stream_seed(seed, lo + r,
    leaf)`` mixed with ``e >> 32``.  The group's elements lie side by side
    in the columns of one ``[n, total]`` buffer and are hashed a chunk of
    columns at a time, every leaf and worker at once (the index arithmetic
    shared by the workers): a draw is a few dozen launches a chunk,
    whatever the number of leaves and workers, and touches only the
    shard's own elements."""
    geo, seeds, total = [], [], 0
    for x, _, leaf, sp in group:
        if x.dim() == 1:                  # one element a worker
            rows, cols, off, stride, rpb, bstride = 1, 1, 0, 1, None, 0
        else:
            view, off, stride, rpb, bstride = TP.split_view(
                torch.empty(x.shape, device="meta"), sp)
            rows, cols = view.shape[1:]
            stride = cols if stride is None else stride
        # its first column, columns, offset, row stride, rows a block,
        # block stride
        geo.append((total, cols, off, stride, rpb or rows, bstride))
        seeds.append([_stream_seed(seed, lo + r, leaf) for r in range(n)])
        total += rows * cols
    firsts = [g[0] for g in geo] + [total]
    wide = any(count > 2 ** 32 for _, count, _, _ in group)
    seeds = torch.tensor(seeds, dtype=torch.int64).t().contiguous().to(dev)
    tab = (torch.tensor(geo, dtype=torch.int64).t().contiguous().to(dev)
           if len(group) > 1 else None)
    out = torch.empty((n, total), dtype=torch.float32, device=dev)
    step = max(1, _DRAW_CHUNK // n)
    for a in range(0, total, step):
        b = min(total, a + step)
        i = bisect.bisect_right(firsts, a) - 1
        one = b <= firsts[i + 1]
        if one:                           # in one leaf: its numbers
            first, cols, off, stride, rpb, bstride = geo[i]
            q = torch.arange(a - first, b - first, dtype=torch.int64,
                             device=dev)
            s = seeds[:, i:i + 1]
        else:                             # each column its leaf's
            g = torch.arange(a, b, dtype=torch.int64, device=dev)
            k = torch.searchsorted(tab[0], g, right=True) - 1
            first, cols, off, stride, rpb, bstride = (t[k] for t in tab)
            q = g - first
            s = seeds[:, k]
        if one and off == 0 and stride == cols and bstride == 0:
            e = q                         # a whole leaf's own order
        else:
            r = torch.div(q, cols, rounding_mode="floor")
            blk = torch.div(r, rpb, rounding_mode="floor")
            e = (off + blk * bstride + (r - blk * rpb) * stride
                 + (q - r * cols))
        if wide:                          # indices past 2^32 change the seed
            s = s ^ (((e >> 32) * 0x9E3779B1) & _U32)
        out[:, a:b] = _counter_uniform(s, e)
    if len(group) == 1:
        return [out.view(group[0][0].shape)]
    return [out[:, c0:c1].reshape(x.shape) for (x, _, _, _), c0, c1
            in zip(group, firsts, firsts[1:])]


def draw_uniforms(X: PyTree, seed: int) -> PyTree:
    """Uniforms in [0, 1), one float32 per element of each leaf of the
    stacked ``X``, on its device: element ``e`` of worker ``i``'s row of
    leaf ``l`` is a counter-based uniform (the Moniqua wire's murmur3
    finalizer, ``quantizers._counter_uniform``) of ``(seed, i, l, e)``,
    ``e`` its index in the whole leaf.  Under a worker split a rank draws
    its own workers' rows; under a ``model`` or FSDP ``data`` split its
    shard's elements only: in both, the bits one process draws for
    them.  Integer arithmetic throughout, so a draw on the card is the
    CPU's bit for bit."""
    return tree.unflatten(tree.flatten(X)[1], list(_leaf_draws(X, seed)))


def _leaf_draws(X: PyTree, seed: int):
    """The leaves of :func:`draw_uniforms`, drawn as they are taken: the
    leaves that fit in one chunk together, a larger leaf alone."""
    leaves = tree.leaves(X)
    splits = TP.leaf_splits(X) or ((),) * len(leaves)
    n = leaves[0].shape[0]
    lo = workers.row_base(n)
    counts = [w.numel() // w.shape[0] for w in tree.leaves(TP.whole(X))]
    group, size = [], 0
    for i, (x, c, sp) in enumerate(zip(leaves, counts, splits)):
        if group and size + x.numel() > _DRAW_CHUNK:
            yield from _draw_group(group, n, seed, lo, x.device)
            group, size = [], 0
        group.append((x, c, i, sp))
        size += x.numel()
    if group:
        yield from _draw_group(group, n, seed, lo, group[0][0].device)


def _uniform_leaves(X: PyTree, seed: Optional[int],
                    uniforms: Optional[PyTree]):
    """Per-leaf rounding uniforms: the handed-in tree's leaves, a draw
    from ``seed`` (each leaf's drawn as the caller takes it, so one leaf's
    uniforms are alive at a time), or ``None`` per leaf (nearest
    rounding)."""
    if uniforms is not None:
        return tree.leaves(uniforms)
    if seed is None:
        return [None] * len(tree.leaves(X))
    return _leaf_draws(X, seed)


def _row_reduce(fn, a: torch.Tensor) -> torch.Tensor:
    """``fn`` over every axis but the worker axis, dims kept."""
    dims = tuple(range(1, a.dim()))
    return fn(a, dim=dims, keepdim=True) if dims else a


def _split_axes(V: PyTree) -> list:
    """For each leaf of ``V`` (shaped like the params), the split axes in
    force that cut it (none outside a split)."""
    n = len(tree.leaves(V))
    dims = [(g.axis, TP.leaf_dims(V, g.axis)) for g in TP.groups()]
    return [tuple(a for a, ds in dims if ds[i] is not None)
            for i in range(n)]


def _norm_quantize(v: torch.Tensor, bits: int, u: Optional[torch.Tensor],
                   unbiased: bool = False, axes=(),
                   count: int = 0) -> torch.Tensor:
    """Per-worker norm-scaled linear quantizer (Choco/DeepSqueeze/DCD/ECD).

    bits >= 2: ``scale_i = max_j |v_ij|`` per worker row; codes cover
    ``[-scale, scale]`` with 2**bits levels, rounded with the uniforms ``u``
    (stochastic) or to nearest (``u is None``).  bits == 1 and not
    ``unbiased``: the biased scaled sign ``sign(v) * mean|v|`` that the
    contraction-based methods admit; DCD/ECD need an unbiased quantizer, so
    they round 1-bit codes stochastically (and diverge: Table 2).

    ``v`` a shard of a leaf the split ``axes`` cut (``count`` elements a
    worker in the whole leaf): the max over the axes of the shard's max,
    and the sum over them of its sum over ``count``.
    """
    if bits == 1 and not unbiased:
        if not axes:
            return torch.sign(v) * _row_reduce(torch.mean, torch.abs(v))
        total = _row_reduce(torch.sum, torch.abs(v))
        for a in axes:
            total = TP.reduce_sum(total, a)
        return torch.sign(v) * (total / _scalar(count, total))
    amax = _row_reduce(torch.amax, torch.abs(v))
    for a in axes:
        amax = TP.max_over(amax, a)
    scale = amax + 1e-12
    levels = 2 ** bits
    lat = (v / (2.0 * scale) + 0.5) * (levels - 1)
    codes = torch.floor(lat + (0.5 if u is None else u))
    codes = torch.clamp(codes, 0, levels - 1)
    return (codes / _scalar(levels - 1, codes) - 0.5) * 2.0 * scale


def _nq_tree(V: PyTree, bits: int, seed: Optional[int],
             uniforms: Optional[PyTree], unbiased: bool = False) -> PyTree:
    leaves, td = tree.flatten(V)
    biased_sign = bits == 1 and not unbiased      # draws no uniforms
    us = ([None] * len(leaves) if biased_sign
          else _uniform_leaves(V, seed, uniforms))
    counts = [w.numel() // w.shape[0] for w in tree.leaves(TP.whole(V))]
    return tree.unflatten(td, [
        _norm_quantize(l, bits, u, unbiased, axes, n)
        for l, u, axes, n in zip(leaves, us, _split_axes(V), counts)])


def _code_bytes(X: PyTree, hp: AlgoHyper) -> int:
    """Bytes a worker sends per step with ``bits``-bit codes of its model
    to each neighbor (the norm-scaled rules)."""
    return (Algorithm._model_bytes(X) * hp.codec.spec.bits // 32
            * len(hp.topo.neighbor_offsets()))


def _device(X: PyTree) -> torch.device:
    return tree.leaves(X)[0].device


def _with_health(extra: dict, X: PyTree, hp: AlgoHyper) -> dict:
    """``extra`` plus a fresh health carry when telemetry is on."""
    if hp.telemetry:
        extra["health"] = obs_metrics.init_health(_device(X))
    return extra


def _zeros_like(X: PyTree) -> PyTree:
    return tree.map(torch.zeros_like, X)


def _f32_copy(X: PyTree) -> PyTree:
    return tree.map(lambda x: x.to(torch.float32, copy=True), X)


class Algorithm:
    """Base: subclasses override init/step and the two accounting methods."""
    name: str = "base"
    # the keys of ``init``'s state whose subtrees mirror the params leaf
    # for leaf, which a split of the weights holds in the params' cut
    mirrors: Tuple[str, ...] = ()

    def init(self, X: PyTree, hp: AlgoHyper) -> PyTree:
        return {}

    def step(self, X: PyTree, extra: PyTree, g: PyTree, alpha, k,
             seed: Optional[int], hp: AlgoHyper,
             uniforms: Optional[PyTree] = None) -> Tuple[PyTree, PyTree]:
        raise NotImplementedError

    def bytes_per_step(self, X: PyTree, hp: AlgoHyper) -> int:
        """Payload bytes *sent* per worker per iteration."""
        raise NotImplementedError

    def extra_memory_bytes(self, X: PyTree, hp: AlgoHyper) -> int:
        """Per-worker state beyond full-precision D-PSGD (Table 1), in the
        paper's accounting (conceptual replicas for the replica schemes)."""
        return 0

    def engines(self, hp: AlgoHyper) -> list:
        """The engine of every round the rule gossips through (what a
        split of the weights must run): the full-precision one unless a
        rule says otherwise."""
        return [hp.exact_engine()]

    @staticmethod
    def _model_bytes(X: PyTree) -> int:
        """Per-worker full-precision model bytes (d * itemsize), one
        process's also under a split of the weights."""
        leaves = tree.leaves(TP.whole(X))
        return sum(l.numel() * l.element_size() for l in leaves) \
            // leaves[0].shape[0]


class AllReduce(Algorithm):
    name = "allreduce"

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        Xh = _sgd(X, g, alpha)
        n = tree.leaves(X)[0].shape[0] * workers.blocks()
        # the workers' sum, all-reduced across ranks, over n: one
        # process's torch.mean; across ranks the partial sums add in the
        # collective's order
        Xm = tree.map(lambda x: (workers.all_sum(torch.sum(
            x.float(), dim=0, keepdim=True)) / n)
            .expand(x.shape).to(x.dtype), Xh)
        return Xm, extra

    def bytes_per_step(self, X, hp):
        return 2 * self._model_bytes(X)  # ring allreduce ~2x model bytes/worker

    def engines(self, hp):
        return []


class DPSGD(Algorithm):
    name = "dpsgd"

    def init(self, X, hp):
        return _with_health({}, X, hp)

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        # theta rides along as a diagnostic only: the full wire ignores it
        res = hp.exact_engine(telemetry=hp.telemetry).mix(
            X, theta=hp.theta, presence=hp.presence)
        if hp.telemetry:
            extra = dict(extra)
            extra["health"] = obs_metrics.accumulate_health(
                extra["health"], res.health)
        return _sgd(res.x, g, alpha), extra

    def bytes_per_step(self, X, hp):
        return hp.exact_engine().bytes_per_round(X)

    def engines(self, hp):
        return [hp.exact_engine(telemetry=hp.telemetry)]


class NaiveQuant(Algorithm):
    """Direct quantization of exchanged models (Eq. 4): the Theorem 1
    failure."""
    name = "naive"

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        d = hp.naive_delta

        def q(v, u):
            lat = v / _scalar(d, v)
            return d * torch.floor(lat + (0.5 if u is None else u))

        leaves, td = tree.flatten(X)
        Q = tree.unflatten(td, [q(l, u) for l, u in zip(
            leaves, _uniform_leaves(X, seed, uniforms))])
        eng = hp.exact_engine()
        sw = eng.self_weight()
        mixed = tree.map(lambda x, nb: x * as_weight(sw, x.dtype) + nb,
                         X, eng.neighbor_sum(Q, lambda v, o: v))
        return _sgd(mixed, g, alpha), extra

    def bytes_per_step(self, X, hp):
        # the code width of an 8-bit budget, for comparison
        return self._model_bytes(X) // 4 * len(hp.topo.neighbor_offsets())


class Moniqua(Algorithm):
    """Algorithm 1: gossip through the engine's configured wire, then SGD.

    A stateful wire (``hp.wire`` ``ef_qsgd`` / ``onebit``) keeps its
    per-worker WireState under ``extra["wire"]``; ``hp.overlap == "stale"``
    (stateless Moniqua wire) mixes one round stale through ``mix_stale``
    and keeps its gossip carry under ``extra["gossip"]``."""
    name = "moniqua"

    def init(self, X, hp):
        eng = hp.engine()
        extra = {}
        if eng.stateful:
            extra["wire"] = eng.init_wire_state(X)
        elif hp.overlap == "stale":
            extra["gossip"] = eng.init_gossip_carry(X)
        return _with_health(extra, X, hp)

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        eng = hp.engine()
        new_extra = dict(extra)
        if eng.stateful:
            res = eng.mix(X, theta=hp.theta, seed=seed, state=extra["wire"],
                          presence=hp.presence)
            new_extra["wire"] = res.state
        elif hp.overlap == "stale":
            res = eng.mix_stale(X, extra["gossip"], theta=hp.theta,
                                seed=seed, presence=hp.presence)
            new_extra["gossip"] = res.state
        else:
            res = eng.mix(X, theta=hp.theta, seed=seed, presence=hp.presence)
        if hp.telemetry:
            new_extra["health"] = obs_metrics.accumulate_health(
                extra["health"], res.health)
        return _sgd(res.x, g, alpha), new_extra

    def bytes_per_step(self, X, hp):
        return hp.engine().bytes_per_round(X)

    def extra_memory_bytes(self, X, hp):
        # 0 for the moniqua wire (the headline claim); residual + counter
        # for the EF wires
        return hp.engine().wire_state_bytes(TP.whole(X))

    def engines(self, hp):
        return [hp.engine()]


class ChocoSGD(Algorithm):
    """Koloskova et al. 2019: gossip on quantized estimators x_hat."""
    name = "choco"
    mirrors = ("x_hat",)

    def init(self, X, hp):
        return {"x_hat": _zeros_like(X)}

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        x_hat = extra["x_hat"]
        Xh = _sgd(X, g, alpha)
        q = _nq_tree(tree.map(lambda a, b: a - b, Xh, x_hat),
                     hp.codec.spec.bits, seed, uniforms)
        x_hat = tree.map(lambda a, b: a + b, x_hat, q)
        mixed_hat = hp.exact_engine().mix(x_hat).x
        Xn = tree.map(
            lambda x, mh, h: (x + hp.gamma * (mh - h)).to(x.dtype),
            Xh, mixed_hat, x_hat)
        return Xn, {"x_hat": x_hat}

    def bytes_per_step(self, X, hp):
        return _code_bytes(X, hp)

    def extra_memory_bytes(self, X, hp):
        # replicas of every neighbor's estimator and its own
        return self._model_bytes(X) * (len(hp.topo.neighbor_offsets()) + 1)


class DeepSqueeze(Algorithm):
    """Tang et al. 2019: error-compensated compressed gossip."""
    name = "deepsqueeze"
    mirrors = ("err",)

    def init(self, X, hp):
        return {"err": _zeros_like(X)}

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        Xh = _sgd(X, g, alpha)
        v = tree.map(lambda a, b: a + b, Xh, extra["err"])
        c = _nq_tree(v, hp.codec.spec.bits, seed, uniforms)
        e = tree.map(lambda a, b: a - b, v, c)
        mixed_c = hp.exact_engine().mix(c).x
        Xn = tree.map(
            lambda x, mc, ci: (x + hp.gamma * (mc - ci)).to(x.dtype),
            Xh, mixed_c, c)
        return Xn, {"err": e}

    def bytes_per_step(self, X, hp):
        return _code_bytes(X, hp)

    def extra_memory_bytes(self, X, hp):
        return self._model_bytes(X)      # one error buffer per worker


class DCD(Algorithm):
    """DCD-PSGD: replicas x_hat updated with quantized model differences."""
    name = "dcd"
    mirrors = ("x_hat",)

    def init(self, X, hp):
        return {"x_hat": _f32_copy(X)}

    def _replica_sgd(self, X, x_hat, g, alpha, hp):
        mixed_hat = hp.exact_engine().mix(x_hat).x
        return _sgd(tree.map(lambda x, mh, h: x + (mh - h), X, mixed_hat,
                             x_hat), g, alpha)

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        x_hat = extra["x_hat"]
        Xn = self._replica_sgd(X, x_hat, g, alpha, hp)
        z = tree.map(lambda a, b: a - b, Xn, x_hat)
        q = _nq_tree(z, hp.codec.spec.bits, seed, uniforms, unbiased=True)
        return Xn, {"x_hat": tree.map(lambda a, b: a + b, x_hat, q)}

    def bytes_per_step(self, X, hp):
        return _code_bytes(X, hp)

    def extra_memory_bytes(self, X, hp):
        return self._model_bytes(X) * (len(hp.topo.neighbor_offsets()) + 1)


class ECD(DCD):
    """ECD-PSGD: extrapolated difference compression (the reference's
    extrapolation weights (1/2, 1/2))."""
    name = "ecd"

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        x_hat = extra["x_hat"]
        Xn = self._replica_sgd(X, x_hat, g, alpha, hp)
        z = tree.map(lambda a, b: 2.0 * a - b, Xn, x_hat)
        q = _nq_tree(z, hp.codec.spec.bits, seed, uniforms, unbiased=True)
        return Xn, {"x_hat": tree.map(lambda a, b: 0.5 * (a + b), x_hat, q)}


class D2(Algorithm):
    """D^2 (Tang et al. 2018): variance-reduced decentralized SGD, Sec. 5."""
    name = "d2"
    mirrors = ("x_prev", "g_prev")

    def init(self, X, hp):
        return _with_health(
            {"x_prev": _f32_copy(X), "g_prev": _zeros_like(X),
             "alpha_prev": torch.zeros((), dtype=torch.float32,
                                       device=_device(X))}, X, hp)

    def _half_step(self, X, extra, g, alpha):
        a_prev = extra["alpha_prev"]
        return tree.map(
            lambda x, xp, gi, gp: 2.0 * x.float() - xp - alpha * gi
            + a_prev * gp, X, extra["x_prev"], g, extra["g_prev"])

    def _mix(self, Xh, extra, seed, hp):
        return hp.exact_engine(telemetry=hp.telemetry).mix(
            Xh, theta=hp.theta, presence=hp.presence)

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        res = self._mix(self._half_step(X, extra, g, alpha), extra, seed, hp)
        Xn = tree.map(lambda a, x: a.to(x.dtype), res.x, X)
        new_extra = {"x_prev": tree.map(lambda x: x.float(), X),
                     "g_prev": g,
                     "alpha_prev": torch.as_tensor(alpha, dtype=torch.float32,
                                                   device=_device(X))}
        if "wire" in extra:
            new_extra["wire"] = res.state
        if hp.telemetry:
            new_extra["health"] = obs_metrics.accumulate_health(
                extra["health"], res.health)
        return Xn, new_extra

    def bytes_per_step(self, X, hp):
        return hp.exact_engine().bytes_per_round(X)

    def extra_memory_bytes(self, X, hp):
        return 2 * self._model_bytes(X)  # x_prev + g_prev (inherent to D^2)

    def engines(self, hp):
        return [hp.exact_engine(telemetry=hp.telemetry)]


class MoniquaD2(D2):
    """Moniqua on D^2 (Algorithm 2): the half-step gossips through the
    engine's configured wire (the bucketed Moniqua round).  A stateful wire
    keeps its WireState under ``extra["wire"]``, beside D^2's carry."""
    name = "moniqua_d2"

    def init(self, X, hp):
        extra = super().init(X, hp)
        eng = hp.engine()
        if eng.stateful:
            extra["wire"] = eng.init_wire_state(X)
        return extra

    def _mix(self, Xh, extra, seed, hp):
        eng = hp.engine()
        return eng.mix(Xh, theta=hp.theta, seed=seed,
                       state=extra["wire"] if eng.stateful else None,
                       presence=hp.presence)

    def bytes_per_step(self, X, hp):
        return hp.engine().bytes_per_round(X)

    def engines(self, hp):
        return [hp.engine()]


ALGORITHMS: Dict[str, Algorithm] = {a.name: a for a in [
    AllReduce(), DPSGD(), NaiveQuant(), Moniqua(), ChocoSGD(), DeepSqueeze(),
    DCD(), ECD(), D2(), MoniquaD2(),
]}


def get_algorithm(name: str) -> Algorithm:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; "
                         f"available: {sorted(ALGORITHMS)}") from None
