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
quantizers draw their rounding uniforms from a ``torch.Generator`` on the
tensors' device seeded with it, unless the caller hands in ``uniforms``, a
tree shaped like ``X`` (the parity tests hand in the reference's
``jax.random.uniform`` draws).  ``seed=None`` with no ``uniforms`` rounds to
nearest, as the reference does for ``key=None``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.comm.engine import CommEngine, FullPrecisionWire, make_wire
from repro_torch.comm.gossip import as_weight
from repro_torch.core.modulo import _scalar
from repro_torch.core.moniqua import MoniquaCodec
from repro_torch.core.topology import Topology

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AlgoHyper:
    """Static hyper-parameters of the update rules (flat topology only).

    ``engine()`` builds the configured wire (``wire`` x ``codec.spec``) for
    quantized gossip, ``exact_engine()`` the full-precision engine the
    baselines (and replica mixing) use.

    Elastic rounds: ``presence`` is a 0/1 worker mask that D-PSGD, Moniqua
    (every branch), D² and Moniqua-D² hand to the engine's
    ``mix(presence=...)`` every round; ``None`` or all-ones is the unmasked
    gossip.  ``deadline`` is the round deadline in seconds that the
    simulator enforces (``sim.faults.FaultSpec.deadline_s``); no step reads
    it, it rides here so one hyper object carries the elastic setup.
    """
    topo: Topology
    codec: MoniquaCodec = MoniquaCodec()
    theta: Any = 2.0              # Moniqua a-priori bound (paper used 2.0)
    gamma: float = 1.0            # consensus step size (Choco/DeepSqueeze)
    naive_delta: float = 0.05     # absolute lattice pitch of the naive rule
    wire: str = "moniqua"         # wire codec for quantized gossip (engine())
    path: str = "bucketed"        # gossip path: bucketed | per_leaf
    chunks: int = 1               # staged-round chunk count (1 = barrier)
    overlap: str = "none"         # step-level overlap: none | stale (Moniqua)
    warmup: int = 16              # onebit wire: fp32 rounds before 1-bit+EF
    presence: Optional[Tuple[int, ...]] = None   # elastic 0/1 worker mask
    deadline: Optional[float] = None             # sim round deadline (s)

    def engine(self) -> CommEngine:
        return CommEngine(self.topo,
                          make_wire(self.wire, self.codec.spec,
                                    warmup=self.warmup),
                          path=self.path, chunks=self.chunks)

    def exact_engine(self) -> CommEngine:
        return CommEngine(self.topo, FullPrecisionWire(), path=self.path,
                          chunks=self.chunks)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _sgd(X: PyTree, g: PyTree, alpha) -> PyTree:
    return tree.map(lambda x, d: (x - alpha * d).to(x.dtype), X, g)


def draw_uniforms(X: PyTree, seed: int) -> PyTree:
    """Uniforms in [0, 1), one float32 per element of each leaf of ``X``,
    from a ``torch.Generator`` on ``X``'s device seeded with ``seed``."""
    leaves, td = tree.flatten(X)
    dev = leaves[0].device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return tree.unflatten(td, [torch.rand(l.shape, generator=gen, device=dev)
                               for l in leaves])


def _uniform_leaves(X: PyTree, seed: Optional[int],
                    uniforms: Optional[PyTree]) -> list:
    """Per-leaf rounding uniforms: the handed-in tree, a draw from ``seed``,
    or ``None`` per leaf (nearest rounding)."""
    if uniforms is None and seed is not None:
        uniforms = draw_uniforms(X, seed)
    if uniforms is None:
        return [None] * len(tree.leaves(X))
    return tree.leaves(uniforms)


def _row_reduce(fn, a: torch.Tensor) -> torch.Tensor:
    """``fn`` over every axis but the worker axis, dims kept."""
    dims = tuple(range(1, a.dim()))
    return fn(a, dim=dims, keepdim=True) if dims else a


def _norm_quantize(v: torch.Tensor, bits: int, u: Optional[torch.Tensor],
                   unbiased: bool = False) -> torch.Tensor:
    """Per-worker norm-scaled linear quantizer (Choco/DeepSqueeze/DCD/ECD).

    bits >= 2: ``scale_i = max_j |v_ij|`` per worker row; codes cover
    ``[-scale, scale]`` with 2**bits levels, rounded with the uniforms ``u``
    (stochastic) or to nearest (``u is None``).  bits == 1 and not
    ``unbiased``: the biased scaled sign ``sign(v) * mean|v|`` that the
    contraction-based methods admit; DCD/ECD need an unbiased quantizer, so
    they round 1-bit codes stochastically (and diverge: Table 2).
    """
    if bits == 1 and not unbiased:
        return torch.sign(v) * _row_reduce(torch.mean, torch.abs(v))
    scale = _row_reduce(torch.amax, torch.abs(v)) + 1e-12
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
    return tree.unflatten(td, [_norm_quantize(l, bits, u, unbiased)
                               for l, u in zip(leaves, us)])


def _code_bytes(X: PyTree, hp: AlgoHyper) -> int:
    """Bytes a worker sends per step with ``bits``-bit codes of its model
    to each neighbor (the norm-scaled rules)."""
    return (Algorithm._model_bytes(X) * hp.codec.spec.bits // 32
            * len(hp.topo.neighbor_offsets()))


def _zeros_like(X: PyTree) -> PyTree:
    return tree.map(torch.zeros_like, X)


def _f32_copy(X: PyTree) -> PyTree:
    return tree.map(lambda x: x.to(torch.float32, copy=True), X)


class Algorithm:
    """Base: subclasses override init/step and the two accounting methods."""
    name: str = "base"

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

    @staticmethod
    def _model_bytes(X: PyTree) -> int:
        """Per-worker full-precision model bytes (d * itemsize)."""
        leaves = tree.leaves(X)
        return sum(l.numel() * l.element_size() for l in leaves) \
            // leaves[0].shape[0]


class AllReduce(Algorithm):
    name = "allreduce"

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        Xh = _sgd(X, g, alpha)
        Xm = tree.map(lambda x: torch.mean(x.float(), dim=0, keepdim=True)
                      .expand(x.shape).to(x.dtype), Xh)
        return Xm, extra

    def bytes_per_step(self, X, hp):
        return 2 * self._model_bytes(X)  # ring allreduce ~2x model bytes/worker


class DPSGD(Algorithm):
    name = "dpsgd"

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        return (_sgd(hp.exact_engine().mix(X, presence=hp.presence).x, g,
                     alpha), extra)

    def bytes_per_step(self, X, hp):
        return hp.exact_engine().bytes_per_round(X)


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
        if eng.stateful:
            return {"wire": eng.init_wire_state(X)}
        if hp.overlap == "stale":
            return {"gossip": eng.init_gossip_carry(X)}
        return {}

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
        return _sgd(res.x, g, alpha), new_extra

    def bytes_per_step(self, X, hp):
        return hp.engine().bytes_per_round(X)

    def extra_memory_bytes(self, X, hp):
        # 0 for the moniqua wire (the headline claim); residual + counter
        # for the EF wires
        return hp.engine().wire_state_bytes(X)


class ChocoSGD(Algorithm):
    """Koloskova et al. 2019: gossip on quantized estimators x_hat."""
    name = "choco"

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

    def init(self, X, hp):
        dev = tree.leaves(X)[0].device
        return {"x_prev": _f32_copy(X), "g_prev": _zeros_like(X),
                "alpha_prev": torch.zeros((), dtype=torch.float32,
                                          device=dev)}

    def _half_step(self, X, extra, g, alpha):
        a_prev = extra["alpha_prev"]
        return tree.map(
            lambda x, xp, gi, gp: 2.0 * x.float() - xp - alpha * gi
            + a_prev * gp, X, extra["x_prev"], g, extra["g_prev"])

    def _mix(self, Xh, seed, hp):
        return hp.exact_engine().mix(Xh, presence=hp.presence).x

    def step(self, X, extra, g, alpha, k, seed, hp, uniforms=None):
        mixed = self._mix(self._half_step(X, extra, g, alpha), seed, hp)
        Xn = tree.map(lambda a, x: a.to(x.dtype), mixed, X)
        dev = tree.leaves(X)[0].device
        return Xn, {"x_prev": tree.map(lambda x: x.float(), X),
                    "g_prev": g,
                    "alpha_prev": torch.as_tensor(alpha, dtype=torch.float32,
                                                  device=dev)}

    def bytes_per_step(self, X, hp):
        return hp.exact_engine().bytes_per_round(X)

    def extra_memory_bytes(self, X, hp):
        return 2 * self._model_bytes(X)  # x_prev + g_prev (inherent to D^2)


class MoniquaD2(D2):
    """Moniqua on D^2 (Algorithm 2): the half-step gossips through the
    engine's configured wire (the bucketed Moniqua round)."""
    name = "moniqua_d2"

    def _mix(self, Xh, seed, hp):
        return hp.engine().mix(Xh, theta=hp.theta, seed=seed,
                               presence=hp.presence).x

    def bytes_per_step(self, X, hp):
        return hp.engine().bytes_per_round(X)


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
