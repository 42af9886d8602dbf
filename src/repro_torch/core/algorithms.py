"""Decentralized training update rules on stacked worker pytrees.

Every rule takes the stacked model ``X`` (leaves ``[n, ...]``), its algorithm
state ``extra``, the local directions ``g`` and the step size ``alpha``, and
routes its communication through :class:`~repro_torch.comm.engine.CommEngine`.
This slice carries the main path's rules:

  allreduce    exact centralized SGD (the AllReduce analog)
  dpsgd        Lian et al. 2017, full-precision gossip
  moniqua      Algorithm 1 (modulo-quantized gossip, zero extra memory)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.comm.engine import CommEngine, FullPrecisionWire, make_wire
from repro_torch.core.moniqua import MoniquaCodec
from repro_torch.core.topology import Topology

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AlgoHyper:
    """Static hyper-parameters of the update rules (flat topology only).

    ``engine()`` builds the configured wire (``wire`` x ``codec.spec``) for
    quantized gossip, ``exact_engine()`` the full-precision engine.
    """
    topo: Topology
    codec: MoniquaCodec = MoniquaCodec()
    theta: Any = 2.0              # Moniqua a-priori bound (paper used 2.0)
    wire: str = "moniqua"         # wire codec for quantized gossip (engine())
    path: str = "bucketed"        # gossip path: bucketed | per_leaf

    def engine(self) -> CommEngine:
        return CommEngine(self.topo, make_wire(self.wire, self.codec.spec),
                          path=self.path)

    def exact_engine(self) -> CommEngine:
        return CommEngine(self.topo, FullPrecisionWire(), path=self.path)


def _sgd(X: PyTree, g: PyTree, alpha) -> PyTree:
    return tree.map(lambda x, d: (x - alpha * d).to(x.dtype), X, g)


class Algorithm:
    """Base: subclasses override init/step and the byte accounting."""
    name: str = "base"

    def init(self, X: PyTree, hp: AlgoHyper) -> PyTree:
        return {}

    def step(self, X: PyTree, extra: PyTree, g: PyTree, alpha, k,
             seed: Optional[int], hp: AlgoHyper) -> Tuple[PyTree, PyTree]:
        raise NotImplementedError

    def bytes_per_step(self, X: PyTree, hp: AlgoHyper) -> int:
        """Payload bytes *sent* per worker per iteration."""
        raise NotImplementedError

    @staticmethod
    def _model_bytes(X: PyTree) -> int:
        """Per-worker full-precision model bytes (d * itemsize)."""
        leaves = tree.leaves(X)
        return sum(l.numel() * l.element_size() for l in leaves) \
            // leaves[0].shape[0]


class AllReduce(Algorithm):
    name = "allreduce"

    def step(self, X, extra, g, alpha, k, seed, hp):
        Xh = _sgd(X, g, alpha)
        Xm = tree.map(lambda x: torch.mean(x.float(), dim=0, keepdim=True)
                      .expand(x.shape).to(x.dtype), Xh)
        return Xm, extra

    def bytes_per_step(self, X, hp):
        return 2 * self._model_bytes(X)  # ring allreduce ~2x model bytes/worker


class DPSGD(Algorithm):
    name = "dpsgd"

    def step(self, X, extra, g, alpha, k, seed, hp):
        return _sgd(hp.exact_engine().mix(X).x, g, alpha), extra

    def bytes_per_step(self, X, hp):
        return hp.exact_engine().bytes_per_round(X)


class Moniqua(Algorithm):
    """Algorithm 1: gossip through the engine's configured wire, then SGD."""
    name = "moniqua"

    def step(self, X, extra, g, alpha, k, seed, hp):
        res = hp.engine().mix(X, theta=hp.theta, seed=seed)
        return _sgd(res.x, g, alpha), extra

    def bytes_per_step(self, X, hp):
        return hp.engine().bytes_per_round(X)


ALGORITHMS: Dict[str, Algorithm] = {a.name: a for a in [
    AllReduce(), DPSGD(), Moniqua(),
]}


def get_algorithm(name: str) -> Algorithm:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; "
                         f"available: {sorted(ALGORITHMS)}") from None
