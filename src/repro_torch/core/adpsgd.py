"""AD-PSGD and Moniqua on AD-PSGD (paper Sec. 5, Algorithm 3), simulated.

The paper's analysis model, as the reference simulates it: an iteration is
ONE gradient update on ONE worker ``i_k`` (uniformly sampled), with a
gradient computed on the model ``tau_k`` iterations stale (``tau_k <= T``
uniform), exactly the single-worker-update process of Theorem 5.  Before
the update, a random edge ``(i_k, j_k)`` of the topology gossips with the
pair-averaging ``W_k``; in the Moniqua variant the exchange is
modulo-quantized and each endpoint decodes against its own model
(``CommEngine.pair_average``: one encode launch and two point-decode
launches an exchange on the card).

The loop runs on the host over a staleness ring buffer of ``T + 1`` model
copies.  Its draws come from a schedule: the worker ``i``, the staleness
``tau``, the neighbour index ``nb`` into the topology's neighbour offsets,
the exchange's uint32 hash ``seed``, and optionally the gradient ``noise``
handed to ``grad_fn``.  :func:`make_schedule` draws one from a seed with a
``torch.Generator``; the parity tests rebuild the reference's
``jax.random`` draws and hand them in instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.comm.engine import CommEngine, FullPrecisionWire, make_wire
from repro_torch.core.moniqua import MoniquaCodec
from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class ADPSGDConfig:
    topo: Topology
    codec: MoniquaCodec = MoniquaCodec()
    theta: float = 2.0
    max_delay: int = 4
    quantized: bool = False     # False = plain AD-PSGD, True = Moniqua
    wire: str = "moniqua"       # wire codec when quantized (moniqua | qsgd)
    telemetry: bool = False     # per-exchange edge health (obs); run()
                                #   then also returns a health trace

    def engine(self) -> CommEngine:
        """Pair-exchange engine: the quantized wire or the exact baseline."""
        return CommEngine(self.topo, make_wire(self.wire, self.codec.spec)
                          if self.quantized else FullPrecisionWire())


def make_schedule(n: int, num_iters: int, cfg: ADPSGDConfig,
                  seed: int = 0) -> Dict[str, torch.Tensor]:
    """Draw ``i``, ``tau``, ``nb`` and the exchange ``seed`` of every
    iteration (int64 tensors on the CPU, read by the host loop)."""
    gen = torch.Generator().manual_seed(int(seed))

    def draw(high):
        return torch.randint(0, high, (num_iters,), generator=gen)

    return {"i": draw(n), "tau": draw(cfg.max_delay + 1),
            "nb": draw(len(cfg.topo.neighbor_offsets())), "seed": draw(2 ** 32)}


def _pair_average(X: torch.Tensor, i: int, j: int, cfg: ADPSGDConfig,
                  seed: int, eng: Optional[CommEngine] = None) -> torch.Tensor:
    """One gossip on edge (i, j), written into rows i and j of ``X``."""
    eng = eng or cfg.engine()
    res = eng.pair_average(X[i], X[j], theta=cfg.theta, seed=seed)
    X[i] = res.xi
    X[j] = res.xj
    return X


def run(x0: torch.Tensor,
        grad_fn: Callable[[torch.Tensor, int, Optional[torch.Tensor]],
                          torch.Tensor],
        alpha: float, num_iters: int, cfg: ADPSGDConfig, seed: int = 0,
        schedule: Optional[Dict] = None
        ) -> Tuple[torch.Tensor, ...]:
    """Run the simulation from ``x0 [n, d]``; returns (final X ``[n, d]``,
    mean-model trace ``[K, d]``, the mean taken before each iteration's
    exchange).  ``grad_fn(x_worker [d], worker, noise)`` is the stochastic
    gradient, ``noise`` the schedule's row for the iteration (``None``
    without one).  ``schedule`` defaults to ``make_schedule(n, num_iters,
    cfg, seed)``.

    With ``cfg.telemetry`` a third element rides along: the per-iteration
    edge-health trace (``CommEngine.pair_health`` of the exchanged pair,
    each value a ``[K]`` tensor keyed like ``obs.metrics.round_health_zero``),
    taken on the *pre-exchange* endpoints under the exchange seed, so it
    observes the payloads the exchange ships (two encode launches an
    iteration on the Moniqua wire).  X is bitwise the same with it on or
    off."""
    n, d = x0.shape
    T = cfg.max_delay
    s = schedule if schedule is not None else make_schedule(
        n, num_iters, cfg, seed)
    noise = s.get("noise")
    offsets = [o % n for o in cfg.topo.neighbor_offsets()]
    eng = cfg.engine()
    X = x0.clone()
    hist = x0.unsqueeze(0).repeat(T + 1, 1, 1)     # staleness ring buffer
    trace = []
    health = []
    for k in range(num_iters):
        i, tau = int(s["i"][k]), int(s["tau"][k])
        g = grad_fn(hist[(k - tau) % (T + 1), i], i,
                    None if noise is None else noise[k])
        # gossip on a random incident edge, then the (delayed) update
        j = (i + offsets[int(s["nb"][k])]) % n
        trace.append(X.mean(dim=0))
        if cfg.telemetry:
            health.append(eng.pair_health(X[i], X[j], theta=cfg.theta,
                                          seed=int(s["seed"][k])))
        _pair_average(X, i, j, cfg, int(s["seed"][k]), eng)
        X[i] = X[i] + -alpha * g
        hist[(k + 1) % (T + 1)] = X
    if cfg.telemetry:
        return X, torch.stack(trace), {
            key: torch.stack([h[key] for h in health]) for key in health[0]}
    return X, torch.stack(trace)
