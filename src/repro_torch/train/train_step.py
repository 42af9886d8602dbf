"""Decentralized training step: local grads -> optimizer -> gossip rule.

Every training-state leaf carries a leading worker dim ``[n, ...]``.
Per-worker gradients come from ``torch.func.vmap(torch.func.grad_and_value(
model.loss))`` over the stacked parameter tree: vmap batches the convs,
group norms and matmuls over the worker axis, so the workers' gradients are
one batched computation and the only cross-worker traffic is the
algorithm's gossip through ``CommEngine``.

Randomness: each step's uint32 hash seed for stochastic rounding is drawn
from the state's ``torch.Generator`` (on the CPU, so drawing it never waits
for the card), unless the caller passes ``seed=`` (parity tests hand in the
reference's per-step seed).

The step size comes from ``TrainStepConfig.lr_schedule`` (a callable of the
step index, e.g. ``optim.sgd.step_decay``), or the constant ``lr``.  With
``AlgoHyper.telemetry`` the rule's accumulated round health
(``extra["health"]``) comes back as ``obs_*`` step metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core.algorithms import AlgoHyper, Algorithm, get_algorithm
from repro_torch.core.theta import ThetaSchedule
from repro_torch.optim import sgd as optim

PyTree = Any


def init_state(model, algo: Algorithm, hp: AlgoHyper, n_workers: int,
               seed: int = 0) -> Dict[str, Any]:
    """All workers start from identical weights (assumption A4), drawn from
    ``model.generator(seed)`` (on the model's device for an LM, so a
    full-width model is drawn there).  The per-step seeds come from a CPU
    generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    params = model.init(model.generator(seed))
    X = tree.map(lambda a: a.unsqueeze(0).expand((n_workers,) + a.shape)
                 .clone(), params)
    return {
        "params": X,
        "mom": optim.init_momentum(X),
        "extra": algo.init(X, hp),
        "step": 0,
        "g_inf": torch.ones((), dtype=torch.float32,
                            device=tree.leaves(X)[0].device),
        "gen": gen,
    }


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    algo: str = "moniqua"
    sgd: optim.SGDConfig = dataclasses.field(default_factory=optim.SGDConfig)
    lr: float = 0.1
    lr_schedule: Optional[Callable[[int], float]] = None
    theta: ThetaSchedule = dataclasses.field(default_factory=ThetaSchedule)


def make_train_step(model, hp: AlgoHyper, tcfg: TrainStepConfig
                    ) -> Callable[..., Tuple[Dict[str, Any], Dict]]:
    """``train_step(state, batch, seed=None) -> (new_state, metrics)``;
    ``model`` exposes ``loss(params, batch)``."""
    algo = get_algorithm(tcfg.algo)
    sched = tcfg.lr_schedule or optim.constant(tcfg.lr)
    grad_fn = torch.func.vmap(torch.func.grad_and_value(model.loss))

    def train_step(state, batch, seed: Optional[int] = None):
        X, mom, extra = state["params"], state["mom"], state["extra"]
        step = state["step"]
        if seed is None:
            seed = int(torch.randint(0, 2 ** 32, (1,),
                                     generator=state["gen"]).item())

        grads, losses = grad_fn(X, batch)
        dirs, mom, g_inf_now = optim.direction(tcfg.sgd, grads, X, mom)
        del grads                       # freed before the gossip round
        g_inf = torch.maximum(0.9 * state["g_inf"], g_inf_now)

        alpha = sched(step)
        theta = tcfg.theta(alpha, g_inf)
        hp_k = dataclasses.replace(hp, theta=theta)
        X, extra = algo.step(X, extra, dirs, alpha, step, seed, hp_k)

        new_state = {"params": X, "mom": mom, "extra": extra,
                     "step": step + 1, "g_inf": g_inf, "gen": state["gen"]}
        metrics = {"loss": torch.mean(losses), "alpha": alpha,
                   "theta": theta, "g_inf": g_inf,
                   "wire_bytes": algo.bytes_per_step(X, hp)}
        if isinstance(extra, dict) and "health" in extra:
            metrics.update({f"obs_{k}": v
                            for k, v in extra["health"].items()})
        return new_state, metrics

    return train_step
