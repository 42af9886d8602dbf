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

Across ranks (``launch.mesh.mesh_context``): the state holds this rank's
block of workers.  The seed generator is the same on every rank, the
gossip exchanges rows point to point, and ``g_inf`` and the logged loss
are reduced over the ranks, so each worker's numbers are those of one
process given the same gradients.  Under a ``model`` split
(``comm/tensor_parallel.py``) a rank holds its shard of each
tensor-parallel leaf of its workers; its per-worker losses are the
replicated loss (taken from this rank, not summed over ``model``), and
``g_inf`` is a max over the shards as well.  ``state_pspecs`` /
``batch_pspecs`` resolve the logical-axis trees into ``PartitionSpec`` s,
the reference's, for the trainer and the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.comm import workers
from repro_torch.core.algorithms import AlgoHyper, Algorithm, get_algorithm
from repro_torch.core.theta import ThetaSchedule
from repro_torch.models.sharding import (P, ShardingRules, resolve_tree,
                                         safe_pspec)
from repro_torch.optim import sgd as optim

PyTree = Any


def n_workers_for(cfg, rules: ShardingRules, mesh_shape: Dict[str, int]
                  ) -> int:
    """The worker count a mesh gives: the product of the worker axes."""
    n = 1
    for a in rules.worker_axes:
        n *= mesh_shape.get(a, 1)
    return max(n, 1)


def init_state(model, algo: Algorithm, hp: AlgoHyper, n_workers: int,
               seed: int = 0, cut: Optional[Callable] = None
               ) -> Dict[str, Any]:
    """All workers start from identical weights (assumption A4), drawn from
    ``model.generator(seed)`` (on the model's device for an LM, so a
    full-width model is drawn there).  The per-step seeds come from a CPU
    generator seeded with ``seed``.  ``cut(params)``, if given, takes the
    one-process draw to this rank's shards before it is stacked (a
    ``model`` split: every rank draws the whole init and keeps its cut)."""
    gen = torch.Generator().manual_seed(seed)
    params = model.init(model.generator(seed))
    if cut is not None:
        params = cut(params)
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


def abstract_state(model, algo: Algorithm, hp: AlgoHyper, n_workers: int
                   ) -> Dict[str, Any]:
    """The full state of :func:`init_state` (params, momentum, the rule's
    ``extra`` with any WireState, ``g_inf``) on ``torch.device("meta")``:
    every leaf at its shape and dtype, nothing allocated.  Built by
    ``init_state`` itself on a meta copy of ``model``, so the shapes cannot
    drift from a real state's (the reference's ``jax.eval_shape`` of
    ``init_state``)."""
    return init_state(dataclasses.replace(model, device="meta"), algo, hp,
                      n_workers)


# ---------------------------------------------------------------------------
# Logical -> PartitionSpec resolution
# ---------------------------------------------------------------------------

def abstract_params(model) -> PyTree:
    """``model.init``'s tree on ``meta``: shapes and dtypes only."""
    meta = dataclasses.replace(model, device="meta")
    return meta.init(meta.generator(0))


def params_pspecs(model, rules: ShardingRules, mesh_shape,
                  stacked: bool = True) -> PyTree:
    """Each parameter's resolved spec; ``stacked`` puts the worker dim in
    front, its size the product of the worker axes."""
    wn = n_workers_for(None, rules, mesh_shape)

    def resolve(names, leaf):
        sizes = list(leaf.shape)
        if stacked:
            names = ("worker",) + names
            sizes = [wn] + sizes
        return safe_pspec(sizes, rules.pspec(*names), mesh_shape)

    return resolve_tree(model.param_logical(), abstract_params(model),
                        resolve)


def batch_pspecs(batch: PyTree, rules: ShardingRules, mesh_shape,
                 stacked: bool = True) -> PyTree:
    def resolve(leaf):
        if stacked:
            names = ("worker", "batch") + (None,) * (leaf.dim() - 2)
        else:
            names = ("batch",) + (None,) * (leaf.dim() - 1)
        return safe_pspec(tuple(leaf.shape), rules.pspec(*names),
                          mesh_shape)
    return tree.map(resolve, batch)


def state_pspecs(model, algo: Algorithm, hp: AlgoHyper,
                 rules: ShardingRules, mesh_shape, n_workers: int) -> PyTree:
    """Specs of :func:`init_state`'s tree, the reference's: params and
    momentum as the stacked params; an ``extra`` leaf whose leading dim is
    ``n_workers`` (replicas, error buffers, the WireState residual, the
    stale carry) on the worker axes, the rest (and ``step``, ``g_inf``,
    ``gen``) replicated.

    Under a split of the weights over ``model`` or FSDP ``data`` the
    trainer holds every ``extra`` leaf that mirrors a params leaf
    (``Algorithm.mirrors``: Choco's and DCD's ``x_hat``, DeepSqueeze's
    ``err``, D²'s ``x_prev`` and ``g_prev``) in that leaf's cut, not
    whole over those axes as these specs place it: the layout XLA gives
    the reference's replicas after its first step (their params'), which
    the port holds from the start."""
    pp = params_pspecs(model, rules, mesh_shape, stacked=True)
    ab = abstract_state(model, algo, hp, n_workers)

    def extra_spec(leaf):
        if leaf.dim() >= 1 and leaf.shape[0] == n_workers:
            names = ("worker",) + (None,) * (leaf.dim() - 1)
            return safe_pspec(tuple(leaf.shape), rules.pspec(*names),
                              mesh_shape)
        return P()

    return {"params": pp, "mom": pp,
            "extra": tree.map(extra_spec, ab["extra"]),
            "step": P(), "g_inf": P(), "gen": P()}


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
        # the mean over every worker: under a worker split the per-worker
        # losses are gathered first, so it is one process's mean bit for bit
        metrics = {"loss": torch.mean(workers.gather_rows(losses)),
                   "alpha": alpha,
                   "theta": theta, "g_inf": g_inf,
                   "wire_bytes": algo.bytes_per_step(X, hp)}
        if isinstance(extra, dict) and "health" in extra:
            metrics.update({f"obs_{k}": v
                            for k, v in extra["health"].items()})
        return new_state, metrics

    return train_step
