"""SGD with momentum + weight decay (the paper's optimizer).

The decentralized algorithms (``core/algorithms.py``) consume a *direction*
``d`` and apply ``x <- gossip(x) - alpha d``; this module turns raw
gradients into that direction (heavy-ball momentum, weight decay) and tracks
``||g||_inf``, which the theory-mode theta schedule reads (Theorem 2); and
the step-size schedules (constant, the paper's step decay, cosine, and
Corollary 1's constant step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch import tree
from repro_torch.comm import tensor_parallel as TP
from repro_torch.comm import workers

PyTree = Any


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    momentum: float = 0.9
    weight_decay: float = 5e-4           # paper Sec. 6 hyper-parameters
    nesterov: bool = False


def init_momentum(params: PyTree) -> PyTree:
    return tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def direction(cfg: SGDConfig, grads: PyTree, params: PyTree,
              mom: PyTree) -> Tuple[PyTree, PyTree, torch.Tensor]:
    """Returns (direction, new momentum, ||g||_inf over the whole tree).

    The reference's float32 operations in its order, with one float32
    temporary a leaf besides the new momentum (``g + wd p`` formed in
    place on a float32 copy of ``p``; IEEE addition commutes): an LM's
    head and embedding are billions of values.  Under a worker split the
    norm is all-reduced over the ranks (a max: exact), and under a
    ``model`` or FSDP ``data`` split over the shards too, so that theta
    and B are the same on every rank."""
    flat_g, treedef = tree.flatten(grads)
    g_inf = torch.zeros((), dtype=torch.float32, device=flat_g[0].device)
    for g in flat_g:                  # |g| and its max are exact in g's dtype
        g_inf = torch.maximum(g_inf, torch.max(torch.abs(g)).float())
    g_inf = workers.all_max(g_inf)
    for axis in ("model", "data"):
        g_inf = TP.max_over(g_inf, axis)

    ds, ms = [], []
    for g, p, m in zip(flat_g, tree.leaves(params), tree.leaves(mom)):
        gf = p.to(torch.float32, copy=True).mul_(cfg.weight_decay).add_(g)
        mn = (cfg.momentum * m).add_(gf)
        ds.append((gf + cfg.momentum * mn) if cfg.nesterov else mn)
        ms.append(mn)
    return (tree.unflatten(treedef, ds), tree.unflatten(treedef, ms), g_inf)


# ---------------------------------------------------------------------------
# Step-size schedules, functions of the (host) step index.  All satisfy the
# paper's two-constant condition alpha_k / alpha_{k+t} <= C_alpha eta^t
# (Theorem 2).  They compute in double; the reference's jnp ones in float32,
# so the two agree to float32 rounding.
# ---------------------------------------------------------------------------

def constant(lr: float) -> Callable[[int], float]:
    return lambda k: lr


def step_decay(lr: float, boundaries, factor: float = 0.1
               ) -> Callable[[int], float]:
    """Paper Sec. 6: decay by ``factor`` at each of the given steps (epochs
    250 and 280 there)."""
    bs = tuple(boundaries)

    def f(k):
        mult = 1.0
        for b in bs:
            if k >= b:
                mult *= factor
        return lr * mult
    return f


def cosine(lr: float, total_steps: int, floor: float = 0.0
           ) -> Callable[[int], float]:
    """Cosine decay from ``lr`` at step 0 to ``floor`` at ``total_steps``
    (held there after)."""
    def f(k):
        t = min(max(k / max(total_steps, 1), 0.0), 1.0)
        return floor + 0.5 * (lr - floor) * (1.0 + math.cos(math.pi * t))
    return f


def theorem_lr(K: int, n: int, sigma: float = 1.0, zeta: float = 1.0,
               L: float = 2.0) -> float:
    """Corollary 1: alpha = 1 / (zeta^(2/3) K^(1/3) + sigma sqrt(K/n) + 2L)."""
    return 1.0 / (zeta ** (2 / 3) * K ** (1 / 3)
                  + sigma * math.sqrt(K / n) + 2 * L)
