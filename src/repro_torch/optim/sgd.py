"""SGD with momentum + weight decay (the paper's optimizer).

The decentralized algorithms (``core/algorithms.py``) consume a *direction*
``d`` and apply ``x <- gossip(x) - alpha d``; this module turns raw
gradients into that direction (heavy-ball momentum, weight decay) and tracks
``||g||_inf``, which the theory-mode theta schedule reads (Theorem 2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch import tree

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
    """Returns (direction, new momentum, ||g||_inf over the whole tree)."""
    flat_g, treedef = tree.flatten(grads)
    g_inf = torch.zeros((), dtype=torch.float32, device=flat_g[0].device)
    for g in flat_g:
        g_inf = torch.maximum(g_inf, torch.max(torch.abs(g.float())))

    ds, ms = [], []
    for g, p, m in zip(flat_g, tree.leaves(params), tree.leaves(mom)):
        gf = g.float() + cfg.weight_decay * p.float()
        mn = cfg.momentum * m + gf
        ds.append((gf + cfg.momentum * mn) if cfg.nesterov else mn)
        ms.append(mn)
    return (tree.unflatten(treedef, ds), tree.unflatten(treedef, ms), g_inf)


def constant(lr: float) -> Callable[[int], float]:
    return lambda k: lr
