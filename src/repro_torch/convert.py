"""Carry parameter trees between the JAX package and the port.

The two packages use the same tree: the same dict keys and nesting, conv
weights in HWIO, the same leaf shapes.  So a conversion is a leaf-wise copy
through numpy; nothing is transposed.  The JAX side is taken as numpy arrays
(``jax.tree.map(np.asarray, params)``), which keeps this module free of JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device

PyTree = Any


def to_torch(params: PyTree, device="cuda") -> PyTree:
    """A tree of numpy arrays (or array-likes) -> the port's tree of tensors
    on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return tree.map(lambda a: torch.from_numpy(np.array(a)).to(dev), params)


def to_numpy(params: PyTree) -> PyTree:
    """The port's tree of tensors -> a tree of numpy arrays (for
    ``jax.tree.map(jnp.asarray, ...)`` on the JAX side)."""
    return tree.map(lambda t: t.detach().cpu().numpy(), params)
