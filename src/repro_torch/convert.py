"""Carry parameter trees between the JAX package and the port.

Any tree of arrays crosses the same way: parameters, and an update rule's
state ``extra`` (replicas ``x_hat``, error buffers, D^2's ``x_prev`` /
``g_prev`` and its 0-d ``alpha_prev``), the EF wires' WireState (float32
``residual [n, padded]``, 0-d int32 ``step``) and ``mix_stale``'s carry
(uint8 ``packed``, float32 ``ref``, 0-d ``B``, 0-d bool ``valid``), so
both packages can start from one state.

The two packages use the same tree: the same dict keys and nesting, conv
weights in HWIO, the same leaf shapes.  So a conversion is a leaf-wise copy
through numpy; nothing is transposed.  The JAX side is taken as numpy arrays
(``jax.tree.map(np.asarray, params)``), which keeps this module free of JAX.

bfloat16 leaves: numpy has no bfloat16, and JAX hands them over as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects.  They
cross as their raw 16-bit words (a ``uint16`` view), so the bits are kept.
The way back gives float32 numpy arrays for bfloat16 tensors (exact: every
bfloat16 is a float32); the JAX side casts them back with
``.astype(jnp.bfloat16)``, again exactly.

A trainer state also crosses between one process and a worker dim split
over ranks (``comm/workers.py``): ``shard_state`` cuts a rank's block out
of a whole state, ``gather_state`` puts the whole state back together from
every rank's block.  On a whole state a leaf is on the worker dim when its
leading dim is the worker count, the reference's ``state_pspecs`` rule; on
a block, which leaves are is a tree of bools beside it, read off the
resolved specs (``sharding.on_worker_dim``).

Under a ``model`` split as well (``comm/tensor_parallel.py``), and under
the hierarchical rules' FSDP ``data`` split (``comm/fsdp.py``), each rank
holds, of its block of workers, its shard of every split leaf of
``params`` and ``mom``: ``shard_state`` also cuts those by their split dims
(``tensor_parallel.AxisGroup``, from the params' specs),
``gather_state`` puts them back whole, and ``shard_params`` cuts a
carried-across params tree (serving's, or one worker's).
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
    return tree.map(lambda a: _from_numpy(np.array(a)).to(dev), params)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _n_workers(state) -> int:
    """The worker count of a trainer state: its params' leading dim."""
    return tree.leaves(state["params"])[0].shape[0]


def shard_params(params: PyTree, specs: PyTree, splits=()) -> PyTree:
    """This rank's shard of a params tree under ``splits``
    (``tensor_parallel.AxisGroup`` s: ``model``, FSDP ``data``): each leaf
    cut, and copied, on the dim its resolved spec in ``specs`` (a tree of
    the same shape: ``params_pspecs``, stacked or not) puts on each
    group's axis; the other leaves whole."""
    from repro_torch.comm import tensor_parallel as TP
    for g in splits:
        if g.size > 1:
            params = g.cut(params, TP.axis_dims(specs, g.axis))
    return params


def cut_subtrees(state: PyTree, mirrors=()) -> list:
    """``(container, key)`` of every subtree of a trainer state held in
    the params' cut under a split of the weights: ``params``, ``mom`` and
    the rule's mirrors of the params, the keys ``mirrors`` of its
    ``extra`` (``Algorithm.mirrors``)."""
    return ([(state, "params"), (state, "mom")]
            + [(state["extra"], k) for k in mirrors])


def shard_state(state: PyTree, rank: int, R: int, splits=(),
                mirrors=()) -> PyTree:
    """Block ``rank`` of ``R`` of a whole trainer state: every tensor leaf
    whose leading dim is the worker count ``n`` keeps rows ``[rank n/R,
    (rank + 1) n/R)``; the other leaves are shared, except a
    ``torch.Generator``, copied, so blocks cut in one process draw the same
    seeds as the whole state.  Under ``splits``
    (``tensor_parallel.AxisGroup`` s with the split dims of the stacked
    params) the leaves of ``params``, ``mom`` and the rule's mirrors of
    the params (``mirrors``, :func:`cut_subtrees`) are also cut to each
    group's shard."""
    n = _n_workers(state)
    if n % R:
        raise ValueError(f"{n} workers do not split into {R} blocks")
    b = n // R

    def leaf(a):
        if isinstance(a, torch.Generator):
            g = torch.Generator(device=a.device)
            g.set_state(a.get_state())
            return g
        if isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[0] == n:
            return a[rank * b:(rank + 1) * b]
        return a
    out = tree.map(leaf, state)
    for g in splits:
        if g.size > 1:
            for sub, key in cut_subtrees(out, mirrors):
                sub[key] = g.cut(sub[key])
    return out


def gather_state(state: PyTree, on_workers: PyTree,
                 mirrors=()) -> PyTree:
    """The whole trainer state from this rank's block of it: every leaf
    that ``on_workers`` marks is all-gathered over the worker split in
    force, in block order, and under a ``model`` or FSDP ``data`` split
    every shard of ``params``, ``mom`` and the rule's mirrors of the
    params (``mirrors``, :func:`cut_subtrees`) is gathered whole over it (an
    all-reduce of a zero-filled whole, exact).  A collective: every rank
    calls it.  The identity in one process."""
    from repro_torch.comm import tensor_parallel as TP
    from repro_torch.comm import workers
    out = tree.map(lambda a, w: workers.gather_rows(a) if w else a,
                   state, on_workers)
    for g in TP.groups():
        for sub, key in cut_subtrees(out, mirrors):
            dims = TP.leaf_dims(sub[key], g.axis)
            leaves, td = tree.flatten(sub[key])
            sub[key] = tree.unflatten(td, [
                a if d is None else TP.gather_dim(a, d, g.axis)
                for a, d in zip(leaves, dims)])
    return out


def to_numpy(params: PyTree) -> PyTree:
    """The port's tree of tensors -> a tree of numpy arrays (for
    ``jax.tree.map(jnp.asarray, ...)`` on the JAX side)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree.map(leaf, params)
