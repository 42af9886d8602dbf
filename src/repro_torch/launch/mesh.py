"""Mesh factories, the counterpart of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group and no device.  Each factory builds a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's shape and
axis names over the ranks of the default process group, which the caller
initialises first (``torch.distributed.init_process_group``, or
``torchrun``); the mesh may not be larger than that group.  The device
type is ``"cuda"`` (NCCL) unless the caller asks for ``"cpu"`` (gloo).

``mesh_context(mesh, rules)`` is the ambient mesh of a training or serving
step: it installs the constraint context of ``models/sharding.py``, the
split of the decentralized worker dim over the mesh's worker axes
(``comm/workers.py``), so the gossip rounds run across the ranks, the
``model`` axis of the tensor-parallel weights
(``comm/tensor_parallel.py``) and the hierarchical rules' FSDP ``data``
axis (``comm/fsdp.py``).
"""
from __future__ import annotations

import contextlib


def _make_mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's target fleet: 16 x 16 = 256 ranks a pod, 2 pods
    multi-pod.  Axes: ``data`` (decentralized workers / FSDP), ``model``
    (tensor parallel), plus ``pod`` across pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_two_tier_mesh(inter: int = 8, intra: int = 4, model: int = 8,
                       device_type: str = "cuda"):
    """Two-tier gossip fleet: the worker dimension split into a fast
    ``intra`` axis and a slow ``inter`` axis.  Worker ``w = g * intra + j``:
    the intra index varies fastest, matching ``HierarchicalTopology``'s
    flat worker ordering and the engine's ``[n_inter, n_intra]`` staging
    view."""
    return _make_mesh((inter, intra, model), ("inter", "intra", "model"),
                      device_type)


def make_host_mesh(data: int = 4, model: int = 2, pod: int = 0,
                   device_type: str = "cuda"):
    """A small mesh, for tests and single-host runs."""
    if pod:
        return _make_mesh((pod, data, model), ("pod", "data", "model"),
                          device_type)
    return _make_mesh((data, model), ("data", "model"), device_type)


def mesh_shape_dict(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def mesh_context(mesh, rules, params=None):
    """Run the body on ``mesh`` under ``rules`` (a ``ShardingRules``):
    ``models.sharding.constrain`` resolves against the mesh, the stacked
    worker dim is split over ``rules.worker_axes``, this rank holding its
    block of workers (``comm.workers.WorkerGroup``), the ``model`` axis is
    installed (``comm.tensor_parallel.AxisGroup``): the Megatron
    operators all-reduce over it, and so is the rules' FSDP axis (the
    hierarchical rules' ``data``, ``comm/fsdp.py``): the layers gather
    their weights over it.  ``params``: the resolved specs
    of the stacked params tree, which leaves the gossip takes as shards of
    ``model`` and ``data`` (``Trainer`` passes them)."""
    from repro_torch.comm import tensor_parallel as tp
    from repro_torch.comm import workers
    from repro_torch.models import sharding
    with sharding.constraint_context(rules, mesh_shape_dict(mesh)), \
            workers.worker_context(workers.WorkerGroup.of(
                mesh, rules.worker_axes, rules.fsdp_axis)), \
            tp.axis_context(*split_groups(mesh, rules, params)):
        yield mesh


def split_groups(mesh, rules, specs=None):
    """The axes of ``mesh`` that split tensors under ``rules``: ``model``
    and the rules' FSDP axis (``comm.tensor_parallel.AxisGroup`` s, with
    the split dims of the resolved params ``specs`` if given)."""
    from repro_torch.comm import tensor_parallel as tp
    return (tp.AxisGroup.of(mesh, "model", specs),
            tp.AxisGroup.of(mesh, rules.fsdp_axis, specs))
