"""Ranks of ``tests/test_torch_moe_split.py``: one MoE layer split over
``model`` and ``data``, in gloo processes.

``python tests/torch_moe_split_cases.py STORE RANK WORLD INPUTS OUT``: the
process joins a gloo group through the ``FileStore`` at STORE, lays it out
as the mesh ``WORLDS[WORLD]`` under ``ShardingRules("hierarchical")``,
reads the layer's params, its input ``x [B, S, d]`` and a cotangent ``r``
from the ``.npz`` at INPUTS, and runs ``models.moe.moe_layer`` on its
shards: the router and the experts' ``d_model`` over ``data``, each
expert's ``d_ff`` over ``model``, its ``data`` rows of ``x``.  It records
its rows' routing (``route``'s outputs on its rows), ``y`` and the aux,
and the gradients of ``sum(y * r) + aux`` by ``torch.func.grad``; checks
in the ranks that the router's gradient and the routing are bitwise the
same on every ``model`` rank; gathers every result whole and, on rank 0,
writes the arrays to ``OUT + ".npz"`` and the checks to ``OUT +
".json"``.  Only the port is imported, one CPU thread a process.
"""
from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np
import torch

E, K, CF, G = 4, 2, 1.25, 64       # experts, top-k, capacity factor, group
D_MODEL, D_FF = 64, 128
B, S = 4, 128                      # rows, tokens a row: two groups a row
# world -> (ranks, mesh shape)
WORLDS = {"d2m2": (4, dict(data=2, model=2)),
          "m4": (4, dict(data=1, model=4)),
          "d4": (4, dict(data=4, model=1))}
# each expert leaf's dims over data and over model (the reference's
# moe_pspecs: the expert dim whole)
SPLIT = {"router": (0, None), "w_up": (1, 2), "w_gate": (1, 2),
         "w_down": (2, 1)}


def moe_cfg():
    from repro_torch.configs.base import MoEConfig
    return MoEConfig(num_experts=E, top_k=K, capacity_factor=CF,
                     group_size=G)


def run(rank: int, world: str, inputs: str) -> dict:
    from repro_torch.comm import fsdp
    from repro_torch.comm import tensor_parallel as TP
    from repro_torch.launch.mesh import make_host_mesh, mesh_context
    from repro_torch.models import moe as M
    from repro_torch.models.sharding import ShardingRules
    _, shape = WORLDS[world]
    mesh = make_host_mesh(data=shape["data"], model=shape["model"],
                          device_type="cpu")
    inp = dict(np.load(inputs))
    p = {k: torch.from_numpy(inp[k]) for k in SPLIT}
    x, r = torch.from_numpy(inp["x"]), torch.from_numpy(inp["r"])
    out, checks = {}, {}
    with mesh_context(mesh, ShardingRules("hierarchical")):
        dg, mg = TP.current(fsdp.AXIS), TP.current("model")
        rd, nd = (dg.rank, dg.size) if dg else (0, 1)
        rm, nm = (mg.rank, mg.size) if mg else (0, 1)
        mine = {k: TP.shard(TP.shard(a, SPLIT[k][0], rd, nd), SPLIT[k][1],
                            rm, nm).contiguous() for k, a in p.items()}
        lo, hi = fsdp.rows(B)
        xr, rr = x[lo:hi], r[lo:hi]
        route = M.route(mine, xr.reshape(-1, G, D_MODEL), moe_cfg())
        y, aux = M.moe_layer(mine, xr, moe_cfg(), True)

        def loss(q):
            y, aux = M.moe_layer(q, xr, moe_cfg(), True)
            return TP.reduce_sum((y * rr).sum(), fsdp.AXIS) + aux
        grads = torch.func.grad(loss)(mine)

        def whole_rows(t, dim=0):
            return TP.gather_dim(t.contiguous(), dim, fsdp.AXIS)
        for name, t in zip(("topg", "topi", "dispatch", "combine"), route):
            out[f"route/{name}"] = whole_rows(t)
        out["y"] = whole_rows(y)
        out["aux"] = aux
        for k, g in grads.items():
            dd, md = SPLIT[k]
            if md is not None:
                g = TP.gather_dim(g.contiguous(), md, "model")
            out[f"grad/{k}"] = TP.gather_dim(g.contiguous(), dd, fsdp.AXIS)

        def same_over_model(t):
            every = TP.gather_dim(t.reshape(1, -1).float(), 0, "model")
            return bool((every == every[:1]).all())
        checks["router grad equal over model"] = same_over_model(
            grads["router"])
        checks["routing equal over model"] = all(
            same_over_model(t) for t in route[:4])
        checks["aux equal over every rank"] = same_over_model(aux) and bool(
            (TP.gather_dim(aux.reshape(1), 0, fsdp.AXIS) == aux).all())
    return {k: v.detach().numpy() for k, v in out.items()}, checks


def main(argv) -> int:
    store_path, rank, world, inputs, out = (argv[1], int(argv[2]), argv[3],
                                            argv[4], argv[5])
    torch.set_num_threads(1)
    import torch.distributed as dist
    n = WORLDS[world][0]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=120))
    try:
        arrays, checks = run(rank, world, inputs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(out + ".npz", **arrays)
        with open(out + ".json", "w") as f:
            json.dump(checks, f)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    sys.exit(main(sys.argv))
