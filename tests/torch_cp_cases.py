"""Cases of ``tests/test_torch_context_parallel.py``, run in gloo ranks.

``python tests/torch_cp_cases.py STORE RANK WORLD OUT``: the process joins
a gloo group of WORLD ranks through the ``FileStore`` at STORE, installs
them as the ``model`` axis, and runs context-parallel attention
(``models.layers._context_parallel_kv``: whole Q, K and V through
``copy_to``, this rank's share of the keys through ``ops.flash_sdpa`` at
its key offset with ``lse``, then ``tensor_parallel.merge_attention``)
under ``torch.func.vmap(torch.func.grad)`` over two workers, against the
whole attention's output, log-sum-exp and gradients in this process.
Rank 0 writes ``{case: [ok, detail]}`` to ``OUT + ".json"``.  Only the
port is imported, one CPU thread a process.
"""
from __future__ import annotations

import datetime
import json
import math
import sys
import traceback

import torch

# (query heads, KV heads, window): none of 2, 3, 4 divides 5 heads
CASES = {"causal": (5, 5, 0), "grouped": (5, 1, 0), "window": (5, 1, 5)}
N, B, S, D = 2, 2, 12, 16       # workers, rows, tokens (2, 3, 4 divide 12)
# one process's autograd against the split's gradients, as the
# tensor-parallel operators' case: this share of each largest entry
GRAD_RTOL = 1e-5
OUT_ATOL = 1e-6


def inputs(hq, hkv):
    g = torch.Generator().manual_seed(7)
    q = torch.randn(N, B, S, hq, D, generator=g)
    k = torch.randn(N, B, S, hkv, D, generator=g)
    v = torch.randn(N, B, S, hkv, D, generator=g)
    go = torch.randn(N, B, S, hq, D, generator=g)
    gl = torch.randn(N, B, hq, S, generator=g)
    return q, k, v, go, gl


def run_case(hq, hkv, window):
    from repro_torch.comm import tensor_parallel as TP
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    scale = 1.0 / math.sqrt(D)
    q, k, v, go, gl = inputs(hq, hkv)

    def whole(q, k, v, go, gl):
        o, lse = ops.flash_sdpa(q, k, v, scale=scale, window=window,
                                lse=True)
        return (o * go).sum() + (lse * gl).sum(), (o, lse)

    def split(q, k, v, go, gl):
        q, k, v, k0 = L._context_parallel_kv(q, k, v, hq)
        o, lse = ops.flash_sdpa(q, k, v, scale=scale, window=window, k0=k0,
                                lse=True)
        o, lse = TP.merge_attention(o, lse.transpose(-1, -2), "model")
        lse = lse.transpose(-1, -2)
        return (o * go).sum() + (lse * gl).sum(), (o, lse)

    grad = torch.func.vmap(torch.func.grad(whole, argnums=(0, 1, 2),
                                           has_aux=True))
    want, (o_w, l_w) = grad(q, k, v, go, gl)
    got, (o_s, l_s) = torch.func.vmap(torch.func.grad(
        split, argnums=(0, 1, 2), has_aux=True))(q, k, v, go, gl)
    gaps = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]
    out_gap = max(float((o_s - o_w).abs().max()),
                  float((l_s - l_w).abs().max()))
    # every rank holds the same merged output and whole gradients
    flat = torch.cat([t.reshape(-1) for t in (o_s, l_s) + tuple(got)])
    every = TP.gather_dim(flat[None], 0, "model")
    same = bool((every == every[:1]).all())
    ok = max(gaps) <= GRAD_RTOL and out_gap <= OUT_ATOL and same
    return ok, (f"gradient gaps {gaps}, output gap {out_gap}, bitwise "
                f"equal over model: {same}")


def main(argv) -> int:
    store_path, rank, world, out = argv[1], int(argv[2]), int(argv[3]), \
        argv[4]
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.comm import tensor_parallel as TP
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    checks = {}
    try:
        with TP.axis_context(TP.AxisGroup("model", rank=rank, size=world,
                                          group=dist.group.WORLD)):
            for name, (hq, hkv, window) in CASES.items():
                try:
                    checks[name] = list(run_case(hq, hkv, window))
                except Exception:             # reported per case
                    checks[name] = [False, traceback.format_exc()[-3000:]]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out + ".json", "w") as f:
            json.dump(checks, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
