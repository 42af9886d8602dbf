#!/usr/bin/env python3
"""Where a rank's memory goes in ``chip_smoke.py`` phase 27 (b), on one
CUDA GPU.

    python3 tools/fsdp_memory.py [--seq N]

Trains qwen2-72b at published widths, 1 layer, one worker, ``4 x N``
tokens a step (default 1024), for 3 steps through ``Trainer(mesh=,
rules=ShardingRules("hierarchical"))`` on ``(data=2, model=2)``: four
processes over a gloo group on the one card, as phase 27 does.  Each rank
records the CUDA allocator's history over the steps, replays its
``device_traces`` to the highest sum of allocations made in them, and
prints one JSON line: ``base_gib`` (allocated before the steps: the
params and momentum shards), ``peak_gib`` (``max_memory_allocated``), the
op at the peak, an out-of-memory error if one was raised, the losses,
and the blocks alive at the peak, summed by the first frame of
``repro_torch`` or ``chip_smoke.py`` that allocated them.
"""
from __future__ import annotations

import argparse
import collections
import datetime
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _where(frames) -> str:
    for f in frames:
        fn = f.get("filename", "")
        if "repro_torch" in fn or "chip_smoke" in fn:
            return f"{os.path.basename(fn)}:{f.get('line')}:{f.get('name')}"
    return "other"


def _peak_blocks(trace):
    """The index of the highest running sum of ``trace``'s allocations
    and the blocks alive there, by allocating frame."""
    cur = best = 0
    at = -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            cur += e["size"]
        elif e["action"] == "free_completed":
            cur -= e["size"]
        if cur > best:
            best, at = cur, i
    live = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], _where(e["frames"]))
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    size, count = collections.Counter(), collections.Counter()
    for n, w in live.values():
        size[w] += n
        count[w] += 1
    return at, [(w, n / 2 ** 30, count[w]) for w, n in size.most_common(25)]


def rank_main(rank: int, store: str, seq: int) -> None:
    import torch.distributed as dist
    import chip_smoke as CS
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model_factory import Model
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=600))
    tr = Trainer(Model(CS.fsdp_config(1), "cuda"), CS.fsdp_trainer_config(),
                 InputShape("lm_train", seq, 4, "train"),
                 mesh=make_host_mesh(data=2, model=2, device_type="cpu"),
                 rules=ShardingRules("hierarchical"))
    state = CS.in_turns(rank, tr.init_state)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=400000)
    err = losses = None
    try:
        losses = [h["loss"] for h in tr.run(state)["history"]]
    except torch.OutOfMemoryError as e:
        err = str(e)[:300]
    trace = torch.cuda.memory._snapshot()["device_traces"][0]
    torch.cuda.memory._record_memory_history(enabled=None)
    at, top = _peak_blocks(trace)
    print(json.dumps({
        "rank": rank, "base_gib": base / 2 ** 30,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "at": _where(trace[at]["frames"]) if at >= 0 else None,
        "error": err, "losses": losses, "live_at_peak": top}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if args.rank is not None:
        rank_main(args.rank, args.store, args.seq)
        return 0
    if not torch.cuda.is_available():
        print("tools/fsdp_memory.py needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build_all(force=True)
    store = os.path.join(ROOT, "build", "fsdp_memory_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r), "--store", store,
                               "--seq", str(args.seq)]) for r in range(4)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return 0 if rcs == [0] * 4 else 1


if __name__ == "__main__":
    sys.exit(main())
