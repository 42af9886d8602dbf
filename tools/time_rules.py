#!/usr/bin/env python3
"""Time the update rules' steps and their rounding draw on one CUDA GPU.

    python3 tools/time_rules.py [--root DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and
prints one JSON line:

* ``step_ms``: each rule of ``chip_smoke.py``'s phase 12 that runs no
  codec kernel (naive, choco, deepsqueeze, dcd, ecd, d2) through
  ``Trainer.run`` on phase 12's cell (ResNet-20 w16, 8 workers on a ring,
  8 bits, 128 images a worker, 10 steps): the host clock from step 0's
  end to step 9's over 9, as phase 12 prints it;
* ``step_launches``: the device kernels of one more step of each rule
  (``torch.profiler``);
* ``draw_ms`` and ``draw_launches``: one ``draw_uniforms`` of that
  ResNet-20 tree (8 x 272282 float32), the mean of 20 calls, card
  synchronised, and its device kernels; ``draw_big_ms``: one draw of a
  ``[2, 128256, 3072]`` leaf (llama3.2-3b's embedding on 2 workers), the
  mean of 3;

with the card's name and power limit.  No kernel of the checkout is
built.  To compare two checkouts, run both in one call on one card, in
turns: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = (("naive", {}), ("choco", dict(gamma=0.3)),
         ("deepsqueeze", dict(gamma=0.3)), ("dcd", {}), ("ecd", {}),
         ("d2", dict(slack=0.75)))
N_WORKERS, IMAGES, STEPS = 8, 128, 10


def device_launches(fn) -> int:
    """The device kernels ``fn()`` launches, by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def timed_ms(fn, reps: int) -> float:
    """Host clock of ``reps`` calls over ``reps``, card synchronised, after
    one call to warm."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default="", help="a name for the JSON line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_rules: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch import tree
    from repro_torch.core import algorithms as talg
    from repro_torch.data.synthetic import stacked_cifar_like
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    model = ResNetModel(depth=20, width=16, device="cuda")
    batches = [stacked_cifar_like(k, IMAGES, N_WORKERS, seed=0,
                                  device="cuda") for k in range(STEPS)]
    out = {"label": args.label, "root": os.path.abspath(args.root),
           "card": card, "step_ms": {}, "step_launches": {}}
    X = None
    for name, kw in RULES:
        tc = TrainerConfig(algo=name, topology="ring", n_workers=N_WORKERS,
                           bits=8, theta=2.0, lr=0.1, momentum=0.9,
                           weight_decay=5e-4, steps=STEPS, log_every=1,
                           seed=0, **kw)
        trainer = Trainer(model, tc, lambda k: batches[k])
        run = trainer.run()
        walls = [h["wall"] for h in run["history"]]
        out["step_ms"][name] = 1e3 * (walls[-1] - walls[0]) / (
            len(walls) - 1)
        state = run["state"]
        out["step_launches"][name] = device_launches(
            lambda: trainer.step_fn(state, batches[0]))
        X = tree.map(lambda a: a.detach().float().clone(), state["params"])
        del trainer, run, state
        torch.cuda.empty_cache()
    out["draw_ms"] = timed_ms(lambda: talg.draw_uniforms(X, 5), 20)
    out["draw_launches"] = device_launches(lambda: talg.draw_uniforms(X, 5))
    big = (torch.zeros((2, 128256, 3072), device="cuda"),)
    out["draw_big_ms"] = timed_ms(lambda: talg.draw_uniforms(big, 5), 3)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
