#!/usr/bin/env python3
"""Count the kernels torch.profiler records in a profiled gossip round, with
and without ``chip_smoke.py``'s priming, on one CUDA GPU.

    python3 tools/profiler_gaps.py [--tries N]

Profiles N per-leaf ``moniqua`` 8-bit rounds (telemetry on and off) of the
ResNet-20 bucket on ring(8), the round whose launches phase 20 counts, in
two windows each: ``plain`` (the round right after the profiler starts) and
``primed`` (``chip_smoke.traced``: ``PROFILER_PRIME`` spin kernels first,
left out of the count).  A round launches the same kernels every time, so
a window that records fewer than the longest one lost some: it prints each
short window with where its gaps fall in the longest window's kernel
sequence, and how many priming kernels each primed window lost, then one
JSON line with the short windows per variant and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import difflib
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tries", type=int, default=25,
                    help="profiled rounds per variant and telemetry setting")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_gaps: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch import tree
    from repro_torch.comm.engine import CommEngine, MoniquaWire
    from repro_torch.core.quantizers import QuantSpec
    from repro_torch.core.topology import ring
    from repro_torch.models.resnet import init_resnet

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    p0 = init_resnet(torch.Generator().manual_seed(1), depth=20, width=16)
    X = tree.map(lambda a: (a[None] + 0.02 * torch.randn(
        (cs.N_WORKERS,) + a.shape, generator=gen)).to(dev), p0)

    def plain(fn):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return prof

    def kernels(prof):
        ev = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.name.startswith(cs.ANNOTATIONS)
                     and cs.SPIN_KERNEL not in e.name),
                    key=lambda e: e.time_range.start)
        return [e.name for e in ev]

    short = {}
    for tel in (True, False):
        eng = CommEngine(ring(cs.N_WORKERS), MoniquaWire(QuantSpec(8)),
                         path="per_leaf", telemetry=tel)
        eng.mix(X, theta=2.0, seed=1)
        torch.cuda.synchronize()
        for variant, run in (("plain", plain), ("primed", cs.traced)):
            seqs, lost = [], []
            for _ in range(args.tries):
                torch.cuda.synchronize()
                prof = run(lambda: eng.mix(X, theta=2.0, seed=1))
                seqs.append(kernels(prof))
                lost.append(cs.primer_lost(prof) if run is cs.traced
                            else None)
            full = max(seqs, key=len)
            tag = f"{variant} telemetry={tel}"
            short[tag] = 0
            for i, sq in enumerate(seqs):
                if len(sq) == len(full):
                    continue
                short[tag] += 1
                gaps = [(i1, i2) for op, i1, i2, _, _ in difflib.SequenceMatcher(
                    a=full, b=sq, autojunk=False).get_opcodes()
                    if op != "equal"]
                print(f"  {tag} try {i}: {len(sq)} of {len(full)} kernels; "
                      f"missing positions {gaps}", flush=True)
            print(f"{tag}: {short[tag]} of {args.tries} windows short "
                  f"(round of {len(full)} kernels)"
                  + ("" if lost[0] is None else
                     f"; priming kernels lost a window {lost}"), flush=True)
    print(json.dumps({"tries": args.tries, "prime": cs.PROFILER_PRIME,
                      "short_windows": short, "card": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
