#!/usr/bin/env python3
"""Time the tensor-core flash-attention kernels of a checkout on one GPU.

    python3 tools/time_flash.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
that checkout's kernels, and prints one JSON line: the device time of its
bfloat16 (``flash_attention_tc``) and float32 (``flash_attention_f32tc``)
tensor-core kernels, causal, at ``chip_smoke.FLASH_MAIN`` (the bfloat16
one with the llama3.2-3b prefill's 16 KV blocks, the float32 one with 48),
at head dim 64 and at ``chip_smoke.FLASH_PHI`` (phi-3-vision-4.2b's
attention, head dim 96), with the card's name and power limit.  A head dim
that the checkout does not send to the tensor cores reads null.
Timer: ``chip_smoke.Timer``.  To compare two checkouts, run both in one
call on one card, in turns: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose src/repro_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_flash: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)                       # chip_smoke's timer
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from chip_smoke import FLASH_MAIN, FLASH_PHI, GQA_MAIN, Timer, nvidia_smi
    from repro_torch.kernels import flash_attention as kfa

    dev = torch.device("cuda", 0)
    timer = Timer(dev)
    gen = torch.Generator().manual_seed(0)
    bh, s, d = FLASH_MAIN
    # (kernel, dtype, query blocks, KV blocks, S, D)
    cases = [("tc", torch.bfloat16, bh, bh // GQA_MAIN, s, d),
             ("tc", torch.bfloat16, bh, bh, s, 64),
             ("tc", torch.bfloat16, FLASH_PHI[0], FLASH_PHI[0],
              *FLASH_PHI[1:]),
             ("f32tc", torch.float32, bh, bh, s, d),
             ("f32tc", torch.float32, bh, bh, s, 64),
             ("f32tc", torch.float32, FLASH_PHI[0], FLASH_PHI[0],
              *FLASH_PHI[1:])]
    row = {"card": f"[{nvidia_smi()}]", "root": os.path.abspath(args.root)}
    for name, dtype, nq, nkv, sl, dh in cases:
        key = f"{name}_{nq}x{sl}x{dh}_kv{nkv}_ms"
        if dh not in kfa.TC_HEAD_DIMS:
            row[key] = None
            continue
        q, k, v = (torch.randn((n, sl, dh), generator=gen).to(dtype).to(dev)
                   for n in (nq, nkv, nkv))
        fn = getattr(kfa, f"flash_attention_{name}")
        kw = dict(scale=1.0 / math.sqrt(dh), causal=True, window=0)
        row[key] = timer(lambda: fn(q, k, v, **kw), reps=20, warmup=2)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
