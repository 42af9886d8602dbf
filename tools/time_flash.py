#!/usr/bin/env python3
"""Time the flash-attention kernels of a checkout on one GPU.

    python3 tools/time_flash.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
that checkout's kernels, and prints one JSON line: the device time of the
kernel that checkout's ``flash_attention`` routes each case to, causal,
in bfloat16 and float32, at ``chip_smoke.FLASH_MAIN`` (the bfloat16 case
with the llama3.2-3b prefill's 16 KV blocks, the float32 one with 48), at
head dim 64, at ``chip_smoke.FLASH_PHI`` (phi-3-vision-4.2b's attention,
head dim 96), at ``chip_smoke.FLASH_WIDE`` (head dim 256) and at
``chip_smoke.FLASH_PAD`` (head dim 80, padded to 96), with the card's name
and power limit.  Each key names the wrapper that ran (``tc``, ``f32tc``
or, in checkouts that still have it, the CUDA-core ``simt``) and the
dtype.
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
    from chip_smoke import (FLASH_MAIN, FLASH_PAD, FLASH_PHI, FLASH_WIDE,
                            GQA_MAIN, Timer, nvidia_smi)
    from repro_torch.kernels import flash_attention as kfa

    dev = torch.device("cuda", 0)
    timer = Timer(dev)
    gen = torch.Generator().manual_seed(0)
    bh, s, d = FLASH_MAIN
    # (dtype, query blocks, KV blocks, S, D)
    cases = [(torch.bfloat16, bh, bh // GQA_MAIN, s, d),
             (torch.bfloat16, bh, bh, s, 64),
             (torch.float32, bh, bh, s, d),
             (torch.float32, bh, bh, s, 64)]
    cases += [(dt, h, h, sl, dh) for h, sl, dh in (FLASH_PHI, FLASH_WIDE,
                                                   FLASH_PAD)
              for dt in (torch.bfloat16, torch.float32)]
    row = {"card": f"[{nvidia_smi()}]", "root": os.path.abspath(args.root)}
    for dtype, nq, nkv, sl, dh in cases:
        q, k, v = (torch.randn((n, sl, dh), generator=gen).to(dtype).to(dev)
                   for n in (nq, nkv, nkv))
        fn = kfa.route(q)
        name = fn.__name__.replace("flash_attention_", "")
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        key = f"{name}_{dt}_{nq}x{sl}x{dh}_kv{nkv}_ms"
        kw = dict(scale=1.0 / math.sqrt(dh), causal=True, window=0)
        row[key] = timer(lambda: fn(q, k, v, **kw), reps=20, warmup=2)
        del q, k, v
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
