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
dtype.  ``--only SUBSTR`` times only the cases whose key holds SUBSTR,
``--reps`` sets the timed runs of each.  ``--sass`` adds, for each flash
library of the checkout, each kernel instantiation's registers and spill
bytes (``-Xptxas -v``), its SASS instruction count and a count of each
opcode (``cuobjdump -sass``): what two checkouts' kernels differ by.
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
    ap.add_argument("--only", default="",
                    help="time only the cases whose key holds this")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed runs of each case")
    ap.add_argument("--sass", action="store_true",
                    help="add each flash kernel's registers and SASS "
                         "opcode counts")
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
        if args.only in key:
            kw = dict(scale=1.0 / math.sqrt(dh), causal=True, window=0)
            row[key] = timer(lambda: fn(q, k, v, **kw), reps=args.reps,
                             warmup=2)
        del q, k, v
    if args.sass:
        row["sass"] = sass_report()
    print(json.dumps(row))
    return 0


def sass_report() -> dict:
    """Per flash library of the imported checkout, per kernel (mangled
    name): ``[registers, spill-store bytes, instructions, instructions
    from the first tensor-core instruction to the last, {opcode:
    count}]``."""
    import collections
    import re
    import subprocess
    from chip_smoke import ptxas_kernels
    from repro_torch.kernels import build
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out = {}
    for lib in ("flash_attention_tc", "flash_attention_f32tc"):
        path = build.library_path(lib)
        regs = ptxas_kernels(path.with_suffix(".log").read_text())
        text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        for fn in text.split("Function : ")[1:]:
            name = fn.split("\n", 1)[0].strip()
            ops = collections.Counter(
                m.group(1).split(".")[0] for m in re.finditer(
                    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                    fn))
            # the key-tile loop: from the first tensor-core instruction
            # to the last
            lines = [m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                fn)]
            mma = [i for i, op in enumerate(lines) if op.startswith(
                ("HMMA", "HGMMA"))]
            r, spill = regs.get(name, (None, None))
            out[f"{lib}:{name}"] = [r, spill, sum(ops.values()),
                                    mma[-1] - mma[0] + 1 if mma else 0,
                                    dict(sorted(ops.items()))]
    return out


if __name__ == "__main__":
    sys.exit(main())
