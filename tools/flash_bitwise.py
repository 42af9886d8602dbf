#!/usr/bin/env python3
"""Phase 7's flash sweep through a checkout's kernels, saved or compared.

    python3 tools/flash_bitwise.py [--root DIR] --out FILE
    python3 tools/flash_bitwise.py --compare A B

The first form imports ``repro_torch`` from ``DIR/src`` (default: this
checkout), builds that checkout's kernels, runs ``chip_smoke``'s phase 7
sweep (``chip_smoke.flash_sweep``) and the ``[48, 4096, 128]`` serving
shape (48 and 16 KV blocks) in float32 and bfloat16 through that
checkout's ``flash_attention`` with its defaults (no key offset, no
log-sum-exp: a checkout that has them runs ``k0 = 0`` without ``lse``),
on inputs drawn from one seeded CPU generator, and saves the outputs to
FILE (``torch.save``).  The second compares two such files case by case
and prints one JSON line: the cases, how many are bitwise equal, the
largest difference, the card's name and power limit.  To show that a
change leaves a kernel bit for bit as it was, run the parent's checkout
(``git archive <rev> | tar -x -C build/parent``) and this one in one call
on one card, then compare.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(root: str, out: str) -> int:
    sys.path.insert(0, HERE)                       # phase 7's cases
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    from chip_smoke import FLASH_MAIN, GQA_MAIN, flash_sweep
    from repro_torch.kernels import flash_attention as kfa

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    bh, s, d = FLASH_MAIN
    cases = flash_sweep() + [(True, s, s, 0, bh, bh, d),
                             (True, s, s, 0, bh, bh // GQA_MAIN, d)]
    outs = []
    for causal, sq, sk, window, nq, nkv, dh in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((nq, sq, dh), generator=gen).to(dtype).to(dev)
            k, v = (torch.randn((nkv, sk, dh), generator=gen).to(dtype)
                    .to(dev) for _ in range(2))
            o = kfa.flash_attention(q, k, v, scale=1.0 / math.sqrt(dh),
                                    causal=causal, window=window)
            outs.append(o.cpu())
    torch.cuda.synchronize()
    torch.save({"root": os.path.abspath(root), "outs": outs}, out)
    print(json.dumps({"root": os.path.abspath(root), "cases": len(outs),
                      "out": out}))
    return 0


def compare(a: str, b: str) -> int:
    sys.path.insert(0, HERE)
    from chip_smoke import nvidia_smi
    x, y = torch.load(a), torch.load(b)
    pairs = list(zip(x["outs"], y["outs"]))
    equal = sum(bool(torch.equal(p, q)) for p, q in pairs)
    worst = max(float((p.float() - q.float()).abs().max()) for p, q in pairs)
    print(json.dumps({"a": x["root"], "b": y["root"], "cases": len(pairs),
                      "bitwise_equal": equal, "max_abs_diff": worst,
                      "card": f"[{nvidia_smi()}]"}))
    return 0 if equal == len(pairs) == len(x["outs"]) == len(y["outs"]) \
        else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bitwise: no CUDA GPU", file=sys.stderr)
        return 2
    if args.compare:
        return compare(*args.compare)
    return run(args.root, args.out)


if __name__ == "__main__":
    sys.exit(main())
