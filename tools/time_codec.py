#!/usr/bin/env python3
"""Time the Moniqua codec kernels of a checkout on one CUDA GPU.

    python3 tools/time_codec.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
that checkout's kernels, and prints one JSON line: the device time of its
encode and decode-reduce kernels at 8 bits (stochastic) and 1 bit (nearest)
on the ResNet-20 and ResNet-110 buckets (8 workers, float32), decode-reduce
on a ring (m=2) and, on ResNet-110's bucket, on exponential(8) (m=5), each
beside its byte bound, with the card's name and power limit; and the point
decode (remote) at an AD-PSGD exchange's ``[2, 272282]``, at ``[8, 272282]``
and at ResNet-110's ``[8, 1730522]``, 8 and 1 bit.  Timer, bounds and the
timed calls are ``chip_smoke.py``'s (``Timer``, ``codec_times``,
``decode_times``).
Beside them stand ``torch.clone`` of the float32 bucket, a streaming pass of
8 bytes an element, and ``floor_ms``, the timer's reading of a one-element
kernel, as yardsticks of what the timer shows at that size.  To compare two
checkouts, run both in one call on one card, in turns: parent, change,
change, parent.
"""
from __future__ import annotations

import argparse
import json
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
        print("time_codec: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)                       # chip_smoke's timer
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from chip_smoke import Timer, codec_times, decode_times, nvidia_smi
    from repro_torch import tree
    from repro_torch.comm.engine import CommEngine, MoniquaWire
    from repro_torch.core.quantizers import QuantSpec
    from repro_torch.core.topology import exponential, ring
    from repro_torch.models.resnet import init_resnet

    dev = torch.device("cuda", 0)
    card = f"[{nvidia_smi()}]"
    timer = Timer(dev)
    gen = torch.Generator().manual_seed(0)
    n = 8
    topos = {"ring": ring(n), "exponential": exponential(n)}
    rows, decode = [], []
    for depth in (20, 110):
        p = init_resnet(torch.Generator().manual_seed(1), depth=depth,
                        width=16)
        X = tree.map(lambda a: a[None] + 0.02 * torch.randn(
            (n,) + a.shape, generator=gen), p)
        for bits, stochastic in ((8, True), (1, False)):
            lay = CommEngine(topos["ring"], MoniquaWire(
                QuantSpec(bits, stochastic))).layout(X)
            flat = lay.flatten(X).reshape(n, 1, lay.padded_elems).to(dev)
            for tname in ("ring", "exponential") if depth == 110 else ("ring",):
                offsets = [o for o in topos[tname].offsets if o % n]
                times = codec_times(timer, dev, card, flat, bits, stochastic,
                                    f"ResNet-{depth} {tname}", offsets)
                row = dict(model=f"resnet{depth}", bits=bits, topology=tname,
                           m=len(offsets), shape=list(flat.shape))
                for name, (ms, bound) in times.items():
                    row[f"{name}_ms"], row[f"{name}_bound_ms"] = ms, bound
                rows.append(row)
            rows[-1]["clone_ms"] = timer(flat.clone)
            if bits == 8:
                # the point decode on the 8-bit layout's bucket, at both widths
                y = flat.reshape(n, -1)
                for b in (8, 1):
                    for y_cut in ((y[:2], y) if depth == 20 else (y,)):
                        ms, bound = decode_times(timer, dev, card, y_cut, b,
                                                 f"ResNet-{depth}")
                        decode.append(dict(model=f"resnet{depth}", bits=b,
                                           shape=list(y_cut.shape), ms=ms,
                                           bound_ms=bound))
            del flat
    one = torch.zeros(1, device=dev)
    print(json.dumps({"root": os.path.abspath(args.root), "card": card,
                      "floor_ms": timer(one.zero_), "times": rows,
                      "decode": decode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
