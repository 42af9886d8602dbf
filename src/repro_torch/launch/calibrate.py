"""Depth-probe roofline calibration on one card.

The counterpart of the reference's ``repro.launch.calibrate``.  There XLA's
``cost_analysis`` counts a ``while`` body exactly once, so a model whose
layer stack is a ``lax.scan`` reports one layer's cost, and calibration
lowers two unrolled shallow probes (1 and 2 layers) per (arch x shape) and
extrapolates

    cost(L) = c1 + (L - 1) * (c2 - c1)

which is exact for homogeneous stacks (embedding and head live in the
intercept).

The port has no scan whose body is counted once: it loops over its layers
in Python, and the dry run's counters (``launch/dryrun.py``) count every
layer.  So here calibration does not correct anything.  It writes the same
rows (``roofline_calibrated``, ``collectives_calibrated``, the probes) that
``benchmarks/roofline_table.py`` merges, from probes at depth 1 and 2
counted on ``meta``; and its extrapolation is a check of the dry run: for a
homogeneous stack it equals the direct count at full depth.  ``ssm`` and
``hybrid`` stacks are not homogeneous (sLSTM every fourth block; a shared
attention block), as in the reference, and stay ``not-scanned``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.calibrate --out calibrated.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Dict, Optional

from repro_torch.analysis import roofline as RL
from repro_torch.configs import assigned_archs, get_config
from repro_torch.configs.base import INPUT_SHAPES, get_input_shape
from repro_torch.launch import dryrun as DR
from repro_torch.models.model_factory import build_model

SCANNED_FAMILIES = ("dense", "moe", "vlm", "audio")


def _probe(arch: str, shape, depth: int, algo: str, bits: int,
           n_workers: Optional[int] = None, override: Optional[dict] = None):
    cfg = get_config(arch)
    if override:
        cfg = dataclasses.replace(cfg, **override)
    ov: Dict = dict(num_layers=depth, unroll_layers=True)
    if cfg.family == "audio":
        ov["encoder_layers"] = depth
    cfg = dataclasses.replace(cfg, **ov)
    model = build_model(cfg, device="meta")
    counts, _, _, stats, _ = DR.count_step(
        model, shape, DR.n_workers_for(cfg, n_workers), algo, bits)
    return counts.flops, counts.bytes_accessed, stats


def _extrapolate(c1: float, c2: float, L: int) -> float:
    return max(c1 + (L - 1) * (c2 - c1), 0.0)


def calibrate_one(arch: str, shape_name: str, *, algo: str = "moniqua",
                  bits: int = 8, n_workers: Optional[int] = None,
                  override: Optional[dict] = None) -> dict:
    """One (arch x shape) calibration row: ``skipped`` (the dry run's
    ``skip_reason``), ``not-scanned`` (ssm, hybrid), ``ok`` or ``error``.
    ``n_workers`` and ``override`` as in ``dryrun.dryrun_one``."""
    cfg = get_config(arch)
    if override:
        cfg = dataclasses.replace(cfg, **override)
    shape = get_input_shape(shape_name)
    if DR.skip_reason(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": DR.MESH,
                "status": "skipped"}
    if cfg.family not in SCANNED_FAMILIES:
        return {"arch": arch, "shape": shape_name, "mesh": DR.MESH,
                "status": "not-scanned"}
    t0 = time.time()
    try:
        f1, b1, s1 = _probe(arch, shape, 1, algo, bits, n_workers, override)
        f2, b2, s2 = _probe(arch, shape, 2, algo, bits, n_workers, override)
        L = cfg.num_layers
        flops = _extrapolate(f1, f2, L)
        nbytes = _extrapolate(b1, b2, L)
        coll_bytes: Dict[str, float] = {}
        coll_counts: Dict[str, float] = {}
        for op in set(s1.bytes_by_op) | set(s2.bytes_by_op):
            coll_bytes[op] = _extrapolate(s1.bytes_by_op.get(op, 0),
                                          s2.bytes_by_op.get(op, 0), L)
            coll_counts[op] = _extrapolate(s1.counts.get(op, 0),
                                           s2.counts.get(op, 0), L)
        roof = RL.roofline_from_counts(
            flops, nbytes, sum(coll_bytes.values()),
            RL.model_flops_for(cfg, shape))
        row = {
            "arch": arch, "shape": shape_name, "mesh": DR.MESH,
            "status": "ok", "seconds": time.time() - t0,
            "probe": {"L1": {"flops": f1, "bytes": b1},
                      "L2": {"flops": f2, "bytes": b2},
                      "num_layers": L},
            "roofline_calibrated": DR.roofline_row(roof),
            "collectives_calibrated": {"counts": coll_counts,
                                       "bytes": coll_bytes},
        }
        r = row["roofline_calibrated"]
        print(f"[{arch} x {shape_name}] calibrated in {row['seconds']:.0f}s "
              f"dominant={r['dominant']} compute={r['compute_s']*1e3:.2f}ms "
              f"memory={r['memory_s']*1e3:.2f}ms "
              f"collective={r['collective_s']*1e3:.2f}ms "
              f"useful={r['useful_ratio']:.3f} mfu<= {r['mfu_upper_bound']:.3f}")
        return row
    except Exception as e:  # noqa: BLE001
        print(f"[{arch} x {shape_name}] calibration FAIL: {e}")
        return {"arch": arch, "shape": shape_name, "mesh": DR.MESH,
                "status": "error",
                "error": f"{e}\n{traceback.format_exc(limit=10)}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--workers", type=int, default=None,
                    help="workers on the ring (default as the dry run's)")
    ap.add_argument("--algo", default="moniqua")
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else assigned_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    failures = 0
    for arch in archs:
        for shape in shapes:
            row = calibrate_one(arch, shape, algo=args.algo, bits=args.bits,
                                n_workers=args.workers)
            if row["status"] == "error":
                failures += 1
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    print(f"calibration complete; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
