#!/usr/bin/env python3
"""Measure the card's mma.sync rate, TF32 and bfloat16, on one GPU.

    python3 tools/mma_rate.py

Builds ``tools/mma_rate.cu`` with the float32 flash kernel's flags into
``build/kernels/`` and times its loop of independent ``mma.sync``
accumulators: m16n8k8 TF32 (the float32 flash kernel's instruction,
``csrc/flash_attention_f32tc.cu``) and m16n8k16 bfloat16.  With the rate,
the float32 kernel's 3xTF32 work at ``chip_smoke.FLASH_MAIN`` (and at
``chip_smoke.FLASH_PHI``, head dim 96) has a bound that this instruction
can reach, beside the data sheet's TF32 peak, which only ``wgmma``
reaches.  Prints one JSON line with the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tflops(fn, tf32: bool, dev) -> float:
    """TFLOP/s of mma.sync with 8 warps an SM, 8 chains a warp."""
    blocks = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    threads, iters = 128, 8192
    out = torch.empty(blocks * threads, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    best = math.inf
    for reps in (16, iters, iters, iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = fn(int(tf32), ctypes.c_void_p(out.data_ptr()), blocks, threads,
                 reps, stream)
        end.record()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"mma_rate launch failed: cudaError_t {err}")
        if reps == iters:
            best = min(best, start.elapsed_time(end))
    flops = (2048 if tf32 else 4096) * 8 * iters * blocks * threads // 32
    return flops / best / 1e9


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from chip_smoke import (FLASH_MAIN, FLASH_PHI, TF32_OPS_PER_S,
                            causal_pairs, nvidia_smi)
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = build.BUILD_DIR / "libmma_rate.so"
    run = subprocess.run([build._nvcc(), *build.FLAGS["flash_attention_f32tc"],
                          "-o", str(lib),
                          os.path.join(HERE, "tools", "mma_rate.cu")],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed on mma_rate.cu:\n{run.stdout}"
                           f"{run.stderr}")
    fn = ctypes.CDLL(str(lib)).mma_rate
    fn.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    rate = {"tf32": tflops(fn, True, dev), "bf16": tflops(fn, False, dev)}
    row = {"card": f"[{nvidia_smi()}]", "mma_sync_tflops": rate}
    for key, (bh, s, d) in (("f32tc", FLASH_MAIN), ("f32tc_d96", FLASH_PHI)):
        flops = 4 * d * bh * causal_pairs(s)
        row.update({f"{key}_shape": [bh, s, d],
                    f"{key}_bound_ms_at_mma_sync":
                        3 * flops / rate["tf32"] / 1e9,
                    f"{key}_bound_ms_at_peak":
                        1e3 * 3 * flops / TF32_OPS_PER_S})
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
