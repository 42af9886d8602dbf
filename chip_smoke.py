#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Moniqua on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no card -> exit 2.  TF32 is off for matmul and cuDNN.
2. Build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a, in parallel), then hold each kernel against its plain PyTorch
   version with ``torch.equal``: encode over bits 1/2/4/8 x stochastic and
   nearest x idx_base != 0 x a ragged row x float32 and bfloat16;
   decode-reduce over ring(8), exponential(8) and torus(3, 3) x 1/2/4/8 bits
   x float32 and bfloat16; both at the main path's shapes too.
3. One gossip round on the full ResNet-20 bucket (n=8, 272,282 elements per
   worker): the mix on the card equals the CPU plain-version mix bit for bit.
4. The main path through ``Trainer.run``: ResNet-20 at width 16, 8 workers
   on a ring, 128 images per worker, lr 0.1, momentum 0.9, weight decay
   5e-4, theta 2.0, 10 steps each of moniqua 8-bit (stochastic), moniqua
   1-bit (nearest, with Theorem 3's slack) and dpsgd; launch counts, bytes
   per step, finite and falling losses.
5. Times on the card (CUDA events, 100 reps after warm-up, L2 flushed and
   the card held by a spin kernel before each rep): each kernel and its
   plain version at the main path's shapes, beside the least time the card
   could take; the step time of each run.
6. A torch.profiler trace of three 8-bit main-path steps: device busy share,
   launches, and device time by kernel group and by kernel.

The second-to-last lines are the kernels' JSON summary and the nvidia-smi
line; the last line is the device contract JSON.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
N_WORKERS, IMAGES, STEPS = 8, 128, 10
# Theorem 3's slack matrix for the 1-bit run: W_bar = s W + (1 - s) I.  At
# theta 2.0 one 1-bit lattice cell is B/2 = 4 wide and has an edge at 0,
# where most of a fresh ResNet's weights sit; every code that flips there
# moves a weight by a gossip weight times 4, and without slack the loss
# climbs, in the JAX reference too (tests/test_torch_resnet.py,
# test_one_bit_without_slack_diverges_like_the_reference).  The slack damps
# each such move by s.
SLACK_1BIT = 0.02
# float32 operations per element, counted from the kernels' code
ENCODE_OPS = 11                # div add floor sub add mul sub add floor max min


def decode_reduce_ops(m: int) -> int:
    """self: value (4) + cmod (5) + 2; each neighbor: value (4) + sub +
    cmod (5) + add + sub + mul + add; then one add."""
    return 11 + 14 * m + 1


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: int, ops: int) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


class Timer:
    """Mean device time of ``fn`` over ``reps`` runs after warm-up, taken
    with CUDA events.  Before each rep a 128 MiB write flushes the 50 MB L2
    (the round's buffers are written by other kernels before the codec
    reads them), then a spin kernel of ~1 ms holds the card while the host
    enqueues the start event, ``fn``'s launches and the end event, so the
    events time the device work and not the host's launch latency."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, device):
        self.flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                 device=device)

    def __call__(self, fn, reps: int = 100, warmup: int = 5) -> float:
        for _ in range(warmup):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in ev:
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / reps


def host_ms(fn, reps: int = 20) -> float:
    """Mean wall time of ``fn`` on the host clock, the card synchronised
    before and after: what a caller waits for, launch overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import tree
    from repro_torch.comm.engine import (CommEngine, FullPrecisionWire,
                                         MoniquaWire)
    from repro_torch.core import modulo
    from repro_torch.core.quantizers import QuantSpec, delta_for_bits
    from repro_torch.core.topology import exponential, ring, torus
    from repro_torch.data.synthetic import stacked_cifar_like
    from repro_torch.kernels import build
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc
    from repro_torch.models.resnet import ResNetModel, init_resnet
    from repro_torch.train.trainer import Trainer, TrainerConfig

    # -- 1. device ---------------------------------------------------------
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    card = f"[{smi}]"
    print(f"device: {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()} | "
          f"TF32 off (matmul and cuDNN)", flush=True)

    # -- 2. build, then each kernel against its plain version --------------
    t0 = time.perf_counter()
    libs = build.build_all(force=True)
    print(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s "
          f"into {build.BUILD_DIR}", flush=True)
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    def B_for(bits, stochastic, device):
        if bits == 1 and stochastic:         # delta = 1/2: no B_theta
            return torch.tensor(0.7, device=device)
        return modulo.b_theta(2.0, delta_for_bits(bits, stochastic), device)

    n_checks = 0
    shape = (3, 5, 1003)                     # 1003: no vpb divides the row
    for dtype in (torch.float32, torch.bfloat16):
        x_cpu = rand(*shape, scale=3.0).to(dtype)
        x = x_cpu.to(dev)
        for bits in (1, 2, 4, 8):
            for stochastic in (True, False):
                kw = dict(bits=bits, stochastic=stochastic, idx_base=12345)
                got = kenc.encode(x, B_for(bits, stochastic, dev), 0xC0FFEE,
                                  **kw)
                plain = kenc.encode_plain(x, B_for(bits, stochastic, dev),
                                          0xC0FFEE, **kw)
                cpu = kenc.encode_plain(x_cpu, B_for(bits, stochastic, "cpu"),
                                        0xC0FFEE, **kw)
                what = f"encode {dtype} bits={bits} stochastic={stochastic}"
                check(torch.equal(got, plain), what + " != plain (card)")
                check(torch.equal(got.cpu(), cpu), what + " != plain (CPU)")
                n_checks += 1
    topos = [ring(8), exponential(8), torus(3, 3)]
    for topo in topos:
        weights = tuple(w for o, w in zip(topo.offsets, topo.weights)
                        if o % topo.n)
        m = len(weights)
        for dtype in (torch.float32, torch.bfloat16):
            y_cpu = rand(topo.n, 3, 1003, scale=4.0).to(dtype)
            y = y_cpu.to(dev)
            for bits in (1, 2, 4, 8):
                pc = -(-1003 // (8 // bits))
                ps_cpu = torch.randint(0, 256, (topo.n, 3, pc), generator=gen,
                                       dtype=torch.uint8)
                pn_cpu = torch.randint(0, 256, (m, topo.n, 3, pc),
                                       generator=gen, dtype=torch.uint8)
                ps, pn = ps_cpu.to(dev), pn_cpu.to(dev)
                B = B_for(bits, bits > 1, dev)
                got = kdr.decode_reduce(ps, pn, y, B, bits=bits,
                                        weights=weights)
                plain = kdr.decode_reduce_plain(ps, pn, y, B, bits=bits,
                                                weights=weights)
                cpu = kdr.decode_reduce_plain(
                    ps_cpu, pn_cpu, y_cpu, B_for(bits, bits > 1, "cpu"),
                    bits=bits, weights=weights)
                what = (f"decode_reduce {topo.name}({topo.n}) m={m} {dtype} "
                        f"bits={bits}")
                check(torch.equal(got, plain), what + " != plain (card)")
                check(torch.equal(got.cpu(), cpu), what + " != plain (CPU)")
                n_checks += 1
    torch.cuda.synchronize()
    print(f"phase 2: {n_checks} kernel sweeps equal their plain versions "
          f"(card and CPU), torch.equal", flush=True)

    # -- 3. one gossip round on the full ResNet-20 bucket ------------------
    p0 = init_resnet(torch.Generator().manual_seed(1), depth=20, width=16)
    X_cpu = tree.map(lambda a: a[None] + 0.02 * torch.randn(
        (N_WORKERS,) + a.shape, generator=gen), p0)
    X = tree.map(lambda a: a.to(dev), X_cpu)
    topo = ring(N_WORKERS)
    for bits, stochastic in ((8, True), (1, False), (4, True), (2, True)):
        eng = CommEngine(topo, MoniquaWire(QuantSpec(bits, stochastic)))
        got = eng.mix(X, theta=2.0, seed=7).x
        cpu = eng.mix(X_cpu, theta=2.0, seed=7).x
        ok = all(torch.equal(a.cpu(), b) for a, b in
                 zip(tree.leaves(got), tree.leaves(cpu)))
        check(ok, f"ResNet-20 bucket mix bits={bits} card != CPU")
    eng = CommEngine(topo, FullPrecisionWire())
    ok = all(torch.equal(a.cpu(), b) for a, b in
             zip(tree.leaves(eng.mix(X).x), tree.leaves(eng.mix(X_cpu).x)))
    check(ok, "ResNet-20 bucket full-wire mix card != CPU")
    layout = CommEngine(topo, MoniquaWire(QuantSpec(8))).layout(X)
    print(f"phase 3: ResNet-20 bucket ({layout.num_leaves} leaves, "
          f"{layout.total_elems} elements/worker, n={N_WORKERS}) mix on the "
          f"card == CPU mix, bitwise, moniqua 8/1/4/2-bit and full",
          flush=True)
    timer = Timer(dev)
    eng8 = CommEngine(topo, MoniquaWire(QuantSpec(8)))
    mix_ms = host_ms(lambda: eng8.mix(X, theta=2.0, seed=7))
    print(f"time: one bucketed moniqua-8bit mix of the ResNet-20 bucket "
          f"(flatten, encode, 2 rolls, decode-reduce, unflatten), host "
          f"clock {mix_ms:.4f} ms {card}", flush=True)

    # -- 4. the main path through Trainer.run ------------------------------
    model = ResNetModel(depth=20, width=16, device="cuda")
    batches = [stacked_cifar_like(k, IMAGES, N_WORKERS, seed=0,
                                  device="cuda") for k in range(STEPS)]
    runs = [("moniqua-8bit", dict(algo="moniqua", bits=8), 544564),
            ("moniqua-1bit", dict(algo="moniqua", bits=1, slack=SLACK_1BIT),
             68168),
            ("dpsgd", dict(algo="dpsgd"), 2178256)]
    step_ms = {}
    main_launches = {}
    for name, kw, want_bytes in runs:
        tc = TrainerConfig(topology="ring", n_workers=N_WORKERS, theta=2.0,
                           lr=0.1, momentum=0.9, weight_decay=5e-4,
                           steps=STEPS, log_every=1, seed=0, **kw)
        trainer = Trainer(model, tc, lambda k: batches[k])
        kenc.encode.launches = 0
        kdr.decode_reduce.launches = 0
        out = trainer.run()
        torch.cuda.synchronize()
        launches = {"moniqua_encode": kenc.encode.launches,
                    "moniqua_decode_reduce": kdr.decode_reduce.launches}
        losses = [h["loss"] for h in out["history"]]
        walls = [h["wall"] for h in out["history"]]
        step_ms[name] = 1e3 * (walls[-1] - walls[0]) / (len(walls) - 1)
        print(f"run {name}: losses {[round(v, 4) for v in losses]} | "
              f"launches {launches} | bytes/step {out['bytes_per_step']}",
              flush=True)
        n_moniqua = STEPS if kw["algo"] == "moniqua" else 0
        check(all(v == n_moniqua for v in launches.values()),
              f"{name}: launches {launches}, want {n_moniqua} each")
        check(all(map(math.isfinite, losses)), f"{name}: non-finite loss")
        check(losses[-1] < losses[0], f"{name}: loss did not fall")
        check(out["bytes_per_step"] == want_bytes,
              f"{name}: bytes/step {out['bytes_per_step']} != {want_bytes}")
        if name == "moniqua-8bit":
            main_launches = launches
            main_run = (trainer.step_fn, out["state"])
    print("phase 4: main path ran through both kernels, one launch each per "
          "Moniqua step", flush=True)

    # -- 5. kernel times at the main path's shapes -------------------------
    D = layout.padded_elems                 # 272,282 at 8 bits
    flat = layout.flatten(X).reshape(N_WORKERS, 1, D)
    B8 = modulo.b_theta(2.0, delta_for_bits(8, True), dev)
    w_ring = (1.0 / 3.0, 1.0 / 3.0)
    p_self = kenc.encode(flat, B8, 7, bits=8, stochastic=True)
    p_nbrs = torch.stack([torch.roll(p_self, -o, 0) for o in (-1, 1)])
    enc_plain = kenc.encode_plain(flat, B8, 7, bits=8, stochastic=True)
    dr = kdr.decode_reduce(p_self, p_nbrs, flat, B8, bits=8, weights=w_ring)
    dr_plain = kdr.decode_reduce_plain(p_self, p_nbrs, flat, B8, bits=8,
                                       weights=w_ring)
    enc_err = float((p_self.int() - enc_plain.int()).abs().max())
    dr_err = float((dr - dr_plain).abs().max())
    check(enc_err == 0 and dr_err == 0, "main-path shape kernel != plain")
    elems = N_WORKERS * D
    kernels = [
        dict(name="moniqua_encode", route="cuda",
             source="src/repro_torch/kernels/csrc/moniqua_encode.cu",
             replaces="src/repro/kernels/moniqua_encode.py:107",
             launches=main_launches["moniqua_encode"], max_abs_err=enc_err,
             ms=timer(lambda: kenc.encode(flat, B8, 7, bits=8,
                                          stochastic=True)),
             plain_ms=timer(lambda: kenc.encode_plain(flat, B8, 7, bits=8,
                                                      stochastic=True)),
             bound_ms=bound_ms(elems * 4 + elems * 1, elems * ENCODE_OPS),
             bound_by="bytes", library_ms=None),
        dict(name="moniqua_decode_reduce", route="cuda",
             source="src/repro_torch/kernels/csrc/moniqua_decode_reduce.cu",
             replaces="src/repro/kernels/moniqua_decode_reduce.py:154",
             launches=main_launches["moniqua_decode_reduce"],
             max_abs_err=dr_err,
             ms=timer(lambda: kdr.decode_reduce(p_self, p_nbrs, flat, B8,
                                                bits=8, weights=w_ring)),
             plain_ms=timer(lambda: kdr.decode_reduce_plain(
                 p_self, p_nbrs, flat, B8, bits=8, weights=w_ring)),
             bound_ms=bound_ms(elems * (3 * 1 + 4 + 4),
                               elems * decode_reduce_ops(2)),
             bound_by="bytes", library_ms=None),
    ]
    for k in kernels:
        print(f"time: {k['name']} 8-bit, [{N_WORKERS}, {D}] float32 (ring, "
              f"m=2 for decode-reduce): kernel {k['ms']:.5f} ms | plain "
              f"{k['plain_ms']:.5f} ms | bound {k['bound_ms']:.5f} ms "
              f"({k['bound_by']}) | library: no single PyTorch call {card}",
              flush=True)
    # the 1-bit main path's shapes (row padded to 272,288 elements)
    layout1 = CommEngine(topo, MoniquaWire(QuantSpec(1, False))).layout(X)
    D1 = layout1.padded_elems
    flat1 = layout1.flatten(X).reshape(N_WORKERS, 1, D1)
    B1 = modulo.b_theta(2.0, delta_for_bits(1, False), dev)
    p1 = kenc.encode(flat1, B1, 7, bits=1, stochastic=False)
    pn1 = torch.stack([torch.roll(p1, -o, 0) for o in (-1, 1)])
    e1 = N_WORKERS * D1
    t_enc1 = timer(lambda: kenc.encode(flat1, B1, 7, bits=1, stochastic=False))
    t_dr1 = timer(lambda: kdr.decode_reduce(p1, pn1, flat1, B1, bits=1,
                                            weights=w_ring))
    print(f"time: moniqua_encode 1-bit, [{N_WORKERS}, {D1}] float32: kernel "
          f"{t_enc1:.5f} ms | bound "
          f"{bound_ms(e1 * 4 + e1 // 8, e1 * ENCODE_OPS):.5f} ms {card}")
    print(f"time: moniqua_decode_reduce 1-bit ring: kernel {t_dr1:.5f} ms | "
          f"bound {bound_ms(e1 * 8 + 3 * e1 // 8, e1 * decode_reduce_ops(2)):.5f}"
          f" ms {card}")
    for name, ms in step_ms.items():
        print(f"time: step {name} (ResNet-20 w16, n={N_WORKERS}, {IMAGES} "
              f"images/worker, mean of steps 1-{STEPS - 1}) {ms:.3f} ms "
              f"{card}")

    # -- 6. where a main-path step's device time goes ---------------------
    step_fn, state = main_run
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(3):
            state, _ = step_fn(state, batches[k])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    if busy_us == 0:
        print("profile: no device time recorded (not measured)")
    else:
        groups = {"conv/gemm": 0.0, "codec kernels": 0.0, "other": 0.0}
        for e in kern:
            n = e.key.lower()
            g = ("codec kernels" if "encode_kernel" in n
                 or "decode_reduce_kernel" in n else "conv/gemm"
                 if any(t in n for t in ("conv", "cudnn", "gemm", "xmma",
                                         "sm90", "cutlass", "implicit"))
                 else "other")
            groups[g] += e.self_device_time_total
        print(f"profile: 3 moniqua-8bit steps: wall {wall_us / 1e3:.3f} ms, "
              f"device busy {busy_us / 1e3:.3f} ms "
              f"({100 * busy_us / wall_us:.1f}%), "
              f"{sum(e.count for e in kern)} kernel launches | " + " | ".join(
                  f"{g} {v / 1e3:.3f} ms" for g, v in groups.items())
              + f" {card}")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:90]}")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
