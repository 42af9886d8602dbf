#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Moniqua on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no card -> exit 2.  TF32 is off for matmul and cuDNN.
2. Build the six CUDA kernels from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a, in parallel; read with cuobjdump, the bfloat16
   tensor-core flash kernel's SASS must hold ``HGMMA`` and ``UTMALDG``, its
   head dim 96 instantiation's too, the float32 one's TF32
   ``HMMA.1688.F32.TF32``; registers and spills from ptxas, none spilled in
   either tensor-core kernel's head dim 96 instantiation), then hold each
   codec kernel against its plain
   PyTorch version with ``torch.equal``, on the card and against the CPU:
   encode over bits 1/2/4/8 x stochastic and nearest x idx_base != 0 x
   float32 and bfloat16, decode-reduce over ring(8), exponential(8) and
   torus(3, 3) x 1/2/4/8 bits x float32 and bfloat16, each at rows of 1003
   (no vpb divides it), 4096 (aligned, a multiple of 128), 17 (shorter than
   a vector), 1 and 4104 (1- and 2-bit payload rows not 4-byte aligned),
   and at 4096 one element off alignment; decode-reduce also at every
   neighbor count m = 1..8 (rows of 4096, off alignment too and with
   payloads one to three bytes in, and of 1003); then ResNet-110's bucket
   at 8 and 1 bit (encoded, and its rolled payloads mixed).
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
   could take; both codec kernels at 1 bit, and at 8 and 1 bit on
   ResNet-110's bucket (1,730,522 parameters a worker); the step time of
   each run.
6. A torch.profiler trace of three 8-bit main-path steps: device busy share,
   launches, and device time by kernel group and by kernel.
7. The flash-attention kernels against their plain version in float32 on
   the same inputs, on the card, each case through the route its dtype and
   head dim select (at head dims 64, 96 and 128 the tensor cores: bfloat16
   the ``wgmma`` kernel, float32 the 3xTF32 ``mma.sync`` kernel; the rest:
   the CUDA-core kernel), each route's launches counted: the reference
   tests' sweep (S 256/384/128/130 with windows 0/100/32/0), non-causal
   Sq=130/Sk=256, head dims 64, 96 and 128, grouped-query cases (K/V at
   1/3, 1/2 and, at 96, 1/4 of the query heads), at 96 also Sq=200/Sk=300
   causal and Sq=130/Sk=200 non-causal, the CUDA-core route at 256 and 33,
   and the serving shape [48, 4096, 128] causal (with 48 and with 16 KV
   heads), each in float32 (rtol = atol = 2e-5, the reference tests'
   numbers) and bfloat16 (within the reference tests' atol 0.03, and
   element by element within one bfloat16 ulp of the plain value plus the
   float32 tolerance).  Then two paths through ``ops.flash_sdpa``, one
   causal 4096-token prompt each: phi-3-vision-4.2b's attention (32 heads
   of 96, bfloat16 as published), the bfloat16 tensor-core kernel once;
   and a check that the CUDA-core route still runs from there, 16 heads
   of 256 (a head dim no config has, the widest the reference's kernel
   takes: a route check, not a workload), that kernel once.
8. The single-payload decode kernel against its plain version, bitwise on
   the card and against the CPU: phase 2's rows (1003, 4096, 17, 1, 4104,
   4096 one element off alignment, payloads one to three bytes into their
   buffer) x bits 1/2/4/8 x remote/self x float32/bfloat16, and ResNet-110's
   bucket at 8 and 1 bit; then its path: the ResNet-20 bucket encoded and
   decoded through ``ops.moniqua_decode_remote`` / ``_self`` within Lemma
   2's delta * B.
9. Serving llama3.2-3b at full width and depth in float32 (torch's TF32
   off: its matmuls run in full float32, while the flash kernel takes its
   products as 3xTF32), batch 2, a 256-token prompt: prefill through the
   float32 tensor-core flash kernel (28 launches, none of the other two
   routes) against the plain masked-softmax path, and the prompt fed token
   by token through ``serve_step`` against prefill, both within 1e-3 x
   max|logit|; then 16 greedy tokens.
10. The published bfloat16 llama3.2-3b, its config as registered (which
   serves through the flash kernel by default): prefill of 2 x 4096 tokens
   (the bfloat16 tensor-core flash kernel launched once per layer, 28
   times, the other two never), its gap to the plain path, 32 greedy
   decode tokens against a 4096-slot cache; prefill and decode times and
   profiles of one prefill and of 4 decode tokens.
11. Times of the serving slice's kernels at [48, 4096, 128] causal: the
   bfloat16 tensor-core kernel with the prefill's 16 KV heads, the float32
   tensor-core kernel and the CUDA-core kernel on the same float32 inputs,
   each beside scaled_dot_product_attention and its bound (float32: the
   3xTF32 bound at the TF32 tensor-core peak, and the CUDA-core one at the
   float32 peak); the two float32 kernels and the library call at head dim
   64; at phase 7's phi-3-vision shape [32, 4096, 96] causal, in both
   dtypes, the tensor-core kernel, the CUDA-core kernel on the same inputs
   (the record of the route head dim 96 left), the plain version, the
   library call and the bound; the CUDA-core kernel on phase 7's route
   check ([16, 4096, 256] bfloat16), which its kernels-line entry reports
   as a record of the route; the point decode at its path's shape.
12. The paper's other update rules on the main path's model (ResNet-20,
   8 workers, 128 images each, 8 bits, 10 steps through ``Trainer.run``):
   naive, choco and deepsqueeze (gamma 0.3), dcd, ecd on a ring; d2 and
   moniqua_d2 on ``ring(8).slack(0.75)``.  Finite losses, bytes per step and
   extra memory equal to the CPU's for the same tree, Moniqua-D^2 through
   one encode and one decode-reduce launch a step (the others through
   none), and one ``algo.step`` on the card against the CPU on the same
   state, directions and handed-in uniforms: Moniqua-D^2 bitwise, the
   rest within ``RULE_ULPS``.  Step time of each rule.
13. Moniqua on AD-PSGD (Algorithm 3) on the ResNet-20 bucket ``[8,
   272282]``: ring(8), max delay 4, 8 bits, theta 2.0, 200 iterations, each
   worker's gradient the ResNet-20 loss gradient of its (stale) model on its
   batch through the bucket layout.  One encode and two point-decode
   launches an exchange; the first exchanges bitwise card against CPU (a
   quadratic gradient with handed-in noise, so the whole run is
   elementwise); the full-wire AD-PSGD on the same schedule beside it;
   time per iteration of each, and the point decode's time at the
   exchange's shape ``[2, 272282]``.
14. Rows too long for one launch: encode, decode-reduce and the point
   decode (remote) of a ``[1, 2^31 + 4100]`` float32 row at 8 and 1 bit,
   the counter base set so the counter crosses 2^32, two launches each
   (the row split), held bitwise
   against the plain version on windows of 2^20 columns at the start,
   across the split, across the wrap and at the end.
15. The staged round on the ResNet-20 bucket (n = 8): ring(8) with the
   wires ``full``, ``moniqua`` 8-bit stochastic and 1-bit nearest,
   ``qsgd`` 8, ``ef_qsgd`` 4 and ``onebit`` (warmup 2), and ``moniqua``
   8-bit on exponential(8), 3 rounds each at K = 1, 2, 5 and 61 chunks
   (61: one a leaf).  Each K bitwise its K = 1 round, WireState included;
   K = 1 against the CPU: ``full`` and ``moniqua`` bitwise, the others
   within ``RULE_ULPS``; a Moniqua round at K chunks K encode and K
   decode-reduce launches (wrapper counts and the profiler).
   ``mix_stale`` 3 rounds card == CPU bitwise, one encode and one
   decode-reduce a round, the first returning the model.  Host-clock round
   times at every K.
16. ``Trainer.run`` on the main path's model, 10 steps each: ``moniqua``
   8-bit at ``chunks=4`` (params bitwise a ``chunks=1`` run's, 4 launches
   of each kernel a step), one round stale twice (bitwise, losses
   falling), ``qsgd`` 8, ``ef_qsgd`` 8 and ``onebit`` (warmup 4); bytes
   per step and extra memory per worker equal to the reference's
   (``WIRE_BYTES``); ``ef_qsgd`` and ``onebit`` cut, checkpointed,
   restored and resumed, bitwise the uninterrupted run's whole state.
   Step times and one profiled step per wire.
17. Elastic rounds on the ResNet-20 bucket (n = 8), phase 15's wires:
   ``presence`` all-ones bitwise ``presence=None`` over 3 rounds with
   WireState, both paths, K = 1 and 5; workers 2 and 5 absent on ring(8),
   worker 3 on exponential(8): absent models and EF residuals untouched,
   K = 5 bitwise K = 1, per-leaf bitwise bucketed on ``moniqua``,
   ``ef_qsgd`` and ``onebit`` (``qsgd``'s per-leaf round hashes a seed a
   leaf; the masked full wire's paths sum in different orders, as in the
   reference), card == CPU bitwise (``onebit`` within ``RULE_ULPS``), the
   full wire's worker mean kept within 1e-6; masked ``mix_stale`` card ==
   CPU over 3 rounds; a masked Moniqua round at K chunks K encode and
   K * m decode-reduce launches (m = 2, 5; wrappers and profiler), a
   masked ``mix_stale`` 1 and m; host-clock round times masked and not.
18. The simulator driving the engine: ``simulate_sync_rounds`` on
   churn-ring (n = 8) with a round deadline gives 20 realized masks,
   replayed through ``mix(presence=)`` on Moniqua's 8-bit wire (card ==
   CPU bitwise, absent workers untouched); ``Trainer.run`` with
   ``presence=(1, 1, 0, 1, 1, 0, 1, 1)`` on the main path's model, 10 steps
   each of moniqua 8-bit, 1-bit (slack) and dpsgd (finite losses, 1 encode
   and 2 decode-reduces a Moniqua step, a profiled step's launches beside
   an unmasked one's); ``replay_adpsgd`` on churn-ring's message loss, 200
   updates with the ResNet-20 gradient on the bucket: one encode and two
   point decodes a delivered exchange, every lost one the identity, the
   first 8 updates card == CPU bitwise (a quadratic gradient); time per
   update.  Phases 17-18's launches are added to the kernels line.

The second-to-last lines are the kernels' JSON summary and the nvidia-smi
line; the last line is the device contract JSON.
"""
from __future__ import annotations

import dataclasses
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
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense
N_WORKERS, IMAGES, STEPS = 8, 128, 10
# Theorem 3's slack matrix for the 1-bit run: W_bar = s W + (1 - s) I.  At
# theta 2.0 one 1-bit lattice cell is B/2 = 4 wide and has an edge at 0,
# where most of a fresh ResNet's weights sit; every code that flips there
# moves a weight by a gossip weight times 4, and without slack the loss
# climbs, in the JAX reference too (tests/test_torch_resnet.py,
# test_one_bit_without_slack_diverges_like_the_reference).  The slack damps
# each such move by s.
SLACK_1BIT = 0.02
# phase 12: the elementwise rules, card against CPU after one step.  Every
# operation they run is one IEEE-rounded float32 operation on both, and the
# per-worker scale is a max (exact): the bits should agree.  Nothing in
# PyTorch promises its CPU and CUDA elementwise kernels the same bits,
# though, so they are held within this many float32 ulp of each leaf's
# largest value, and the measured error is printed.
RULE_ULPS = 2
ADPSGD_ITERS, ADPSGD_DELAY, ADPSGD_CHECK = 200, 4, 8
SPLIT_COLS = 2 ** 31 + 4100    # phase 14's row
SPLIT_WIN = 2 ** 20            # the columns of each window it is checked on
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


def sass_counts(lib, ops, fn=None):
    """How many instructions of each name in ``ops`` the library's SASS
    holds (cuobjdump -sass), only in the functions whose mangled name holds
    ``fn`` if it is given; None without cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    if fn is not None:
        text = "".join(f for f in text.split("Function : ")[1:]
                       if fn in f.split("\n", 1)[0])
    return {op: text.count(op) for op in ops}


# the codec kernels the main path launches: float32 at 8 and 1 bit, and
# decode-reduce with a ring's m = 2 (mangled template arguments)
MAIN_PATH_KERNELS = ("encode_kernelIfLi8E", "encode_kernelIfLi1E",
                     "decode_reduce_kernelIfLi8ELi2E",
                     "decode_reduce_kernelIfLi1ELi2E")
# the tensor-core flash kernels' head dim 96 instantiations, by library
FLASH_D96_KERNELS = {"flash_attention_tc": "fa_kernel_tcILi96E",
                     "flash_attention_f32tc": "fa_f32tc_kernelILi96E"}


def ptxas_kernels(log: str) -> dict:
    """Each kernel's registers and spill-store bytes from ``-Xptxas -v``."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name:
            out[name] = (int(line.split("Used")[1].split()[0]), spill)
            name, spill = None, 0
    return out


def bound_ms(nbytes: int, ops: int) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def decode_bound_ms(elems: int, bits: int) -> float:
    """Point decode of ``elems`` float32 values: y read and out written
    once, the payload read once."""
    return bound_ms(elems * 8 + elems * bits // 8, elems * DECODE_OPS)


def offset_view(t, k=1):
    """``t`` in a buffer ``k`` elements in: for k = 1, no row of y starts
    16-byte aligned and the wrapper's output does not share its
    alignment; a payload k bytes in starts inside a 4-byte word."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    buf[k:] = t.reshape(-1)
    return buf[k:].view(t.shape)


def encode_bound_ms(elems: int, bits: int) -> float:
    """Encode of ``elems`` float32 values: each read once, its code written."""
    return bound_ms(elems * 4 + elems * bits // 8, elems * ENCODE_OPS)


def decode_reduce_bound_ms(elems: int, bits: int, m: int) -> float:
    """Decode-reduce of ``elems`` float32 values with ``m`` neighbors: y read
    and out written once, the own and m neighbor payloads read once."""
    return bound_ms(elems * 8 + (m + 1) * elems * bits // 8,
                    elems * decode_reduce_ops(m))


def codec_times(timer, dev, card, flat, bits, stochastic, what, offsets):
    """Time both codec kernels on ``flat [workers, 1, D]`` float32 at theta
    2.0, decode-reduce mixing the payload rolled by each of ``offsets``
    (the neighbors' gossip weights 1 / (m + 1)); print each beside its byte
    bound and return ``{name: (ms, bound_ms)}``."""
    from repro_torch.core import modulo
    from repro_torch.core.quantizers import delta_for_bits
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc
    m = len(offsets)
    w = (1.0 / (m + 1),) * m
    B = modulo.b_theta(2.0, delta_for_bits(bits, stochastic), dev)
    p = kenc.encode(flat, B, 7, bits=bits, stochastic=stochastic)
    pn = torch.stack([torch.roll(p, -o, 0) for o in offsets])
    e = flat.numel()
    times = {"moniqua_encode": (
                 timer(lambda: kenc.encode(flat, B, 7, bits=bits,
                                           stochastic=stochastic)),
                 encode_bound_ms(e, bits)),
             "moniqua_decode_reduce": (
                 timer(lambda: kdr.decode_reduce(p, pn, flat, B, bits=bits,
                                                 weights=w)),
                 decode_reduce_bound_ms(e, bits, m))}
    for name, (ms, bound) in times.items():
        print(f"time: {name} {bits}-bit, {what} {list(flat.shape)} float32 "
              f"(m={m}): kernel {ms:.5f} ms | bound {bound:.5f} ms (bytes) "
              f"| {100 * bound / ms:.1f}% of the bound {card}", flush=True)
    return times


def decode_times(timer, dev, card, y, bits, what):
    """Time the point decode (remote, line 5) of ``y [rows, D]`` float32
    against its left neighbor's payload, encoded at ``bits`` (8 stochastic,
    else nearest) and theta 2.0; print it beside its byte bound and return
    ``(ms, bound_ms)``."""
    from repro_torch.core import modulo
    from repro_torch.core.quantizers import delta_for_bits
    from repro_torch.kernels import moniqua_decode as kdec
    from repro_torch.kernels import moniqua_encode as kenc
    B = modulo.b_theta(2.0, delta_for_bits(bits, bits == 8), dev)
    p = torch.roll(kenc.encode(y[:, None], B, 7, bits=bits,
                               stochastic=bits == 8)[:, 0], 1, 0)
    ms = timer(lambda: kdec.decode(p, y, B, bits=bits))
    bound = decode_bound_ms(y.numel(), bits)
    print(f"time: moniqua_decode {bits}-bit remote, {what} {list(y.shape)} "
          f"float32: kernel {ms:.5f} ms | bound {bound:.5f} ms (bytes) | "
          f"{100 * bound / ms:.1f}% of the bound {card}", flush=True)
    return ms, bound


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


# -- serving slice: flash attention, point decode, llama3.2-3b -------------

BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense (data sheet)
SERVE_ARCH = "llama3.2-3b"
SERVE_BATCH = 2
F32_PROMPT, F32_GREEDY = 256, 16          # phase 9
BF16_PROMPT, BF16_GREEDY = 4096, 32       # phase 10
FLASH_MAIN = (48, 4096, 128)              # [B*H, S, D] of phase 10's prefill
# [B*H, S, D] of phase 7's two flash paths: phi-3-vision-4.2b's attention
# (32 heads of 96); and a check that the CUDA-core route still runs from
# ops.flash_sdpa, at 16 heads of 256, a head dim no config has (no model's
# traffic: its times are a record of the route, not of a workload)
FLASH_PHI = (32, 4096, 96)
FLASH_WIDE = (16, 4096, 256)
GQA_MAIN = 3                               # its query heads per KV head (24/8)
# float32 serving checks (phase 9): the flash path and the token-by-token
# decode against prefill, each within this share of max|logit|
F32_LOGIT_TOL = 1e-3
# Bound on phase 10's bfloat16 gap between the flash and the plain prefill,
# as a share of max|logit|.  Phase 9 holds the kernel path to the plain one
# within 1e-3 in float32, so in bfloat16 the gap is rounding: the plain path
# rounds the scores and the softmax weights to bfloat16, the kernel keeps
# them in float32, and each path's activations are rounded to bfloat16 in
# all 28 layers.  bfloat16 keeps 8 bits (relative step 2^-8 = 0.4%); over
# 28 layers such gaps grow to a few percent of the largest logit.  The
# bound allows 0.1.
BF16_GAP_BOUND = 0.1
DECODE_OPS = 11                # value (4) + sub + cmod (5) + add


def serve_config(**over):
    """The published config as registered, with ``over`` replaced: it
    serves through the flash kernel unless ``flash_attention=False`` asks
    for the plain masked-softmax path."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SERVE_ARCH), **over)


def causal_pairs(s: int) -> int:
    """(query, key) pairs that s causal query rows attend."""
    return s * (s + 1) // 2


def profile_device(fn, what, card):
    """Device busy share, launches and device time by kernel group of one
    call of ``fn`` under torch.profiler (the serve steps' ``serve.*``
    ranges are host annotations and are left out of the device sums)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("serve.")]
    busy_us = sum(e.self_device_time_total for e in kern)
    if busy_us == 0:
        print(f"profile: {what}: no device time recorded (not measured)")
        return
    groups = {"flash kernel": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kern:
        nm = e.key.lower()
        g = ("flash kernel" if "fa_kernel" in nm else "gemm"
             if any(t in nm for t in ("gemm", "xmma", "sm90", "cutlass",
                                      "nvjet", "gemv", "matmul"))
             else "other")
        groups[g] += e.self_device_time_total
    print(f"profile: {what}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"{sum(e.count for e in kern)} kernel launches | " + " | ".join(
              f"{g} {v / 1e3:.3f} ms" for g, v in groups.items())
          + f" {card}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def serving_phases(dev, timer, card, flat, B8, flat110):
    """Phases 7-11 (``flat110``: phase 2's ResNet-110 buckets by bit
    width); returns the kernels-line entries of the serving slice's
    kernels."""
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.core import modulo
    from repro_torch.core.quantizers import QuantSpec, delta_for_bits
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import moniqua_decode as kdec
    from repro_torch.kernels import moniqua_encode as kenc
    from repro_torch.kernels import ops
    from repro_torch.models.model_factory import Model
    from repro_torch.train.serve_step import make_prefill_step, make_serve_step

    gen = torch.Generator().manual_seed(12)
    routes = (kfa.flash_attention_tc, kfa.flash_attention_f32tc,
              kfa.flash_attention_simt)

    def launches():
        return {r.__name__: r.launches for r in routes}

    def zero_launches():
        for r in routes:
            r.launches = 0

    # -- 7. flash kernels against their plain version --------------------
    torch.cuda.synchronize()
    zero_launches()
    routed = {r.__name__: 0 for r in routes}

    def flash_case(what, q, k, v, **kw):
        """Hold ``kfa.flash_attention`` (the route dtype and head dim pick)
        to the plain version in float32 on the same inputs -> max abs err,
        worst error / tolerance, median |plain|."""
        routed[kfa.route(q).__name__] += 1
        got = kfa.flash_attention(q, k, v, **kw)
        want = kfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         **kw)
        check(got.dtype == q.dtype and got.shape == q.shape,
              what + ": dtype/shape")
        ok, err, ratio = kfa.flash_close(got, want)
        check(ok, what + f" != plain (max abs {err:.3g}, {ratio:.3g} x "
              f"tolerance)")
        return err, ratio, float(want.abs().median())

    cases = [(True, 256, 256, 0), (True, 384, 384, 100), (True, 128, 128, 32),
             (True, 130, 130, 0), (False, 130, 256, 0)]
    n = 0
    # head dim 96 also at ragged Sq != Sk, causal and not
    cases96 = [(True, 200, 300, 0), (False, 130, 200, 0)]
    for causal, sq, sk, window in cases + cases96:
        # (query blocks, KV blocks): MHA at head dims 64, 96 and 128, then
        # grouped-query attention with g = 3 (llama3.2-3b's 24 / 8), 2 and,
        # at head dim 96, 4
        heads = [((4, 4), 96), ((4, 1), 96)]
        if (causal, sq, sk, window) not in cases96:
            heads += [((4, 4), 64), ((4, 4), 128), ((6, 2), 128),
                      ((4, 2), 128), ((6, 2), 64)]
        for (bh, bh_kv), d in heads:
            for dtype in (torch.float32, torch.bfloat16):
                q = torch.randn((bh, sq, d), generator=gen).to(dtype).to(dev)
                k, v = (torch.randn((bh_kv, sk, d), generator=gen).to(dtype)
                        .to(dev) for _ in range(2))
                flash_case(f"flash {dtype} causal={causal} sq={sq} sk={sk} "
                           f"window={window} d={d} g={bh // bh_kv}", q, k, v,
                           scale=1.0 / math.sqrt(d), causal=causal,
                           window=window)
                n += 1
    for d in (256, 33):                # the CUDA-core route: widest, odd
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((4, 384, d), generator=gen).to(dtype)
                       .to(dev) for _ in range(3))
            flash_case(f"flash {dtype} d={d}", q, k, v,
                       scale=1.0 / math.sqrt(d), causal=True, window=100)
            n += 1
    bh, s_main, d_main = FLASH_MAIN
    kv_main = bh // GQA_MAIN            # the prefill's KV blocks
    fa_kw = dict(scale=1.0 / math.sqrt(d_main), causal=True, window=0)
    main = {}
    for dtype, n_kv in ((torch.float32, bh), (torch.bfloat16, bh),
                        (torch.bfloat16, kv_main)):
        qm, km, vm = (torch.randn((rows, s_main, d_main), generator=gen)
                      .to(dtype).to(dev) for rows in (bh, n_kv, n_kv))
        main[str(dtype)[6:], n_kv] = flash_case(
            f"flash {list(FLASH_MAIN)} {dtype} kv={n_kv}", qm, km, vm,
            **fa_kw)
        if dtype == torch.float32:
            f32_main = (qm, km, vm)
    torch.cuda.synchronize()
    check(launches() == routed, f"flash sweep launches {launches()}, want "
          f"{routed} (one per case on the route its dtype and head dim pick)")
    print(f"phase 7: flash kernels == plain version in {n} sweep cases "
          f"(float32 rtol=atol=2e-5; bfloat16 atol 0.03 and one bfloat16 "
          f"ulp + the float32 tolerance) and at {list(FLASH_MAIN)} causal: "
          + ", ".join(f"{dt} with {kv} KV blocks max abs {e:.4g} ({r:.3g} x "
                      f"tolerance, median |plain| {m:.4g})"
                      for (dt, kv), (e, r, m) in main.items())
          + f"; launches by route {launches()}", flush=True)
    def sdpa_path(shape, route, what):
        """``ops.flash_sdpa`` on one causal bfloat16 prompt ``[1, S, H, D]``
        (``shape`` is ``[H, S, D]``), the route counts zeroed just before
        and read just after; the launches must be ``route``'s one ->
        launches, max abs error, worst error / tolerance."""
        h, s_, d = shape
        qp, kp, vp = (torch.randn((1, s_, h, d), generator=gen)
                      .to(torch.bfloat16).to(dev) for _ in range(3))
        kw = dict(scale=1.0 / math.sqrt(d), causal=True, window=0)
        torch.cuda.synchronize()
        zero_launches()
        op = ops.flash_sdpa(qp, kp, vp, **kw)
        torch.cuda.synchronize()
        got = launches()
        want = {r.__name__: int(r is route) for r in routes}
        check(got == want, f"{what} launches {got}, want {want}")

        def fold(t):                    # [1, S, H, D] -> [H, S, D]
            return t.movedim(2, 1).reshape(h, s_, d)
        plain = kfa.flash_attention_plain(
            *(fold(t).float() for t in (qp, kp, vp)), **kw)
        ok, err, ratio = kfa.flash_close(fold(op), plain)
        check(ok, f"{what} != plain (max abs {err:.3g})")
        print(f"phase 7: {what}, ops.flash_sdpa [1, {s_}, {h}, {d}] bfloat16 "
              f"causal: launches {got}; max abs vs plain {err:.4g} "
              f"({ratio:.3g} x tolerance)", flush=True)
        return got, err, ratio

    # phi-3-vision-4.2b's attention (32 query and 32 KV heads of 96,
    # bfloat16 as published): the bfloat16 tensor-core kernel at head dim 96
    ph_h, ph_s, ph_d = FLASH_PHI
    ph_kw = dict(scale=1.0 / math.sqrt(ph_d), causal=True, window=0)
    tc96_path, ph_err, _ = sdpa_path(FLASH_PHI, kfa.flash_attention_tc,
                                     "phi-3-vision-4.2b's attention")
    # a check of the CUDA-core route through ops.flash_sdpa, not a
    # workload: head dim 256, which no config has, the widest the
    # reference's kernel takes
    wd_h, wd_s, wd_d = FLASH_WIDE
    wd_kw = dict(scale=1.0 / math.sqrt(wd_d), causal=True, window=0)
    simt_path, wd_err, _ = sdpa_path(FLASH_WIDE, kfa.flash_attention_simt,
                                     "the CUDA-core route check")

    # -- 8. decode kernel: bitwise sweep, then its path --------------------
    # phase 2's rows [workers, rows, cols]: 1003, no vpb divides it; 4096,
    # aligned (also with y one element off alignment, and with the payload
    # one to three bytes into its buffer); 17, shorter than one vector; 1;
    # 4104, 1- and 2-bit payload rows not 4-byte aligned
    n = 0
    for shape in ((3, 5, 1003), (2, 3, 4096), (1, 1, 17), (1, 1, 1),
                  (1, 3, 4104)):
        for dtype in (torch.float32, torch.bfloat16):
            y_cpu = (torch.randn(shape, generator=gen) * 4).to(dtype)
            y = y_cpu.to(dev)
            cases = [("", y, 0)]
            if shape == (2, 3, 4096):
                cases += [("y off alignment", offset_view(y), 0)] + [
                    (f"payload +{k} bytes", y, k) for k in (1, 2, 3)]
            for bits in (1, 2, 4, 8):
                spec = QuantSpec(bits, bits > 1)
                B_cpu = modulo.b_theta(2.0, delta_for_bits(bits, bits > 1),
                                       "cpu")
                p_cpu = torch.randint(0, 256, shape[:2] + (
                    -(-shape[2] // (8 // bits)),), generator=gen,
                    dtype=torch.uint8)
                for mode in kdec.MODES:
                    fn = getattr(ops, f"moniqua_decode_{mode}")
                    cpu = fn(p_cpu, y_cpu, B_cpu, spec)
                    for tag, yv, k in cases:
                        p = offset_view(p_cpu.to(dev), k) if k else \
                            p_cpu.to(dev)
                        got = fn(p, yv, B_cpu.to(dev), spec)
                        plain = kdec.decode_plain(
                            p.reshape(-1, p.shape[-1]),
                            yv.reshape(-1, shape[-1]), B_cpu.to(dev),
                            bits=bits, mode=mode).reshape(shape)
                        what = (f"decode {mode} {list(shape)} {tag} {dtype} "
                                f"bits={bits}")
                        check(torch.equal(got, plain),
                              what + " != plain (card)")
                        check(torch.equal(got.cpu(), cpu),
                              what + " != plain (CPU)")
                        n += 1
    # ResNet-110's bucket (8 workers): its own payload (self) and its left
    # neighbor's (remote), at the main path's 8-bit (stochastic) and 1-bit
    # (nearest) specs
    for bits, x110 in flat110.items():
        spec = QuantSpec(bits, bits == 8)
        B = modulo.b_theta(2.0, delta_for_bits(bits, spec.stochastic), dev)
        for dtype in (torch.float32, torch.bfloat16):
            y = x110.reshape(N_WORKERS, -1).to(dtype)
            p = kenc.encode(y[:, None], B, 7, bits=bits,
                            stochastic=spec.stochastic)[:, 0]
            y_cpu, B_cpu = y.cpu(), B.cpu()
            for mode, pm in (("self", p), ("remote", torch.roll(p, 1, 0))):
                got = kdec.decode(pm, y, B, bits=bits, mode=mode)
                what = (f"decode {mode} ResNet-110 {list(y.shape)} {dtype} "
                        f"bits={bits}")
                check(torch.equal(got, kdec.decode_plain(
                    pm, y, B, bits=bits, mode=mode)),
                    what + " != plain (card)")
                check(torch.equal(got.cpu(), kdec.decode_plain(
                    pm.cpu(), y_cpu, B_cpu, bits=bits, mode=mode)),
                    what + " != plain (CPU)")
                n += 1
    # the path: each worker encodes, receives its left neighbor's payload
    # and decodes it (line 5) and its own (line 4)
    spec8 = QuantSpec(8)
    torch.cuda.synchronize()
    kenc.encode.launches = kdec.decode.launches = 0
    p_self = ops.moniqua_encode_stacked(flat, B8, spec8, 7)
    p_nbr = torch.roll(p_self, 1, 0)
    x_remote = ops.moniqua_decode_remote(p_nbr, flat, B8, spec8)
    x_self = ops.moniqua_decode_self(p_self, flat, B8, spec8)
    torch.cuda.synchronize()
    dec_launches = kdec.decode.launches
    check(dec_launches == 2 and kenc.encode.launches == 1,
          f"decode path launches: decode {dec_launches} (want 2), encode "
          f"{kenc.encode.launches} (want 1)")
    lemma2 = float(delta_for_bits(8, True) * B8) * (1 + 1e-3)
    e_remote = float((x_remote - torch.roll(flat, 1, 0)).abs().max())
    e_self = float((x_self - flat).abs().max())
    check(e_remote <= lemma2 and e_self <= lemma2,
          f"decode path errors {e_remote}, {e_self} > delta*B {lemma2}")
    plain8 = kdec.decode_plain(p_nbr, flat, B8, bits=8)
    dec_err = float((kdec.decode(p_nbr, flat, B8, bits=8) - plain8
                     ).abs().max())
    check(dec_err == 0, f"decode at {list(flat.shape)} != plain")
    print(f"phase 8: decode kernel == plain version bitwise in {n} sweep "
          f"cases (card and CPU); its path on the ResNet-20 bucket "
          f"{list(flat.shape)}: {dec_launches} launches, |x_hat - x| "
          f"remote {e_remote:.4g}, self {e_self:.4g} <= delta*B "
          f"{lemma2:.4g}", flush=True)

    # -- 9. float32 llama3.2-3b, full width and depth ----------------------
    m32 = Model(serve_config(dtype="float32"), "cuda")
    m32_plain = Model(serve_config(dtype="float32", flash_attention=False),
                      "cuda")
    check(m32.cfg.flash_attention, "the config's default is not the kernel")
    cfg = m32.cfg
    t0 = time.perf_counter()
    params = m32.init(m32.generator(0))
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in tree.leaves(params))
    print(f"serve f32: {SERVE_ARCH} {n_params / 1e9:.3f} B params drawn on "
          f"the card in {time.perf_counter() - t0:.1f} s", flush=True)
    batch = SyntheticLMPipeline(m32, InputShape("smoke_f32", F32_PROMPT,
                                                SERVE_BATCH, "prefill"),
                                seed=0).global_batch(0)
    tokens = batch["tokens"]
    torch.cuda.synchronize()
    zero_launches()
    lf = make_prefill_step(m32)(params, batch)
    torch.cuda.synchronize()
    f32_launches = launches()
    check(f32_launches == {"flash_attention_tc": 0,
                           "flash_attention_f32tc": cfg.num_layers,
                           "flash_attention_simt": 0},
          f"f32 prefill flash launches {f32_launches}, want the float32 "
          f"tensor-core kernel {cfg.num_layers} times and no other")
    lp = make_prefill_step(m32_plain)(params, batch)
    scale32 = float(lp.abs().max())
    gap_i = float((lf - lp).abs().max()) / scale32
    check(bool(torch.isfinite(lf).all()), "f32 prefill logits not finite")
    check(gap_i <= F32_LOGIT_TOL, f"f32 flash vs plain prefill {gap_i:.3g} "
          f"x max|logit| > {F32_LOGIT_TOL}")
    serve = make_serve_step(m32)
    cache = m32.init_cache(SERVE_BATCH, InputShape(
        "smoke_f32_decode", F32_PROMPT + F32_GREEDY, SERVE_BATCH, "decode"))
    for t in range(F32_PROMPT):
        logits, cache = serve(params, cache, tokens[:, t:t + 1])
    gap_ii = float((logits - lf).abs().max()) / scale32
    check(gap_ii <= F32_LOGIT_TOL, f"f32 token-by-token decode vs prefill "
          f"{gap_ii:.3g} x max|logit| > {F32_LOGIT_TOL}")
    greedy = []
    for _ in range(F32_GREEDY):
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        greedy.append(tok)
        logits, cache = serve(params, cache, tok.int())
        check(bool(torch.isfinite(logits).all()), "f32 decode not finite")
    check(int(cache["pos"]) == F32_PROMPT + F32_GREEDY, "f32 cache pos")
    print(f"phase 9: {SERVE_ARCH} float32 (torch's TF32 off; the flash "
          f"kernel 3xTF32), batch {SERVE_BATCH}, {F32_PROMPT}-token prompt: "
          f"flash launches in one prefill {f32_launches}; last-position "
          f"logits flash vs plain prefill {gap_i:.3g} x max|logit| "
          f"({scale32:.4g}), token-by-token serve_step vs prefill "
          f"{gap_ii:.3g}; greedy {torch.cat(greedy, 1).tolist()}",
          flush=True)
    del params, cache, lf, lp, logits
    torch.cuda.empty_cache()

    # -- 10. the published bfloat16 model ----------------------------------
    mbf = Model(serve_config(), "cuda")          # the published config
    mbf_plain = Model(serve_config(flash_attention=False), "cuda")
    cfg = mbf.cfg
    check(cfg.dtype == "bfloat16", f"published dtype {cfg.dtype}")
    params = mbf.init(mbf.generator(0))
    shape = InputShape("smoke_prefill_4k", BF16_PROMPT, SERVE_BATCH,
                       "prefill")
    batch = SyntheticLMPipeline(mbf, shape, seed=1).global_batch(0)
    prefill = make_prefill_step(mbf)
    torch.cuda.synchronize()
    zero_launches()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    fa_launches = kfa.flash_attention_tc.launches
    check(launches() == {"flash_attention_tc": cfg.num_layers,
                         "flash_attention_f32tc": 0,
                         "flash_attention_simt": 0},
          f"bf16 prefill flash launches {launches()}, want the tensor-core "
          f"kernel {cfg.num_layers} times and no other")
    check(bool(torch.isfinite(logits).all()), "bf16 prefill not finite")
    plain = make_prefill_step(mbf_plain)(params, batch)
    gap = float((logits - plain).abs().max()) / float(plain.abs().max())
    check(gap <= BF16_GAP_BOUND, f"bf16 flash vs plain prefill {gap:.4g} "
          f"x max|logit| > {BF16_GAP_BOUND}")
    del plain
    prefill_ms = host_ms(lambda: prefill(params, batch), reps=3)
    serve = make_serve_step(mbf)
    cache = mbf.init_cache(SERVE_BATCH, InputShape(
        "smoke_decode_4k", BF16_PROMPT, SERVE_BATCH, "decode"))
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True).int()
    out, cache = serve(params, cache, tok)          # warm-up: first token
    torch.cuda.synchronize()
    greedy = [tok]
    t0 = time.perf_counter()
    for _ in range(BF16_GREEDY - 1):
        tok = out[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True).int()
        greedy.append(tok)
        out, cache = serve(params, cache, tok)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / (BF16_GREEDY - 1)
    check(bool(torch.isfinite(out).all()), "bf16 decode not finite")
    print(f"phase 10: {SERVE_ARCH} bfloat16, {SERVE_BATCH} x {BF16_PROMPT} "
          f"prompt: tensor-core flash launched {fa_launches} times in one "
          f"prefill; "
          f"flash vs plain prefill {gap:.4g} x max|logit| (bound "
          f"{BF16_GAP_BOUND}); {BF16_GREEDY} greedy tokens against a "
          f"{cache['layers']['k'].shape[2]}-slot cache: "
          f"{torch.cat(greedy, 1)[:, :8].tolist()}...", flush=True)
    print(f"time: serve prefill {SERVE_BATCH} x {BF16_PROMPT} tokens "
          f"{prefill_ms:.2f} ms ({SERVE_BATCH * BF16_PROMPT / prefill_ms * 1e3:.0f}"
          f" tokens/s); decode {decode_ms:.3f} ms per token (batch "
          f"{SERVE_BATCH}, host clock, mean of {BF16_GREEDY - 1}) {card}",
          flush=True)
    profile_device(lambda: prefill(params, batch), "one bf16 prefill",
                    card)

    def decode4():
        nonlocal out, cache
        for _ in range(4):
            tok = out[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True).int()
            out, cache = serve(params, cache, tok)
    profile_device(decode4, "4 bf16 decode tokens", card)
    del params, cache, logits, out
    torch.cuda.empty_cache()

    # -- 11. times of the serving slice's kernels at their path's shapes --
    # qm, km, vm: the bfloat16 inputs at the prefill's shape (16 KV blocks)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fa_ms = timer(lambda: kfa.flash_attention_tc(qm, km, vm, **fa_kw),
                  reps=20, warmup=2)
    fa_plain_ms = timer(lambda: kfa.flash_attention_plain(qm, km, vm,
                                                          **fa_kw),
                        reps=10, warmup=2)
    sdpa_ms = timer(lambda: sdpa(qm[None], km[None], vm[None], is_causal=True,
                                 enable_gqa=True), reps=20, warmup=2)
    # the same function with the KV blocks expanded to 48, the shape of
    # the earlier timings, where both routes and the library call are timed
    # side by side
    km1, vm1 = (kfa.expand_kv(t, GQA_MAIN) for t in (km, vm))
    tc48_ms = timer(lambda: kfa.flash_attention_tc(qm, km1, vm1, **fa_kw),
                    reps=20, warmup=2)
    simt_bf16_ms = timer(lambda: kfa.flash_attention_simt(qm, km1, vm1,
                                                          **fa_kw),
                         reps=10, warmup=2)
    sdpa48_ms = timer(lambda: sdpa(qm[None], km1[None], vm1[None],
                                   is_causal=True), reps=20, warmup=2)
    del km1, vm1
    fa_flops = 4 * d_main * bh * causal_pairs(s_main)
    fa_bytes = 2 * (2 * bh + 2 * kv_main) * s_main * d_main
    fa_bound = 1e3 * max(fa_bytes / HBM_BYTES_PER_S,
                         fa_flops / BF16_OPS_PER_S)
    # float32 at the same shape, 48 KV blocks: the float32 tensor-core
    # kernel (phase 9's route), the CUDA-core kernel on the same inputs,
    # the plain version and the library call
    q32, k32, v32 = f32_main
    f32tc_ms = timer(lambda: kfa.flash_attention_f32tc(q32, k32, v32,
                                                       **fa_kw),
                     reps=10, warmup=2)
    simt_ms = timer(lambda: kfa.flash_attention_simt(q32, k32, v32, **fa_kw),
                    reps=10, warmup=2)
    f32_plain_ms = timer(lambda: kfa.flash_attention_plain(q32, k32, v32,
                                                           **fa_kw),
                         reps=5, warmup=1)
    sdpa32_ms = timer(lambda: sdpa(q32[None], k32[None], v32[None],
                                   is_causal=True), reps=10, warmup=2)
    _, simt_err, _ = kfa.flash_close(
        kfa.flash_attention_simt(q32, k32, v32, **fa_kw),
        kfa.flash_attention_plain(q32, k32, v32, **fa_kw))
    f32_bytes = 4 * 4 * bh * s_main * d_main
    # 3xTF32 issues three TF32 products for each float32 one
    f32tc_bound = 1e3 * max(f32_bytes / HBM_BYTES_PER_S,
                            3 * fa_flops / TF32_OPS_PER_S)
    simt_bound = 1e3 * max(f32_bytes / HBM_BYTES_PER_S,
                           fa_flops / F32_OPS_PER_S)
    del q32, k32, v32, f32_main
    # float32 at head dim 64, the route's other instantiation
    d64 = 64
    q64, k64, v64 = (torch.randn((bh, s_main, d64), generator=gen).to(dev)
                     for _ in range(3))
    kw64 = dict(fa_kw, scale=1.0 / math.sqrt(d64))
    f32tc64_ms = timer(lambda: kfa.flash_attention_f32tc(q64, k64, v64,
                                                         **kw64),
                       reps=10, warmup=2)
    simt64_ms = timer(lambda: kfa.flash_attention_simt(q64, k64, v64,
                                                       **kw64),
                      reps=10, warmup=2)
    sdpa64_ms = timer(lambda: sdpa(q64[None], k64[None], v64[None],
                                   is_causal=True), reps=10, warmup=2)
    del q64, k64, v64
    f32tc64_bound = 1e3 * max(4 * 4 * bh * s_main * d64 / HBM_BYTES_PER_S,
                              3 * 4 * d64 * bh * causal_pairs(s_main)
                              / TF32_OPS_PER_S)
    # head dim 96 at phase 7's phi-3-vision shape as the kernels get it,
    # [32, 4096, 96] causal, in both dtypes: the tensor-core kernel, the
    # CUDA-core kernel on the same inputs (the record of the route head dim
    # 96 took before), the plain version and the library call
    qp, kp, vp = (torch.randn((ph_h, ph_s, ph_d), generator=gen)
                  .to(torch.bfloat16).to(dev) for _ in range(3))
    ph_ms = timer(lambda: kfa.flash_attention_tc(qp, kp, vp, **ph_kw),
                  reps=20, warmup=2)
    ph_simt_ms = timer(lambda: kfa.flash_attention_simt(qp, kp, vp,
                                                        **ph_kw),
                       reps=10, warmup=2)
    ph_plain_ms = timer(lambda: kfa.flash_attention_plain(qp, kp, vp,
                                                          **ph_kw),
                        reps=5, warmup=1)
    ph_sdpa_ms = timer(lambda: sdpa(qp[None], kp[None], vp[None],
                                    is_causal=True), reps=20, warmup=2)
    qp, kp, vp = (t.float() for t in (qp, kp, vp))
    ph32_ms = timer(lambda: kfa.flash_attention_f32tc(qp, kp, vp, **ph_kw),
                    reps=10, warmup=2)
    ph32_simt_ms = timer(lambda: kfa.flash_attention_simt(qp, kp, vp,
                                                          **ph_kw),
                         reps=10, warmup=2)
    ph32_plain_ms = timer(lambda: kfa.flash_attention_plain(qp, kp, vp,
                                                            **ph_kw),
                          reps=5, warmup=1)
    ph32_sdpa_ms = timer(lambda: sdpa(qp[None], kp[None], vp[None],
                                      is_causal=True), reps=10, warmup=2)
    ok, ph32_err, ph32_ratio = kfa.flash_close(
        kfa.flash_attention_f32tc(qp, kp, vp, **ph_kw),
        kfa.flash_attention_plain(qp, kp, vp, **ph_kw))
    check(ok, f"float32 flash {list(FLASH_PHI)} != plain (max abs "
          f"{ph32_err:.3g})")
    del qp, kp, vp
    ph_flops = 4 * ph_d * ph_h * causal_pairs(ph_s)
    ph_bytes = 2 * 4 * ph_h * ph_s * ph_d
    ph_bound = 1e3 * max(ph_bytes / HBM_BYTES_PER_S,
                         ph_flops / BF16_OPS_PER_S)
    ph32_bound = 1e3 * max(2 * ph_bytes / HBM_BYTES_PER_S,
                           3 * ph_flops / TF32_OPS_PER_S)
    # the CUDA-core kernel on phase 7's route check, [16, 4096, 256]
    # bfloat16 causal (a head dim no config has)
    qw, kw_, vw = (torch.randn((wd_h, wd_s, wd_d), generator=gen)
                   .to(torch.bfloat16).to(dev) for _ in range(3))
    wd_ms = timer(lambda: kfa.flash_attention_simt(qw, kw_, vw, **wd_kw),
                  reps=10, warmup=2)
    wd_plain_ms = timer(lambda: kfa.flash_attention_plain(qw, kw_, vw,
                                                          **wd_kw),
                        reps=5, warmup=1)
    wd_sdpa_ms = timer(lambda: sdpa(qw[None], kw_[None], vw[None],
                                    is_causal=True), reps=10, warmup=2)
    del qw, kw_, vw
    wd_flops = 4 * wd_d * wd_h * causal_pairs(wd_s)
    wd_bound = 1e3 * max(2 * 4 * wd_h * wd_s * wd_d / HBM_BYTES_PER_S,
                         wd_flops / BF16_OPS_PER_S)
    elems = flat.numel()
    dec_ms = timer(lambda: kdec.decode(p_nbr, flat, B8, bits=8))
    dec_plain_ms = timer(lambda: kdec.decode_plain(p_nbr, flat, B8, bits=8))
    dec_bound = decode_bound_ms(elems, 8)
    print(f"time: flash_attention_tc {list(FLASH_MAIN)} bfloat16 causal, "
          f"{kv_main} KV blocks: kernel {fa_ms:.4f} ms "
          f"({fa_flops / fa_ms / 1e9:.1f} TFLOP/s of the algorithm's "
          f"{fa_flops / 1e9:.1f} GFLOP) | plain {fa_plain_ms:.4f} ms | "
          f"scaled_dot_product_attention (enable_gqa) {sdpa_ms:.4f} ms | "
          f"bound {fa_bound:.4f} ms (operations at "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s; bytes {fa_bytes / 1e6:.0f} "
          f"MB take {1e3 * fa_bytes / HBM_BYTES_PER_S:.4f} ms) {card}",
          flush=True)
    print(f"time: flash {list(FLASH_MAIN)} bfloat16 causal, {bh} KV blocks: "
          f"tensor-core kernel {tc48_ms:.4f} ms | CUDA-core kernel "
          f"{simt_bf16_ms:.4f} ms | scaled_dot_product_attention "
          f"{sdpa48_ms:.4f} ms {card}", flush=True)
    print(f"time: flash {list(FLASH_MAIN)} float32 causal, {bh} KV blocks: "
          f"flash_attention_f32tc (3xTF32 mma.sync) {f32tc_ms:.4f} ms | "
          f"flash_attention (CUDA cores) {simt_ms:.4f} ms | plain "
          f"{f32_plain_ms:.4f} ms | scaled_dot_product_attention "
          f"{sdpa32_ms:.4f} ms | bounds: 3xTF32 {f32tc_bound:.4f} ms "
          f"(operations x3 at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s TF32), "
          f"CUDA cores {simt_bound:.4f} ms (operations at "
          f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s float32) {card}", flush=True)
    print(f"time: flash [{bh}, {s_main}, {d64}] float32 causal, {bh} KV "
          f"blocks: flash_attention_f32tc {f32tc64_ms:.4f} ms | "
          f"flash_attention (CUDA cores) {simt64_ms:.4f} ms | "
          f"scaled_dot_product_attention {sdpa64_ms:.4f} ms | 3xTF32 bound "
          f"{f32tc64_bound:.4f} ms "
          f"{card}", flush=True)
    print(f"time: flash {list(FLASH_PHI)} bfloat16 causal (phi-3-vision-"
          f"4.2b's attention): flash_attention_tc {ph_ms:.4f} ms "
          f"({ph_flops / ph_ms / 1e9:.1f} TFLOP/s of the algorithm's "
          f"{ph_flops / 1e9:.1f} GFLOP) | flash_attention (CUDA cores) "
          f"{ph_simt_ms:.4f} ms | plain {ph_plain_ms:.4f} ms | "
          f"scaled_dot_product_attention {ph_sdpa_ms:.4f} ms | bound "
          f"{ph_bound:.4f} ms (operations at {BF16_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s bf16; {1e3 * ph_flops / F32_OPS_PER_S:.4f} ms at the "
          f"CUDA cores' {F32_OPS_PER_S / 1e12:.0f} TFLOP/s float32) {card}",
          flush=True)
    print(f"time: flash {list(FLASH_PHI)} float32 causal: "
          f"flash_attention_f32tc (3xTF32 mma.sync) {ph32_ms:.4f} ms | "
          f"flash_attention (CUDA cores) {ph32_simt_ms:.4f} ms | plain "
          f"{ph32_plain_ms:.4f} ms | scaled_dot_product_attention "
          f"{ph32_sdpa_ms:.4f} ms | 3xTF32 bound {ph32_bound:.4f} ms "
          f"(operations x3 at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s TF32) | "
          f"max abs vs plain {ph32_err:.4g} ({ph32_ratio:.3g} x tolerance) "
          f"{card}", flush=True)
    print(f"time: flash_attention (CUDA cores) on the route check "
          f"{list(FLASH_WIDE)} bfloat16 causal: kernel {wd_ms:.4f} ms "
          f"({wd_flops / wd_ms / 1e9:.1f} TFLOP/s) | plain {wd_plain_ms:.4f} "
          f"ms | scaled_dot_product_attention {wd_sdpa_ms:.4f} ms | bound "
          f"{wd_bound:.4f} ms (operations at {BF16_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s bf16; {1e3 * wd_flops / F32_OPS_PER_S:.4f} ms at the "
          f"CUDA cores' {F32_OPS_PER_S / 1e12:.0f} TFLOP/s float32) {card}",
          flush=True)
    print(f"time: moniqua_decode 8-bit remote {list(flat.shape)} float32: "
          f"kernel {dec_ms:.5f} ms | plain {dec_plain_ms:.5f} ms | bound "
          f"{dec_bound:.5f} ms (bytes) | library: no single PyTorch call "
          f"{card}", flush=True)
    return [
        dict(name="flash_attention_tc", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
             replaces="src/repro/kernels/flash_attention.py:130",
             launches=fa_launches,
             max_abs_err=main["bfloat16", kv_main][0], ms=fa_ms,
             plain_ms=fa_plain_ms, bound_ms=fa_bound, bound_by="operations",
             library_ms=sdpa_ms,
             # head dim 96 on its path, phase 7's phi-3-vision attention
             d96=dict(shape=list(FLASH_PHI),
                      launches=tc96_path["flash_attention_tc"],
                      max_abs_err=ph_err, ms=ph_ms, plain_ms=ph_plain_ms,
                      bound_ms=ph_bound, bound_by="operations",
                      library_ms=ph_sdpa_ms)),
        dict(name="flash_attention_f32tc", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_f32tc.cu",
             replaces="src/repro/kernels/flash_attention.py:130",
             launches=f32_launches["flash_attention_f32tc"],
             max_abs_err=main["float32", bh][0], ms=f32tc_ms,
             plain_ms=f32_plain_ms, bound_ms=f32tc_bound,
             bound_by="operations", library_ms=sdpa32_ms,
             # head dim 96 at phase 7's phi-3-vision shape (no float32 path)
             d96=dict(shape=list(FLASH_PHI), max_abs_err=ph32_err,
                      ms=ph32_ms, plain_ms=ph32_plain_ms,
                      bound_ms=ph32_bound, bound_by="operations",
                      library_ms=ph32_sdpa_ms)),
        # launches and times on phase 7's check of the CUDA-core route
        # (head dim 256, which no config has: a route check, not traffic);
        # head dim 96, which it served before, and float32 at the serving
        # shape kept beside as the earlier records
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:130",
             launches=simt_path["flash_attention_simt"],
             max_abs_err=wd_err, ms=wd_ms, plain_ms=wd_plain_ms,
             bound_ms=wd_bound, bound_by="operations",
             library_ms=wd_sdpa_ms,
             d96_record=dict(shape=list(FLASH_PHI), bfloat16_ms=ph_simt_ms,
                             float32_ms=ph32_simt_ms),
             float32_record=dict(shape=list(FLASH_MAIN), max_abs_err=simt_err,
                                 ms=simt_ms, plain_ms=f32_plain_ms,
                                 bound_ms=simt_bound, bound_by="operations",
                                 library_ms=sdpa32_ms)),
        dict(name="moniqua_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/moniqua_decode.cu",
             replaces="src/repro/kernels/moniqua_decode.py:68",
             launches=dec_launches, max_abs_err=dec_err, ms=dec_ms,
             plain_ms=dec_plain_ms, bound_ms=dec_bound, bound_by="bytes",
             library_ms=None),
    ]

# -- the other update rules, AD-PSGD, long rows -------------------------------

def rules_phase(dev, card, model, batches):
    """Phase 12: the paper's other update rules on the main path's model."""
    from repro_torch import tree
    from repro_torch.core import algorithms as talg
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc
    from repro_torch.train.trainer import Trainer, TrainerConfig

    runs = [("naive", {}), ("choco", dict(gamma=0.3)),
            ("deepsqueeze", dict(gamma=0.3)), ("dcd", {}), ("ecd", {}),
            ("d2", dict(slack=0.75)), ("moniqua_d2", dict(slack=0.75))]
    eps = torch.finfo(torch.float32).eps
    for name, kw in runs:
        tc = TrainerConfig(algo=name, topology="ring", n_workers=N_WORKERS,
                           bits=8, theta=2.0, lr=0.1, momentum=0.9,
                           weight_decay=5e-4, steps=STEPS, log_every=1,
                           seed=0, **kw)
        trainer = Trainer(model, tc, lambda k: batches[k])
        algo, hp = trainer.algo, trainer.hp
        torch.cuda.synchronize()
        kenc.encode.launches = kdr.decode_reduce.launches = 0
        out = trainer.run()
        torch.cuda.synchronize()
        launches = (kenc.encode.launches, kdr.decode_reduce.launches)
        losses = [h["loss"] for h in out["history"]]
        walls = [h["wall"] for h in out["history"]]
        step_ms = 1e3 * (walls[-1] - walls[0]) / (len(walls) - 1)
        check(all(map(math.isfinite, losses)), f"{name}: non-finite loss")
        want = (STEPS, STEPS) if name == "moniqua_d2" else (0, 0)
        check(launches == want, f"{name}: encode / decode-reduce launches "
              f"{launches}, want {want}")
        state = out["state"]
        X = state["params"]
        Xc = tree.map(lambda a: a.cpu(), X)
        mem = algo.extra_memory_bytes(X, hp)
        check(out["bytes_per_step"] == algo.bytes_per_step(Xc, hp)
              and mem == algo.extra_memory_bytes(Xc, hp),
              f"{name}: byte accounting differs between card and CPU")
        # one step on the card and on the CPU from the same state
        gen = torch.Generator().manual_seed(21)
        g_cpu = tree.map(lambda a: 0.01 * torch.randn(a.shape, generator=gen),
                         Xc)
        u_cpu = talg.draw_uniforms(Xc, 5)
        extra_cpu = tree.map(lambda a: a.cpu(), state["extra"])
        got = algo.step(X, state["extra"], tree.map(lambda a: a.to(dev), g_cpu),
                        0.1, STEPS, 12345, hp,
                        uniforms=tree.map(lambda a: a.to(dev), u_cpu))
        ref = algo.step(Xc, extra_cpu, g_cpu, 0.1, STEPS, 12345, hp,
                        uniforms=u_cpu)
        err = 0.0
        for a, b in zip(tree.leaves(got), tree.leaves(ref)):
            a = a.cpu()
            if name == "moniqua_d2":
                check(torch.equal(a, b), f"{name}: card step != CPU step")
            d = float((a.float() - b.float()).abs().max()) if a.numel() else 0
            err = max(err, d)
            tol = RULE_ULPS * eps * max(1.0, float(b.abs().max()))
            check(d <= tol, f"{name}: card step vs CPU {d:.3g} > {tol:.3g}")
        print(f"run {name} (ResNet-20 w16, n={N_WORKERS}, {tc.topology}"
              f"{'-slack' + str(tc.slack) if tc.slack < 1 else ''}, 8 bits"
              f"{', gamma ' + str(tc.gamma) if 'gamma' in kw else ''}): "
              f"losses {[round(v, 4) for v in losses]} | encode / "
              f"decode-reduce launches {launches} | bytes/step "
              f"{out['bytes_per_step']} | extra memory {mem} bytes/worker | "
              f"one step card vs CPU max abs {err:.3g}"
              f"{' (bitwise)' if name == 'moniqua_d2' else ''}", flush=True)
        print(f"time: step {name} (ResNet-20 w16, n={N_WORKERS}, {IMAGES} "
              f"images/worker, mean of steps 1-{STEPS - 1}) {step_ms:.3f} ms "
              f"{card}", flush=True)
        if name == "dcd":       # the slowest rule: host launches or device?
            profile_device(lambda: trainer.step_fn(state, batches[0]),
                           "one dcd step", card)
        del trainer, out, state, X, got, ref
        torch.cuda.empty_cache()
    print(f"phase 12: {len(runs)} update rules ran {STEPS} steps each on the "
          f"main path's model; moniqua_d2 one encode and one decode-reduce a "
          f"step, its step bitwise card vs CPU; the rest within {RULE_ULPS} "
          f"ulp", flush=True)


def bucket_grad(model, batches, lay1):
    """``(grad, calls)``: ``grad(x, i, _)`` is worker i's ResNet-20 loss
    gradient at the flat bucket row ``x`` (its model, through the bucket
    layout ``lay1`` of one worker) on its part of batch ``calls[0]`` (mod
    the batches), and counts the call."""
    from repro_torch import tree
    loss_grad = torch.func.grad_and_value(model.loss)
    calls = [0]

    def grad(x, i, _):
        params = tree.map(lambda a: a[0], lay1.unflatten(x[None]))
        b = batches[calls[0] % len(batches)]
        g, _ = loss_grad(params, {key: v[i] for key, v in b.items()})
        calls[0] += 1
        return lay1.flatten(tree.map(lambda a: a[None], g))[0]
    return grad, calls


def adpsgd_phase(dev, timer, card, model, batches, X_cpu):
    """Phase 13: Moniqua on AD-PSGD on the ResNet-20 bucket; returns the
    point decode's kernels-line entry on this path."""
    from repro_torch import tree
    from repro_torch.comm.engine import CommEngine, MoniquaWire
    from repro_torch.core import adpsgd, modulo
    from repro_torch.core.moniqua import MoniquaCodec
    from repro_torch.core.quantizers import QuantSpec, delta_for_bits
    from repro_torch.core.topology import ring
    from repro_torch.data.synthetic import quadratic_grad
    from repro_torch.kernels import moniqua_decode as kdec
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc
    from repro_torch.kernels import ops

    spec8 = QuantSpec(8)
    eng = CommEngine(ring(N_WORKERS), MoniquaWire(spec8))
    p0 = model.init(torch.Generator().manual_seed(0))
    X0 = tree.map(lambda a: a[None].expand((N_WORKERS,) + a.shape), p0)
    lay = eng.layout(X0)
    lay1 = eng.layout(tree.map(lambda a: a[:1], X0))
    x0 = lay.flatten(X0)                          # [8, 272282], identical rows
    D = x0.shape[1]
    resnet_grad, calls = bucket_grad(model, batches, lay1)

    def mean_loss(X):
        params = tree.map(lambda a: a[0], lay1.unflatten(X.mean(0)[None]))
        return float(model.loss(params, {key: v[0] for key, v in
                                         batches[0].items()}))

    cfg = adpsgd.ADPSGDConfig(topo=ring(N_WORKERS), codec=MoniquaCodec(spec8),
                              theta=2.0, max_delay=ADPSGD_DELAY,
                              quantized=True)
    sched = adpsgd.make_schedule(N_WORKERS, ADPSGD_ITERS, cfg, seed=0)
    res = {}
    for wire, c in (("moniqua", cfg),
                    ("full", dataclasses.replace(cfg, quantized=False))):
        calls[0] = 0
        torch.cuda.synchronize()
        kenc.encode.launches = kdec.decode.launches = 0
        kdr.decode_reduce.launches = 0
        t0 = time.perf_counter()
        Xf, trace = adpsgd.run(x0, resnet_grad, 0.1, ADPSGD_ITERS, c,
                               schedule=sched)
        torch.cuda.synchronize()
        it_ms = 1e3 * (time.perf_counter() - t0) / ADPSGD_ITERS
        launches = (kenc.encode.launches, kdec.decode.launches,
                    kdr.decode_reduce.launches)
        want = ((ADPSGD_ITERS, 2 * ADPSGD_ITERS, 0) if wire == "moniqua"
                else (0, 0, 0))
        check(launches == want, f"AD-PSGD {wire}: encode / point decode / "
              f"decode-reduce launches {launches}, want {want}")
        check(bool(torch.isfinite(Xf).all()), f"AD-PSGD {wire}: not finite")
        check(calls[0] == ADPSGD_ITERS, f"AD-PSGD {wire}: {calls[0]} grads")
        res[wire] = (Xf, it_ms, launches, mean_loss(Xf))
        print(f"run adpsgd-{wire} ({list(x0.shape)}, ring({N_WORKERS}), max "
              f"delay {ADPSGD_DELAY}, {ADPSGD_ITERS} iterations): launches "
              f"encode / point decode / decode-reduce {launches}; mean-model "
              f"loss {mean_loss(x0):.4f} -> {res[wire][3]:.4f}", flush=True)
        print(f"time: AD-PSGD {wire} wire, ResNet-20 gradient an "
              f"iteration, host clock {it_ms:.3f} ms per iteration (mean of "
              f"{ADPSGD_ITERS}) {card}", flush=True)
    gap = float((res["moniqua"][0] - res["full"][0]).abs().max())
    five = {k: v[:5] for k, v in sched.items()}
    profile_device(lambda: adpsgd.run(x0, resnet_grad, 0.1, 5, cfg,
                                      schedule=five),
                   "5 AD-PSGD moniqua iterations", card)
    # the first exchanges, card against CPU: perturbed ResNet-20 models, a
    # quadratic gradient with handed-in noise (elementwise), the same
    # schedule's first entries
    lay_c = eng.layout(X_cpu)
    xp_cpu = lay_c.flatten(X_cpu)
    gen = torch.Generator().manual_seed(13)
    first = {k: v[:ADPSGD_CHECK] for k, v in sched.items()}
    noise_cpu = torch.randn((ADPSGD_CHECK, D), generator=gen)

    def quad(x, i, noise):
        return quadratic_grad(x, 0.2, noise, 0.05)
    x_card, _ = adpsgd.run(xp_cpu.to(dev), quad, 0.1, ADPSGD_CHECK, cfg,
                           schedule=dict(first, noise=noise_cpu.to(dev)))
    x_host, _ = adpsgd.run(xp_cpu, quad, 0.1, ADPSGD_CHECK, cfg,
                           schedule=dict(first, noise=noise_cpu))
    check(torch.equal(x_card.cpu(), x_host),
          f"AD-PSGD first {ADPSGD_CHECK} exchanges card != CPU")
    # the point decode at the exchange's shape [2, 272282]
    B8 = modulo.b_theta(2.0, delta_for_bits(8, True), dev)
    pair = x_card[:2].contiguous()
    p2 = ops.moniqua_encode_stacked(pair, B8, spec8, 7)
    p2f = p2.flip(0).contiguous()
    got = kdec.decode(p2f, pair, B8, bits=8)
    plain = kdec.decode_plain(p2f, pair, B8, bits=8)
    dec_err = float((got - plain).abs().max())
    check(dec_err == 0, "point decode at the exchange's shape != plain")
    dec_ms = timer(lambda: kdec.decode(p2f, pair, B8, bits=8))
    dec_plain_ms = timer(lambda: kdec.decode_plain(p2f, pair, B8, bits=8))
    elems = pair.numel()
    dec_bound = decode_bound_ms(elems, 8)
    print(f"time: moniqua_decode 8-bit remote {list(pair.shape)} float32 (an "
          f"AD-PSGD exchange): kernel {dec_ms:.5f} ms | plain "
          f"{dec_plain_ms:.5f} ms | bound {dec_bound:.5f} ms (bytes) | "
          f"library: no single PyTorch call {card}", flush=True)
    print(f"phase 13: Moniqua on AD-PSGD, {ADPSGD_ITERS} exchanges: "
          f"{res['moniqua'][2][0]} encode and {res['moniqua'][2][1]} point "
          f"decode launches (1 and 2 an exchange); the full wire on the same "
          f"schedule: none; max |X_moniqua - X_full| {gap:.4g}; the first "
          f"{ADPSGD_CHECK} exchanges card == CPU bitwise", flush=True)
    return dict(name="moniqua_decode", route="cuda",
                source="src/repro_torch/kernels/csrc/moniqua_decode.cu",
                replaces="src/repro/kernels/moniqua_decode.py:68",
                launches=res["moniqua"][2][1], max_abs_err=dec_err,
                ms=dec_ms, plain_ms=dec_plain_ms, bound_ms=dec_bound,
                bound_by="bytes", library_ms=None)


def split_phase(dev, card):
    """Phase 14: a row of 2^31 + 4100 columns through the three codec
    kernels."""
    from repro_torch.core import modulo
    from repro_torch.core.quantizers import QuantSpec, delta_for_bits
    from repro_torch.kernels import moniqua_decode as kdec
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc
    from repro_torch.kernels import ops

    cols = SPLIT_COLS
    gen = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((1, cols), generator=gen, device=dev) * 3.0
    base = 2 ** 32 - cols // 2        # the counter wraps mid-row
    win = SPLIT_WIN
    weights = (1.0 / 3.0, 1.0 / 3.0)
    t0 = time.perf_counter()
    for bits in (8, 1):
        spec = QuantSpec(bits, True)
        vpb = spec.values_per_byte
        B = (torch.tensor(0.7, device=dev) if bits == 1 else
             modulo.b_theta(2.0, delta_for_bits(bits, True), dev))
        n_win = len(ops._windows(cols, vpb))
        torch.cuda.synchronize()
        kenc.encode.launches = kdr.decode_reduce.launches = 0
        kdec.decode.launches = 0
        p = ops.moniqua_encode_stacked(x, B, spec, 99, idx_base=base)
        pn = torch.randint(0, 256, (2,) + tuple(p.shape), generator=gen,
                           device=dev, dtype=torch.uint8)
        out = ops.moniqua_decode_reduce_stacked(p, pn, x, B, weights, spec)
        torch.cuda.synchronize()
        xr = ops.moniqua_decode_remote(pn[0], x, B, spec)
        torch.cuda.synchronize()
        launches = (kenc.encode.launches, kdr.decode_reduce.launches,
                    kdec.decode.launches)
        check(launches == (n_win,) * 3 and n_win > 1,
              f"split row {bits}-bit: launches {launches}, want {n_win} "
              f"each (> 1)")
        split = ops._windows(cols, vpb)[1][0]
        wrap = 2 ** 32 - base

        def around(c):
            """``win`` columns (fewer at the row's end) from a multiple of
            vpb at or before ``c - win / 2``."""
            a = max(0, (c - win // 2) // vpb * vpb)
            return a, min(a + win, cols)
        spots = {"start": (0, win), "split": around(split),
                 "wrap": around(wrap), "end": around(cols)}
        for where, (a, b) in spots.items():
            pw = slice(a // vpb, -(-b // vpb))
            xa = x[:, a:b].reshape(1, 1, b - a).contiguous()
            want_p = kenc.encode_plain(xa, B, 99, bits=bits, stochastic=True,
                                       idx_base=(base + a) % 2 ** 32)
            check(torch.equal(p[:, pw].reshape(want_p.shape), want_p),
                  f"split row {bits}-bit encode != plain at the {where}")
            want_o = kdr.decode_reduce_plain(
                p[:, pw].reshape(1, 1, -1).contiguous(),
                pn[:, :, pw].reshape(2, 1, 1, -1).contiguous(), xa, B,
                bits=bits, weights=weights)
            check(torch.equal(out[:, a:b].reshape(want_o.shape), want_o),
                  f"split row {bits}-bit decode-reduce != plain at the "
                  f"{where}")
            want_r = kdec.decode_plain(pn[0, :, pw].contiguous(),
                                       x[:, a:b].contiguous(), B, bits=bits)
            check(torch.equal(xr[:, a:b], want_r),
                  f"split row {bits}-bit point decode != plain at the "
                  f"{where}")
        del p, pn, out, xr
        torch.cuda.empty_cache()
    print(f"phase 14: a [1, {cols}] float32 row ("
          f"{x.numel() * 4 / 1e9:.2f} GB), counter base {base} (wraps at "
          f"column {2 ** 32 - base}): encode, decode-reduce and the point "
          f"decode in {n_win} launches each at 8 and 1 bit, bitwise equal to "
          f"the plain version on "
          f"{win}-column windows at the start, across the split, across the "
          f"wrap and at the end ({time.perf_counter() - t0:.1f} s) {card}",
          flush=True)
    del x
    torch.cuda.empty_cache()


# -- the staged round, stale overlap and the other wires ----------------------

# phase 15's wires (wire, bits): the matrix of tests/test_overlap.py
STAGED_WIRES = (("full", 32), ("moniqua", 8), ("moniqua", 1), ("qsgd", 8),
                ("ef_qsgd", 4), ("onebit", 1))
STAGED_KS = (1, 2, 5, 61)       # 61: one chunk a leaf of ResNet-20
STAGED_ROUNDS = 3               # onebit's warmup of 2 switches in round 3
# phase 16's bytes per step and extra memory per worker, from the
# reference's CommEngine on ResNet-20 and ring(8)
WIRE_BYTES = {"moniqua": (544564, 0), "qsgd": (545052, 0),
              "ef_qsgd": (545052, 1089132), "onebit": (69144, 1090692)}


def _kernel_launches(prof) -> tuple:
    """(encode, decode-reduce) kernels the profiler saw on the card."""
    n = {"encode_kernel": 0, "decode_reduce_kernel": 0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for k in n:
                if k in e.key:
                    n[k] += e.count
    return n["encode_kernel"], n["decode_reduce_kernel"]


def staged_phase(dev, card, X_cpu):
    """Phase 15: the staged round at K chunks on every wire, and
    ``mix_stale``, on the ResNet-20 bucket."""
    from repro_torch import tree
    from repro_torch.comm.engine import CommEngine, MoniquaWire, make_wire
    from repro_torch.core.quantizers import QuantSpec
    from repro_torch.core.topology import exponential, ring
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc

    X = tree.map(lambda a: a.to(dev), X_cpu)
    eps = torch.finfo(torch.float32).eps
    t0 = time.perf_counter()
    cases = [(w, b, ring) for w, b in STAGED_WIRES]
    cases.append(("moniqua", 8, exponential))
    for wire, bits, topo_fn in cases:
        spec = QuantSpec(min(bits, 8), 1 < bits <= 8)
        what = f"{wire} {bits}-bit on {topo_fn.__name__}({N_WORKERS})"

        def engine(K):
            return CommEngine(topo_fn(N_WORKERS),
                              make_wire(wire, spec, warmup=2), chunks=K)

        def kw(k):
            if wire == "full":
                return {}
            return dict(seed=500 + k, **({"theta": 2.0}
                                         if wire == "moniqua" else {}))

        def rounds(eng, X0):
            Xk = X0
            st = eng.init_wire_state(X0) if eng.stateful else None
            out = []
            for k in range(STAGED_ROUNDS):
                r = eng.mix(Xk, state=st, **kw(k))
                Xk, st = r.x, (r.state if eng.stateful else None)
                out.append((tree.leaves(Xk), st))
            return out

        card_rounds = {K: rounds(engine(K), X) for K in STAGED_KS}
        for K in STAGED_KS[1:]:
            for k, ((xa, sa), (xb, sb)) in enumerate(zip(card_rounds[1],
                                                         card_rounds[K])):
                check(all(torch.equal(a, b) for a, b in zip(xa, xb)),
                      f"{what}: K={K} round {k} != K=1 (card)")
                if sa is not None:
                    check(torch.equal(sa["residual"], sb["residual"])
                          and torch.equal(sa["step"], sb["step"]),
                          f"{what}: K={K} round {k} WireState != K=1")
        err = 0.0
        for k, ((xa, sa), (xc, sc)) in enumerate(zip(
                card_rounds[1], rounds(engine(1), X_cpu))):
            pairs = list(zip(xa, xc))
            if sa is not None:
                pairs.append((sa["residual"], sc["residual"]))
                check(int(sa["step"]) == int(sc["step"]) == k + 1,
                      f"{what}: step counter")
            for a, b in pairs:
                a = a.cpu()
                if wire in ("full", "moniqua"):
                    check(torch.equal(a, b), f"{what}: round {k} card != "
                          f"CPU")
                    continue
                d = float((a.float() - b.float()).abs().max())
                tol = RULE_ULPS * eps * max(1.0, float(b.abs().max()))
                check(d <= tol, f"{what}: round {k} card vs CPU {d:.3g} > "
                      f"{tol:.3g}")
                err = max(err, d)
        times = []
        for K in STAGED_KS:
            eng = engine(K)
            st = eng.init_wire_state(X) if eng.stateful else None
            if wire == "moniqua":
                torch.cuda.synchronize()
                kenc.encode.launches = kdr.decode_reduce.launches = 0
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    eng.mix(X, **kw(0))
                    torch.cuda.synchronize()
                n = eng.round_plan(X, **kw(0)).num_chunks
                check((kenc.encode.launches, kdr.decode_reduce.launches)
                      == (n, n) and n == min(K, 61),
                      f"{what}: K={K} launches "
                      f"{(kenc.encode.launches, kdr.decode_reduce.launches)}")
                seen = _kernel_launches(prof)
                if seen == (0, 0):
                    print(f"  profile: {what} K={K}: no device kernels "
                          f"recorded (not measured)")
                else:
                    check(seen == (n, n), f"{what}: K={K} profiler saw "
                          f"{seen} encode / decode-reduce kernels")
            times.append(host_ms(lambda: eng.mix(X, state=st, **kw(0)),
                                 reps=10))
        print(f"time: one {what} round of the ResNet-20 bucket, host clock, "
              + ", ".join(f"K={K} {t:.3f} ms"
                          for K, t in zip(STAGED_KS, times))
              + f" | card vs CPU at K=1 "
              + ("bitwise" if wire in ("full", "moniqua")
                 else f"max abs {err:.3g}") + f" {card}", flush=True)
    # one-round-stale overlap: 3 rounds, card against CPU
    eng = CommEngine(ring(N_WORKERS), MoniquaWire(QuantSpec(8)))
    Xg, Xc = X, X_cpu
    cg, cc = eng.init_gossip_carry(X), eng.init_gossip_carry(X_cpu)
    check(all(t.device == dev for t in cg.values()),
          "stale carry not on the card")
    torch.cuda.synchronize()
    kenc.encode.launches = kdr.decode_reduce.launches = 0
    card_rounds = []
    for k in range(STAGED_ROUNDS):
        rg = eng.mix_stale(Xg, cg, theta=2.0, seed=700 + k)
        Xg, cg = rg.x, rg.state
        card_rounds.append(rg)
    torch.cuda.synchronize()
    stale_launches = (kenc.encode.launches, kdr.decode_reduce.launches)
    check(stale_launches == (STAGED_ROUNDS, STAGED_ROUNDS),
          f"mix_stale launches {stale_launches}")
    check(all(torch.equal(a, b) for a, b in zip(
        tree.leaves(card_rounds[0].x), tree.leaves(X))),
        "mix_stale round 1 moved the model")
    for k, rg in enumerate(card_rounds):
        rc = eng.mix_stale(Xc, cc, theta=2.0, seed=700 + k)
        Xc, cc = rc.x, rc.state
        check(all(torch.equal(a.cpu(), b) for a, b in zip(
            tree.leaves(rg.x), tree.leaves(rc.x))),
            f"mix_stale round {k}: card != CPU")
        for name in ("packed", "ref", "B", "valid"):
            check(torch.equal(rg.state[name].cpu(), rc.state[name]),
                  f"mix_stale round {k}: carry {name} card != CPU")
    stale_ms = host_ms(lambda: eng.mix_stale(Xg, cg, theta=2.0, seed=1),
                       reps=10)
    print(f"time: one mix_stale of the ResNet-20 bucket (8-bit, ring), host "
          f"clock {stale_ms:.3f} ms {card}", flush=True)
    print(f"phase 15: staged rounds on the ResNet-20 bucket: {len(cases)} "
          f"wire cases x K in {list(STAGED_KS)}, {STAGED_ROUNDS} rounds, "
          f"K chunks == K=1 bitwise (WireState too), card == CPU at K=1 "
          f"(full, moniqua bitwise; qsgd, ef_qsgd, onebit within "
          f"{RULE_ULPS} ulp), K encode + K decode-reduce launches a Moniqua "
          f"round; mix_stale 3 rounds card == CPU bitwise, one launch each a "
          f"round, round 1 the model ({time.perf_counter() - t0:.1f} s) "
          f"{card}", flush=True)


def wires_phase(dev, card, model, batches):
    """Phase 16: Trainer.run on the new schedules and wires, and resume."""
    import shutil

    from repro_torch import tree
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    base = dict(algo="moniqua", topology="ring", n_workers=N_WORKERS,
                theta=2.0, lr=0.1, momentum=0.9, weight_decay=5e-4,
                steps=STEPS, log_every=1, seed=0)
    # The bitwise run-against-run checks below need deterministic
    # gradients: by default cuDNN may pick a convolution backward whose
    # sums run in another order from one run to the next (phase 4's
    # moniqua-8bit losses and this phase's barrier run part in the 4th
    # digit after 4 steps).  The gossip itself is bitwise (phase 15).
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)

    def run(name, kw, want_launches):
        trainer = Trainer(model, TrainerConfig(**base, **kw),
                          lambda k: batches[k])
        torch.cuda.synchronize()
        kenc.encode.launches = kdr.decode_reduce.launches = 0
        out = trainer.run()
        torch.cuda.synchronize()
        launches = (kenc.encode.launches, kdr.decode_reduce.launches)
        losses = [h["loss"] for h in out["history"]]
        walls = [h["wall"] for h in out["history"]]
        step_ms = 1e3 * (walls[-1] - walls[0]) / (len(walls) - 1)
        check(all(map(math.isfinite, losses)), f"{name}: non-finite loss")
        check(launches == want_launches, f"{name}: encode / decode-reduce "
              f"launches {launches}, want {want_launches}")
        X = out["state"]["params"]
        wire = kw.get("wire", "moniqua")
        mem = trainer.algo.extra_memory_bytes(X, trainer.hp)
        check((out["bytes_per_step"], mem) == WIRE_BYTES[wire],
              f"{name}: bytes/step, memory {(out['bytes_per_step'], mem)} "
              f"!= {WIRE_BYTES[wire]}")
        print(f"run {name}: losses {[round(v, 4) for v in losses]} | "
              f"launches {launches} | bytes/step {out['bytes_per_step']} | "
              f"extra memory {mem} bytes/worker", flush=True)
        print(f"time: step {name} (ResNet-20 w16, n={N_WORKERS}, {IMAGES} "
              f"images/worker, mean of steps 1-{STEPS - 1}) {step_ms:.3f} ms "
              f"{card}", flush=True)
        return trainer, out, losses

    S = STEPS
    tr, barrier, _ = run("moniqua-8bit chunks=1", dict(bits=8), (S, S))
    profile_device(lambda: tr.step_fn(barrier["state"], batches[0]),
                   "one moniqua-8bit chunks=1 step", card)
    tr, chunked, _ = run("moniqua-8bit chunks=4", dict(bits=8, chunks=4),
                         (4 * S, 4 * S))
    check(all(torch.equal(a, b) for a, b in zip(
        tree.leaves(barrier["state"]["params"]),
        tree.leaves(chunked["state"]["params"]))),
        "chunks=4 params != chunks=1 params after 10 steps")
    profile_device(lambda: tr.step_fn(chunked["state"], batches[0]),
                   "one moniqua-8bit chunks=4 step", card)
    stale = []
    for rep in range(2):
        tr, out, losses = run(f"moniqua-8bit stale (run {rep + 1})",
                              dict(bits=8, overlap="stale"), (S, S))
        check(losses[-1] < losses[0], "stale: loss did not fall")
        stale.append(out)
    check(all(torch.equal(a, b) for a, b in zip(
        tree.leaves(stale[0]["state"]["params"]),
        tree.leaves(stale[1]["state"]["params"]))),
        "two stale runs differ")
    profile_device(lambda: tr.step_fn(stale[0]["state"], batches[0]),
                   "one moniqua-8bit stale step", card)
    ckdir = os.path.join(ROOT, "build", "ckpt")
    wires = (("qsgd-8bit", dict(wire="qsgd", bits=8)),
             ("ef_qsgd-8bit", dict(wire="ef_qsgd", bits=8)),
             ("onebit warmup 4", dict(wire="onebit", bits=1, warmup=4)))

    def resume_check(name, kw, full_state):
        """``cut`` steps, checkpoint, restore, the rest == STEPS steps
        uninterrupted.  onebit is cut at its warmup: the checkpoint holds
        the last warm round's state and the resumed leg crosses the
        switch."""
        cut = min(kw.get("warmup", STEPS // 2), STEPS // 2)
        path = os.path.join(ckdir, kw["wire"])
        first = dict(kw, steps=cut, checkpoint_path=path,
                     checkpoint_every=cut)
        Trainer(model, TrainerConfig(**dict(base, **first)),
                lambda k: batches[k]).run()
        resumer = Trainer(model, TrainerConfig(**dict(
            base, **kw, steps=STEPS - cut, checkpoint_path=path)),
            lambda k: batches[k])
        state = resumer.restore_state()
        check(state["step"] == cut
              and int(state["extra"]["wire"]["step"]) == cut
              and state["extra"]["wire"]["residual"].device == dev,
              f"{name}: restored state")
        resumed = resumer.run(state)["state"]
        a_l, a_t = tree.flatten(full_state)
        b_l, b_t = tree.flatten(resumed)
        check(a_t == b_t, f"{name}: resumed state tree differs")
        for a, b in zip(a_l, b_l):
            if isinstance(a, torch.Generator):
                same = torch.equal(a.get_state(), b.get_state())
            elif isinstance(a, torch.Tensor):
                same = a.dtype == b.dtype and torch.equal(a, b)
            else:
                same = a == b
            check(same, f"{name}: {cut} + checkpoint + {STEPS - cut} "
                  f"steps != {STEPS} steps")
        print(f"resume {name}: {cut} steps, checkpoint, restore, "
              f"{STEPS - cut} more == {STEPS} uninterrupted steps, bitwise "
              f"(params, momentum, WireState, step, generator)", flush=True)

    for name, kw in wires:
        tr, full, _ = run(name, kw, (0, 0))
        if kw["wire"] != "qsgd":
            resume_check(name, kw, full["state"])
        # after the resume check: a step draws from the state's generator
        profile_device(lambda: tr.step_fn(full["state"], batches[0]),
                       f"one {name} step", card)
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False

    print(f"phase 16: Trainer.run on the main path's model: chunks=4 == "
          f"chunks=1 bitwise, two stale runs bitwise with falling losses, "
          f"qsgd / ef_qsgd / onebit finite, bytes and extra memory equal to "
          f"the reference's, ef_qsgd and onebit resumed bitwise "
          f"({time.perf_counter() - t0:.1f} s) {card}", flush=True)


# -- elastic rounds and the simulator -----------------------------------------

# phase 17's masks: workers 2 and 5 absent on the ring, worker 3 on
# exponential(8) (m = 2 and 5 neighbour offsets)
ELASTIC_MASKS = (("ring", (1, 1, 0, 1, 1, 0, 1, 1)),
                 ("exponential", (1, 1, 1, 0, 1, 1, 1, 1)))
ELASTIC_KS = (1, 5)
# the wires whose per-leaf round hashes the bucket's global indices, so it
# is bitwise the bucketed round (qsgd's per-leaf round hashes a seed per
# leaf; the masked full wire's two paths add the gated diffs in different
# orders, in the reference too)
PATH_BITWISE = ("moniqua", "ef_qsgd", "onebit")
# phase 18: churn-ring (n = 8) under a round deadline, rounds replayed;
# the trainer's mask; the AD-PSGD replay's updates and its card-vs-CPU
# prefix
SIM_ROUNDS, SIM_DEADLINE = 20, 0.054
TRAIN_MASK = (1, 1, 0, 1, 1, 0, 1, 1)
REPLAY_UPDATES, REPLAY_CHECK = 200, 8


def _same_rounds(a, b) -> bool:
    """Every round's leaves and WireState bitwise."""
    for (xa, sa), (xb, sb) in zip(a, b):
        if not all(torch.equal(u, v) for u, v in zip(xa, xb)):
            return False
        if sa is not None and not (torch.equal(sa["residual"], sb["residual"])
                                   and torch.equal(sa["step"], sb["step"])):
            return False
    return len(a) == len(b)


def elastic_phase(dev, card, X_cpu):
    """Phase 17: masked rounds on every wire, both paths and chunk counts,
    and masked ``mix_stale``, on the ResNet-20 bucket; returns the counted
    masked Moniqua rounds' launches by kernels-line entry."""
    from repro_torch import tree
    from repro_torch.comm.engine import CommEngine, MoniquaWire, make_wire
    from repro_torch.core.quantizers import QuantSpec
    from repro_torch.core.topology import exponential, ring
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc

    X = tree.map(lambda a: a.to(dev), X_cpu)
    topos = {"ring": ring, "exponential": exponential}
    eps = torch.finfo(torch.float32).eps
    t0 = time.perf_counter()
    n_cases = 0
    for wire, bits in STAGED_WIRES:
        spec = QuantSpec(min(bits, 8), 1 < bits <= 8)

        def engine(topo, path="bucketed", K=1):
            return CommEngine(topos[topo](N_WORKERS),
                              make_wire(wire, spec, warmup=2), path=path,
                              chunks=K)

        def kw(k):
            if wire == "full":
                return {}
            return dict(seed=900 + k, **({"theta": 2.0}
                                         if wire == "moniqua" else {}))

        def rounds(eng, X0, presence):
            Xk = X0
            st = eng.init_wire_state(X0) if eng.stateful else None
            out = []
            for k in range(STAGED_ROUNDS):
                r = eng.mix(Xk, state=st, presence=presence, **kw(k))
                Xk, st = r.x, (r.state if eng.stateful else None)
                out.append((tree.leaves(Xk), st))
            return out

        what = f"{wire} {bits}-bit"
        # full presence: all-ones is the unmasked round, bit for bit
        for path in ("bucketed", "per_leaf"):
            for K in ELASTIC_KS:
                eng = engine("ring", path, K)
                check(_same_rounds(rounds(eng, X, None),
                                   rounds(eng, X, (1,) * N_WORKERS)),
                      f"{what} {path} K={K}: all-ones presence != None")
                n_cases += 1
        for topo, mask in ELASTIC_MASKS:
            wt = f"{what} on {topo}({N_WORKERS}) mask {mask}"
            absent = [i for i in range(N_WORKERS) if not mask[i]]
            eng = engine(topo)
            card1 = rounds(eng, X, mask)
            prev = (tree.leaves(X),
                    eng.init_wire_state(X) if eng.stateful else None)
            for k, (xs, st) in enumerate(card1):
                check(all(torch.equal(a[i], b[i]) for a, b in zip(xs, prev[0])
                          for i in absent),
                      f"{wt}: round {k} moved an absent worker's model")
                if st is not None:
                    check(int(st["step"]) == k + 1, f"{wt}: step counter")
                    check(all(torch.equal(st["residual"][i],
                                          prev[1]["residual"][i])
                              for i in absent),
                          f"{wt}: round {k} moved an absent residual")
                prev = (xs, st)
            check(_same_rounds(card1, rounds(engine(topo, K=5), X, mask)),
                  f"{wt}: K=5 != K=1")
            leaf = rounds(engine(topo, "per_leaf"), X, mask)
            if wire in PATH_BITWISE:
                check(_same_rounds(card1, leaf),
                      f"{wt}: per-leaf != bucketed")
            pairs = [(card1, rounds(engine(topo), X_cpu, mask))]
            if wire not in PATH_BITWISE:
                pairs.append((leaf, rounds(engine(topo, "per_leaf"), X_cpu,
                                           mask)))
            err = 0.0
            for got, cpu in pairs:
                for k, ((xg, sg), (xc, sc)) in enumerate(zip(got, cpu)):
                    ts = list(zip(xg, xc))
                    if sg is not None:
                        ts.append((sg["residual"], sc["residual"]))
                    for a, b in ts:
                        a = a.cpu()
                        if wire != "onebit":
                            check(torch.equal(a, b),
                                  f"{wt}: round {k} card != CPU")
                            continue
                        d = float((a - b).abs().max())
                        tol = RULE_ULPS * eps * max(1.0,
                                                    float(b.abs().max()))
                        check(d <= tol, f"{wt}: round {k} card vs CPU "
                              f"{d:.3g} > {tol:.3g}")
                        err = max(err, d)
            if wire == "full":
                for a, b in zip(card1[0][0], tree.leaves(X)):
                    d = float((a.mean(0) - b.mean(0)).abs().max())
                    check(d <= 1e-6, f"{wt}: worker mean moved by {d:.3g}")
            n_cases += 1
            if wire == "onebit":
                print(f"  {wt}: card vs CPU max abs {err:.3g}", flush=True)
    # masked mix_stale: 3 rounds card == CPU, carry included
    eng8 = {t: CommEngine(topos[t](N_WORKERS), MoniquaWire(QuantSpec(8)))
            for t in topos}
    for topo, mask in ELASTIC_MASKS:
        eng = eng8[topo]
        Xg, Xc = X, X_cpu
        cg, cc = eng.init_gossip_carry(X), eng.init_gossip_carry(X_cpu)
        for k in range(STAGED_ROUNDS):
            rg = eng.mix_stale(Xg, cg, theta=2.0, seed=950 + k,
                               presence=mask)
            rc = eng.mix_stale(Xc, cc, theta=2.0, seed=950 + k,
                               presence=mask)
            Xg, cg, Xc, cc = rg.x, rg.state, rc.x, rc.state
            check(all(torch.equal(a.cpu(), b) for a, b in zip(
                tree.leaves(Xg), tree.leaves(Xc))),
                f"masked mix_stale on {topo} round {k}: card != CPU")
            for name in ("packed", "ref", "B", "valid"):
                check(torch.equal(cg[name].cpu(), cc[name]),
                      f"masked mix_stale on {topo} round {k}: carry {name}")
    # launches of a masked Moniqua round: K encodes, K * m decode-reduces
    counted = {"moniqua_encode": 0, "moniqua_decode_reduce": 0}
    for topo, mask in ELASTIC_MASKS:
        m = len(topos[topo](N_WORKERS).neighbor_offsets())
        for K in ELASTIC_KS:
            eng = CommEngine(topos[topo](N_WORKERS), MoniquaWire(QuantSpec(8)),
                             chunks=K)
            torch.cuda.synchronize()
            kenc.encode.launches = kdr.decode_reduce.launches = 0
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                eng.mix(X, theta=2.0, seed=1, presence=mask)
                torch.cuda.synchronize()
            got = (kenc.encode.launches, kdr.decode_reduce.launches)
            counted["moniqua_encode"] += got[0]
            counted["moniqua_decode_reduce"] += got[1]
            check(got == (K, K * m), f"masked moniqua round on {topo} K={K}:"
                  f" encode / decode-reduce launches {got}, want "
                  f"{(K, K * m)}")
            seen = _kernel_launches(prof)
            if seen == (0, 0):
                print(f"  profile: masked round on {topo} K={K}: no device "
                      f"kernels recorded (not measured)")
            else:
                check(seen == got, f"masked moniqua round on {topo} K={K}: "
                      f"profiler saw {seen}")
            print(f"  masked moniqua-8bit round on {topo}({N_WORKERS}) "
                  f"K={K}: {got[0]} encode and {got[1]} decode-reduce "
                  f"launches (wrappers; profiler {seen})", flush=True)
        torch.cuda.synchronize()
        kenc.encode.launches = kdr.decode_reduce.launches = 0
        eng8[topo].mix_stale(X, eng8[topo].init_gossip_carry(X), theta=2.0,
                             seed=1, presence=mask)
        torch.cuda.synchronize()
        got = (kenc.encode.launches, kdr.decode_reduce.launches)
        check(got == (1, m), f"masked mix_stale on {topo}: launches {got}")
        counted["moniqua_encode"] += got[0]
        counted["moniqua_decode_reduce"] += got[1]
    for topo, mask in ELASTIC_MASKS:
        eng = eng8[topo]
        plain = host_ms(lambda: eng.mix(X, theta=2.0, seed=1), reps=10)
        masked = host_ms(lambda: eng.mix(X, theta=2.0, seed=1,
                                         presence=mask), reps=10)
        print(f"time: one moniqua-8bit round of the ResNet-20 bucket on "
              f"{topo}({N_WORKERS}) at K=1, host clock: unmasked "
              f"{plain:.3f} ms | mask {mask} {masked:.3f} ms {card}",
              flush=True)
    print(f"phase 17: elastic rounds on the ResNet-20 bucket: "
          f"{len(STAGED_WIRES)} wires, all-ones == None bitwise (both paths,"
          f" K in {list(ELASTIC_KS)}, 3 rounds with WireState); masks on "
          f"ring and exponential(8): absent models and residuals untouched,"
          f" K=5 == K=1 and per-leaf == bucketed ({', '.join(PATH_BITWISE)})"
          f" bitwise, card == CPU bitwise (onebit within {RULE_ULPS} ulp), "
          f"full-wire mean kept within 1e-6; masked mix_stale card == CPU; "
          f"K encode + K*m decode-reduce launches a masked Moniqua round "
          f"({n_cases} cases, {time.perf_counter() - t0:.1f} s) {card}",
          flush=True)
    return counted


def sim_phase(dev, card, model, batches, X_cpu):
    """Phase 18: the simulator driving the engine: churn-ring's realized
    masks replayed through ``mix``, ``Trainer.run`` under a mask, and
    ``replay_adpsgd`` on churn-ring's message loss; returns the launches of
    the three paths by kernels-line entry."""
    from repro_torch import tree
    from repro_torch.comm.engine import CommEngine, MoniquaWire
    from repro_torch.core.quantizers import QuantSpec
    from repro_torch.core.topology import ring
    from repro_torch.data.synthetic import quadratic_grad
    from repro_torch.kernels import moniqua_decode as kdec
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc
    from repro_torch.sim import events, scenarios
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def zero():
        torch.cuda.synchronize()
        kenc.encode.launches = kdr.decode_reduce.launches = 0
        kdec.decode.launches = 0

    def read():
        torch.cuda.synchronize()
        return {"moniqua_encode": kenc.encode.launches,
                "moniqua_decode_reduce": kdr.decode_reduce.launches,
                "moniqua_decode": kdec.decode.launches}

    def add(total, got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    t0 = time.perf_counter()
    counted = {}
    X = tree.map(lambda a: a.to(dev), X_cpu)
    eng = CommEngine(ring(N_WORKERS), MoniquaWire(QuantSpec(8)))
    sc = scenarios.get_scenario("churn-ring", n=N_WORKERS)
    # -- the sync rounds' realized masks, replayed through mix -------------
    nbytes = eng.payload_bytes_per_broadcast(X)
    trace = events.simulate_sync_rounds(sc.with_deadline(SIM_DEADLINE),
                                        nbytes, SIM_ROUNDS)
    masks = trace.presence
    check(len(masks) == SIM_ROUNDS, f"sim gave {len(masks)} masks")
    zero()
    t1 = time.perf_counter()
    Xg, card_rounds = X, []
    for k, mask in enumerate(masks):
        Xg = eng.mix(Xg, theta=2.0, seed=1000 + k, presence=mask).x
        card_rounds.append(Xg)
    got = read()
    round_ms = 1e3 * (time.perf_counter() - t1) / SIM_ROUNDS
    add(counted, got)
    partial = sum(1 for m in masks if not all(m))
    want = (SIM_ROUNDS, 2 * partial + (SIM_ROUNDS - partial), 0)
    check(tuple(got.values()) == want, f"sync replay launches {got}, want "
          f"{want}")
    Xc, prev = X_cpu, X_cpu
    for k, (mask, Xk) in enumerate(zip(masks, card_rounds)):
        Xc = eng.mix(Xc, theta=2.0, seed=1000 + k, presence=mask).x
        check(all(torch.equal(a.cpu(), b) for a, b in zip(
            tree.leaves(Xk), tree.leaves(Xc))),
            f"sync replay round {k}: card != CPU")
        check(all(torch.equal(a[i], b[i]) for a, b in zip(
            tree.leaves(Xc), tree.leaves(prev))
            for i in range(N_WORKERS) if not mask[i]),
            f"sync replay round {k}: an absent worker moved")
        prev = Xc
    print(f"run sim-sync churn-ring ({SIM_ROUNDS} rounds, deadline "
          f"{SIM_DEADLINE} s): participation {trace.participation_mean:.4f},"
          f" {partial} masked rounds, {trace.count(events.LATE)} late and "
          f"{trace.count(events.MSGDROP)} lost payloads, simulated "
          f"{trace.total_seconds:.4f} s; replayed through mix(presence=) on "
          f"the card: launches {got}, card == CPU bitwise", flush=True)
    print(f"time: sync replay, one moniqua-8bit round of the ResNet-20 "
          f"bucket under churn-ring's masks, host clock {round_ms:.3f} ms "
          f"(mean of {SIM_ROUNDS}) {card}", flush=True)
    # -- Trainer.run under a fixed mask -----------------------------------
    base = dict(topology="ring", n_workers=N_WORKERS, theta=2.0, lr=0.1,
                momentum=0.9, weight_decay=5e-4, steps=STEPS, log_every=1,
                seed=0)
    runs = [("moniqua-8bit", dict(algo="moniqua", bits=8), (1, 2)),
            ("moniqua-1bit", dict(algo="moniqua", bits=1, slack=SLACK_1BIT),
             (1, 2)),
            ("dpsgd", dict(algo="dpsgd"), (0, 0))]
    for name, kw, (enc_step, dr_step) in runs:
        trainer = Trainer(model, TrainerConfig(**base, **kw,
                                               presence=TRAIN_MASK),
                          lambda k: batches[k])
        check(trainer.hp.presence == TRAIN_MASK, f"{name}: presence lost")
        zero()
        out = trainer.run()
        got = read()
        add(counted, got)
        losses = [h["loss"] for h in out["history"]]
        walls = [h["wall"] for h in out["history"]]
        step_ms = 1e3 * (walls[-1] - walls[0]) / (len(walls) - 1)
        check(all(map(math.isfinite, losses)), f"{name} masked: non-finite "
              f"loss")
        want = {"moniqua_encode": STEPS * enc_step,
                "moniqua_decode_reduce": STEPS * dr_step,
                "moniqua_decode": 0}
        check(got == want, f"{name} masked: launches {got}, want {want}")
        steps = {}
        for tag, tr in (("masked", trainer), ("unmasked", Trainer(
                model, TrainerConfig(**base, **kw), lambda k: batches[k]))):
            state = out["state"] if tag == "masked" else tr.init_state()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                tr.step_fn(state, batches[0])
                torch.cuda.synchronize()
            steps[tag] = sum(e.count for e in prof.key_averages()
                             if e.device_type
                             == torch.autograd.DeviceType.CUDA)
        print(f"run {name} presence {TRAIN_MASK}: losses "
              f"{[round(v, 4) for v in losses]} | launches {got}",
              flush=True)
        print(f"time: step {name} presence {TRAIN_MASK} (ResNet-20 w16, "
              f"n={N_WORKERS}, {IMAGES} images/worker, mean of steps 1-"
              f"{STEPS - 1}) {step_ms:.3f} ms | one profiled step: "
              f"{steps['masked']} kernel launches masked, "
              f"{steps['unmasked']} unmasked {card}", flush=True)
    # -- AD-PSGD replay on churn-ring's message loss ----------------------
    p0 = model.init(torch.Generator().manual_seed(0))
    X0 = tree.map(lambda a: a[None].expand((N_WORKERS,) + a.shape), p0)
    lay1 = eng.layout(tree.map(lambda a: a[:1], X0))
    x0 = eng.layout(X0).flatten(X0)               # [8, 272282], identical rows
    grad, calls = bucket_grad(model, batches, lay1)
    rep_eng = CommEngine(ring(N_WORKERS), MoniquaWire(QuantSpec(8)))
    exchanges, drops = [], []
    pair = rep_eng.pair_average

    def spy(xi, xj, presence=None, **kw_):
        res = pair(xi, xj, presence=presence, **kw_)
        exchanges.append(presence)
        if presence is not None:
            drops.append((xi, xj, res))
        return res
    object.__setattr__(rep_eng, "pair_average", spy)
    zero()
    t1 = time.perf_counter()
    out = events.replay_adpsgd(sc, rep_eng, x0, grad, alpha=0.1,
                               num_updates=REPLAY_UPDATES, theta=2.0)
    got = read()
    upd_ms = 1e3 * (time.perf_counter() - t1) / REPLAY_UPDATES
    add(counted, got)
    tr = out["trace"]
    delivered, dropped = tr.count(events.GOSSIP), tr.count(events.MSGDROP)
    check(delivered + dropped == REPLAY_UPDATES == len(exchanges)
          == calls[0], f"replay: {delivered} + {dropped} exchanges, "
          f"{len(exchanges)} pair_average calls, {calls[0]} gradients")
    want = {"moniqua_encode": delivered, "moniqua_decode_reduce": 0,
            "moniqua_decode": 2 * delivered}
    check(got == want, f"replay launches {got}, want {want}")
    check(dropped >= 1, "replay: churn-ring lost no exchange; nothing "
          "exercised the identity exchange")
    check(len(drops) == dropped and all(
        torch.equal(r.xi, xi) and torch.equal(r.xj, xj)
        for xi, xj, r in drops), "replay: a dropped exchange moved")
    check(bool(torch.isfinite(out["X"]).all()), "replay: not finite")
    # the first exchanges card against CPU: perturbed ResNet-20 models, a
    # quadratic gradient with noise drawn on the host from the draw's seed
    lay_c = eng.layout(X_cpu)
    xp = lay_c.flatten(X_cpu)

    def quad(x, i, seed):
        noise = torch.randn(x.shape, generator=torch.Generator()
                            .manual_seed(seed))
        return quadratic_grad(x, 0.2, noise.to(x.device), 0.05)
    first = [events.replay_adpsgd(sc, CommEngine(ring(N_WORKERS),
                                                 MoniquaWire(QuantSpec(8))),
                                  x, quad, alpha=0.1,
                                  num_updates=REPLAY_CHECK, theta=2.0)
             for x in (xp.to(dev), xp)]
    check(torch.equal(first[0]["X"].cpu(), first[1]["X"])
          and first[0]["trace"].fingerprint()
          == first[1]["trace"].fingerprint(),
          f"replay: first {REPLAY_CHECK} exchanges card != CPU")
    print(f"run sim-adpsgd churn-ring ({REPLAY_UPDATES} updates, ResNet-20 "
          f"gradient, moniqua 8-bit): {delivered} exchanges delivered, "
          f"{dropped} lost (the identity, bitwise); launches {got}; "
          f"consensus_sq {out['consensus_sq']:.6g}; simulated "
          f"{tr.total_seconds:.4f} s, staleness max {tr.staleness_max}",
          flush=True)
    print(f"time: replay_adpsgd, one update (ResNet-20 gradient and one "
          f"exchange) host clock {upd_ms:.3f} ms (mean of "
          f"{REPLAY_UPDATES}) {card}", flush=True)
    print(f"phase 18: the simulator on the card: {SIM_ROUNDS} churn-ring "
          f"rounds replayed through mix (card == CPU bitwise), 3 masked "
          f"trainings with finite losses, replay_adpsgd with 2 point "
          f"decodes a delivered exchange and the identity on {dropped} "
          f"lost, the first {REPLAY_CHECK} card == CPU "
          f"({time.perf_counter() - t0:.1f} s) {card}", flush=True)
    return counted


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
    check(len(libs) == 6, f"built {sorted(libs)}, want 6 kernels")
    print(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s "
          f"into {build.BUILD_DIR}", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log").read_text()
        kern = ptxas_kernels(log)
        if kern:
            regs = [r for r, _ in kern.values()]
            spilled = {k: s for k, (_, s) in kern.items() if s}
            print(f"  ptxas {name}: {len(kern)} kernels, {min(regs)}-"
                  f"{max(regs)} registers, {len(spilled)} spilling "
                  f"({sum(spilled.values())} bytes of stores)")
        else:
            print(f"  ptxas {name}: registers not measured (no ptxas lines)")
        for k, (r, s) in kern.items():
            if any(t in k for t in MAIN_PATH_KERNELS):
                print(f"    {k}: {r} registers, {s} bytes spilled")
        for line in log.splitlines():
            if "C75" in line:                    # ptxas performance warnings
                print(f"  ptxas {name}: {line.strip()}")
    for name, ops_, what in (
            ("flash_attention_tc", ("HGMMA", "UTMALDG"),
             "wgmma (HGMMA) and TMA loads (UTMALDG)"),
            ("flash_attention_f32tc", ("HMMA.1688.F32.TF32",),
             "TF32 mma.sync (HMMA.1688.F32.TF32)")):
        sass = sass_counts(libs[name], ops_)
        if sass is None:
            print(f"sass: {name} {' and '.join(ops_)} counts not measured "
                  f"(no cuobjdump in the toolkit)")
            continue
        check(all(sass.values()), f"{name} SASS {sass}: want {what}")
        print(f"sass: {name} " + ", ".join(
            f"{op} {n}" for op, n in sass.items()), flush=True)
    # the head dim 96 instantiations (phi-3-vision-4.2b's attention): the
    # bfloat16 one's SASS, and no spill in either
    fn96 = FLASH_D96_KERNELS["flash_attention_tc"]
    sass = sass_counts(libs["flash_attention_tc"], ("HGMMA", "UTMALDG"),
                       fn=fn96)
    if sass is None:
        print("sass: flash_attention_tc head dim 96 counts not measured (no "
              "cuobjdump in the toolkit)")
    else:
        check(all(sass.values()), f"flash_attention_tc head dim 96 SASS "
              f"{sass}: want wgmma (HGMMA) and TMA loads (UTMALDG)")
        print(f"sass: flash_attention_tc head dim 96 ({fn96}) " + ", ".join(
            f"{op} {n}" for op, n in sass.items()), flush=True)
    for name, fn in FLASH_D96_KERNELS.items():
        kern = {k: v for k, v in ptxas_kernels(
            libs[name].with_suffix(".log").read_text()).items() if fn in k}
        check(len(kern) == 1, f"{name}: no ptxas lines for {fn}")
        (regs, spill), = kern.values()
        check(spill == 0, f"{name} head dim 96 spills {spill} bytes")
        print(f"  ptxas {name} head dim 96 ({fn}): {regs} registers, "
              f"{spill} bytes spilled", flush=True)

    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    def B_for(bits, stochastic, device):
        if bits == 1 and stochastic:         # delta = 1/2: no B_theta
            return torch.tensor(0.7, device=device)
        return modulo.b_theta(2.0, delta_for_bits(bits, stochastic), device)

    def check_encode(x_cpu, x, bits, stochastic, what):
        kw = dict(bits=bits, stochastic=stochastic, idx_base=12345)
        B = B_for(bits, stochastic, dev)
        got = kenc.encode(x, B, 0xC0FFEE, **kw)
        plain = kenc.encode_plain(x, B, 0xC0FFEE, **kw)
        cpu = kenc.encode_plain(x_cpu, B_for(bits, stochastic, "cpu"),
                                0xC0FFEE, **kw)
        what = f"encode {what} {x.dtype} bits={bits} stochastic={stochastic}"
        check(torch.equal(got, plain), what + " != plain (card)")
        check(torch.equal(got.cpu(), cpu), what + " != plain (CPU)")
        return cpu

    def check_decode_reduce(ps_cpu, pn_cpu, y_cpu, y, bits, weights, what,
                            pay_off=(0, 0)):
        ps = offset_view(ps_cpu.to(dev), pay_off[0])
        pn = offset_view(pn_cpu.to(dev), pay_off[1])
        B = B_for(bits, bits > 1, dev)
        got = kdr.decode_reduce(ps, pn, y, B, bits=bits, weights=weights)
        plain = kdr.decode_reduce_plain(ps, pn, y, B, bits=bits,
                                        weights=weights)
        cpu = kdr.decode_reduce_plain(ps_cpu, pn_cpu, y_cpu,
                                      B_for(bits, bits > 1, "cpu"),
                                      bits=bits, weights=weights)
        what = (f"decode_reduce {what} m={len(weights)} {y.dtype} "
                f"bits={bits}")
        check(torch.equal(got, plain), what + " != plain (card)")
        check(torch.equal(got.cpu(), cpu), what + " != plain (CPU)")

    # [workers, rows, cols]: 1003, no vpb divides the row; 4096, rows
    # 16-byte aligned and a multiple of 128; 17, shorter than one vector;
    # 1, a single value; 4104, x rows aligned but 1- and 2-bit payload rows
    # not 4-byte aligned
    shapes = [(3, 5, 1003), (2, 3, 4096), (1, 1, 17), (1, 1, 1),
              (1, 3, 4104)]
    n_checks = 0
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x_cpu = rand(*shape, scale=3.0).to(dtype)
            cases = [("", x_cpu.to(dev))]
            if shape == (2, 3, 4096):
                cases.append(("offset", offset_view(x_cpu.to(dev))))
            for tag, x in cases:
                for bits in (1, 2, 4, 8):
                    for stochastic in (True, False):
                        check_encode(x_cpu, x, bits, stochastic,
                                     f"{list(shape)} {tag}")
                        n_checks += 1
    topos = [ring(8), exponential(8), torus(3, 3)]
    for topo in topos:
        weights = tuple(w for o, w in zip(topo.offsets, topo.weights)
                        if o % topo.n)
        m = len(weights)
        for shape in [(topo.n, 3, 1003)] + shapes[1:]:
            for dtype in (torch.float32, torch.bfloat16):
                y_cpu = rand(*shape, scale=4.0).to(dtype)
                cases = [("", y_cpu.to(dev))]
                if shape == (2, 3, 4096):
                    cases.append(("offset", offset_view(y_cpu.to(dev))))
                for bits in (1, 2, 4, 8):
                    pshape = shape[:2] + (-(-shape[2] // (8 // bits)),)
                    ps_cpu = torch.randint(0, 256, pshape, generator=gen,
                                           dtype=torch.uint8)
                    pn_cpu = torch.randint(0, 256, (m,) + pshape,
                                           generator=gen, dtype=torch.uint8)
                    for tag, y in cases:
                        check_decode_reduce(ps_cpu, pn_cpu, y_cpu, y, bits,
                                            weights, f"{topo.name}({topo.n}) "
                                            f"{list(shape)} {tag}")
                        n_checks += 1
    # every neighbor count the kernel is built for (m = 1..8, each its own
    # instantiation), at rows in the vector body (also one element off
    # alignment, and with the own and the neighbor payloads one to three
    # bytes in) and at ragged rows
    for m in range(1, 9):
        weights = tuple(float(v) for v in torch.rand(m, generator=gen) / m)
        for shape in ((2, 3, 4096), (3, 5, 1003)):
            for dtype in (torch.float32, torch.bfloat16):
                y_cpu = rand(*shape, scale=4.0).to(dtype)
                y = y_cpu.to(dev)
                cases = [("", y, (0, 0))]
                if shape == (2, 3, 4096):
                    cases.append(("offset", offset_view(y), (0, 0)))
                    cases += [(f"payloads +{k}/+{k % 3 + 1} bytes", y,
                               (k, k % 3 + 1)) for k in (1, 2, 3)]
                for bits in (1, 2, 4, 8):
                    pshape = shape[:2] + (-(-shape[2] // (8 // bits)),)
                    ps_cpu = torch.randint(0, 256, pshape, generator=gen,
                                           dtype=torch.uint8)
                    pn_cpu = torch.randint(0, 256, (m,) + pshape,
                                           generator=gen, dtype=torch.uint8)
                    for tag, yv, off in cases:
                        check_decode_reduce(ps_cpu, pn_cpu, y_cpu, yv, bits,
                                            weights, f"{list(shape)} {tag}",
                                            pay_off=off)
                        n_checks += 1
    # ResNet-110's bucket (the paper's other model), 8 workers on a ring:
    # encode it, roll the payload to each neighbor, mix; at the main path's
    # 8-bit (stochastic) and 1-bit (nearest) specs
    p110 = init_resnet(torch.Generator().manual_seed(2), depth=110, width=16)
    X110 = tree.map(lambda a: a[None] + 0.02 * torch.randn(
        (N_WORKERS,) + a.shape, generator=gen), p110)
    w_ring = (1.0 / 3.0, 1.0 / 3.0)
    flat110 = {}
    for bits, stochastic in ((8, True), (1, False)):
        lay = CommEngine(ring(N_WORKERS), MoniquaWire(
            QuantSpec(bits, stochastic))).layout(X110)
        f32 = lay.flatten(X110).reshape(N_WORKERS, 1, lay.padded_elems)
        flat110[bits] = f32.to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x_cpu = f32.to(dtype)
            x = x_cpu.to(dev)
            p_cpu = check_encode(x_cpu, x, bits, stochastic,
                                 f"ResNet-110 {list(x.shape)}")
            pn_cpu = torch.stack([torch.roll(p_cpu, -o, 0) for o in (-1, 1)])
            check_decode_reduce(p_cpu, pn_cpu, x_cpu, x, bits, w_ring,
                                f"ResNet-110 {list(x.shape)}")
            n_checks += 2
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
             bound_ms=encode_bound_ms(elems, 8),
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
             bound_ms=decode_reduce_bound_ms(elems, 8, 2),
             bound_by="bytes", library_ms=None),
    ]
    for k in kernels:
        print(f"time: {k['name']} 8-bit, [{N_WORKERS}, {D}] float32 (ring, "
              f"m=2 for decode-reduce): kernel {k['ms']:.5f} ms | plain "
              f"{k['plain_ms']:.5f} ms | bound {k['bound_ms']:.5f} ms "
              f"({k['bound_by']}) | library: no single PyTorch call {card}",
              flush=True)
    # the 1-bit main path's shapes (each of the 61 leaves padded to 8
    # values: 272,672 a worker), then ResNet-110's bucket (1,730,522
    # parameters a worker; 55 MB of float32 at 8 bits, more than the L2)
    layout1 = CommEngine(topo, MoniquaWire(QuantSpec(1, False))).layout(X)
    flat1 = layout1.flatten(X).reshape(N_WORKERS, 1, layout1.padded_elems)
    codec_times(timer, dev, card, flat1, 1, False, "ResNet-20", (-1, 1))
    for bits, stochastic in ((8, True), (1, False)):
        codec_times(timer, dev, card, flat110[bits], bits, stochastic,
                    "ResNet-110", (-1, 1))
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

    torch.cuda.synchronize()
    kernels += serving_phases(dev, timer, card, flat.reshape(N_WORKERS, D),
                              B8, flat110)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rules_phase(dev, card, model, batches)
    dec_entry = adpsgd_phase(dev, timer, card, model, batches, X_cpu)
    kernels = [dec_entry if k["name"] == "moniqua_decode" else k
               for k in kernels]
    split_phase(dev, card)
    torch.cuda.empty_cache()
    staged_phase(dev, card, X_cpu)
    wires_phase(dev, card, model, batches)
    torch.cuda.empty_cache()
    # the new paths' launches go onto the codec and point-decode entries
    extra = {}
    for counts in (elastic_phase(dev, card, X_cpu),
                   sim_phase(dev, card, model, batches, X_cpu)):
        for name, n in counts.items():
            extra[name] = extra.get(name, 0) + n
    for k in kernels:
        k["launches"] += extra.get(k["name"], 0)
    print(f"launches on phases 17-18's paths, added to the kernels line: "
          f"{extra}", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
