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
   (61: one a leaf), on the bucketed path.  Each K bitwise its K = 1
   round, WireState included; K = 1 against the CPU: ``full`` and
   ``moniqua`` bitwise, the others within ``RULE_ULPS``; a Moniqua round
   at K chunks K encode and K decode-reduce launches (wrapper counts and
   the profiler).
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
   update.
19. Two-tier rounds on the ResNet-20 bucket (n = 8), phase 15's wires, 3
   rounds each with WireState: ``two_tier(8, 1)`` bitwise ring(8)'s
   bucketed round at K = 1 and 5; on ``two_tier(8, 2)`` and ``(8, 4)``
   K = 5 bitwise K = 1 and card == CPU bitwise (``onebit`` within
   ``RULE_ULPS``), every node's workers leaving with one model; per-node
   presence on ``two_tier(8, 2)``: all-ones bitwise ``None``, node 1
   absent keeps its intra average and its residual rows, card == CPU; the
   fast/slow ledger, bytes a round and WireState bytes equal to the
   reference's (``TIER_BYTES``); ``path="auto"``'s verdicts on ResNet-20,
   flat and per shard (``TIER_SHARDS``), and the default ``qsgd`` round
   per-leaf, card == CPU bitwise; a tiered Moniqua round's launches
   (``TIER_LAUNCHES``, wrappers and profiler) and its host-clock time
   beside the flat round's; ``Trainer.run`` with ``tiers=2`` for moniqua
   8-bit and dpsgd (falling losses, 2 encodes and 2 decode-reduces a
   Moniqua step, bytes per step, no extra memory).
20. Round-health telemetry (``repro_torch.obs``) on the ResNet-20 bucket:
   phase 15's wires on ring(8), ring(8) under phase 18's mask and
   ``two_tier(8, 2)``, bucketed at K = 1 and 5 and per-leaf, 3 rounds:
   telemetry on == off bitwise (x, WireState), the health the same across
   the routes and equal to the CPU's (``ef_residual_l2`` within
   ``OBS_L2_RTOL`` relative); a telemetered Moniqua round's encode and
   decode-reduce launches beside an untelemetered one's (wrappers and
   profiler: the sentinel reuses a barrier bucketed round's payload, else
   one re-encode); the alias sentinel silent on the main path's trained
   model at theta 2.0 and firing, card == CPU, at an undersized theta;
   ``Trainer.run`` of the main path with telemetry, a run log and a Chrome
   trace (params bitwise a telemetry-off run's under deterministic cuDNN,
   ``obs_*`` metrics, log and trace valid by the port's validators, device
   time of a profiled step under the ``comm.*`` labels); AD-PSGD with edge
   telemetry, 200 iterations (X bitwise, two extra encodes an iteration);
   ``SimTrace.to_chrome`` of churn-ring merged with the trainer's trace;
   ``MoniquaCodec(use_kernels=True)`` on the bucket (encode and point
   decode card == CPU bitwise, within Lemma 2's delta B) and
   ``moniqua_gossip`` on the ResNet-20 params (within its bound of the
   exact mix); host-clock rounds with telemetry on and off, and phase
   15's K = 61 round with its phase labels on and off, in turns.  Phases
   17-20's launches are added to the kernels line.
21. Decentralized LM training and the dense zoo: llama3.2-3b at its
   published widths (d 3072, 24 query and 8 KV heads of 128, d_ff 8192,
   vocab 128,256, bfloat16) cut to 2 layers, 4 workers on ring(4), one
   2048-token sequence a worker, through ``Trainer(model, tc, shape)``: 5
   steps of moniqua 8-bit (stochastic) and 5 of dpsgd from the same state
   and batches (finite losses, step 0's within 10% of ln V; the flash
   kernel launched once a layer a step, the workers folded into one
   launch; codec launches as ``path="auto"`` resolves for the tree;
   ``bytes_per_step`` equal to the shape-only accounting); step time,
   tokens/s, peak memory and a profile of two steps; Lemma 2 on the LM
   tree (one step of each rule from one state and one direction:
   ``|X_moniqua - X_dpsgd| <= 2 (1 - w_ii) delta B`` plus two bfloat16
   ulps); one worker's loss and gradients through the flash route against
   the plain one; the flash kernel timed at the training shape.  Then
   chatglm3-6b, internlm2-20b and qwen2-72b at published widths, 2 layers:
   a 2 x 2048 prefill through the flash kernel (GQA groups 16, 6 and 8)
   within phase 10's bound of the plain path, and 8 greedy decode tokens
   at a 2048-slot cache.  Its launches are added to the kernels line.
22. The MoE family and the Mamba2 hybrid, through the same entry points:
   (a) dbrx-132b and grok-1-314b at published widths (d 6144, 48 query and
   8 KV heads of 128, E 16 top-4 and E 8 top-2, capacity factor 1.25,
   dispatch groups of 256), bf16, cut to 2 layers, one after the other: a
   2 x 2048 prefill (2 flash launches, GQA group 6) within phase 10's
   bound of the plain route over the tokens routed alike in both
   (top-k experts and kept slots read from ``models.moe.route``; the share
   rerouted printed), 8 greedy tokens at a 2048-slot cache; (b) dbrx-132b
   trained, routing and attention at published widths, depth 40 -> 1,
   d_ff 10752 -> 1344, ring(2), 2048 tokens a worker: 3 steps of moniqua
   8-bit and 3 of dpsgd as in phase 21 (one flash launch a step, the
   loss's xent and aux parts at step 0, Lemma 2); (c) zamba2-1.2b as
   published (38 layers, the shared attention block 6 times a prefill: 32
   heads of 64, window 8192): a 2 x 4096 prefill within phase 10's bound
   of the plain route, 32 greedy tokens at a 4096-slot cache; (d)
   zamba2-1.2b at 12 layers (2 calls of the shared block) on ring(4) as
   in (b), and one worker's loss and gradients, flash route against plain
   (phase 21's bounds).  The flash kernel timed at both training
   shapes; the launches added to the kernels line.
23. The rest of the zoo, through the same entry points: (a) xlstm-125m as
   published (12 layers, d 768, 4 heads of 192, sLSTM at layers 0, 4 and
   8, chunk 128, vocab 50,304, bf16): a 2 x 2048 prefill (no attention,
   no flash launch), 32 greedy tokens, and a float32 copy whose 256-token
   prompt fed token by token matches its prefill's last position within
   phase 9's 1e-3 x max|logit|; (b) xlstm-125m trained as published on
   ring(8), one 2048-token sequence a worker, 3 steps of moniqua 8-bit
   and 3 of dpsgd as in phase 21 (finite gradients at chunk 128, Lemma
   2); (c) whisper-base as published (6 + 6 layers, d 512, 8 heads of
   64, vocab 51,865 tied), 16 windows of 30 s (1500 frames, 375 decoder
   tokens): a prefill that launches flash 6 times (the decoder's
   self-attention; the encoder's and the cross attention take the plain
   route, as in the reference) within phase 10's bound of the plain
   route, ``whisper_prefill_cross`` and 32 greedy tokens (3000 self
   slots, 1500 cross), and a float32 check of decode against prefill at
   64 tokens; (d) whisper-base trained on ring(8), one window a worker (6
   flash launches a step, flash vs plain gradients); (e)
   phi-3-vision-4.2b as published (32 layers, d 3072, 32 heads of 96,
   bf16; 576 patch embeddings of 1024, the CLIP tower a stub): a 2 x (576
   + 3520) prefill (32 flash launches) within phase 10's bound, 32 greedy
   tokens at a 4096-slot cache; (f) phi-3-vision-4.2b cut to 2 layers on
   ring(4), 576 patches + 1472 text tokens a worker, the loss over the
   text (2 flash launches a step, flash vs plain gradients).  The flash
   kernel timed at ``[128, 375, 64]`` and ``[64, 4096, 96]``; the
   launches added to the kernels line.
24. The launch layer: (a) ``repro_torch.launch.train.main`` in this
   process with ``--arch whisper-base --full-size --workers 8 --batch 8
   --seq 3000 --steps 3 --algo moniqua --bits 8`` (phase 23 (d)'s cell
   through the user's entry point): finite losses, 32 encodes and 32
   decode-reduces a step (per-leaf) and 6 bf16 flash launches, the printed
   ``bytes/step/worker`` equal to the shape-only accounting; step time
   and peak memory; (b) the CLI's default, ``--arch llama3.2-3b --steps
   5`` (reduced, float32: the float32 flash kernel once a layer a step,
   the codec as ``path="auto"`` resolves the tree); (c) the dry run of
   (a)'s step on ``meta`` (``dryrun_one``): its peak within 0.8-1.25x of
   (a)'s measured one, its FLOPs equal to the same counters' around one
   real step on the card (the kernels charged by the same formulas), and
   the step's MFU beside the dry run's bound; (d) the dry run's sweep,
   ``dryrun.main`` over the ten assigned architectures x the four input
   shapes in processes of its own beside (a)-(c) (xlstm-125m x
   prefill_32k left out, ROADMAP): no error row, whisper-base x long_500k
   skipped with the reference's reason, each combination's seconds and
   peak against the card's 80 GB; and ``calibrate_one`` for llama3.2-3b x
   train_4k against the sweep's direct count.  The CLI runs' launches are
   added to the kernels line.

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
from typing import NamedTuple

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
    from repro_torch.kernels import cost
    return bound_ms(elems * 8 + elems * bits // 8, elems * cost.DECODE_OPS)


def offset_view(t, k=1):
    """``t`` in a buffer ``k`` elements in: for k = 1, no row of y starts
    16-byte aligned and the wrapper's output does not share its
    alignment; a payload k bytes in starts inside a 4-byte word."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    buf[k:] = t.reshape(-1)
    return buf[k:].view(t.shape)


def encode_bound_ms(elems: int, bits: int) -> float:
    """Encode of ``elems`` float32 values: each read once, its code written
    (the operations a value: ``kernels/cost.py``, the dry run's)."""
    from repro_torch.kernels import cost
    return bound_ms(elems * 4 + elems * bits // 8, elems * cost.ENCODE_OPS)


def decode_reduce_bound_ms(elems: int, bits: int, m: int) -> float:
    """Decode-reduce of ``elems`` float32 values with ``m`` neighbors: y read
    and out written once, the own and m neighbor payloads read once."""
    from repro_torch.kernels import cost
    return bound_ms(elems * 8 + (m + 1) * elems * bits // 8,
                    elems * cost.decode_reduce_ops(m))


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


# record_function labels (the engine's ``comm.*`` phases, the serve steps'
# ``serve.*``): host ranges the profiler also draws on the device track,
# left out of every device sum and launch count
ANNOTATIONS = ("comm.", "serve.")

# The profiler loses the first kernel records of a profiled window: 10 of
# every window late in a run of this script on the H100, and in a fresh
# process now and then a few dozen (`tools/profiler_gaps.py`), whatever
# host time passes first.  Every profiled window therefore opens with
# PROFILER_PRIME spin kernels, which absorb the loss and which
# ``device_kernels`` leaves out of every sum and count.
PROFILER_PRIME = 256
SPIN_KERNEL = "spin_kernel"        # torch.cuda._sleep's kernel


class Kernel(NamedTuple):
    key: str                       # the kernel's name
    count: int                     # its launches in the window
    self_device_time_total: float  # its device time, µs


def device_kernels(prof) -> list:
    """The kernels a profile recorded, by name, not label ranges or the
    window's priming spin kernels.  Read from the raw Kineto records:
    ``key_averages`` first builds an event object a record, and phase
    23's profile of two xlstm-125m training steps (273 k kernels) took
    170.6 s through it, 35.1 s this way, recording included."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or name.startswith(ANNOTATIONS) or SPIN_KERNEL in name):
            continue
        n, us = out.get(name, (0, 0.0))
        out[name] = (n + 1, us + e.duration_ns() / 1e3)
    return [Kernel(k, n, us) for k, (n, us) in out.items()]


def profiler_prime() -> None:
    for _ in range(PROFILER_PRIME):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def traced(fn):
    """Profile one call of ``fn`` (host and card) in a primed window, the
    card synchronised before it closes; returns the profile."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        profiler_prime()
        fn()
        torch.cuda.synchronize()
    return prof


def primer_lost(prof) -> int:
    """How many of the window's priming spin kernels the profiler lost."""
    return PROFILER_PRIME - sum(
        e.count for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and SPIN_KERNEL in e.key)


def window_edges(prof) -> str:
    """The kernels a profile recorded: their number, and the first and last
    three in launch order (what a short count lost)."""
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(ANNOTATIONS)
                 and SPIN_KERNEL not in e.name),
                key=lambda e: e.time_range.start)
    nm = [e.name.split("(")[0][-40:] for e in ev]
    return f"{len(nm)} kernels, first {nm[:3]}, last {nm[-3:]}"


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


def serve_config(**over):
    """The published config as registered, with ``over`` replaced: it
    serves through the flash kernel unless ``flash_attention=False`` asks
    for the plain masked-softmax path."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SERVE_ARCH), **over)


def causal_pairs(s: int) -> int:
    """(query, key) pairs that s causal query rows attend (the dry run's
    count, ``kernels/cost.py``)."""
    from repro_torch.kernels import cost
    return cost.attended_pairs(s, s, True, 0)


def profile_device(fn, what, card):
    """Device busy share, launches and device time by kernel group of one
    call of ``fn`` under torch.profiler (label ranges left out:
    ``device_kernels``)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        profiler_prime()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    if busy_us == 0:
        print(f"profile: {what}: no device time recorded (not measured)")
        return
    groups = {"flash kernel": 0.0, "gemm": 0.0, "codec kernels": 0.0,
              "other": 0.0}
    for e in kern:
        nm = e.key.lower()
        g = ("flash kernel" if "fa_kernel" in nm else "codec kernels"
             if "encode_kernel" in nm or "decode_reduce_kernel" in nm
             else "gemm"
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
                                1, seed=0).global_batch(0)
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
    batch = SyntheticLMPipeline(mbf, shape, 1, seed=1).global_batch(0)
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
    for e in device_kernels(prof):
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
                              make_wire(wire, spec, warmup=2),
                              path="bucketed", chunks=K)

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
                prof = traced(lambda: eng.mix(X, **kw(0)))
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
            prof = traced(lambda: eng.mix(X, theta=2.0, seed=1,
                                          presence=mask))
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
            prof = traced(lambda: tr.step_fn(state, batches[0]))
            steps[tag] = sum(e.count for e in device_kernels(prof))
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


# -- two-tier rounds and path="auto" ------------------------------------------

# phase 19's engines: n_intra -> (moniqua 8-bit slow bytes a broadcast, fast
# bytes a round, total bytes a round, ef_qsgd 4-bit and onebit WireState
# bytes a worker), from the reference's CommEngine on ResNet-20 (n = 8;
# n_intra 1 is ring(8), flat)
TIER_BYTES = {1: (272282, 0, 544564, 1089132, 1090692),
              2: (136141, 1089128, 1361410, 544568, 545348),
              4: (68071, 1633692, 1701763, 272288, 272676)}
# each owned shard's slots and the reference's "auto" verdict for moniqua
TIER_SHARDS = {2: ((46, "bucketed"), (15, "bucketed")),
               4: ((39, "bucketed"), (7, "per_leaf"), (6, "per_leaf"),
                   (9, "per_leaf"))}
# (n_intra, K) -> encodes (= decode-reduces) of a tiered moniqua round
TIER_LAUNCHES = {(2, 1): 2, (2, 5): 10, (4, 1): 23, (4, 5): 27}
TIER_KS = (1, 5)
TIER_MASK = (1, 0, 1, 1)       # node 1 (workers 2-3) absent on two_tier(8, 2)


def tiered_phase(dev, card, model, batches, X_cpu):
    """Phase 19: two-tier rounds of every wire on the ResNet-20 bucket,
    per-node presence, the fast/slow byte ledger, ``path="auto"`` and
    ``Trainer.run(tiers=2)``; returns the counted tiered Moniqua launches
    by kernels-line entry."""
    from repro_torch import tree
    from repro_torch.comm.engine import CommEngine, make_wire
    from repro_torch.comm.gossip import BytesLedger
    from repro_torch.core.quantizers import QuantSpec
    from repro_torch.core.topology import ring, two_tier
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc
    from repro_torch.train.trainer import Trainer, TrainerConfig

    X = tree.map(lambda a: a.to(dev), X_cpu)
    eps = torch.finfo(torch.float32).eps
    t0 = time.perf_counter()
    counted = {"moniqua_encode": 0, "moniqua_decode_reduce": 0}

    def topo_of(n_intra):
        return two_tier(N_WORKERS, n_intra)

    def wire_of(wire, bits):
        return make_wire(wire, QuantSpec(min(bits, 8), 1 < bits <= 8),
                         warmup=2)

    def kw(wire, k):
        if wire == "full":
            return {}
        return dict(seed=1100 + k, **({"theta": 2.0}
                                      if wire == "moniqua" else {}))

    def rounds(eng, X0, presence=None):
        Xk = X0
        st = eng.init_wire_state(X0) if eng.stateful else None
        out = []
        for k in range(STAGED_ROUNDS):
            r = eng.mix(Xk, state=st, presence=presence,
                        **kw(eng.codec.name, k))
            Xk, st = r.x, (r.state if eng.stateful else None)
            out.append((tree.leaves(Xk), st))
        return out

    def card_vs_cpu(got, cpu, wire, what):
        err = 0.0
        for k, ((xg, sg), (xc, sc)) in enumerate(zip(got, cpu)):
            ts = list(zip(xg, xc))
            if sg is not None:
                check(int(sg["step"]) == int(sc["step"]) == k + 1,
                      f"{what}: step counter")
                ts.append((sg["residual"], sc["residual"]))
            for a, b in ts:
                a = a.cpu()
                if wire != "onebit":
                    check(torch.equal(a, b), f"{what}: round {k} card != "
                          f"CPU")
                    continue
                d = float((a - b).abs().max())
                tol = RULE_ULPS * eps * max(1.0, float(b.abs().max()))
                check(d <= tol, f"{what}: round {k} card vs CPU {d:.3g} > "
                      f"{tol:.3g}")
                err = max(err, d)
        return err

    n_cases = 0
    for wire, bits in STAGED_WIRES:
        what = f"{wire} {bits}-bit"
        # the trivial tier is the flat bucketed round, WireState too
        for K in TIER_KS:
            flat = CommEngine(ring(N_WORKERS), wire_of(wire, bits),
                              path="bucketed", chunks=K)
            triv = CommEngine(topo_of(1), wire_of(wire, bits), chunks=K)
            check(_same_rounds(rounds(flat, X), rounds(triv, X)),
                  f"{what}: two_tier(8, 1) K={K} != ring(8) bucketed")
            n_cases += 1
        errs = []
        for n_intra in (2, 4):
            wt = f"{what} on two_tier({N_WORKERS}, {n_intra})"
            eng = {K: CommEngine(topo_of(n_intra), wire_of(wire, bits),
                                 chunks=K) for K in TIER_KS}
            got = rounds(eng[1], X)
            check(_same_rounds(got, rounds(eng[5], X)), f"{wt}: K=5 != K=1")
            errs.append(card_vs_cpu(got, rounds(eng[1], X_cpu), wire, wt))
            for xs, _ in got:               # a node leaves with one model
                for a in xs:
                    nodes = a.reshape(N_WORKERS // n_intra, n_intra, -1)
                    check(torch.equal(nodes, nodes[:, :1].expand_as(nodes)),
                          f"{wt}: a node's workers differ")
            n_cases += 2
        # per-node presence on two_tier(8, 2)
        eng = CommEngine(topo_of(2), wire_of(wire, bits))
        check(_same_rounds(rounds(eng, X), rounds(eng, X, (1,) * 4)),
              f"{what}: all-ones node mask != None")
        masked = rounds(eng, X, TIER_MASK)
        prev = (tree.leaves(X),
                eng.init_wire_state(X) if eng.stateful else None)
        for k, (xs, st) in enumerate(masked):
            for a, b in zip(xs, prev[0]):
                avg = b[2] * 0.5 + b[3] * 0.5
                check(torch.equal(a[2], avg) and torch.equal(a[3], avg),
                      f"{what} mask {TIER_MASK}: round {k} node 1 is not "
                      f"its intra average")
            if st is not None:
                check(torch.equal(st["residual"][1], prev[1]["residual"][1]),
                      f"{what} mask {TIER_MASK}: round {k} moved node 1's "
                      f"residual")
            prev = (xs, st)
        errs.append(card_vs_cpu(masked, rounds(eng, X_cpu, TIER_MASK), wire,
                                f"{what} mask {TIER_MASK}"))
        n_cases += 2
        if wire == "onebit":
            print(f"  {what} tiered: card vs CPU max abs {max(errs):.3g}",
                  flush=True)
    # the byte ledger and the owned-shard WireState
    spec8 = QuantSpec(8)
    for n_intra, (slow, fast, total, ef_b, ob_b) in TIER_BYTES.items():
        topo = ring(N_WORKERS) if n_intra == 1 else topo_of(n_intra)
        eng = CommEngine(topo, make_wire("moniqua", spec8))
        led = BytesLedger()
        eng.mix(X, theta=2.0, seed=1, ledger=led)
        m = len(eng.gossip_topo.neighbor_offsets())
        got = (eng.payload_bytes_per_broadcast(X),
               eng.fast_bytes_per_round(X), eng.bytes_per_round(X),
               CommEngine(topo, make_wire("ef_qsgd", QuantSpec(4)))
               .wire_state_bytes(X),
               CommEngine(topo, make_wire("onebit", QuantSpec(1, False)))
               .wire_state_bytes(X))
        check(got == (slow, fast, total, ef_b, ob_b),
              f"{topo.name}: bytes {got} != {(slow, fast, total, ef_b, ob_b)}")
        check((led.bytes_slow, led.bytes_fast, led.bytes_per_worker)
              == (slow * m, fast, total), f"{topo.name}: ledger "
              f"{(led.bytes_slow, led.bytes_fast, led.bytes_per_worker)}")
        print(f"  bytes {topo.name}: moniqua-8bit slow {slow} B a broadcast "
              f"x {m}, fast {fast} B, total {total} B a round (ledger "
              f"equal); WireState ef_qsgd-4bit {ef_b}, onebit {ob_b} B a "
              f"worker", flush=True)
    # path="auto": the reference's verdicts on ResNet-20
    for wire, bits in STAGED_WIRES:
        eng = CommEngine(ring(N_WORKERS), wire_of(wire, bits))
        want = "per_leaf" if wire in ("full", "qsgd") else "bucketed"
        check(eng.resolved_path(X) == want, f"auto {wire} {bits}-bit on "
              f"ring(8): {eng.resolved_path(X)}, want {want}")
        for n_intra in (2, 4):
            eng = CommEngine(topo_of(n_intra), wire_of(wire, bits))
            lay = eng.layout(X)
            shards = [lay.shard(n_intra, j) for j in range(n_intra)]
            got = tuple((len(s.slots), eng.resolved_path(None, shard=s))
                        for s in shards)
            if wire == "moniqua" and bits == 8:
                check(got == TIER_SHARDS[n_intra], f"auto shards on "
                      f"two_tier(8, {n_intra}): {got}")
            if wire in ("full", "qsgd"):
                check(all(v == "per_leaf" for _, v in got), f"auto {wire} "
                      f"shards on two_tier(8, {n_intra}): {got}")
    eng = CommEngine(ring(N_WORKERS), wire_of("qsgd", 8))
    got, cpu = eng.mix(X, seed=77).x, eng.mix(X_cpu, seed=77).x
    check(all(torch.equal(a.cpu(), b) for a, b in zip(tree.leaves(got),
                                                      tree.leaves(cpu))),
          "default-path qsgd 8-bit round: card != CPU")
    bk = CommEngine(ring(N_WORKERS), wire_of("qsgd", 8), path="bucketed")
    check(any(not torch.equal(a, b) for a, b in zip(
        tree.leaves(got), tree.leaves(bk.mix(X, seed=77).x))),
        "default-path qsgd round equals the bucketed one")
    print(f"  auto: ResNet-20 moniqua bucketed, qsgd and full per-leaf (flat"
          f" and on every shard), the EF wires bucketed; shards "
          f"{TIER_SHARDS}; the default qsgd 8-bit round per-leaf, card == "
          f"CPU bitwise", flush=True)
    # launches of a tiered Moniqua round: wrappers and profiler
    times = {}
    for (n_intra, K), want in TIER_LAUNCHES.items():
        eng = CommEngine(topo_of(n_intra), make_wire("moniqua", spec8),
                         chunks=K)
        eng.mix(X, theta=2.0, seed=1)       # warm-up, outside the trace
        torch.cuda.synchronize()
        kenc.encode.launches = kdr.decode_reduce.launches = 0
        prof = traced(lambda: eng.mix(X, theta=2.0, seed=1))
        got = (kenc.encode.launches, kdr.decode_reduce.launches)
        counted["moniqua_encode"] += got[0]
        counted["moniqua_decode_reduce"] += got[1]
        check(got == (want, want), f"tiered moniqua round two_tier(8, "
              f"{n_intra}) K={K}: launches {got}, want {(want, want)}")
        seen = _kernel_launches(prof)
        if seen == (0, 0):
            print(f"  profile: tiered round two_tier(8, {n_intra}) K={K}: "
                  f"no device kernels recorded (not measured)")
        else:
            check(seen == got, f"tiered moniqua round two_tier(8, {n_intra})"
                  f" K={K}: profiler saw {seen}")
        if K == 1:
            times[n_intra] = host_ms(lambda: eng.mix(X, theta=2.0, seed=1),
                                     reps=10)
        print(f"  tiered moniqua-8bit round on two_tier({N_WORKERS}, "
              f"{n_intra}) K={K}: {got[0]} encode and {got[1]} "
              f"decode-reduce launches (wrappers; profiler {seen})",
              flush=True)
    flat8 = CommEngine(ring(N_WORKERS), make_wire("moniqua", spec8))
    times[1] = host_ms(lambda: flat8.mix(X, theta=2.0, seed=1), reps=10)
    print(f"time: one moniqua-8bit round of the ResNet-20 bucket at K=1, "
          f"host clock: ring(8) {times[1]:.3f} ms | two_tier(8, 2) "
          f"{times[2]:.3f} ms | two_tier(8, 4) {times[4]:.3f} ms {card}",
          flush=True)
    # Trainer.run with tiers=2 on the main path's model
    base = dict(topology="ring", n_workers=N_WORKERS, theta=2.0, lr=0.1,
                momentum=0.9, weight_decay=5e-4, steps=STEPS, log_every=1,
                seed=0, tiers=2)
    for name, kwr, per_step in (("moniqua-8bit", dict(algo="moniqua",
                                                      bits=8), 2),
                                ("dpsgd", dict(algo="dpsgd"), 0)):
        trainer = Trainer(model, TrainerConfig(**base, **kwr),
                          lambda k: batches[k])
        check(trainer.hp.comm_topo().name == "ring4xcomplete2",
              f"tiers=2 {name}: {trainer.hp.comm_topo().name}")
        torch.cuda.synchronize()
        kenc.encode.launches = kdr.decode_reduce.launches = 0
        out = trainer.run()
        torch.cuda.synchronize()
        got = (kenc.encode.launches, kdr.decode_reduce.launches)
        counted["moniqua_encode"] += got[0]
        counted["moniqua_decode_reduce"] += got[1]
        losses = [h["loss"] for h in out["history"]]
        walls = [h["wall"] for h in out["history"]]
        step_ms = 1e3 * (walls[-1] - walls[0]) / (len(walls) - 1)
        mem = trainer.algo.extra_memory_bytes(out["state"]["params"],
                                              trainer.hp)
        want_bytes = (TIER_BYTES[2][2] if name != "dpsgd" else
                      trainer.hp.exact_engine().bytes_per_round(X_cpu))
        check(all(map(math.isfinite, losses)), f"tiers=2 {name}: "
              f"non-finite loss")
        check(losses[-1] < losses[0], f"tiers=2 {name}: loss did not fall")
        check(got == (STEPS * per_step,) * 2, f"tiers=2 {name}: launches "
              f"{got}, want {(STEPS * per_step,) * 2}")
        check((out["bytes_per_step"], mem) == (want_bytes, 0),
              f"tiers=2 {name}: bytes/step, memory "
              f"{(out['bytes_per_step'], mem)}")
        print(f"run {name} tiers=2 (two_tier(8, 2)): losses "
              f"{[round(v, 4) for v in losses]} | launches {got} | "
              f"bytes/step {out['bytes_per_step']} | extra memory {mem}",
              flush=True)
        print(f"time: step {name} tiers=2 (ResNet-20 w16, n={N_WORKERS}, "
              f"{IMAGES} images/worker, mean of steps 1-{STEPS - 1}) "
              f"{step_ms:.3f} ms {card}", flush=True)
    # what the reference's verdict costs the card: the rounds that "auto"
    # moved onto the per-leaf path, beside the bucketed round
    for wire, mask in (("full", None), ("full", TRAIN_MASK), ("qsgd", None)):
        ms, n = {}, {}
        for path in ("bucketed", "auto"):
            eng = CommEngine(ring(N_WORKERS), wire_of(wire, 8), path=path)
            kwp = kw(wire, 0)
            prof = traced(lambda: eng.mix(X, presence=mask, **kwp))
            n[path] = sum(e.count for e in device_kernels(prof))
            ms[path] = host_ms(lambda: eng.mix(X, presence=mask, **kwp),
                               reps=10)
        print(f"time: one {wire} round of the ResNet-20 bucket on ring(8)"
              f"{'' if mask is None else f' mask {mask}'}, host clock: "
              f"bucketed {ms['bucketed']:.3f} ms ({n['bucketed']} kernel "
              f"launches) | auto, per-leaf {ms['auto']:.3f} ms "
              f"({n['auto']}) {card}", flush=True)
    # the same cost a step: D-PSGD under phase 18's mask on both paths
    flat_base = dict(base, tiers=1, algo="dpsgd", presence=TRAIN_MASK,
                     steps=STEPS // 2)
    step_ms = {}
    for path in ("bucketed", "auto", "bucketed", "auto"):
        out = Trainer(model, TrainerConfig(**flat_base, comm_path=path),
                      lambda k: batches[k]).run()
        walls = [h["wall"] for h in out["history"]]
        step_ms.setdefault(path, []).append(
            1e3 * (walls[-1] - walls[0]) / (len(walls) - 1))
    print(f"time: step dpsgd presence {TRAIN_MASK} (ResNet-20 w16, "
          f"n={N_WORKERS}, {IMAGES} images/worker, mean of steps 1-"
          f"{STEPS // 2 - 1}, two runs each, in turns): bucketed "
          + ", ".join(f"{v:.3f}" for v in step_ms["bucketed"])
          + " ms | auto, per-leaf "
          + ", ".join(f"{v:.3f}" for v in step_ms["auto"])
          + f" ms {card}", flush=True)
    print(f"phase 19: two-tier rounds on the ResNet-20 bucket: "
          f"{len(STAGED_WIRES)} wires, two_tier(8, 1) == ring(8) bucketed, "
          f"K=5 == K=1 and card == CPU on two_tier(8, 2) and (8, 4) "
          f"(onebit within {RULE_ULPS} ulp), per-node presence (all-ones == "
          f"None, node 1 absent keeps its intra average and residual), "
          f"fast/slow bytes and WireState equal to the reference's, auto "
          f"verdicts, launches {TIER_LAUNCHES}, Trainer.run tiers=2 "
          f"({n_cases} cases, {time.perf_counter() - t0:.1f} s) {card}",
          flush=True)
    return counted


# -- round-health telemetry, run logs and traces (phase 20) -------------------

# phase 20's rounds: ring(8), ring(8) under phase 18's mask, two_tier(8, 2);
# the routes each takes (path, K); the card's ef_residual_l2 against the
# CPU's (its sum of squares runs in another order on the card: relative)
OBS_LAYOUTS = (("ring", None), ("ring", TRAIN_MASK), ("two_tier", None))
OBS_ROUTES = (("bucketed", 1), ("bucketed", 5), ("per_leaf", 1))
OBS_L2_RTOL = 1e-5
OBS_TURNS = 4                  # in-turn repeats of each host-clock timing
OBS_BAD_THETA = 0.05           # an undersized theta (tests/test_obs.py)


def _label_device_ms(prof) -> dict:
    """Device time under each ``comm.*`` label (the CPU-side label event's
    children), ms."""
    out = {}
    for e in prof.key_averages():
        if (e.key.startswith("comm.")
                and e.device_type == torch.autograd.DeviceType.CPU):
            base = e.key.split("/")[0]
            out[base] = out.get(base, 0.0) + e.device_time_total / 1e3
    return out


def _device_busy_ms(prof) -> float:
    return sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3


def obs_phase(dev, card, model, batches, X_cpu, trained):
    """Phase 20: round-health telemetry on every wire (observational on the
    card, card health == CPU health), the alias sentinel, the trainer's run
    log and Chrome trace, AD-PSGD's edge health, ``SimTrace.to_chrome``,
    the functional kernel codec and ``moniqua_gossip``, and telemetry's and
    the phase labels' cost; returns the counted launches by kernels-line
    entry.  ``trained`` is the main path's params after its 10 steps."""
    from repro_torch import tree
    from repro_torch.comm import gossip
    from repro_torch.comm.engine import CommEngine, MoniquaWire, make_wire
    from repro_torch.core import adpsgd, modulo
    from repro_torch.core.moniqua import MoniquaCodec
    from repro_torch.core.quantizers import QuantSpec
    from repro_torch.core.topology import ring, two_tier
    from repro_torch.kernels import moniqua_decode as kdec
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import runlog, trace as obs_trace
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
    exact = [k for k in obs_metrics.HEALTH_ROUND_KEYS
             if k != "ef_residual_l2"]
    outdir = os.path.join(ROOT, "build", "obs")
    os.makedirs(outdir, exist_ok=True)

    def kw(wire, k):
        if wire == "full":
            return {}
        return dict(seed=2000 + k, **({"theta": 2.0}
                                      if wire == "moniqua" else {}))

    def rounds(eng, X0, presence):
        Xk = X0
        st = eng.init_wire_state(X0) if eng.stateful else None
        out = []
        for k in range(STAGED_ROUNDS):
            r = eng.mix(Xk, state=st, presence=presence,
                        **kw(eng.codec.name, k))
            Xk, st = r.x, (r.state if eng.stateful else None)
            out.append((tree.leaves(Xk), st, r.health))
        return out

    # -- 1-2. on == off on the card, the same across routes, card == CPU ---
    n_cases, l2_worst = 0, 0.0
    for topo_name, mask in OBS_LAYOUTS:
        topo = (ring(N_WORKERS) if topo_name == "ring"
                else two_tier(N_WORKERS, 2))
        presence = mask if topo_name == "ring" else None
        for wire, bits in STAGED_WIRES:
            spec = QuantSpec(min(bits, 8), 1 < bits <= 8)
            what = (f"{wire} {bits}-bit on {topo.name}"
                    + ("" if presence is None else f" mask {presence}"))

            def engine(path, K, tel):
                return CommEngine(topo, make_wire(wire, spec, warmup=2),
                                  path=path, chunks=K, telemetry=tel)

            first = None
            for path, K in OBS_ROUTES:
                on = rounds(engine(path, K, True), X, presence)
                off = rounds(engine(path, K, False), X, presence)
                check(_same_rounds([r[:2] for r in on], [r[:2] for r in off]),
                      f"{what} {path} K={K}: telemetry on != off (card)")
                check(all(r[2] is None for r in off), f"{what}: health off")
                n_cases += 1
                if first is None:
                    first = on
                    continue
                # every round when the routes are bitwise (K = 5), the
                # first (same input) when they are not (per-leaf)
                upto = STAGED_ROUNDS if path == "bucketed" else 1
                for k in range(upto):
                    for key in obs_metrics.HEALTH_ROUND_KEYS:
                        check(torch.equal(first[k][2][key], on[k][2][key]),
                              f"{what} {path} K={K} round {k}: health "
                              f"{key} differs from bucketed K=1")
            cpu = rounds(engine("bucketed", 1, True), X_cpu, presence)
            bitwise = wire in ("full", "moniqua")
            for k in range(STAGED_ROUNDS if bitwise else 1):
                hg, hc = first[k][2], cpu[k][2]
                for key in exact:
                    check(torch.equal(hg[key].cpu(), hc[key]),
                          f"{what} round {k}: health {key} card "
                          f"{float(hg[key])} != CPU {float(hc[key])}")
                a, b = float(hg["ef_residual_l2"]), float(hc["ef_residual_l2"])
                rel = abs(a - b) / max(abs(b), 1e-30)
                check(rel <= OBS_L2_RTOL, f"{what}: ef_residual_l2 card {a} "
                      f"vs CPU {b} (rel {rel:.3g})")
                l2_worst = max(l2_worst, rel)
    print(f"phase 20: telemetry on == off bitwise on the card ({n_cases} "
          f"cases: {len(STAGED_WIRES)} wires x {len(OBS_LAYOUTS)} layouts x "
          f"routes {list(OBS_ROUTES)}, {STAGED_ROUNDS} rounds, x and "
          f"WireState); health equal across routes; card == CPU ({exact} "
          f"exact; ef_residual_l2 within {l2_worst:.3g} relative, limit "
          f"{OBS_L2_RTOL}) {card}", flush=True)

    # -- 3. a telemetered round's launches, beside an untelemetered one ---
    eng_of = {}
    for path, K in OBS_ROUTES + (("bucketed", 61),):
        for tel in (False, True):
            eng_of[path, K, tel] = CommEngine(
                ring(N_WORKERS), MoniquaWire(QuantSpec(8)), path=path,
                chunks=K, telemetry=tel)
    prof_busy, lost = {}, {}
    for path, K in OBS_ROUTES:
        n = (eng_of[path, K, False].round_plan(X, theta=2.0, seed=1)
             .num_chunks if path == "bucketed" else len(tree.leaves(X)))
        seen = {}
        for tel in (False, True):
            eng = eng_of[path, K, tel]
            eng.mix(X, theta=2.0, seed=1)            # untraced warm-up
            want = (n + (1 if tel and (path, K) != ("bucketed", 1) else 0),
                    n)
            zero()
            prof = traced(lambda: eng.mix(X, theta=2.0, seed=1))
            got = read()
            add(counted, got)
            have = (got["moniqua_encode"], got["moniqua_decode_reduce"])
            check(have == want, f"{path} K={K} telemetry={tel}: encode / "
                  f"decode-reduce launches {have}, want {want}")
            prof_seen = _kernel_launches(prof)
            if prof_seen == (0, 0):
                print(f"  profile: {path} K={K} telemetry={tel}: no device "
                      f"kernels recorded (not measured)")
            else:
                check(prof_seen == want, f"{path} K={K} telemetry={tel}: "
                      f"profiler saw {prof_seen}, want {want}; "
                      + window_edges(prof))
            prof_busy[path, K, tel] = _device_busy_ms(prof)
            lost[path, K, tel] = primer_lost(prof)
            seen[tel] = have
        print(f"launches: one moniqua 8-bit round on ring(8), {path} K={K}: "
              f"encode / decode-reduce {seen[False]} untelemetered, "
              f"{seen[True]} telemetered (wrappers and profiler); device "
              f"busy {prof_busy[path, K, False]:.4f} -> "
              f"{prof_busy[path, K, True]:.4f} ms; priming kernels the "
              f"profiler lost {lost[path, K, False]}, {lost[path, K, True]} "
              f"of {PROFILER_PRIME} {card}", flush=True)

    # -- 4. the sentinel on the trained bucket, and firing ----------------
    eng = eng_of["bucketed", 1, True]
    h = eng.mix(trained, theta=2.0, seed=3).health
    check(int(h["alias_count"]) == 0, f"trained bucket at theta 2.0: "
          f"alias_count {int(h['alias_count'])}")
    print(f"sentinel: the main path's trained ResNet-20 ({STEPS} steps) at "
          f"theta 2.0: consensus_inf {float(h['consensus_inf']):.6g}, headroom "
          f"{float(h['headroom']):.6g}, alias_count 0", flush=True)
    gen = torch.Generator().manual_seed(5)
    bad_cpu = {"w": torch.randn((N_WORKERS, 4096), generator=gen) * 3.0}
    bad = tree.map(lambda a: a.to(dev), bad_cpu)
    fired = {}
    for bits in (4, 8):
        e = CommEngine(ring(N_WORKERS), MoniquaWire(QuantSpec(bits)),
                       telemetry=True)
        hg = e.mix(bad, theta=OBS_BAD_THETA, seed=2).health
        hc = e.mix(bad_cpu, theta=OBS_BAD_THETA, seed=2).health
        fired[bits] = int(hg["alias_count"])
        check(fired[bits] > 0 and fired[bits] == int(hc["alias_count"]),
              f"undersized theta {bits}-bit: alias_count card "
              f"{fired[bits]}, CPU {int(hc['alias_count'])}")
    print(f"sentinel: theta {OBS_BAD_THETA} on [8, 4096] of scale 3.0: "
          f"alias_count {fired} (4-, 8-bit), card == CPU", flush=True)

    # -- 5. Trainer.run with telemetry, a run log and a trace -------------
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    base = dict(algo="moniqua", topology="ring", n_workers=N_WORKERS, bits=8,
                theta=2.0, lr=0.1, momentum=0.9, weight_decay=5e-4,
                steps=STEPS, log_every=1, seed=0)
    log = os.path.join(outdir, "trainer_runlog.jsonl")
    trace_path = os.path.join(outdir, "trainer_trace.json")
    runs, step_ms = {}, {}
    for tel in (True, False, True, False):
        extra = (dict(telemetry=True, log_jsonl=log, trace_path=trace_path)
                 if tel else {})
        trainer = Trainer(model, TrainerConfig(**base, **extra),
                          lambda k: batches[k])
        zero()
        out = trainer.run()
        got = read()
        check((got["moniqua_encode"], got["moniqua_decode_reduce"])
              == (STEPS, STEPS), f"trainer telemetry={tel}: launches {got}")
        walls = [hh["wall"] for hh in out["history"]]
        step_ms.setdefault(tel, []).append(
            1e3 * (walls[-1] - walls[0]) / (len(walls) - 1))
        runs[tel] = (trainer, out)
    same = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(runs[True][1]["state"]["params"]),
        tree.leaves(runs[False][1]["state"]["params"])))
    check(same, "Trainer.run telemetry on != off (params, deterministic "
          "cuDNN)")
    hist = runs[True][1]["history"]
    obs_keys = sorted(k for k in hist[-1] if k.startswith("obs_"))
    check(len(obs_keys) == len(obs_metrics.HEALTH_KEYS),
          f"obs metrics {obs_keys}")
    check(not any(k.startswith("obs_") for k in runs[False][1]["history"][-1]),
          "obs_* without telemetry")
    check(runlog.validate_runlog(log) == [], f"run log: "
          f"{runlog.validate_runlog(log)[:3]}")
    records = runlog.read_runlog(log)
    with open(trace_path) as f:
        tobj = json.load(f)
    check(obs_trace.validate_chrome(tobj) == [], "trainer Chrome trace")
    n_spans = sum(e.get("name") == "train.step" and e.get("ph") == "X"
                  for e in tobj["traceEvents"])
    check(n_spans == STEPS, f"trace has {n_spans} train.step spans")
    last = hist[-1]
    print(f"run moniqua-8bit telemetry=True ({STEPS} steps, deterministic "
          f"cuDNN): "
          f"params == telemetry-off run bitwise; obs_alias_total "
          f"{last['obs_alias_total']:.0f}, headroom {last['obs_headroom']:.6g}"
          f", consensus_inf {last['obs_consensus_inf']:.6g}, bits/param "
          f"{last['obs_bits_per_param']:.6g}; run log {len(records)} records "
          f"({len(runlog.step_records(records))} steps, valid), Chrome trace "
          f"{len(tobj['traceEvents'])} events (valid)", flush=True)
    print(f"time: step moniqua-8bit (deterministic cuDNN, mean of steps 1-"
          f"{STEPS - 1}, two runs each, in turns): telemetry on "
          + ", ".join(f"{v:.3f}" for v in step_ms[True]) + " ms | off "
          + ", ".join(f"{v:.3f}" for v in step_ms[False]) + f" ms {card}",
          flush=True)
    # one profiled step: device time under each comm.* label
    trainer, out = runs[True]
    state = out["state"]
    trainer.step_fn(state, batches[0])               # untraced warm-up
    torch.cuda.synchronize()
    prof = traced(lambda: trainer.step_fn(state, batches[0]))
    labels = _label_device_ms(prof)
    busy = _device_busy_ms(prof)
    if busy == 0:
        print("profile: one telemetered step: no device time recorded (not "
              "measured)")
    else:
        print(f"profile: one telemetered moniqua-8bit step: device busy "
              f"{busy:.3f} ms; under the labels " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in sorted(labels.items()))
              + f" {card}", flush=True)

    # -- 6. AD-PSGD with telemetry ----------------------------------------
    spec8 = QuantSpec(8)
    e1 = CommEngine(ring(N_WORKERS), MoniquaWire(spec8))
    p0 = model.init(torch.Generator().manual_seed(0))
    X0 = tree.map(lambda a: a[None].expand((N_WORKERS,) + a.shape), p0)
    lay1 = e1.layout(tree.map(lambda a: a[:1], X0))
    x0 = e1.layout(X0).flatten(X0)
    resnet_grad, calls = bucket_grad(model, batches, lay1)
    cfg = adpsgd.ADPSGDConfig(topo=ring(N_WORKERS),
                              codec=MoniquaCodec(spec8), theta=2.0,
                              max_delay=ADPSGD_DELAY, quantized=True)
    sched = adpsgd.make_schedule(N_WORKERS, ADPSGD_ITERS, cfg, seed=0)
    ad, it_ms = {}, {}
    for turn, tel in enumerate((False, True, False, True)):
        calls[0] = 0
        zero()
        t1 = time.perf_counter()
        res = adpsgd.run(x0, resnet_grad, 0.1, ADPSGD_ITERS,
                         dataclasses.replace(cfg, telemetry=tel),
                         schedule=sched)
        got = read()
        it_ms.setdefault(tel, []).append(
            1e3 * (time.perf_counter() - t1) / ADPSGD_ITERS)
        if turn < 2:                # the second pair only times
            add(counted, got)
            ad[tel] = (res, got)
    check(torch.equal(ad[False][0][0], ad[True][0][0]),
          "AD-PSGD telemetry on != off (X)")
    enc_off, enc_on = (ad[False][1]["moniqua_encode"],
                       ad[True][1]["moniqua_encode"])
    check(enc_off == ADPSGD_ITERS and enc_on == 3 * ADPSGD_ITERS,
          f"AD-PSGD encodes {enc_off} / {enc_on}")
    check(ad[True][1]["moniqua_decode"] == ad[False][1]["moniqua_decode"]
          == 2 * ADPSGD_ITERS, "AD-PSGD point decodes")
    htr = ad[True][0][2]
    check(tuple(htr["consensus_inf"].shape) == (ADPSGD_ITERS,),
          "AD-PSGD health trace shape")
    print(f"run adpsgd-moniqua telemetry=True ({ADPSGD_ITERS} iterations, "
          f"deterministic cuDNN): X == telemetry-off bitwise; encodes "
          f"{enc_off} -> {enc_on} (two extra an iteration); edge alias "
          f"total {int(htr['alias_count'].sum())}, max consensus_inf "
          f"{float(htr['consensus_inf'].max()):.6g}", flush=True)
    print(f"time: AD-PSGD moniqua iteration (ResNet-20 gradient, mean of "
          f"{ADPSGD_ITERS}), host clock, two runs each, in turns: telemetry "
          f"off " + ", ".join(f"{v:.3f}" for v in it_ms[False]) + " ms | on "
          + ", ".join(f"{v:.3f}" for v in it_ms[True]) + f" ms {card}",
          flush=True)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False

    # -- 7. the simulator's timeline as a Chrome trace --------------------
    sc = scenarios.get_scenario("churn-ring", n=N_WORKERS)
    nbytes = eng_of["bucketed", 1, False].payload_bytes_per_broadcast(X)
    strace = events.simulate_sync_rounds(sc.with_deadline(SIM_DEADLINE),
                                         nbytes, SIM_ROUNDS)
    sobj = strace.to_chrome()
    merged = obs_trace.merge_chrome_traces([tobj, sobj])
    check(obs_trace.validate_chrome(sobj) == []
          and obs_trace.validate_chrome(merged) == [],
          "SimTrace.to_chrome / merged trace invalid")
    obs_trace.save_chrome_trace(merged, os.path.join(outdir, "merged.json"))
    print(f"sim: churn-ring {SIM_ROUNDS} rounds -> Chrome trace of "
          f"{len(sobj['traceEvents'])} events (valid), merged with the "
          f"trainer's ({len(merged['traceEvents'])} events, valid)",
          flush=True)

    # -- 8. the functional kernel codec and moniqua_gossip -----------------
    codec = MoniquaCodec(spec8, use_kernels=True)
    lay = e1.layout(X)
    x = lay.flatten(X)
    y_cpu = (lay.flatten(X_cpu) + (torch.rand(x.shape, generator=gen) - 0.5)
             * 1.8 * 2.0)                          # |y - x| < theta
    y = y_cpu.to(dev)
    zero()
    p = codec.encode(x, 2.0, seed=77)
    xh = codec.decode(p, y, 2.0)
    xs = codec.decode_self(p, x, 2.0)
    got = read()
    add(counted, got)
    check(got == {"moniqua_encode": 1, "moniqua_decode_reduce": 0,
                  "moniqua_decode": 2}, f"codec launches {got}")
    p_cpu = codec.encode(x.cpu(), 2.0, seed=77)
    check(torch.equal(p.cpu(), p_cpu), "kernel codec encode card != CPU")
    check(torch.equal(xh.cpu(), codec.decode(p_cpu, y_cpu, 2.0)),
          "kernel codec decode card != CPU")
    B = float(modulo.b_theta(2.0, spec8.delta))
    eps = torch.finfo(torch.float32).eps
    err = float((xh - x).abs().max())
    slack = 4 * eps * max(float(x.abs().max()), B)
    check(err <= codec.max_error(2.0) + slack, f"codec decode error {err} > "
          f"delta B {codec.max_error(2.0)}")
    check(bool(torch.isfinite(xs).all()), "decode_self not finite")
    seeds = list(range(900, 900 + len(tree.leaves(X))))
    zero()
    mg = gossip.moniqua_gossip(X, ring(N_WORKERS), codec, 2.0, seeds=seeds)
    got = read()
    add(counted, got)
    n_leaves = len(tree.leaves(X))
    check(got == {"moniqua_encode": n_leaves, "moniqua_decode_reduce": 0,
                  "moniqua_decode": 3 * n_leaves},
          f"moniqua_gossip launches {got}")
    exact_mix = gossip.mix(X, ring(N_WORKERS))
    w_self = gossip.self_weight(ring(N_WORKERS))
    gap = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(mg), tree.leaves(exact_mix)))
    bound = 2 * (1 - w_self) * codec.max_error(2.0) + slack
    check(all(bool(torch.isfinite(a).all()) for a in tree.leaves(mg))
          and gap <= bound, f"moniqua_gossip {gap} from the exact mix > "
          f"{bound}")
    mg_cpu = gossip.moniqua_gossip(X_cpu, ring(N_WORKERS), codec, 2.0,
                                   seeds=seeds)
    cpu_gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree.leaves(mg), tree.leaves(mg_cpu)))
    print(f"codec: MoniquaCodec(use_kernels=True) on the ResNet-20 bucket "
          f"{list(x.shape)}: encode card == CPU bitwise, decode card == CPU "
          f"bitwise, |x_hat - x| {err:.6g} <= delta B {codec.max_error(2.0)}"
          f"; moniqua_gossip on the ResNet-20 params ({n_leaves} leaves): "
          f"finite, {gap:.6g} from the exact mix (bound {bound:.6g}), card "
          f"vs CPU {cpu_gap:.3g}; launches {got}", flush=True)

    # -- 9. host-clock cost of telemetry and of the phase labels -----------
    ms = {}
    for _ in range(OBS_TURNS):
        for tel in (False, True):
            e = eng_of["bucketed", 1, tel]
            ms.setdefault(tel, []).append(
                host_ms(lambda: e.mix(X, theta=2.0, seed=1), reps=10))
    print(f"time: one moniqua 8-bit round of the ResNet-20 bucket on "
          f"ring(8), bucketed K=1, host clock, in turns: telemetry off "
          + ", ".join(f"{v:.3f}" for v in ms[False]) + " ms | on "
          + ", ".join(f"{v:.3f}" for v in ms[True]) + f" ms {card}",
          flush=True)
    # the labels' cost: entered on every call (labels_on patched to True)
    # against the default, entered only while a profiler records
    e61 = eng_of["bucketed", 61, False]
    lab = {}
    default = obs_trace.labels_on
    try:
        for _ in range(OBS_TURNS):
            for on in (False, True):
                obs_trace.labels_on = (lambda: True) if on else default
                lab.setdefault(on, []).append(
                    host_ms(lambda: e61.mix(X, theta=2.0, seed=1), reps=10))
    finally:
        obs_trace.labels_on = default
    n_labels = 3 * e61.round_plan(X, theta=2.0, seed=1).num_chunks
    print(f"time: phase 15's K=61 moniqua 8-bit round ({n_labels} phase "
          f"labels), host clock, in turns: labels off (the default without a "
          f"profiler) " + ", ".join(f"{v:.3f}" for v in lab[False])
          + " ms | labels entered " + ", ".join(
              f"{v:.3f}" for v in lab[True]) + f" ms {card}", flush=True)
    print(f"phase 20: telemetry observational and card == CPU, launches "
          f"counted, sentinel silent on the trained bucket and firing at "
          f"theta {OBS_BAD_THETA}, Trainer.run run log and trace valid, "
          f"AD-PSGD bitwise, SimTrace.to_chrome valid, kernel codec and "
          f"moniqua_gossip; launches {counted} "
          f"({time.perf_counter() - t0:.1f} s) {card}", flush=True)
    return counted


# -- decentralized LM training and the dense zoo (phase 21) ------------------

LM_ARCH = "llama3.2-3b"
LM_LAYERS = 2                  # depth 28 -> 2; every width as published
LM_WORKERS, LM_SEQ = 4, 2048   # ring(4), one 2048-token sequence a worker
LM_STEPS = 5
ZOO_ARCHS = ("chatglm3-6b", "internlm2-20b", "qwen2-72b")
ZOO_PROMPT, ZOO_GREEDY = 2048, 8
# phase 21's flash-vs-plain check of one worker's loss and gradients: the
# backward is the same recompute on both routes, so they part only through
# the forward's attention output (rounded once to bfloat16 by the kernel,
# twice by the plain path), over 2 layers.  Loss within this share of
# itself; each gradient leaf within BF16_GAP_BOUND of its largest entry.
LM_LOSS_RTOL = 1e-2


def lm_config(arch, layers=LM_LAYERS, **over):
    """The published config of ``arch`` cut to ``layers`` layers (``None``:
    its published depth), with ``over`` replaced."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                               **over)


class Launches:
    """Launch counts of the three flash routes and the two codec wrappers:
    ``zero()`` just before a path, ``read()`` just after it; ``add(got)``
    sums a reading into ``counted``, by kernels-line entry."""

    KEYS = ("flash_attention_tc", "flash_attention_f32tc", "moniqua_encode",
            "moniqua_decode_reduce")

    def __init__(self):
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import moniqua_decode_reduce as kdr
        from repro_torch.kernels import moniqua_encode as kenc
        self.routes = (kfa.flash_attention_tc, kfa.flash_attention_f32tc,
                       kfa.flash_attention_simt)
        self.codec = {"moniqua_encode": kenc.encode,
                      "moniqua_decode_reduce": kdr.decode_reduce}
        self.counted = {}

    def zero(self):
        torch.cuda.synchronize()
        for f in self.routes + tuple(self.codec.values()):
            f.launches = 0

    def read(self) -> dict:
        torch.cuda.synchronize()
        got = {r.__name__: r.launches for r in self.routes}
        got.update({k: f.launches for k, f in self.codec.items()})
        return got

    def add(self, got):
        for k in self.KEYS:
            self.counted[k] = self.counted.get(k, 0) + got[k]


def train_runs(model, shape, base, runs, launches, card, what,
               flash_per_step, before=None):
    """Each of ``runs`` through ``Trainer(model, tc, shape)`` from one seed
    (``Trainer.run`` owns each run's state: the card holds one): finite
    losses, step 0's within 10% of ln V, the bf16 tensor-core flash kernel
    ``flash_per_step`` times a step, the codec kernels as ``path="auto"``
    resolves for the tree, bytes a step equal to the shape-only
    accounting; step time, tokens/s, peak memory, and a profile of two
    steps after the Moniqua run.  ``before(params)`` sees one worker's
    initial parameters first."""
    from repro_torch import tree
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = model.cfg
    n, steps = base["n_workers"], base["steps"]
    p0 = model.init(model.generator(base["seed"]))
    if before is not None:
        before(p0)
    # the stacked tree from its shapes alone (meta tensors), for the
    # port's shape-only accounting of the wire's bytes
    meta = tree.map(lambda a: torch.empty((n,) + a.shape, dtype=a.dtype,
                                          device="meta"), p0)
    del p0
    n_leaves = len(tree.leaves(meta))
    n_params = sum(a[0].numel() for a in tree.leaves(meta))
    # sequence positions a worker: tokens, and whisper's encoder frames or
    # the VLM's patch embeddings beside them
    positions = sum(shp[1] for name, (shp, _) in
                    model.batch_spec(shape).items()
                    if name != "labels") * shape.global_batch // n
    for name, kw in runs.items():
        tr = Trainer(model, TrainerConfig(**base, **kw), shape)
        want_bytes = tr.algo.bytes_per_step(meta, tr.hp)
        path = tr.hp.engine().resolved_path(meta)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches.zero()
        res = tr.run()              # holds no other state: the peak is a run's
        got = launches.read()
        peak = torch.cuda.max_memory_allocated()
        launches.add(got)
        hist = res["history"]
        losses = [h["loss"] for h in hist]
        walls = [h["wall"] for h in hist]
        step_ms = 1e3 * (walls[-1] - walls[0]) / (len(walls) - 1)
        per_step = 1 if path == "bucketed" else n_leaves
        n_codec = steps * per_step if kw["algo"] == "moniqua" else 0
        check(all(map(math.isfinite, losses)), f"{what} {name}: losses "
              f"{losses}")
        check(abs(losses[0] - math.log(cfg.vocab_size))
              <= 0.1 * math.log(cfg.vocab_size),
              f"{what} {name}: step 0's loss {losses[0]} not within 10% of "
              f"ln V = {math.log(cfg.vocab_size):.4f}")
        check(got["flash_attention_tc"] == steps * flash_per_step
              and got["flash_attention_f32tc"] == 0
              and got["flash_attention_simt"] == 0,
              f"{what} {name}: flash launches {got}, want "
              f"{flash_per_step} a step on the bf16 tensor-core kernel")
        check(got["moniqua_encode"] == n_codec
              and got["moniqua_decode_reduce"] == n_codec,
              f"{what} {name}: codec launches {got}, want {n_codec} each "
              f"({path} path, {n_leaves} leaves)")
        check(res["bytes_per_step"] == want_bytes,
              f"{what} {name}: bytes/step {res['bytes_per_step']} != the "
              f"shape-only {want_bytes}")
        print(f"run {what} {name}: {cfg.name} {cfg.num_layers} layers, "
              f"{n_params / 1e6:.1f} M params a worker, ring({n}), "
              f"{positions} positions a worker; path {path}; losses "
              f"{[round(v, 5) for v in losses]}; launches {got}; "
              f"bytes/step {res['bytes_per_step']}", flush=True)
        print(f"time: {what} step {name} {step_ms:.3f} ms (host clock, card "
              f"synchronised, mean of steps 1-{steps - 1}), "
              f"{n * positions / step_ms * 1e3:.0f} positions/s; "
              f"max_memory_allocated {peak / 2 ** 30:.2f} GiB {card}",
              flush=True)
        if kw["algo"] == "moniqua":
            state = res["state"]
            del res
            batches = [tr.batch_fn(k) for k in (steps, steps + 1)]

            def two_steps():
                nonlocal state
                for b in batches:
                    state, _ = tr.step_fn(state, b)
            t_prof = time.perf_counter()
            profile_device(two_steps, f"2 {what} {name} steps", card)
            print(f"time: the profile of 2 {what} {name} steps took "
                  f"{time.perf_counter() - t_prof:.1f} s of host time, "
                  f"recording and reading included", flush=True)
            del state, batches
        else:
            del res
        del tr
        torch.cuda.empty_cache()


def lemma2_check(model, shape, base, runs, dev, what):
    """Lemma 2 on an LM tree: one step of each rule from one state and one
    direction, ``|X_moniqua - X_dpsgd| <= 2 (1 - w_ii) delta B`` plus two
    bf16 ulps.  Returns worker 0's parameters after one Moniqua step and
    its next batch, for ``flash_vs_plain``."""
    from repro_torch import tree
    from repro_torch.core import modulo
    from repro_torch.core.algorithms import get_algorithm
    from repro_torch.core.quantizers import delta_for_bits
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.optim import sgd as optim
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tc1 = TrainerConfig(**dict(base, steps=1), **runs["moniqua-8bit"])
    tr1 = Trainer(model, tc1, shape)
    s1 = tr1.run()["state"]
    X1 = s1["params"]
    batch = tr1.batch_fn(1)
    grads, _ = torch.func.vmap(torch.func.grad_and_value(model.loss))(
        X1, batch)
    check(all(bool(torch.isfinite(g).all()) for g in tree.leaves(grads)),
          f"{what}: a gradient leaf is not finite")
    dirs, _, _ = optim.direction(tr1.tcfg.sgd, grads, X1, s1["mom"])
    del grads, s1["mom"]
    torch.cuda.empty_cache()
    Xm, _ = get_algorithm("moniqua").step(X1, s1["extra"], dirs, 0.1, 1,
                                          0x5EED, tr1.hp)
    Xd, _ = get_algorithm("dpsgd").step(X1, {}, dirs, 0.1, 1, None, tr1.hp)
    del dirs
    topo = tr1.hp.topo
    w_self = sum(w for o, w in zip(topo.offsets, topo.weights)
                 if o % topo.n == 0)
    dB = delta_for_bits(8, True) * float(modulo.b_theta(
        2.0, delta_for_bits(8, True), dev))
    lemma = 2 * (1 - w_self) * dB
    worst = worst_ratio = 0.0
    ok = True
    for a, b in zip(tree.leaves(Xm), tree.leaves(Xd)):
        for w in range(base["n_workers"]):
            af, bf = a[w].float(), b[w].float()
            err = (af - bf).abs()
            tol = lemma + kfa.bf16_ulp(af) + kfa.bf16_ulp(bf)
            ok = ok and bool((err <= tol).all())
            worst = max(worst, float(err.max()))
            worst_ratio = max(worst_ratio, float((err / tol).max()))
    check(ok, f"{what} Lemma 2: |X_moniqua - X_dpsgd| {worst:.6g} above "
          f"2 (1 - w_ii) delta B = {lemma:.6g} plus two bf16 ulps")
    print(f"{what}: Lemma 2 on the LM tree (one step of each rule from one "
          f"state and one direction): max |X_moniqua - X_dpsgd| {worst:.6g} "
          f"<= 2 (1 - w_ii) delta B = {lemma:.6g} (w_ii {w_self:.6g}, "
          f"delta B {dB:.6g}) plus two bf16 ulps of |X| (worst "
          f"{worst_ratio:.4f} of the bound); every gradient leaf finite",
          flush=True)
    return (tree.map(lambda a: a[0].clone(), X1),
            {k: v[0] for k, v in batch.items()})


def flash_vs_plain(model, plain, p0, b0, launches, flash_per_call,
                   loss_rtol, grad_bound, what):
    """One worker's loss and gradients through the flash route against the
    plain one (``flash_attention=False``)."""
    from repro_torch import tree

    torch.cuda.empty_cache()
    launches.zero()
    gf, lf = torch.func.grad_and_value(model.loss)(p0, b0)
    check(launches.read()["flash_attention_tc"] == flash_per_call,
          f"{what} flash-route gradient: flash launches, want "
          f"{flash_per_call}")
    gp, lp = torch.func.grad_and_value(plain.loss)(p0, b0)
    loss_gap = abs(float(lf) - float(lp)) / abs(float(lp))
    grad_gap = max(float((a.float() - b.float()).abs().max())
                   / float(b.float().abs().max())
                   for a, b in zip(tree.leaves(gf), tree.leaves(gp)))
    check(loss_gap <= loss_rtol and grad_gap <= grad_bound,
          f"{what} flash vs plain: loss {loss_gap:.4g} (bound {loss_rtol}), "
          f"gradients {grad_gap:.4g} of a leaf's max (bound {grad_bound})")
    print(f"{what}: one worker's loss and gradients, flash route vs plain "
          f"(flash_attention=False): loss {float(lf):.6f} vs "
          f"{float(lp):.6f} ({loss_gap:.3g} relative, bound "
          f"{loss_rtol}); worst gradient leaf {grad_gap:.4g} of its max "
          f"(bound {grad_bound})", flush=True)
    del gf, gp
    torch.cuda.empty_cache()


def flash_times(dev, timer, card, bh, hk, s, d, what, window=0):
    """The bf16 tensor-core flash kernel at ``[bh, s, d]`` against ``hk``
    KV blocks, causal (a window, if any, no shorter than ``s``): checked
    against the plain version, timed beside it, SDPA and the bound."""
    from repro_torch.kernels import flash_attention as kfa

    check(window == 0 or window >= s, f"flash_times: window {window} < {s}")
    gen = torch.Generator(device=dev).manual_seed(21)
    qt = torch.randn((bh, s, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    kt, vt = (torch.randn((hk, s, d), generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
    kw = dict(scale=1.0 / math.sqrt(d), causal=True, window=window)
    ok_t, err_t, _ = kfa.flash_close(
        kfa.flash_attention_tc(qt, kt, vt, **kw),
        kfa.flash_attention_plain(qt.float(), kt.float(), vt.float(), **kw))
    check(ok_t, f"flash at {what} [{bh}, {s}, {d}]: max abs err {err_t}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4 * d * bh * causal_pairs(s)
    nbytes = 2 * (2 * bh + 2 * hk) * s * d
    out = dict(
        shape=[bh, s, d], kv_blocks=hk, window=window, max_abs_err=err_t,
        ms=timer(lambda: kfa.flash_attention_tc(qt, kt, vt, **kw), reps=20,
                 warmup=2),
        plain_ms=timer(lambda: kfa.flash_attention_plain(qt, kt, vt, **kw),
                       reps=5, warmup=1),
        bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                           flops / BF16_OPS_PER_S),
        bound_by="operations" if flops / BF16_OPS_PER_S
        > nbytes / HBM_BYTES_PER_S else "bytes",
        library_ms=timer(lambda: sdpa(qt[None], kt[None], vt[None],
                                      is_causal=True, enable_gqa=True),
                         reps=20, warmup=2))
    print(f"time: flash_attention_tc at {what} {out['shape']} bf16, {hk} KV "
          f"blocks, causal, window {window}: kernel {out['ms']:.4f} ms | "
          f"plain {out['plain_ms']:.3f} ms | SDPA {out['library_ms']:.4f} ms "
          f"| bound {out['bound_ms']:.4f} ms ({out['bound_by']}) {card}",
          flush=True)
    del qt, kt, vt
    torch.cuda.empty_cache()
    return out


def serve_cell(model, params, prompt, greedy, launches, flash_per_prefill,
               gap_bound, what, card, detail="", gap_fn=None,
               n_batch=SERVE_BATCH, prime=None):
    """An ``n_batch x prompt`` prefill (``batch_spec`` at ``seq_len =
    prompt``) through ``make_prefill_step`` (the bf16 tensor-core flash
    kernel ``flash_per_prefill`` times, finite logits, within
    ``gap_bound`` x max|logit| of the plain route), its host time, then
    ``greedy`` tokens through ``make_serve_step`` against a
    ``prompt``-slot cache.  ``gap_fn(batch) -> (gap, note)`` replaces the
    last-position comparison with the plain route; ``prime(batch, cache)
    -> cache`` fills the cache first (whisper's cross K/V).  Returns the
    greedy tokens."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.models.model_factory import Model
    from repro_torch.train.serve_step import make_prefill_step, make_serve_step

    cfg = model.cfg
    batch = SyntheticLMPipeline(model, InputShape(
        "serve_prefill", prompt, n_batch, "prefill"), 1,
        seed=1).global_batch(0)
    positions = n_batch * sum(v.shape[1] for v in batch.values())
    shapes = {k: list(v.shape) for k, v in batch.items()}
    prefill = make_prefill_step(model)
    launches.zero()
    logits = prefill(params, batch)
    got = launches.read()
    launches.add(got)
    check(got["flash_attention_tc"] == flash_per_prefill
          and got["flash_attention_f32tc"] == 0
          and got["flash_attention_simt"] == 0,
          f"{what} prefill flash launches {got}, want {flash_per_prefill}")
    check(bool(torch.isfinite(logits).all()), f"{what} prefill logits")
    if gap_fn is None:
        plain = Model(dataclasses.replace(cfg, flash_attention=False),
                      model.device)
        ref = make_prefill_step(plain)(params, batch)
        gap = float((logits - ref).abs().max()) / float(ref.abs().max())
        note = ""
        del ref
    else:
        gap, note = gap_fn(batch)
    check(gap <= gap_bound, f"{what} flash vs plain prefill {gap:.4g} x "
          f"max|logit| > {gap_bound}")
    pre_ms = host_ms(lambda: prefill(params, batch), reps=3)
    serve = make_serve_step(model)
    cache = model.init_cache(n_batch, InputShape(
        "serve_decode", prompt, n_batch, "decode"))
    if prime is not None:
        with torch.no_grad():
            cache = prime(batch, cache)
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True).int()
    out_d, cache = serve(params, cache, tok)
    torch.cuda.synchronize()
    tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(greedy - 1):
        tok = out_d[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True).int()
        tokens.append(tok)
        out_d, cache = serve(params, cache, tok)
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t0) / (greedy - 1)
    check(bool(torch.isfinite(out_d).all()), f"{what} decode")
    check(int(cache["pos"]) == greedy, f"{what} cache pos")
    print(f"{what}{detail}, {n_batch} x {prompt} prompt ({shapes}): "
          f"tensor-core flash "
          f"launched {got['flash_attention_tc']} times in one prefill; "
          f"flash vs plain prefill {gap:.4g} x max|logit| (bound "
          f"{gap_bound}){note}; {greedy} greedy tokens at a {prompt}-slot "
          f"cache: {torch.cat(tokens, 1).tolist()}", flush=True)
    print(f"time: {what} prefill {n_batch} x {prompt} {pre_ms:.2f} ms "
          f"({positions / pre_ms * 1e3:.0f} positions/s), decode "
          f"{dec_ms:.3f} ms a token (host clock) {card}", flush=True)
    del cache, logits, out_d, batch
    torch.cuda.empty_cache()
    return tokens


def lm_phase(dev, timer, card):
    """Phase 21: decentralized LM training through ``Trainer(model, tc,
    shape)`` (llama3.2-3b at its published widths, 2 layers, ring(4), the
    flash kernel in the vmapped step), Lemma 2 on the LM tree, flash vs
    plain gradients, then the three new dense configs served at published
    widths.  Returns the launches on these paths by kernels-line entry and
    the flash kernel's times at the training shape."""
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.models.model_factory import Model

    t_phase = time.perf_counter()
    launches = Launches()
    cfg = lm_config(LM_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.flash_attention,
          f"{LM_ARCH}: dtype {cfg.dtype}, flash {cfg.flash_attention}")
    model = Model(cfg, "cuda")
    shape = InputShape("lm_train", LM_SEQ, LM_WORKERS, "train")
    base = dict(topology="ring", n_workers=LM_WORKERS, theta=2.0, lr=0.1,
                momentum=0.9, weight_decay=5e-4, steps=LM_STEPS,
                log_every=1, seed=0)
    runs = {"moniqua-8bit": dict(algo="moniqua", bits=8),
            "dpsgd": dict(algo="dpsgd")}
    train_runs(model, shape, base, runs, launches, card, "LM",
               cfg.num_layers)
    p0, b0 = lemma2_check(model, shape, base, runs, dev, "phase 21")
    flash_vs_plain(model, Model(lm_config(LM_ARCH, flash_attention=False),
                                "cuda"), p0, b0, launches,
                   cfg.num_layers, LM_LOSS_RTOL, BF16_GAP_BOUND, "phase 21")
    del p0, b0
    torch.cuda.empty_cache()
    train_flash = flash_times(dev, timer, card, cfg.num_heads * LM_WORKERS,
                              cfg.num_kv_heads * LM_WORKERS, LM_SEQ, cfg.hd,
                              "the LM training shape")

    # -- the three new dense configs, served at published widths -----------
    gen = torch.Generator(device=dev).manual_seed(21)
    for arch in ZOO_ARCHS:
        mz = Model(lm_config(arch), "cuda")
        zcfg = mz.cfg
        params = mz.init(mz.generator(0))
        if zcfg.qkv_bias:              # zeros at init: exercise the path
            attn = params["blocks"]["attn"]
            for name in ("bq", "bk", "bv"):
                attn[name] = 0.1 * torch.randn(
                    attn[name].shape, generator=gen, device=dev
                ).to(attn[name].dtype)
        n_params = sum(a.numel() for a in tree.leaves(params))
        g = zcfg.num_heads // zcfg.num_kv_heads
        serve_cell(mz, params, ZOO_PROMPT, ZOO_GREEDY, launches,
                   zcfg.num_layers, BF16_GAP_BOUND,
                   f"phase 21: {arch} ({zcfg.num_layers} layers)", card,
                   f" at published widths ({n_params / 1e9:.3f} B params, "
                   f"GQA group {g}, rope_fraction {zcfg.rope_fraction}, "
                   f"qkv_bias {zcfg.qkv_bias})")
        del params
        torch.cuda.empty_cache()
    print(f"phase 21: LM training and the dense zoo passed in "
          f"{time.perf_counter() - t_phase:.1f} s; launches on its paths "
          f"{launches.counted}", flush=True)
    return launches.counted, train_flash


# -- the MoE family and the Mamba2 hybrid (phase 22) -------------------------

MOE_ARCHS = ("dbrx-132b", "grok-1-314b")
MOE_SERVE_LAYERS = 2           # depths 40 and 64 -> 2; every width as published
# MoE training: dbrx-132b's routing and attention at published widths, cut
# only in depth (40 -> 1) and expert width (d_ff 10752 -> 1344), which
# leaves 1.72 B parameters a worker: two workers' params, float32 momentum,
# gradients and update passes fit one card, where d_ff 10752 would not
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_DFF = "dbrx-132b", 1, 1344
MOE_WORKERS = 2                # ring(2), one 2048-token sequence a worker
HYB_ARCH = "zamba2-1.2b"
HYB_PROMPT, HYB_GREEDY = 4096, 32
HYB_TRAIN_LAYERS = 12          # 38 -> 12: two calls of the shared block
HYB_WORKERS = 4                # ring(4), one 2048-token sequence a worker
P22_STEPS = 3
# bytes a parameter-worker that phase 21's llama training peaked at (its
# max_memory_allocated over 4 workers x 989.3 M parameters): the reckoning
# of the MoE training peak before it runs
PEAK_BYTES_PER_PARAM = 16.5
# Phase 22 holds the flash route to the plain one with phase 21's bounds:
# prefill logits within BF16_GAP_BOUND x max|logit| (for MoE over the
# tokens routed alike in both routes), one worker's loss within
# LM_LOSS_RTOL and its gradients within BF16_GAP_BOUND of each leaf's max.
# The routes part through bf16 rounding alone (the plain path rounds the
# scores and softmax weights to bf16, the kernel keeps them in float32),
# and the gap grows with depth: 38 bf16 Mamba2 layers follow zamba's first
# shared-attention call.


class RouteRecorder:
    """While active, records each ``models.moe.route`` call's routing:
    per token (rows in ``[B * S]`` order), its top-k experts and whether
    each choice kept its capacity slot, ``[tokens, 2K]``."""

    def __enter__(self):
        from repro_torch.models import moe as M
        self.M, self.orig, self.seen = M, M.route, []

        def spy(p, xg, moe_cfg):
            out = self.orig(p, xg, moe_cfg)
            topi, dispatch = out[1], out[2]
            kept = dispatch.sum(-1).gather(-1, topi) > 0          # [G, g, K]
            self.seen.append(torch.cat([topi, kept.long()], -1)
                             .reshape(-1, 2 * topi.shape[-1]))
            return out
        M.route = spy
        return self

    def __exit__(self, *exc):
        self.M.route = self.orig


def moe_gap(model, params):
    """``serve_cell``'s comparison for MoE: full prefill logits of the flash
    and the plain route, over the tokens whose routing (top-k experts and
    kept slots, every layer) is the same in both."""
    from repro_torch.models.model_factory import Model

    plain = Model(dataclasses.replace(model.cfg, flash_attention=False),
                  model.device)

    def gap_fn(batch):
        with torch.no_grad():
            with RouteRecorder() as rf:
                lf = model.prefill_logits(params, batch)
            with RouteRecorder() as rp:
                lp = plain.prefill_logits(params, batch)
        same = torch.stack([(a == b).all(-1) for a, b in
                            zip(rf.seen, rp.seen)]).all(0)
        same = same.reshape(lf.shape[:2])
        n_same, n = int(same.sum()), same.numel()
        check(n_same > 0, "MoE prefill: no token routed alike in both routes")
        gap = float((lf - lp).abs()[same].max()) / float(lp.abs().max())
        del lf, lp
        return gap, (f" over the {n_same} of {n} tokens routed alike at every "
                     f"layer ({100 * (n - n_same) / n:.4f}% rerouted)")
    return gap_fn


def moe_hybrid_phase(dev, timer, card):
    """Phase 22: the MoE family (dbrx-132b, grok-1-314b) and the Mamba2
    hybrid (zamba2-1.2b) through the port's entry points: (a) both MoE
    configs served at published widths, 2 layers; (b) dbrx-132b trained
    (1 layer, d_ff 1344, ring(2)); (c) zamba2-1.2b served as published;
    (d) zamba2-1.2b trained (12 layers, ring(4)).  Returns the launches on
    these paths by kernels-line entry and the flash kernel's times at the
    two training shapes."""
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.models import transformer as T
    from repro_torch.models import zamba as Z
    from repro_torch.models.model_factory import Model

    t_phase = time.perf_counter()
    launches = Launches()
    runs = {"moniqua-8bit": dict(algo="moniqua", bits=8),
            "dpsgd": dict(algo="dpsgd")}

    def base(n):
        return dict(topology="ring", n_workers=n, theta=2.0, lr=0.1,
                    momentum=0.9, weight_decay=5e-4, steps=P22_STEPS,
                    log_every=1, seed=0)

    # -- (a) MoE serving at published widths ------------------------------
    for arch in MOE_ARCHS:
        model = Model(lm_config(arch, MOE_SERVE_LAYERS), "cuda")
        cfg = model.cfg
        check(cfg.family == "moe" and cfg.dtype == "bfloat16"
              and cfg.flash_attention, f"{arch}: {cfg.family} {cfg.dtype}")
        params = model.init(model.generator(0))
        n_params = sum(a.numel() for a in tree.leaves(params))
        moe = cfg.moe
        serve_cell(model, params, ZOO_PROMPT, ZOO_GREEDY, launches,
                   cfg.num_layers, BF16_GAP_BOUND,
                   f"phase 22 (a): {arch} ({cfg.num_layers} layers)", card,
                   f" at published widths ({n_params / 1e9:.3f} B params, "
                   f"d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
                   f"of {cfg.hd}: GQA group "
                   f"{cfg.num_heads // cfg.num_kv_heads}; E {moe.num_experts} "
                   f"top-{moe.top_k}, cf {moe.capacity_factor}, group "
                   f"{moe.group_size}, d_ff {cfg.d_ff}; depth "
                   f"{lm_config(arch, None).num_layers} -> {cfg.num_layers})",
                   gap_fn=moe_gap(model, params))
        del params, model
        torch.cuda.empty_cache()

    # -- (b) MoE training --------------------------------------------------
    cfg = lm_config(MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, d_ff=MOE_TRAIN_DFF)
    model = Model(cfg, "cuda")
    shape = InputShape("moe_train", LM_SEQ, MOE_WORKERS, "train")
    n_params = cfg.param_count()
    reckoned = PEAK_BYTES_PER_PARAM * n_params * MOE_WORKERS
    print(f"phase 22 (b): {MOE_TRAIN_ARCH} cut: depth "
          f"{lm_config(MOE_TRAIN_ARCH, None).num_layers} -> {cfg.num_layers}, "
          f"d_ff {lm_config(MOE_TRAIN_ARCH, None).d_ff} -> {cfg.d_ff}; "
          f"{MOE_WORKERS} workers on ring({MOE_WORKERS}), {LM_SEQ} tokens a "
          f"worker ({LM_SEQ // cfg.moe.group_size} dispatch groups); "
          f"{n_params / 1e9:.4f} B params a worker, reckoned peak "
          f"{reckoned / 1e9:.1f} GB at {PEAK_BYTES_PER_PARAM} bytes a "
          f"parameter-worker", flush=True)
    check(reckoned < 75e9, f"MoE training reckoned at {reckoned / 1e9:.1f} "
          f"GB: cut d_ff further")

    def loss_parts(p0):
        b = SyntheticLMPipeline(model, shape, MOE_WORKERS,
                                seed=0).worker_batch(0)
        with torch.no_grad():
            logits, aux = T.lm_logits(p0, cfg, b["tokens"][0])
            xe = T.xent(logits, b["labels"][0], cfg.vocab_size)
        w = cfg.moe.aux_loss_weight
        check(math.isfinite(float(xe)) and 0 < float(aux) < math.inf,
              f"MoE step 0 loss parts: xent {float(xe)}, aux {float(aux)}")
        print(f"phase 22 (b): step 0's loss on worker 0 = xent "
              f"{float(xe):.6f} + {w} x aux {float(aux):.6f} = "
              f"{float(xe + w * aux):.6f}", flush=True)
        del logits
    train_runs(model, shape, base(MOE_WORKERS), runs, launches, card, "MoE",
               cfg.num_layers, before=loss_parts)
    p0, b0 = lemma2_check(model, shape, base(MOE_WORKERS), runs, dev,
                          "phase 22 (b)")
    del p0, b0, model
    torch.cuda.empty_cache()
    moe_flash = flash_times(dev, timer, card, cfg.num_heads * MOE_WORKERS,
                            cfg.num_kv_heads * MOE_WORKERS, LM_SEQ, cfg.hd,
                            "the MoE training (and prefill) shape")

    # -- (c) zamba2-1.2b served as published -------------------------------
    model = Model(lm_config(HYB_ARCH, None), "cuda")
    cfg = model.cfg
    check(cfg.family == "hybrid" and cfg.dtype == "bfloat16"
          and cfg.flash_attention, f"{HYB_ARCH}: {cfg.family} {cfg.dtype}")
    params = model.init(model.generator(0))
    n_params = sum(a.numel() for a in tree.leaves(params))
    n_inv = Z.n_shared_invocations(cfg)
    serve_cell(model, params, HYB_PROMPT, HYB_GREEDY, launches, n_inv,
               BF16_GAP_BOUND, f"phase 22 (c): {HYB_ARCH} ({cfg.num_layers} "
               f"layers)", card,
               f" as published ({n_params / 1e9:.4f} B params, d "
               f"{cfg.d_model}, SSM state {cfg.ssm.state_dim}, expand "
               f"{cfg.ssm.expand}, chunk {cfg.ssm.chunk}; the shared block "
               f"once every {cfg.shared_attn_every} layers: {n_inv} calls, "
               f"{cfg.num_heads} heads of {cfg.hd}, window "
               f"{cfg.long_context_window})")
    del params, model
    torch.cuda.empty_cache()

    # -- (d) zamba2-1.2b training ------------------------------------------
    cfg = lm_config(HYB_ARCH, HYB_TRAIN_LAYERS)
    model = Model(cfg, "cuda")
    shape = InputShape("hybrid_train", LM_SEQ, HYB_WORKERS, "train")
    n_inv = Z.n_shared_invocations(cfg)
    print(f"phase 22 (d): {HYB_ARCH} cut: depth "
          f"{lm_config(HYB_ARCH, None).num_layers} -> {cfg.num_layers} "
          f"({n_inv} calls of the shared block); {HYB_WORKERS} workers on "
          f"ring({HYB_WORKERS}), {LM_SEQ} tokens a worker "
          f"({LM_SEQ // cfg.ssm.chunk} SSD chunks)", flush=True)
    train_runs(model, shape, base(HYB_WORKERS), runs, launches, card,
               "zamba", n_inv)
    p0, b0 = lemma2_check(model, shape, base(HYB_WORKERS), runs, dev,
                          "phase 22 (d)")
    flash_vs_plain(model, Model(lm_config(HYB_ARCH, HYB_TRAIN_LAYERS,
                                          flash_attention=False), "cuda"),
                   p0, b0, launches, n_inv, LM_LOSS_RTOL, BF16_GAP_BOUND,
                   "phase 22 (d)")
    del p0, b0, model
    torch.cuda.empty_cache()
    hyb_flash = flash_times(dev, timer, card, cfg.num_heads * HYB_WORKERS,
                            cfg.num_kv_heads * HYB_WORKERS, LM_SEQ, cfg.hd,
                            "the zamba training shape",
                            window=cfg.long_context_window)
    print(f"phase 22: the MoE family and the Mamba2 hybrid passed in "
          f"{time.perf_counter() - t_phase:.1f} s; launches on its paths "
          f"{launches.counted} {card}", flush=True)
    return launches.counted, [moe_flash, hyb_flash]


# -- the rest of the zoo: xlstm, whisper, phi-3-vision (phase 23) ------------

XL_ARCH, WH_ARCH, VLM_ARCH = "xlstm-125m", "whisper-base", "phi-3-vision-4.2b"
XL_PROMPT, XL_F32_PROMPT = 2048, 256
# xlstm training: ring(8), the paper's topology, 2048 tokens a worker
XL_WORKERS = 8
# whisper: 16 windows of 30 s, the reference's batch_spec at seq_len 3000:
# 1500 encoder frames and min(448, 3000 / 8) = 375 decoder tokens a window
WH_BATCH, WH_SEQ = 16, 3000
WH_F32_SEQ = 512               # float32 check: 256 frames, 64 decoder tokens
WH_WORKERS = 8                 # ring(8), one window a worker
VLM_PROMPT = 4096              # 576 patches + 3520 text tokens
VLM_TRAIN_LAYERS = 2           # depth 32 -> 2; every width as published
VLM_WORKERS, VLM_SEQ = 4, 2048  # ring(4), 576 patches + 1472 text tokens
P23_GREEDY = 32


def f32_decode_check(model, params, shape, launches, flash_f32, what,
                     prime=None):
    """A float32 model's prefill of ``shape``'s batch (the float32
    tensor-core flash kernel ``flash_f32`` times) against the prompt fed
    token by token through ``make_serve_step``: the last position within
    ``F32_LOGIT_TOL`` x max|logit| (phase 9's bound).  ``prime(batch,
    cache) -> cache`` fills the cache first."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.train.serve_step import make_prefill_step, make_serve_step

    batch = SyntheticLMPipeline(model, shape, 1, seed=2).global_batch(0)
    tokens = batch["tokens"]
    launches.zero()
    want = make_prefill_step(model)(params, batch)
    got = launches.read()
    launches.add(got)
    check(got["flash_attention_f32tc"] == flash_f32
          and got["flash_attention_tc"] == 0
          and got["flash_attention_simt"] == 0,
          f"{what} float32 prefill flash launches {got}, want {flash_f32}")
    cache = model.init_cache(shape.global_batch, shape)
    serve = make_serve_step(model)
    with torch.no_grad():
        if prime is not None:
            cache = prime(batch, cache)
        for t in range(tokens.shape[1]):
            logits, cache = serve(params, cache, tokens[:, t:t + 1])
    scale = float(want.abs().max())
    gap = float((logits - want).abs().max()) / scale
    check(bool(torch.isfinite(logits).all()) and gap <= F32_LOGIT_TOL,
          f"{what} float32 decode vs prefill {gap:.3g} x max|logit| > "
          f"{F32_LOGIT_TOL}")
    print(f"{what}: float32, {list(tokens.shape)} tokens fed one at a time "
          f"through make_serve_step vs prefill's last position: {gap:.3g} x "
          f"max|logit| (bound {F32_LOGIT_TOL}); float32 flash launches in "
          f"the prefill {got['flash_attention_f32tc']}", flush=True)


def zoo_phase(dev, timer, card):
    """Phase 23: the rest of the zoo through the port's entry points: (a)
    xlstm-125m served as published, and a float32 copy's decode against
    its prefill; (b) xlstm-125m trained on ring(8); (c) whisper-base served
    as published (16 windows), and a float32 check; (d) whisper-base
    trained on ring(8); (e) phi-3-vision-4.2b served as published; (f)
    phi-3-vision-4.2b trained (2 layers, ring(4)).  Returns the launches on
    these paths by kernels-line entry and the flash kernel's times at
    whisper's and phi-3-vision's prefill shapes."""
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.models import whisper as WH
    from repro_torch.models.model_factory import Model

    t_phase = t_part = time.perf_counter()
    launches = Launches()
    runs = {"moniqua-8bit": dict(algo="moniqua", bits=8),
            "dpsgd": dict(algo="dpsgd")}

    def base(n):
        return dict(topology="ring", n_workers=n, theta=2.0, lr=0.1,
                    momentum=0.9, weight_decay=5e-4, steps=P22_STEPS,
                    log_every=1, seed=0)

    def part_done(part):
        nonlocal t_part
        now = time.perf_counter()
        print(f"phase 23 ({part}) took {now - t_part:.1f} s", flush=True)
        t_part = now

    def published(arch, **over):
        model = Model(lm_config(arch, None, **over), "cuda")
        params = model.init(model.generator(0))
        n_params = sum(a.numel() for a in tree.leaves(params))
        return model, params, n_params

    # -- (a) xlstm-125m served as published ---------------------------------
    model, params, n_params = published(XL_ARCH)
    cfg = model.cfg
    check(cfg.family == "ssm" and cfg.dtype == "bfloat16",
          f"{XL_ARCH}: {cfg.family} {cfg.dtype}")
    n_s = sum(model._is_slstm(i) for i in range(cfg.num_layers))
    serve_cell(model, params, XL_PROMPT, P23_GREEDY, launches, 0,
               BF16_GAP_BOUND, f"phase 23 (a): {XL_ARCH}", card,
               f" as published ({n_params:,} params, d {cfg.d_model}, "
               f"{cfg.num_heads} heads of {cfg.d_model // cfg.num_heads}; "
               f"{n_s} sLSTM and {cfg.num_layers - n_s} mLSTM blocks, chunk "
               f"{cfg.ssm.chunk})",
               gap_fn=lambda batch: (0.0, " (no attention layer: the flash "
                                     "and plain routes are one path)"))
    del params, model
    m32, p32, _ = published(XL_ARCH, dtype="float32")
    f32_decode_check(m32, p32, InputShape("xl_f32", XL_F32_PROMPT,
                                          SERVE_BATCH, "prefill"),
                     launches, 0, "phase 23 (a)")
    del m32, p32
    torch.cuda.empty_cache()
    part_done("a")

    # -- (b) xlstm-125m trained as published --------------------------------
    model = Model(lm_config(XL_ARCH, None), "cuda")
    shape = InputShape("xlstm_train", LM_SEQ, XL_WORKERS, "train")
    print(f"phase 23 (b): {XL_ARCH} as published on ring({XL_WORKERS}), "
          f"{LM_SEQ} tokens a worker ({LM_SEQ // model.cfg.ssm.chunk} "
          f"mLSTM chunks of {model.cfg.ssm.chunk})", flush=True)
    train_runs(model, shape, base(XL_WORKERS), runs, launches, card,
               "xlstm", 0)
    p0, b0 = lemma2_check(model, shape, base(XL_WORKERS), runs, dev,
                          "phase 23 (b)")
    del p0, b0, model
    torch.cuda.empty_cache()
    part_done("b")

    # -- (c) whisper-base served as published --------------------------------
    model, params, n_params = published(WH_ARCH)
    cfg = model.cfg
    check(cfg.family == "audio" and cfg.dtype == "bfloat16"
          and cfg.flash_attention, f"{WH_ARCH}: {cfg.family} {cfg.dtype}")
    serve_cell(model, params, WH_SEQ, P23_GREEDY, launches, cfg.num_layers,
               BF16_GAP_BOUND, f"phase 23 (c): {WH_ARCH}", card,
               f" as published ({n_params:,} params, {cfg.encoder_layers} + "
               f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} "
               f"heads of {cfg.hd}, tied head; encoder and cross attention "
               f"on the plain route)", n_batch=WH_BATCH,
               prime=lambda b, c: WH.whisper_prefill_cross(
                   params, cfg, b["enc_embeds"], c))
    del params, model
    m32, p32, _ = published(WH_ARCH, dtype="float32")
    f32_decode_check(m32, p32, InputShape("wh_f32", WH_F32_SEQ, SERVE_BATCH,
                                          "prefill"),
                     launches, m32.cfg.num_layers, "phase 23 (c)",
                     prime=lambda b, c: WH.whisper_prefill_cross(
                         p32, m32.cfg, b["enc_embeds"], c))
    del m32, p32
    torch.cuda.empty_cache()
    part_done("c")

    # -- (d) whisper-base trained as published -------------------------------
    model = Model(lm_config(WH_ARCH, None), "cuda")
    shape = InputShape("whisper_train", WH_SEQ, WH_WORKERS, "train")
    print(f"phase 23 (d): {WH_ARCH} as published on ring({WH_WORKERS}), one "
          f"30 s window a worker ({WH_SEQ // 2} frames, "
          f"{min(448, WH_SEQ // 8)} decoder tokens)", flush=True)
    train_runs(model, shape, base(WH_WORKERS), runs, launches, card,
               "whisper", model.cfg.num_layers)
    p0, b0 = lemma2_check(model, shape, base(WH_WORKERS), runs, dev,
                          "phase 23 (d)")
    flash_vs_plain(model, Model(lm_config(WH_ARCH, None,
                                          flash_attention=False), "cuda"),
                   p0, b0, launches, model.cfg.num_layers, LM_LOSS_RTOL,
                   BF16_GAP_BOUND, "phase 23 (d)")
    del p0, b0, model
    torch.cuda.empty_cache()
    part_done("d")

    # -- (e) phi-3-vision-4.2b served as published ---------------------------
    model, params, n_params = published(VLM_ARCH)
    cfg = model.cfg
    check(cfg.family == "vlm" and cfg.dtype == "bfloat16"
          and cfg.flash_attention, f"{VLM_ARCH}: {cfg.family} {cfg.dtype}")
    serve_cell(model, params, VLM_PROMPT, P23_GREEDY, launches,
               cfg.num_layers, BF16_GAP_BOUND, f"phase 23 (e): {VLM_ARCH}",
               card, f" as published ({n_params:,} params, d "
               f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.hd}, d_ff "
               f"{cfg.d_ff}; {cfg.vision_tokens} patch embeddings of "
               f"{cfg.vision_embed_dim} projected before the text)")
    del params, model
    torch.cuda.empty_cache()
    part_done("e")

    # -- (f) phi-3-vision-4.2b trained at 2 layers ---------------------------
    cfg = lm_config(VLM_ARCH, VLM_TRAIN_LAYERS)
    model = Model(cfg, "cuda")
    shape = InputShape("vlm_train", VLM_SEQ, VLM_WORKERS, "train")
    print(f"phase 23 (f): {VLM_ARCH} cut: depth "
          f"{lm_config(VLM_ARCH, None).num_layers} -> {cfg.num_layers}; "
          f"{VLM_WORKERS} workers on ring({VLM_WORKERS}), "
          f"{cfg.vision_tokens} patches + {VLM_SEQ - cfg.vision_tokens} text "
          f"tokens a worker (the loss over the text)", flush=True)
    train_runs(model, shape, base(VLM_WORKERS), runs, launches, card, "vlm",
               cfg.num_layers)
    p0, b0 = lemma2_check(model, shape, base(VLM_WORKERS), runs, dev,
                          "phase 23 (f)")
    flash_vs_plain(model, Model(lm_config(VLM_ARCH, VLM_TRAIN_LAYERS,
                                          flash_attention=False), "cuda"),
                   p0, b0, launches, cfg.num_layers, LM_LOSS_RTOL,
                   BF16_GAP_BOUND, "phase 23 (f)")
    del p0, b0, model
    torch.cuda.empty_cache()
    part_done("f")

    wh = lm_config(WH_ARCH, None)
    times = [flash_times(dev, timer, card, WH_BATCH * wh.num_heads,
                         WH_BATCH * wh.num_kv_heads, min(448, WH_SEQ // 8),
                         wh.hd, "whisper's decoder prefill"),
             flash_times(dev, timer, card, SERVE_BATCH * cfg.num_heads,
                         SERVE_BATCH * cfg.num_kv_heads, VLM_PROMPT, cfg.hd,
                         "phi-3-vision's prefill")]
    print(f"phase 23: xlstm, whisper and phi-3-vision passed in "
          f"{time.perf_counter() - t_phase:.1f} s; launches on its paths "
          f"{launches.counted} {card}", flush=True)
    return launches.counted, times

# -- phase 24: the launch layer: the CLI, the dry run, the calibration -------

# (a): phase 23 (d)'s cell through the user's entry point, one 30 s window a
# worker on ring(8); (b): the CLI's default run (reduced llama3.2-3b, float32)
CLI_WH = ("--arch", "whisper-base", "--full-size", "--workers", "8",
          "--batch", "8", "--seq", "3000", "--steps", "3", "--algo",
          "moniqua", "--bits", "8", "--log-every", "1")
CLI_LM = ("--arch", "llama3.2-3b", "--steps", "5", "--log-every", "1")
CLI_WH_CODEC, CLI_WH_FLASH = 32, 6     # (a)'s launches a step: per-leaf on
                                       # whisper's 32 leaves; its 6 decoder
                                       # layers' self-attention
CARD_BYTES = 80e9              # the H100's HBM (data sheet)
PEAK_RATIO = (0.8, 1.25)       # dry-run peak / measured peak
# (d): dryrun.main's sweep on meta, one process a part, run beside (a)-(c).
# xlstm-125m x prefill_32k is left out: its sLSTM loop is 3 x 32768 steps
# of ~14 ops through the Python dispatch modes (~1.4 M ops, several
# minutes); ROADMAP lists it.
SWEEP_PARTS = ((("--shape", "train_4k"),),
               (("--shape", "decode_32k"), ("--shape", "long_500k")),
               tuple(("--arch", a, "--shape", "prefill_32k") for a in (
                   "dbrx-132b", "grok-1-314b", "chatglm3-6b", "llama3.2-3b",
                   "phi-3-vision-4.2b", "internlm2-20b", "qwen2-72b",
                   "whisper-base", "zamba2-1.2b")))
SWEEP_TIMEOUT = 600


class StepLines:
    """A stdout that passes everything on and keeps each line with the
    host time it was written at (the CLI's step lines: each is printed
    after the step's metrics came back from the card)."""

    def __init__(self, out):
        self.out, self.lines, self._buf = out, [], ""

    def write(self, text):
        self.out.write(text)
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(text)

    def flush(self):
        self.out.flush()


def run_cli(argv, launches, what):
    """``repro_torch.launch.train.main(argv)`` in this process, on the
    card: -> (losses, bytes/step/worker, mean step ms over steps 1.., peak
    bytes, launches by kernel)."""
    import contextlib
    import re
    from repro_torch.launch import train as LT
    tee = StepLines(sys.stdout)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches.zero()
    with contextlib.redirect_stdout(tee):
        rc = LT.main(list(argv))
    got = launches.read()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"{what}: the CLI exited {rc}")
    steps = [(t, float(m.group(1))) for t, line in tee.lines
             for m in [re.match(r"step\s+\d+\s+loss (\S+)", line)] if m]
    bps = [int(m.group(1)) for _, line in tee.lines
           for m in [re.match(r"bytes/step/worker = (\d+)$", line)] if m]
    check(len(bps) == 1 and len(steps) >= 2, f"{what}: CLI output "
          f"{[line for _, line in tee.lines][-4:]}")
    step_ms = 1e3 * (steps[-1][0] - steps[0][0]) / (len(steps) - 1)
    return [v for _, v in steps], bps[0], step_ms, peak, got


def cli_config(args):
    """The config the CLI builds for ``args`` (``launch.train.parse_args``)
    and the dry run's ``override`` that gives it (None at full size)."""
    from repro_torch.configs import get_config
    full = get_config(args.arch)
    if args.full_size:
        return full, None
    red = full.reduced()
    return red, {f.name: getattr(red, f.name)
                 for f in dataclasses.fields(red)
                 if getattr(red, f.name) != getattr(full, f.name)}


def cli_expect(cfg, n, bits, algo):
    """The CLI's tree on ``meta``: (shape-only bytes a step a worker, the
    codec launches a Moniqua step as ``path="auto"`` resolves it, the
    leaves)."""
    from repro_torch import tree
    from repro_torch.core.algorithms import get_algorithm
    from repro_torch.models.model_factory import Model
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import TrainerConfig, build_hyper
    hp = build_hyper(TrainerConfig(algo=algo, topology="ring", n_workers=n,
                                   bits=bits))
    X = TS.abstract_state(Model(cfg, "meta"), get_algorithm(algo), hp,
                          n)["params"]
    leaves = len(tree.leaves(X))
    per_step = 1 if hp.engine().resolved_path(X) == "bucketed" else leaves
    return get_algorithm(algo).bytes_per_step(X, hp), per_step, leaves


def start_sweep(out_dir):
    """Start ``dryrun.main`` over ``SWEEP_PARTS`` on ``meta``, one process a
    part (no card: ``CUDA_VISIBLE_DEVICES`` empty), each appending its rows
    to a JSONL file of its own and its output to a log beside it ->
    [(process, rows path, log path)]."""
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for i, part in enumerate(SWEEP_PARTS):
        path = os.path.join(out_dir, f"sweep{i}.jsonl")
        log = os.path.join(out_dir, f"sweep{i}.log")
        if os.path.exists(path):
            os.remove(path)
        calls = [list(a) + ["--out", path] for a in part]
        code = ("import sys\nfrom repro_torch.launch import dryrun\n"
                f"sys.exit(max(dryrun.main(a) for a in {calls!r}))\n")
        with open(log, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, "-c", code], env=env, cwd=ROOT, stdout=f,
                stderr=subprocess.STDOUT), path, log))
    return procs


def launch_phase(dev, card):
    """Phase 24: the launch layer on one card.  (a) whisper-base at full
    width trained 3 steps through ``repro_torch.launch.train.main``; (b) the
    CLI's default (reduced llama3.2-3b); (c) the dry run of (a)'s step on
    ``meta``: its peak against (a)'s, its FLOPs against the same counters
    around a real step on the card, the step's MFU; (d) the dry run's
    sweep (``dryrun.main``, run beside (a)-(c) in processes of its own) and
    ``calibrate_one`` for llama3.2-3b x train_4k against the sweep's
    direct count.  Returns the launches on the CLI runs by kernels-line
    entry."""
    from repro_torch.analysis import roofline as RL
    from repro_torch.configs import assigned_archs, get_config
    from repro_torch.configs.base import INPUT_SHAPES, InputShape
    from repro_torch.launch import calibrate as CAL
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import train as LT
    from repro_torch.models.model_factory import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    sweep_dir = os.path.join(ROOT, "build", "dryrun")
    procs = start_sweep(sweep_dir)
    try:
        launches = Launches()

        # -- (a) whisper-base at full width through the CLI ------------------
        args = LT.parse_args(list(CLI_WH))
        wh, over = cli_config(args)
        n, steps = args.workers, args.steps
        shape = InputShape("cli", args.seq, args.batch, "train")
        losses, bps, step_ms, peak, got = run_cli(CLI_WH, launches,
                                                  "phase 24 (a)")
        launches.add(got)
        want_bytes, per_step, leaves = cli_expect(wh, n, args.bits,
                                                  args.algo)
        check(all(map(math.isfinite, losses)), f"phase 24 (a): losses "
              f"{losses}")
        check(bps == want_bytes, f"phase 24 (a): bytes/step/worker {bps} != "
              f"the shape-only {want_bytes}")
        check(got["moniqua_encode"] == got["moniqua_decode_reduce"]
              == steps * per_step == steps * CLI_WH_CODEC,
              f"phase 24 (a): codec launches {got}, want {CLI_WH_CODEC} a "
              f"step ({per_step} a step on {leaves} leaves)")
        check(got["flash_attention_tc"] == steps * wh.num_layers
              == steps * CLI_WH_FLASH
              and got["flash_attention_f32tc"] == 0
              and got["flash_attention_simt"] == 0,
              f"phase 24 (a): flash launches {got}, want {CLI_WH_FLASH} a "
              f"step on the bf16 tensor-core kernel")
        print(f"phase 24 (a): python -m repro_torch.launch.train "
              f"{' '.join(CLI_WH)}: losses {[round(v, 5) for v in losses]}; "
              f"bytes/step/worker {bps} (= the shape-only accounting); "
              f"launches {got}", flush=True)
        print(f"time: phase 24 (a) whisper-base step through the CLI "
              f"{step_ms:.3f} ms (host clock between step lines, mean of "
              f"steps 1-{steps - 1}); max_memory_allocated "
              f"{peak / 2 ** 30:.2f} GiB ({peak} bytes) {card}", flush=True)

        # -- (b) the CLI's default: reduced llama3.2-3b, float32 -------------
        args_b = LT.parse_args(list(CLI_LM))
        lm, _ = cli_config(args_b)
        lm_steps = args_b.steps
        losses_b, bps_b, ms_b, peak_b, got_b = run_cli(CLI_LM, launches,
                                                       "phase 24 (b)")
        launches.add(got_b)
        want_b, per_b, leaves_b = cli_expect(lm, args_b.workers,
                                             args_b.bits, args_b.algo)
        check(all(map(math.isfinite, losses_b)), f"phase 24 (b): losses "
              f"{losses_b}")
        check(bps_b == want_b, f"phase 24 (b): bytes/step/worker {bps_b} != "
              f"{want_b}")
        check(got_b["flash_attention_f32tc"] == lm_steps * lm.num_layers
              and got_b["flash_attention_tc"] == 0
              and got_b["flash_attention_simt"] == 0,
              f"phase 24 (b): flash launches {got_b}, want one float32 "
              f"launch a layer a step")
        check(got_b["moniqua_encode"] == got_b["moniqua_decode_reduce"]
              == lm_steps * per_b, f"phase 24 (b): codec launches {got_b}, "
              f"want {per_b} a step ({leaves_b} leaves)")
        print(f"phase 24 (b): python -m repro_torch.launch.train "
              f"{' '.join(CLI_LM)} (reduced, {lm.dtype}, "
              f"ring({args_b.workers}), {args_b.batch // args_b.workers} x "
              f"{args_b.seq} tokens a worker): path "
              f"{'bucketed' if per_b == 1 else 'per-leaf'} on {leaves_b} "
              f"leaves; losses {[round(v, 5) for v in losses_b]}; "
              f"bytes/step/worker {bps_b}; launches {got_b}; step "
              f"{ms_b:.3f} ms; max_memory_allocated "
              f"{peak_b / 2 ** 30:.3f} GiB {card}", flush=True)

        # -- (c) the dry run of (a)'s step on meta, and on the card ---------
        row = DR.dryrun_one(args.arch, shape, n_workers=n, bits=args.bits,
                            override=over, verbose=False)
        check(row.status == "ok", f"phase 24 (c): dry run {row.error}")
        ratio = row.memory["peak_estimate_gb"] * 1e9 / peak
        check(PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1],
              f"phase 24 (c): dry-run peak {row.memory['peak_estimate_gb']} "
              f"GB vs measured {peak / 1e9:.3f} GB (ratio {ratio:.4f})")
        model = build_model(wh, "cuda")
        tr = Trainer(model, TrainerConfig(algo=args.algo, topology="ring",
                                          n_workers=n, bits=args.bits,
                                          steps=1, log_every=1), shape)
        state = tr.init_state()
        b0 = tr.batch_fn(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with DR.StepCounters((state, b0)) as ctr:
            new_state, _ = tr.step_fn(state, b0)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated()
        c = ctr.counts
        del new_state, state, b0, tr, model
        torch.cuda.empty_cache()
        meta_c, _, _, _, _ = DR.count_step(build_model(wh, "meta"), shape, n,
                                           args.algo, args.bits)
        check(c.flops == row.roofline["flops_per_chip"] == meta_c.flops,
              f"phase 24 (c): FLOPs on the card {c.flops} != on meta "
              f"{row.roofline['flops_per_chip']}")
        check(c.kernel.calls == meta_c.kernel.calls
              and c.bytes_accessed == meta_c.bytes_accessed
              and c.peak_bytes == meta_c.peak_bytes,
              f"phase 24 (c): card {c} != meta {meta_c}")
        mf = RL.model_flops_for(wh, shape)
        mfu = mf / (step_ms * 1e-3 * RL.HW["peak_flops"])
        r = row.roofline
        print(f"phase 24 (c): dry run of (a)'s step on meta: peak "
              f"{row.memory['peak_estimate_gb']:.4f} GB vs measured "
              f"{peak / 1e9:.4f} GB (ratio {ratio:.4f}); FLOPs "
              f"{r['flops_per_chip']:.6e} (kernels "
              f"{meta_c.kernel.total_flops:.6e}) == the same counters "
              f"around one step on the card {c.flops:.6e}; bytes accessed "
              f"meta {meta_c.bytes_accessed:.6e}, card "
              f"{c.bytes_accessed:.6e}; the tracker's peak meta "
              f"{meta_c.peak_bytes / 1e9:.4f} GB, card "
              f"{c.peak_bytes / 1e9:.4f} GB, max_memory_allocated of the "
              f"counted step {step_peak / 1e9:.4f} GB; roofline "
              f"compute {r['compute_s'] * 1e3:.3f} ms, memory "
              f"{r['memory_s'] * 1e3:.3f} ms, collective "
              f"{r['collective_s'] * 1e3:.4f} ms ({r['dominant']})", flush=True)
        print(f"phase 24 (c): MFU of (a)'s step: model FLOPs {mf:.6e} / "
              f"({step_ms:.3f} ms x 989 TFLOP/s) = {mfu:.5f}; the dry run's "
              f"mfu_upper_bound {r['mfu_upper_bound']:.5f} {card}",
              flush=True)

        # -- (d) the sweep, and the depth-probe calibration -----------------
        cal = CAL.calibrate_one("llama3.2-3b", "train_4k")
        check(cal["status"] == "ok", f"phase 24 (d): calibrate {cal}")
        probe3 = DR.dryrun_one("llama3.2-3b", "train_4k", verbose=False,
                               override={"num_layers": 3})
        check(probe3.status == "ok", f"phase 24 (d): {probe3.error}")
        rows, fails = [], []
        t_wait = time.perf_counter()
        for proc, path, log in procs:
            proc.wait(timeout=SWEEP_TIMEOUT)
            if proc.returncode:
                with open(log) as f:
                    fails.append(f.read()[-3000:])
            with open(path) as f:
                rows += [json.loads(line) for line in f]
        print(f"phase 24 (d): waited {time.perf_counter() - t_wait:.1f} s "
              f"for the sweep's processes", flush=True)
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    errors = [(r["arch"], r["shape"], r["error"][:300]) for r in rows
              if r["status"] == "error"]
    check(not errors and not fails, f"phase 24 (d): error rows {errors} "
          f"{fails}")
    want = {(a, s) for a in assigned_archs() for s in INPUT_SHAPES}
    want.discard(("xlstm-125m", "prefill_32k"))
    check({(r["arch"], r["shape"]) for r in rows} == want and
          len(rows) == len(want), f"phase 24 (d): {len(rows)} rows, want "
          f"{len(want)}")
    skipped = [r for r in rows if r["status"] == "skipped"]
    check([(r["arch"], r["shape"]) for r in skipped]
          == [("whisper-base", "long_500k")]
          and skipped[0]["error"] == DR.skip_reason(
              get_config("whisper-base"), InputShape("long_500k", 524288, 1,
                                                     "decode")),
          f"phase 24 (d): skipped {skipped}")
    for r in sorted(rows, key=lambda r: (r["shape"], r["arch"])):
        if r["status"] != "ok":
            print(f"  sweep {r['arch']} x {r['shape']}: {r['status']} "
                  f"({r['error'][:60]})")
            continue
        m, f = r["memory"], r["roofline"]
        print(f"  sweep {r['arch']} x {r['shape']}: {r['seconds']:.2f} s; "
              f"peak_estimate_gb {m['peak_estimate_gb']:.3f} of the card's "
              f"{CARD_BYTES / 1e9:.0f} GB ({'fits' if m['peak_estimate_gb'] * 1e9 <= CARD_BYTES else 'does not fit'}); "
              f"flops {f['flops_per_chip']:.4e}, bytes "
              f"{f['bytes_per_chip']:.4e}, {f['dominant']} "
              f"{f['bound_s'] * 1e3:.3f} ms, mfu<= {f['mfu_upper_bound']:.4f}; "
              f"{r['collectives']['summary']}")
    direct = next(r for r in rows if (r["arch"], r["shape"])
                  == ("llama3.2-3b", "train_4k"))["roofline"]
    calr = cal["roofline_calibrated"]
    L = cal["probe"]["num_layers"]
    b1, b2 = cal["probe"]["L1"]["bytes"], cal["probe"]["L2"]["bytes"]
    second = probe3.roofline["bytes_per_chip"] - 2 * b2 + b1
    check(calr["flops_per_chip"] == direct["flops_per_chip"]
          and calr["collective_bytes_per_chip"]
          == direct["collective_bytes_per_chip"],
          f"phase 24 (d): calibrated {calr} != the sweep's {direct}")
    check(direct["bytes_per_chip"] == calr["bytes_per_chip"]
          + (L - 1) * (L - 2) // 2 * second,
          f"phase 24 (d): bytes direct {direct['bytes_per_chip']} != "
          f"calibrated {calr['bytes_per_chip']} + the stacked-gradient "
          f"term ({second} a layer pair)")
    print(f"phase 24 (d): {len(rows)} dry-run rows, 0 errors, 1 skipped "
          f"(whisper-base x long_500k: the reference's reason); "
          f"llama3.2-3b x train_4k calibrated from depth 1 and 2 to {L}: "
          f"FLOPs {calr['flops_per_chip']:.6e} == the sweep's direct "
          f"count; bytes {calr['bytes_per_chip']:.6e} + "
          f"{(L - 1) * (L - 2) // 2} x {second:.6e} (the backward's "
          f"zero-filled stacked gradients) == the direct "
          f"{direct['bytes_per_chip']:.6e}", flush=True)
    print(f"phase 24: the launch layer passed in "
          f"{time.perf_counter() - t_phase:.1f} s; launches on the CLI's "
          f"paths {launches.counted} {card}", flush=True)
    return launches.counted


def main() -> int:
    # phase 21's LM training allocates and frees tensors of many GB in
    # varied sizes; without expandable segments the caching allocator
    # fragments, and a step runs out of memory with much of the card
    # reserved but free.  Read when the allocator starts, at the first
    # allocation on the card.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
        profiler_prime()
        t0 = time.perf_counter()
        for k in range(3):
            state, _ = step_fn(state, batches[k])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = device_kernels(prof)
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
                   sim_phase(dev, card, model, batches, X_cpu),
                   tiered_phase(dev, card, model, batches, X_cpu),
                   obs_phase(dev, card, model, batches, X_cpu,
                             main_run[1]["params"])):
        for name, n in counts.items():
            extra[name] = extra.get(name, 0) + n
    torch.cuda.empty_cache()
    lm_counts, train_flash = lm_phase(dev, timer, card)
    torch.cuda.empty_cache()
    p22_counts, p22_flash = moe_hybrid_phase(dev, timer, card)
    torch.cuda.empty_cache()
    p23_counts, p23_flash = zoo_phase(dev, timer, card)
    torch.cuda.empty_cache()
    p24_counts = launch_phase(dev, card)
    for counts in (lm_counts, p22_counts, p23_counts, p24_counts):
        for name, n in counts.items():
            extra[name] = extra.get(name, 0) + n
    for k in kernels:
        k["launches"] += extra.get(k["name"], 0)
        if k["name"] == "flash_attention_tc":
            k["train"] = train_flash
            k["phase22"] = p22_flash
            k["phase23"] = p23_flash
    print(f"launches on phases 17-24's paths, added to the kernels line: "
          f"{extra}", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
