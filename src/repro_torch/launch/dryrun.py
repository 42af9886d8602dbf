"""Dry run on one card: count every (arch x shape) step on the ``meta``
device, with nothing allocated, and derive its memory and roofline terms.

The counterpart of the reference's ``repro.launch.dryrun``, which lowers and
compiles each step on a 256-chip mesh of forced host devices and reads
XLA's memory and cost analyses.  The port has no compiler to ask, so it
runs the step itself, on ``meta`` tensors (``train_step.abstract_state``,
``serve_step.abstract_cache``, :func:`input_specs`), under three counters
(:class:`StepCounters`):

* ``torch.utils.flop_counter.FlopCounterMode`` for every PyTorch op;
* the kernels' own FLOPs and bytes, each wrapper charging its kernel by
  formula (``kernels/cost.py``);
* :class:`LiveBytes`, a dispatch mode that tracks live storages (each
  counted once; views share one) for the peak, and sums the input and
  output bytes of every op that moves data (not a view, not ``empty``).

Bytes accessed are that sum plus the kernels' terms.  For an eager program
every op reads its inputs from HBM and writes its outputs there, so this is
the traffic HBM sees, less what the L2 cache catches.  The memory row is
the reference's: ``argument_bytes`` (the step's inputs), ``output_bytes``
(new storages it returns), ``alias_bytes`` (inputs it returns, updated in
place), ``temp_bytes`` and ``peak_estimate_gb`` (the tracker's peak of live
bytes, arguments included).

Workers: a decentralized config takes ``--workers`` (default 8, the
paper's ring), a hierarchical one (dbrx-132b, grok-1-314b, qwen2-72b) 1,
what the reference's ``n_workers_for`` gives on one pod, where workers are
pods; ``--workers`` overrides both.

Flags the reference has and this one does not: ``--multi-pod``,
``--both-meshes`` and ``--host-mesh`` need the port's meshes (ROADMAP
#13d); ``--comm-backend`` (jnp | pallas | auto) has no counterpart: the
port's ``AlgoHyper`` has no backend, and a CUDA tensor always launches the
kernel.  The reference's forced-device ``XLA_FLAGS`` have none either.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun             # all 10 x 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
        --shape decode_32k --algo moniqua --bits 8
    ... --out results.json   (incremental append; safe to re-run)

Exit code is non-zero if any requested combination fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.analysis import roofline as RL
from repro_torch.configs import assigned_archs, get_config
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      get_input_shape)
from repro_torch.core.algorithms import AlgoHyper, get_algorithm
from repro_torch.core.moniqua import MoniquaCodec
from repro_torch.core.quantizers import QuantSpec
from repro_torch.core.theta import ThetaSchedule
from repro_torch.core.topology import ring
from repro_torch.kernels import cost as kcost
from repro_torch.models.model_factory import build_model
from repro_torch.optim.sgd import SGDConfig
from repro_torch.train import serve_step as SS
from repro_torch.train import train_step as TS

MESH = "1-card"
# the reference's --reduced override, verbatim
REDUCED = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
               head_dim=64, d_ff=512, vocab_size=512, remat=False)
_expired = torch.UntypedStorage._expired
_EMPTY_OPS = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided")


def skip_reason(cfg: ArchConfig, shape: InputShape) -> Optional[str]:
    if cfg.name == "whisper-base" and shape.name == "long_500k":
        return ("full-attention encoder-decoder is quadratic; no sub-quadratic "
                "variant implemented (DESIGN.md §5)")
    return None


def input_specs(model, shape: InputShape, n_workers: int, stacked: bool,
                device="meta") -> Dict[str, torch.Tensor]:
    """Empty stand-ins for every model input, on ``meta`` by default (no
    allocation): the reference's ``ShapeDtypeStruct``s."""
    spec = model.batch_spec(shape)
    out = {}
    for name, (shp, dt) in spec.items():
        if stacked:
            if shp[0] % n_workers:
                raise ValueError(f"batch {shp[0]} does not split over "
                                 f"{n_workers} workers")
            shp = (n_workers, shp[0] // n_workers) + tuple(shp[1:])
        out[name] = torch.empty(shp, dtype=dt, device=device)
    return out


def n_workers_for(cfg: ArchConfig, workers: Optional[int] = None) -> int:
    """``workers`` if given; else 8 for a decentralized config (the paper's
    ring) and 1 for a hierarchical one (the reference's ``n_workers_for``
    on one pod, where workers are pods)."""
    if workers is not None:
        return int(workers)
    return 1 if cfg.dist_mode == "hierarchical" else 8


def _tensors(obj):
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


class LiveBytes(TorchDispatchMode):
    """Live storage bytes over the ops dispatched inside, and their peak.

    Every storage an op reads or writes is tracked once by a weak reference
    (views and in-place results share their base's).  Frees are not
    announced, so the live total counts every storage seen since the last
    sweep, which drops the dead ones; a sweep runs when that total passes
    the peak and more than ``1 / PEAK_SLACK`` of the peak was allocated
    since the last one.  The peak is taken from sweeps only, so it is low
    by at most that share, and an op's output is counted while its inputs
    are still held.  ``roots`` (the step's arguments) are live from the
    start.  ``traffic`` sums each op's input and output bytes, views and
    ``empty`` (which moves nothing) excepted."""

    PEAK_SLACK = 64

    def __init__(self, roots=()):
        super().__init__()
        self.live: Dict[int, tuple] = {}
        self.current = 0
        self.traffic = 0
        for t in _tensors(roots):
            self.current += self._track(t)
        self.peak = self.current
        self._since = 0             # bytes first seen since the last sweep

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        got = self.live.get(key)
        if got is not None and not _expired(got[0].cdata):
            return 0
        n = st.nbytes()
        self.live[key] = (StorageWeakRef(st), n)
        return n

    def _sweep(self) -> None:
        self.live = {k: v for k, v in self.live.items()
                     if not _expired(v[0].cdata)}
        self.current = sum(n for _, n in self.live.values())
        self.peak = max(self.peak, self.current)
        self._since = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not (func.is_view
                or func.overloadpacket.__name__ in _EMPTY_OPS):
            self.traffic += kcost.nbytes(*ins) + kcost.nbytes(*outs)
        new = sum(self._track(t) for t in ins + outs)
        if new:
            self.current += new
            self._since += new
            if (self.current > self.peak
                    and self._since * self.PEAK_SLACK > self.peak):
                self._sweep()
        return out

    def __exit__(self, *exc):
        self._sweep()
        return super().__exit__(*exc)


@dataclasses.dataclass
class StepCounts:
    flops: float                 # FlopCounterMode's + the kernels'
    torch_flops: float
    kernel: kcost.KernelCost
    bytes_accessed: float        # ops' input + output bytes + the kernels'
    argument_bytes: int
    peak_bytes: int


class StepCounters:
    """The dry run's three counters around one step: ``FlopCounterMode``,
    the kernels' cost context and :class:`LiveBytes` with ``roots`` (the
    step's arguments) live from the start.  The same on ``meta``, CPU and
    CUDA tensors; on CUDA the kernels launch.  ``counts`` after exit."""

    def __init__(self, roots):
        self.roots = roots
        self.counts: Optional[StepCounts] = None

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self.flop = self._stack.enter_context(FlopCounterMode(display=False))
        self.kernel = self._stack.enter_context(kcost.counting())
        self.live = self._stack.enter_context(LiveBytes(self.roots))
        self.argument_bytes = self.live.current
        return self

    def __exit__(self, *exc):
        self._stack.close()
        torch_flops = float(self.flop.get_total_flops())
        self.counts = StepCounts(
            flops=torch_flops + self.kernel.total_flops,
            torch_flops=torch_flops, kernel=self.kernel,
            bytes_accessed=self.live.traffic + self.kernel.total_bytes,
            argument_bytes=self.argument_bytes, peak_bytes=self.live.peak)
        return False


@dataclasses.dataclass
class DryrunResult:
    arch: str
    shape: str
    mesh: str
    status: str
    seconds: float = 0.0
    error: str = ""
    memory: Dict[str, float] = dataclasses.field(default_factory=dict)
    roofline: Dict[str, Any] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, Any] = dataclasses.field(default_factory=dict)
    sim: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def row(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def roofline_row(roof: RL.Roofline) -> Dict[str, Any]:
    return {
        "flops_per_chip": roof.flops,
        "bytes_per_chip": roof.bytes_accessed,
        "collective_bytes_per_chip": roof.collective_bytes,
        "compute_s": roof.compute_s,
        "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "dominant": roof.dominant,
        "bound_s": roof.bound_s,
        "model_flops": roof.model_flops,
        "useful_ratio": roof.useful_ratio,
        "mfu_upper_bound": roof.mfu_upper_bound,
    }


def count_step(model, shape: InputShape, n_workers: int,
               algo: str = "moniqua", bits: int = 8, wire: str = "moniqua",
               comm_path: str = "auto", chunks: int = 1, tiers: int = 1,
               telemetry: bool = False):
    """Run one step of ``shape``'s kind on ``meta`` under
    :class:`StepCounters` -> ``(StepCounts, outputs, collectives, hyper)``:
    the train step on ``abstract_state`` and a stacked batch (the
    collectives from its gossip round's plan), the prefill, or one decode
    token against ``abstract_cache``."""
    meta = dataclasses.replace(model, device="meta")
    hp = stats = None
    if shape.kind == "train":
        hp = _hyper(model.cfg, n_workers, algo, bits, wire, comm_path,
                    chunks, tiers, telemetry)
        step = TS.make_train_step(meta, hp, _train_config(algo))
        state = TS.abstract_state(meta, get_algorithm(algo), hp, n_workers)
        batch = input_specs(meta, shape, n_workers, stacked=True)
        args = (state, batch)
        stats = RL.collectives_of(hp.engine(), state["params"])
        # the step draws its hash seed from the state's CPU generator, as
        # in a run (the draw's two host ops are counted too)
        call = lambda: step(state, batch)                  # noqa: E731
    else:
        params = meta.init(meta.generator(0))
        if shape.kind == "prefill":
            batch = input_specs(meta, shape, 1, stacked=False)
            args = (params, batch)
            call = lambda: SS.make_prefill_step(meta)(     # noqa: E731
                params, batch)
        else:
            cache = SS.abstract_cache(meta, shape)
            tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                              device="meta")
            args = (params, cache, tok)
            call = lambda: SS.make_serve_step(meta)(       # noqa: E731
                params, cache, tok)
        stats = RL.CollectiveStats({}, {})
    with StepCounters(args) as ctr:
        out = call()
    return ctr.counts, args, out, stats, hp


def _train_config(algo: str) -> TS.TrainStepConfig:
    return TS.TrainStepConfig(algo=algo, sgd=SGDConfig(), lr=0.1,
                              theta=ThetaSchedule(mode="constant", value=2.0))


def _memory_row(counts: StepCounts, args, out) -> Dict[str, float]:
    arg_keys = {t.untyped_storage()._cdata for t in _tensors(args)}
    out_st: Dict[int, int] = {}
    for t in _tensors(out):
        st = t.untyped_storage()
        out_st[st._cdata] = st.nbytes()
    alias = sum(n for k, n in out_st.items() if k in arg_keys)
    output = sum(out_st.values())
    arg = counts.argument_bytes
    return {"argument_bytes": arg, "output_bytes": output,
            "temp_bytes": counts.peak_bytes - arg - output + alias,
            "alias_bytes": alias,
            "peak_estimate_gb": counts.peak_bytes / 1e9}


def dryrun_one(arch: str, shape_name: Union[str, InputShape], *,
               n_workers: Optional[int] = None, algo: str = "moniqua",
               bits: int = 8, wire: str = "moniqua",
               comm_path: str = "auto", chunks: int = 1, tiers: int = 1,
               telemetry: bool = False, scenario: Optional[str] = None,
               verbose: bool = True, override: Optional[dict] = None,
               rec=None) -> DryrunResult:
    """One (arch x shape) count on ``meta``.  ``shape_name`` is a name of
    ``INPUT_SHAPES`` or an ``InputShape``; ``n_workers`` as
    :func:`n_workers_for`.  ``rec`` (a ``repro_torch.obs.trace.
    SpanRecorder``) gets the count and sim phase spans; ``telemetry``
    threads the obs flag into the train step being counted."""
    cfg = get_config(arch)
    if override:
        cfg = dataclasses.replace(cfg, **override)
    shape = (shape_name if isinstance(shape_name, InputShape)
             else get_input_shape(shape_name))
    reason = skip_reason(cfg, shape)
    if reason:
        return DryrunResult(arch, shape.name, MESH, "skipped", error=reason)
    t0 = time.time()
    tag = f"[{arch} x {shape.name} x {MESH}]"

    def span(name):
        if rec is None:
            return contextlib.nullcontext()
        return rec.span(name, tid=f"{arch}/{shape.name}", mesh=MESH)

    try:
        model = build_model(cfg, device="meta")
        n = n_workers_for(cfg, n_workers)
        with span("dryrun.count"):
            counts, args, out, stats, hp = count_step(
                model, shape, n, algo, bits, wire, comm_path, chunks, tiers,
                telemetry)
        memory = _memory_row(counts, args, out)
        del args, out
        if verbose:
            print(f"{tag} memory: {memory}")
            print(f"{tag} counts: flops={counts.flops:.3e} (kernels "
                  f"{counts.kernel.total_flops:.3e}) "
                  f"bytes={counts.bytes_accessed:.3e}")
        roof = RL.roofline_from_counts(
            counts.flops, counts.bytes_accessed, stats.total_bytes,
            RL.model_flops_for(cfg, shape))
        sim_pred: Dict[str, Any] = {}
        if scenario and shape.kind == "train":
            with span("dryrun.sim"):
                sim_pred = _sim_predict(scenario, model, hp, n, roof)
            if verbose:
                print(f"{tag} sim {scenario}: round="
                      f"{sim_pred['predicted_round_s']*1e3:.3f}ms "
                      f"({sim_pred['network_overhead_x']:.2f}x roofline "
                      f"bound)")
        res = DryrunResult(
            arch, shape.name, MESH, "ok", seconds=time.time() - t0,
            memory=memory, roofline=roofline_row(roof),
            collectives={"counts": stats.counts, "bytes": stats.bytes_by_op,
                         "summary": stats.summary()},
            sim=sim_pred)
        if verbose:
            r = res.roofline
            print(f"{tag} OK in {res.seconds:.1f}s  peak "
                  f"{memory['peak_estimate_gb']:.3f} GB  "
                  f"dominant={r['dominant']} "
                  f"compute={r['compute_s']*1e3:.3f}ms "
                  f"memory={r['memory_s']*1e3:.3f}ms "
                  f"collective={r['collective_s']*1e3:.3f}ms  "
                  f"colls: {res.collectives['summary']}", flush=True)
        return res
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        tb = traceback.format_exc(limit=20)
        if verbose:
            print(f"{tag} FAIL: {e}", flush=True)
        return DryrunResult(arch, shape.name, MESH, "error",
                            seconds=time.time() - t0, error=f"{e}\n{tb}")


def _hyper(cfg, n_workers, algo, bits, wire="moniqua", comm_path="auto",
           chunks=1, tiers=1, telemetry=False) -> AlgoHyper:
    topo = ring(n_workers)
    spec = QuantSpec(bits=bits, stochastic=bits > 1)
    return AlgoHyper(topo=topo, codec=MoniquaCodec(spec), theta=2.0,
                     wire=wire, path=comm_path, chunks=chunks, tiers=tiers,
                     telemetry=telemetry)


def _sim_predict(scenario_name: str, model, hp, n_workers: int, roof):
    """Price one gossip round of this config on a named sim scenario.

    Compute time per round = the roofline bound of the counted step (the
    best the card can do); network time = the engine's wire bytes under
    the scenario's link model.  The ratio says how much the scenario's
    network inflates the step beyond the hardware bound.
    """
    from repro_torch.sim import events as SE
    from repro_torch.sim import scenarios as SC

    meta = dataclasses.replace(model, device="meta")
    params = meta.init(meta.generator(0))
    X_ab = tree.map(lambda a: a.expand((n_workers,) + a.shape), params)
    eng = hp.engine()
    bytes_round = eng.bytes_per_round(X_ab)
    compute_s = max(roof.bound_s, 1e-9)
    sc = SC.get_scenario(scenario_name, n=n_workers, compute_s=compute_s)
    trace = SE.simulate_sync_rounds(sc, eng.payload_bytes_per_broadcast(X_ab),
                                    num_rounds=25)
    return {
        "scenario": sc.name,
        "bytes_per_round": bytes_round,
        "predicted_round_s": trace.mean_round_seconds,
        "roofline_bound_s": roof.bound_s,
        "network_overhead_x": trace.mean_round_seconds / compute_s,
    }


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--workers", type=int, default=None,
                    help="workers on the ring (default: 8 for a "
                         "decentralized config, 1 for a hierarchical one)")
    ap.add_argument("--algo", default="moniqua")
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--wire", default="moniqua",
                    choices=["moniqua", "qsgd", "full"],
                    help="CommEngine wire codec for quantized gossip")
    ap.add_argument("--comm-path", default="auto",
                    choices=["bucketed", "per_leaf", "auto"],
                    help="CommEngine gossip path: bucketed flat buffer, "
                         "per-leaf mixing, or the auto crossover")
    ap.add_argument("--chunks", type=int, default=1,
                    help="staged-round chunk count for the pipelined "
                         "gossip round (1 = barrier round)")
    ap.add_argument("--tiers", type=int, default=1,
                    help="two-tier hierarchical gossip: workers per node "
                         "(1 = flat single-tier; k>1 puts the ring across "
                         "n/k nodes with a full-precision reduce inside "
                         "each)")
    ap.add_argument("--scenario", default=None,
                    help="repro_torch.sim scenario name: price one gossip "
                         "round of each train config on this simulated "
                         "network (see repro_torch/sim/scenarios.py)")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--telemetry", action="store_true",
                    help="thread AlgoHyper.telemetry into the counted "
                         "train step (obs_* round-health metrics)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the count phase "
                         "spans (open in Perfetto)")
    ap.add_argument("--log-jsonl", default=None, metavar="PATH",
                    help="write a repro.obs.runlog JSONL: one event per "
                         "combination + phase spans + final result")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink every arch to a tiny layer stack (the "
                         "reference's override) before counting")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else assigned_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    override = dict(REDUCED) if args.reduced else None

    rec = writer = None
    if args.trace or args.log_jsonl:
        from repro_torch.obs.trace import SpanRecorder
        rec = SpanRecorder()
    if args.log_jsonl:
        from repro_torch.obs.runlog import RunLogWriter
        writer = RunLogWriter(args.log_jsonl, run=vars(args), tool="dryrun")

    failures = 0
    try:
        for arch in archs:
            for shape in shapes:
                res = dryrun_one(arch, shape, n_workers=args.workers,
                                 algo=args.algo, bits=args.bits,
                                 wire=args.wire, comm_path=args.comm_path,
                                 chunks=args.chunks, tiers=args.tiers,
                                 telemetry=args.telemetry,
                                 scenario=args.scenario, override=override,
                                 rec=rec)
                if res.status == "error":
                    failures += 1
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(res.row()) + "\n")
                if writer is not None:
                    writer.event("dryrun", {
                        "arch": res.arch, "shape": res.shape,
                        "mesh": res.mesh, "status": res.status,
                        "seconds": res.seconds,
                        "peak_estimate_gb":
                            res.memory.get("peak_estimate_gb")})
        if writer is not None:
            writer.spans_from(rec)
            writer.result(failures=failures,
                          combinations=len(archs) * len(shapes))
        if rec is not None and args.trace:
            rec.save(args.trace, process_name="dryrun")
    finally:
        if writer is not None:
            writer.close()
    print(f"dry-run complete; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
