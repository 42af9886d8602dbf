"""Host-side training loop: batch source, step function, history.

The batch source is an ``InputShape``, from which the trainer builds the
reference's ``SyntheticLMPipeline(model, shape, n_workers, seed=seed)`` and
reads its ``worker_batch`` (an LM: ``Trainer(model, tc, shape)``), or a
callable ``step -> stacked batch`` (leaves ``[n, batch, ...]``); for
ResNet-20 that is ``data.synthetic.stacked_cifar_like``.  Checkpoints
(``checkpoint/ckpt.py``) hold the params and the full state, so a cut run
resumes bit for bit.

Observability (``repro_torch.obs``): ``telemetry`` adds the round-health
``obs_*`` metrics; ``log_jsonl`` writes a ``repro.obs.runlog/v1`` run log
(header, drained step metrics, host spans, result); ``trace_path`` a Chrome
trace of the host spans (``train.step``, ``train.checkpoint``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import InputShape
from repro_torch.core.algorithms import AlgoHyper, get_algorithm
from repro_torch.core.moniqua import MoniquaCodec
from repro_torch.core.quantizers import QuantSpec
from repro_torch.core.theta import ThetaSchedule
from repro_torch.core.topology import get_topology
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.obs.runlog import RunLogWriter
from repro_torch.obs.trace import SpanRecorder
from repro_torch.optim.sgd import SGDConfig
from repro_torch.train import train_step as TS


@dataclasses.dataclass
class TrainerConfig:
    algo: str = "moniqua"
    topology: str = "ring"
    n_workers: int = 8
    bits: int = 8
    theta: float = 2.0
    gamma: float = 1.0          # Choco/DeepSqueeze consensus step size
    slack: float = 1.0          # Theorem 3 slack matrix W_bar = s W + (1-s) I
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    steps: int = 100
    log_every: int = 10
    seed: int = 0
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    wire: str = "moniqua"       # CommEngine wire codec (moniqua | qsgd |
                                #   ef_qsgd | onebit | full)
    comm_path: str = "auto"     # gossip path: bucketed | per_leaf | auto
    chunks: int = 1             # staged-round chunk count (1 = barrier)
    overlap: str = "none"       # step-level overlap: none | stale (moniqua)
    warmup: int = 16            # onebit wire: fp32 rounds before 1-bit+EF
    tiers: int = 1              # 1 = flat gossip; k>1 = two-tier hierarchy
                                #   (nodes of k workers, tc.topology across
                                #   nodes, full-precision reduce inside)
    presence: Optional[tuple] = None  # elastic 0/1 worker mask for every
                                #   round (AlgoHyper.presence); None = all up
    deadline: Optional[float] = None  # sim round deadline in seconds
                                #   (recorded; enforced by sim/faults.py)
    telemetry: bool = False     # round-health obs_* metrics (obs.metrics)
    log_jsonl: Optional[str] = None   # schema-versioned run log (obs.runlog):
                                #   drained metrics + spans + result
    trace_path: Optional[str] = None  # Chrome-trace JSON of the host spans
                                #   (Perfetto / chrome://tracing)


def build_hyper(tc: TrainerConfig) -> AlgoHyper:
    """The run's AlgoHyper (D-PSGD and all-reduce gossip full precision
    whatever the wire).  1-bit rounds to nearest (stochastic 1-bit has
    delta = 1/2, which Moniqua rejects), wider codes round
    stochastically."""
    topo = get_topology(tc.topology, tc.n_workers)
    if tc.slack < 1.0:
        topo = topo.slack(tc.slack)
    spec = QuantSpec(bits=tc.bits, stochastic=tc.bits > 1)
    presence = None if tc.presence is None else tuple(tc.presence)
    return AlgoHyper(topo=topo, codec=MoniquaCodec(spec), theta=tc.theta,
                     gamma=tc.gamma, wire=tc.wire, path=tc.comm_path,
                     chunks=tc.chunks, overlap=tc.overlap, warmup=tc.warmup,
                     tiers=tc.tiers, presence=presence,
                     deadline=tc.deadline, telemetry=tc.telemetry)


def drain_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Every metric as a Python float, with one host transfer per device
    for all the tensor metrics (one ``float()`` each would wait for the card
    once per metric)."""
    out = {k: float(v) for k, v in metrics.items()
           if not isinstance(v, torch.Tensor)}
    by_dev: Dict[Any, List[str]] = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            by_dev.setdefault(v.device, []).append(k)
    for keys in by_dev.values():
        vals = torch.stack([metrics[k].detach().reshape(())
                            .to(torch.float64) for k in keys]).cpu()
        out.update(zip(keys, vals.tolist()))
    return {k: out[k] for k in metrics}


class Trainer:
    def __init__(self, model, tc: TrainerConfig,
                 data: Union[InputShape,
                             Callable[[int], Dict[str, torch.Tensor]]]):
        """``data``: an ``InputShape`` of the ``train`` kind (synthetic LM
        batches of the model's ``batch_spec``, ``global_batch / n_workers``
        sequences a worker) or a callable ``step -> stacked batch``."""
        self.model, self.tc = model, tc
        self.batch_fn = (SyntheticLMPipeline(model, data, tc.n_workers,
                                             seed=tc.seed).worker_batch
                         if isinstance(data, InputShape) else data)
        self.hp = build_hyper(tc)
        self.algo = get_algorithm(tc.algo)
        self.tcfg = TS.TrainStepConfig(
            algo=tc.algo,
            sgd=SGDConfig(momentum=tc.momentum, weight_decay=tc.weight_decay),
            lr=tc.lr,
            theta=ThetaSchedule(mode="constant", value=tc.theta,
                                n=tc.n_workers,
                                rho=self.hp.comm_topo().rho))
        self.step_fn = TS.make_train_step(model, self.hp, self.tcfg)

    def init_state(self) -> Dict[str, Any]:
        return TS.init_state(self.model, self.algo, self.hp,
                             self.tc.n_workers, seed=self.tc.seed)

    def bytes_per_step(self, state) -> int:
        return self.algo.bytes_per_step(state["params"], self.hp)

    def restore_state(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Rebuild the FULL trainer state (params, momentum, the rule's
        ``extra`` with any WireState or gossip carry, step, g_inf and the
        seed generator) from the ``<checkpoint_path>.state`` file ``run()``
        writes, on the devices of a fresh state.  Passing it back into
        ``run()`` resumes bit for bit."""
        path = path or self.tc.checkpoint_path
        if not path:
            raise ValueError("restore_state needs a checkpoint path "
                             "(argument or TrainerConfig.checkpoint_path)")
        return ckpt.restore(path + ".state", self.init_state())

    def run(self, state: Optional[Dict[str, Any]] = None,
            callback: Optional[Callable[[int, Dict], None]] = None
            ) -> Dict[str, Any]:
        """Run ``tc.steps`` steps from ``state`` (a fresh one by default;
        a restored one resumes at its own step, and the batch source is
        indexed by the global step).  Every ``log_every`` steps, and at the
        last, the metrics are read back to the host in one transfer (which
        waits for the card) into ``history``, with ``wall`` the seconds
        since the loop started, and handed to ``callback(step, metrics)``.
        With ``checkpoint_path`` and ``checkpoint_every``, every that many
        steps the params go to ``checkpoint_path`` and the full state to
        ``<checkpoint_path>.state``.  ``log_jsonl`` / ``trace_path`` write
        the run log and the Chrome trace of the ``train.step`` /
        ``train.checkpoint`` host spans."""
        tc = self.tc
        state = state if state is not None else self.init_state()
        k0 = state["step"]
        history: List[Dict] = []
        rec = SpanRecorder() if (tc.trace_path or tc.log_jsonl) else None
        writer = None
        if tc.log_jsonl:
            run_meta = dataclasses.asdict(tc)
            run_meta["theta_mode"] = self.tcfg.theta.mode
            writer = RunLogWriter(tc.log_jsonl, run=run_meta, tool="trainer")

        def span(name, step):
            return (rec.span(name, tid="train", step=step) if rec is not None
                    else contextlib.nullcontext())

        t0 = time.perf_counter()
        try:
            for k in range(k0, k0 + tc.steps):
                batch = self.batch_fn(k)
                with span("train.step", k):
                    state, metrics = self.step_fn(state, batch)
                if (k - k0) % tc.log_every == 0 or k == k0 + tc.steps - 1:
                    m = drain_metrics(metrics)
                    m["step"] = k
                    m["wall"] = time.perf_counter() - t0
                    history.append(m)
                    if writer is not None:
                        writer.step(k, {kk: v for kk, v in m.items()
                                        if kk not in ("step", "wall")},
                                    wall_s=m["wall"])
                    if callback:
                        callback(k, m)
                if (tc.checkpoint_path and tc.checkpoint_every
                        and (k + 1) % tc.checkpoint_every == 0):
                    meta = {"step": k + 1, "algo": tc.algo, "wire": tc.wire}
                    with span("train.checkpoint", k + 1):
                        ckpt.save(tc.checkpoint_path, state["params"], meta)
                        ckpt.save(tc.checkpoint_path + ".state", state,
                                  meta)
            bps = self.bytes_per_step(state)
            if writer is not None:
                writer.spans_from(rec)
                writer.result(bytes_per_step=bps, steps=tc.steps,
                              wall_s=time.perf_counter() - t0)
            if rec is not None and tc.trace_path:
                rec.save(tc.trace_path, process_name="trainer")
        finally:
            if writer is not None:
                writer.close()
        return {"state": state, "history": history, "bytes_per_step": bps}
