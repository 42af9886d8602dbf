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

Across processes: ``Trainer(model, tc, data, mesh=, rules=)`` (the
reference's ``mesh`` / ``rules``) splits the worker dim over the mesh's
worker axes (``launch/mesh.py``).  Each rank builds its block of the state
from the same seeded init, takes its workers' rows of every batch and runs
each step under ``mesh_context``; checkpoints hold the whole state (the
file one process writes), and ``restore_state`` cuts this rank's block
out of it.  A ``model`` axis > 1 splits the weights of the dense and MoE
families (``comm/tensor_parallel.py``; the MoE experts on each expert's
``d_ff``, ``models/moe.py``): the ranks that differ only in ``model``
share a block of workers and its batch rows, each rank's state is its cut
of the one-process init (every rank draws the whole init), the gossip is
the per-leaf round on the shards, and checkpoints are gathered whole.
Under the hierarchical rules (``ShardingRules("hierarchical"[,
multi_pod=True])``) those families' weights are also split over
``data`` (FSDP, ``comm/fsdp.py``): the workers are the pods (one block on
one pod, every rank holding all of them), each rank's state is its cut of
the one-process init over ``data`` and ``model``, it takes its ``data``
share of every worker's batch rows, and the gossip is the per-leaf round
on the shards.  Every update rule runs on the shards, presence masks
included; a rule's state that mirrors the params (Choco's and DCD's
``x_hat``, DeepSqueeze's ``err``, D²'s ``x_prev`` and ``g_prev``) is held
in the params' cut, and gathered and restored with them
(``Algorithm.mirrors``).  Heads that the ``model`` axis does not divide
run context-parallel (``models/layers.py``: the attention weights whole
on every rank, the keys split over ``model``), and KV heads replicated in
groups a rank cannot read whole are expanded to its query heads.
Everything else on a ``model`` or FSDP axis > 1 (other families, the
``qsgd`` / ``ef_qsgd`` / ``onebit`` wires, the bucketed path, two tiers,
the stale overlap, telemetry) and any
state spec over another mesh axis of size > 1 raise
``NotImplementedError`` (ROADMAP #13e) at construction: nothing is
replicated silently.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from repro_torch import convert, tree
from repro_torch.checkpoint import ckpt
from repro_torch.comm import fsdp as FS
from repro_torch.comm import tensor_parallel as TP
from repro_torch.comm import workers
from repro_torch.configs.base import InputShape
from repro_torch.core.algorithms import AlgoHyper, get_algorithm
from repro_torch.core.moniqua import MoniquaCodec
from repro_torch.core.quantizers import QuantSpec
from repro_torch.core.theta import ThetaSchedule
from repro_torch.core.topology import get_topology
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.launch.mesh import mesh_context, mesh_shape_dict, split_groups
from repro_torch.models.sharding import (ShardingRules, check_runnable,
                                         fsdp_size, on_worker_dim)
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
                             Callable[[int], Dict[str, torch.Tensor]]],
                 mesh=None, rules: Optional[ShardingRules] = None):
        """``data``: an ``InputShape`` of the ``train`` kind (synthetic LM
        batches of the model's ``batch_spec``, ``global_batch / n_workers``
        sequences a worker) or a callable ``step -> stacked batch``.
        ``mesh`` (a ``DeviceMesh`` of ``launch/mesh.py``) with its
        ``rules``: the worker dim split over the mesh's worker axes, this
        rank holding its block (module docstring)."""
        self.model, self.tc = model, tc
        self.hp = build_hyper(tc)
        self.algo = get_algorithm(tc.algo)
        self.mesh, self.rules = mesh, rules
        self.param_specs, self.splits = None, ()
        self.workers = None if mesh is None else self._worker_group()
        b = tc.n_workers // (1 if mesh is None else self.workers.size)
        lo, hi = self.rows = (0, b) if mesh is None else (
            self.workers.index * b, (self.workers.index + 1) * b)
        inner = self._inner_rows(data)
        if isinstance(data, InputShape):
            pipe = SyntheticLMPipeline(model, data, tc.n_workers,
                                       seed=tc.seed)
            self.batch_fn = lambda k: pipe.worker_batch(k, rows=(lo, hi),
                                                        inner=inner)
        elif mesh is not None:
            self.batch_fn = lambda k: {name: v[lo:hi]
                                       for name, v in data(k).items()}
        else:
            self.batch_fn = data
        self.tcfg = TS.TrainStepConfig(
            algo=tc.algo,
            sgd=SGDConfig(momentum=tc.momentum, weight_decay=tc.weight_decay),
            lr=tc.lr,
            theta=ThetaSchedule(mode="constant", value=tc.theta,
                                n=tc.n_workers,
                                rho=self.hp.comm_topo().rho))
        self.step_fn = TS.make_train_step(model, self.hp, self.tcfg)

    def _worker_group(self) -> workers.WorkerGroup:
        """This rank's split of the worker dim, once the mesh and the rules
        are checked: the workers divide over the worker axes, and no state
        spec shards another axis of size > 1 (#13e)."""
        tc, rules = self.tc, self.rules
        if rules is None:
            raise ValueError("Trainer(mesh=...) needs its ShardingRules")
        shape = mesh_shape_dict(self.mesh)
        if tc.n_workers % TS.n_workers_for(None, rules, shape):
            raise ValueError(f"{tc.n_workers} workers do not split over the "
                             f"worker axes {rules.worker_axes} of {shape}")
        specs = TS.state_pspecs(self.model, self.algo, self.hp, rules,
                                shape, tc.n_workers)
        check_runnable(specs, rules, shape,
                       cfg=getattr(self.model, "cfg", None))
        if shape.get("model", 1) > 1 or fsdp_size(rules, shape) > 1:
            self._check_tensor_parallel()
            self.param_specs = specs["params"]
            self.splits = tuple(g for g in split_groups(
                self.mesh, rules, self.param_specs) if g.size > 1)
        # the state leaves held in blocks of rows (gathered, restored)
        self.on_workers = tree.map(lambda s: on_worker_dim(s, rules), specs)
        return workers.WorkerGroup.of(self.mesh, rules.worker_axes,
                                      rules.fsdp_axis)

    def _inner_rows(self, data):
        """This rank's ``[a, b)`` of every worker's batch rows under an
        FSDP split (the hierarchical rules' ``batch`` on ``data``), or
        ``None``."""
        g = [g for g in self.splits if g.axis == FS.AXIS]
        if not g:
            return None
        if not isinstance(data, InputShape):
            raise ValueError("an FSDP split takes its batches from an "
                             "InputShape")
        return FS.rows(data.global_batch // self.tc.n_workers, g[0])

    def _check_tensor_parallel(self) -> None:
        """Refuse, naming #13e, what the slice does not run over a
        ``model`` or FSDP axis > 1: the stale overlap here, the rest as
        each engine the rule gossips through refuses it on one process's
        tree (``CommEngine.model_split_refusal``)."""
        from repro_torch.models.sharding import TODO_13E
        tc, hp = self.tc, self.hp
        if tc.overlap != "none":
            raise NotImplementedError(
                f"the {tc.overlap} overlap with the weights split over "
                f"'model' or 'data': {TODO_13E}")
        n = tc.n_workers
        whole = tree.map(lambda a: torch.empty(
            (n,) + tuple(a.shape), dtype=a.dtype, device="meta"),
            TS.abstract_params(self.model))
        for eng in self.algo.engines(hp):
            eng.check_model_split(whole)

    def _context(self):
        return (mesh_context(self.mesh, self.rules, params=self.param_specs)
                if self.mesh is not None else contextlib.nullcontext())

    @property
    def lead(self) -> bool:
        """Whether this process writes the files: the one process, or the
        rank of the first block of workers and the first ``model`` and
        ``data`` shard."""
        return self.workers is None or (self.workers.index == 0 and all(
            g.rank == 0 for g in self.splits))

    def gather_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The whole state (one process's) from this rank's block: a
        collective, every rank calls it.  The identity without a mesh."""
        if self.mesh is None:
            return state
        with self._context():
            return convert.gather_state(state, self.on_workers,
                                        self.algo.mirrors)

    def init_state(self) -> Dict[str, Any]:
        """A fresh state; with a mesh this rank's block of it (the rows of
        one process's state: every worker starts from the same weights),
        under a ``model`` or FSDP split its shards of them."""
        lo, hi = self.rows
        cut = None
        if self.splits:
            def cut(p):
                for g in self.splits:
                    # the specs are the stacked ones: a worker's dim d is
                    # d - 1
                    p = g.cut(p, tuple(None if d is None else d - 1
                                       for d in g.dims))
                return p
        return TS.init_state(self.model, self.algo, self.hp, hi - lo,
                             seed=self.tc.seed, cut=cut)

    def bytes_per_step(self, state) -> int:
        """The one-process figure, also under a split."""
        with self._context():
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
        like = self.init_state()
        if self.mesh is None:
            return ckpt.restore(path + ".state", like)
        # the file holds every worker: restore it on the host at full
        # size, cut this rank's rows, then move them to the devices
        n = self.tc.n_workers
        host = tree.map(lambda a, w: torch.empty(
            (n,) + tuple(a.shape[1:]), dtype=a.dtype) if w else a,
            like, self.on_workers)
        if self.splits:
            with self._context():
                for sub, key in convert.cut_subtrees(host,
                                                     self.algo.mirrors):
                    sub[key] = tree.map(lambda a: torch.empty(
                        a.shape, dtype=a.dtype), TP.whole(sub[key]))
        full = ckpt.restore(path + ".state", host)
        block = convert.shard_state(full, self.workers.index,
                                    self.workers.size, self.splits,
                                    self.algo.mirrors)
        return tree.map(lambda a, l: a.to(l.device)
                        if isinstance(a, torch.Tensor) else a, block, like)

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
        ``train.checkpoint`` host spans.  With a mesh, ``state`` is this
        rank's block; the checkpoints are gathered (every rank takes part)
        and written, like the run log and the trace, by the rank of the
        first block."""
        tc = self.tc
        state = state if state is not None else self.init_state()
        k0 = state["step"]
        history: List[Dict] = []
        lead = self.lead
        rec = (SpanRecorder() if lead and (tc.trace_path or tc.log_jsonl)
               else None)
        writer = None
        if tc.log_jsonl and lead:
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
                with span("train.step", k), self._context():
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
                    with span("train.checkpoint", k + 1), self._context():
                        whole = self.gather_state(state)
                        if lead:
                            ckpt.save(tc.checkpoint_path, whole["params"],
                                      meta)
                            ckpt.save(tc.checkpoint_path + ".state", whole,
                                      meta)
                        workers.barrier()       # the file is whole for all
                        for g in TP.groups():
                            TP.barrier(g.axis)
                        del whole
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
