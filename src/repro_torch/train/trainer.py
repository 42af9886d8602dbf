"""Host-side training loop: batch source, step function, history.

The batch source is a callable ``step -> stacked batch`` (leaves
``[n, batch, ...]``); for ResNet-20 that is
``data.synthetic.stacked_cifar_like``.  Checkpoints (``checkpoint/ckpt.py``)
hold the params and the full state, so a cut run resumes bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.algorithms import AlgoHyper, get_algorithm
from repro_torch.core.moniqua import MoniquaCodec
from repro_torch.core.quantizers import QuantSpec
from repro_torch.core.theta import ThetaSchedule
from repro_torch.core.topology import get_topology
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
    chunks: int = 1             # staged-round chunk count (1 = barrier)
    overlap: str = "none"       # step-level overlap: none | stale (moniqua)
    warmup: int = 16            # onebit wire: fp32 rounds before 1-bit+EF
    presence: Optional[tuple] = None  # elastic 0/1 worker mask for every
                                #   round (AlgoHyper.presence); None = all up
    deadline: Optional[float] = None  # sim round deadline in seconds
                                #   (recorded; enforced by sim/faults.py)


def build_hyper(tc: TrainerConfig) -> AlgoHyper:
    """The run's AlgoHyper on the bucketed path (D-PSGD and all-reduce
    gossip full precision whatever the wire).  1-bit rounds to nearest
    (stochastic 1-bit has delta = 1/2, which Moniqua rejects), wider codes
    round stochastically."""
    topo = get_topology(tc.topology, tc.n_workers)
    if tc.slack < 1.0:
        topo = topo.slack(tc.slack)
    spec = QuantSpec(bits=tc.bits, stochastic=tc.bits > 1)
    presence = None if tc.presence is None else tuple(tc.presence)
    return AlgoHyper(topo=topo, codec=MoniquaCodec(spec), theta=tc.theta,
                     gamma=tc.gamma, wire=tc.wire, chunks=tc.chunks,
                     overlap=tc.overlap, warmup=tc.warmup, presence=presence,
                     deadline=tc.deadline)


class Trainer:
    def __init__(self, model, tc: TrainerConfig,
                 batch_fn: Callable[[int], Dict[str, torch.Tensor]]):
        self.model, self.tc, self.batch_fn = model, tc, batch_fn
        self.hp = build_hyper(tc)
        self.algo = get_algorithm(tc.algo)
        self.tcfg = TS.TrainStepConfig(
            algo=tc.algo,
            sgd=SGDConfig(momentum=tc.momentum, weight_decay=tc.weight_decay),
            lr=tc.lr,
            theta=ThetaSchedule(mode="constant", value=tc.theta,
                                n=tc.n_workers, rho=self.hp.topo.rho))
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

    def run(self, state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Run ``tc.steps`` steps from ``state`` (a fresh one by default;
        a restored one resumes at its own step, and the batch source is
        indexed by the global step).  Every ``log_every`` steps, and at the
        last, the metrics are read back to the host (which waits for the
        card) into ``history``, with ``wall`` the seconds since the loop
        started.  With ``checkpoint_path`` and ``checkpoint_every``, every
        that many steps the params go to ``checkpoint_path`` and the full
        state to ``<checkpoint_path>.state``."""
        tc = self.tc
        state = state if state is not None else self.init_state()
        k0 = state["step"]
        history: List[Dict] = []
        t0 = time.perf_counter()
        for k in range(k0, k0 + tc.steps):
            state, metrics = self.step_fn(state, self.batch_fn(k))
            if (k - k0) % tc.log_every == 0 or k == k0 + tc.steps - 1:
                m = {kk: float(v) for kk, v in metrics.items()}
                m["step"] = k
                m["wall"] = time.perf_counter() - t0
                history.append(m)
            if (tc.checkpoint_path and tc.checkpoint_every
                    and (k + 1) % tc.checkpoint_every == 0):
                meta = {"step": k + 1, "algo": tc.algo, "wire": tc.wire}
                ckpt.save(tc.checkpoint_path, state["params"], meta)
                ckpt.save(tc.checkpoint_path + ".state", state, meta)
        return {"state": state, "history": history,
                "bytes_per_step": self.bytes_per_step(state)}
