"""Cases of ``tests/test_torch_mesh_gossip.py``, run in R gloo processes.

``python tests/torch_mesh_cases.py STORE RANK WORLD OUT [nccl]``: the
process joins a gloo process group of WORLD ranks through the
``FileStore`` at STORE, runs every case of ``case_names(WORLD)`` with the
decentralized worker dim split over a mesh of its ranks
(``repro_torch.launch.mesh``), all-gathers each result, and rank 0 holds it
against the single-process port on its device and writes ``{case: [ok,
detail]}`` as JSON to OUT.  Every process pins one CPU thread.  Only the
port is imported (no JAX).  With ``nccl`` the ranks take one card each and
run ``NCCL_CASES`` on an NCCL group, held against one process on rank 0's
card.

``python tests/torch_mesh_cases.py --nccl OUTDIR``, on a host with cards:
builds the kernels, starts one NCCL rank a card (4, or 2), prints
each case's result and writes them to ``OUTDIR/nccl_cases.json``; exits
non-zero unless every case of ``NCCL_CASES`` ran and held.

Tolerances: every round is held bitwise.  The ResNet step is held to
``RESNET_ATOL`` on the parameters (and its logged losses bitwise): the CPU's
grouped-convolution backward, which ``vmap`` makes of the workers' convs,
sums the stem's weight gradient in another order for 2 workers than for 8
(a few 1e-4 of the leaf's largest entry apart), so two steps part in the
6th decimal; the LM trainer, whose matmuls are per worker, is bitwise on
the CPU.  Sums over ranks add in the collective's order: the AllReduce
rule's mean and the telemetry's EF residual norm are held to ``SUM_RTOL``
of the leaf's largest entry.  On the cards the LM trainer's split run is
held to the one-process run on one card at ``LM_CARD_RTOL``: cuBLAS may
pick another kernel for a batch of n/R workers than for n, so the
gradients may part in the last bits before the (bitwise) round.
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import traceback

import numpy as np
import torch

N = 8                      # workers of the flat rounds and the ResNet step
THETA = 2.0
WIRES = ("full", "moniqua", "qsgd", "ef_qsgd", "onebit")
PRESENCE = (1, 1, 0, 1, 1, 0, 1, 1)
# (n, n_intra) of the two-tier rounds, by world size: a rank holds whole
# nodes at R = 2, a node spans two ranks at R = 4
TIERED = {2: ((8, 4),), 4: ((4, 2), (8, 4))}
TIER_WIRES = WIRES
LM_WORKERS, LM_SEQ = 4, 32
RULES = ("allreduce", "dpsgd", "naive", "moniqua", "choco", "deepsqueeze",
         "dcd", "ecd", "d2", "moniqua_d2")
RESNET_ATOL = 1e-4
SUM_RTOL = 1e-6
LM_CARD_RTOL = 1e-3
# the cases run on NCCL, one card a rank (those of the world size)
NCCL_CASES = tuple(f"mix-{w}-bucketed-k1" for w in WIRES) + (
    "mix-moniqua-bucketed-k4", "mix-moniqua-per_leaf-k1",
    "mix-moniqua-per_leaf-k4", "mix-ef_qsgd-per_leaf-k4", "masked-moniqua",
    "masked-onebit", "stale", "telemetry-moniqua", "rule-allreduce",
    "rule-choco", "tiered-4x2-moniqua", "tiered-4x2-ef_qsgd",
    "tiered-8x4-moniqua", "tiered-8x4-onebit", "tiered-8x4-masked",
    "lm-trainer")


def nccl_worlds(cards: int) -> int:
    """The NCCL world size on ``cards`` cards: 4 or 2 (0: too few)."""
    return 4 if cards >= 4 else 2 if cards >= 2 else 0


def nccl_case_names(world: int):
    return tuple(c for c in NCCL_CASES if c in case_names(world))


def case_names(world: int):
    names = []
    for wire in WIRES:
        for path in ("bucketed", "per_leaf"):
            for k in (1, 4):
                names.append(f"mix-{wire}-{path}-k{k}")
        names.append(f"masked-{wire}")
    names += ["masked-moniqua-per_leaf", "exponential-moniqua",
              "stale", "stale-masked", "telemetry-moniqua",
              "telemetry-ef_qsgd", "placements", "constrain-dtensor"]
    names += [f"rule-{r}" for r in RULES]
    for n, k in TIERED[world]:
        for wire in TIER_WIRES:
            names.append(f"tiered-{n}x{k}-{wire}")
        names.append(f"tiered-{n}x{k}-masked")
    names += ["seeds", "resnet-step-k1",
              "resnet-step-k2", "lm-trainer", "lm-checkpoint",
              "hierarchical-refused"]
    return names


# -- inputs ------------------------------------------------------------------

def tree_np(n: int, seed: int = 0):
    """Six leaves (chunks = 4 needs at least four slots), workers near
    consensus so that Moniqua decodes within theta."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (37,), "b": (3, 29), "c": (64,), "d": (5, 7),
              "e": (130,), "f": ()}
    return {k: (rng.standard_normal(s)[None]
                + 0.05 * rng.standard_normal((n,) + s)).astype(np.float32)
            for k, s in shapes.items()}


def as_torch(t, device="cpu"):
    from repro_torch import tree
    return tree.map(lambda a: torch.from_numpy(np.array(a)).to(device), t)


def rows(t, lo, hi):
    from repro_torch import tree
    return tree.map(lambda a: a[lo:hi].clone(), t)


def engine(topo, wire, path="bucketed", chunks=1, telemetry=False):
    from repro_torch.comm.engine import CommEngine, make_wire
    from repro_torch.core.quantizers import QuantSpec
    spec = QuantSpec(1, False) if wire == "onebit" else QuantSpec(8)
    return CommEngine(topo, make_wire(wire, spec, warmup=1), path=path,
                      chunks=chunks, telemetry=telemetry)


def rounds(eng, X, n_rounds, presence=None):
    """``n_rounds`` of ``eng.mix`` (WireState threaded): the last result's
    model, state and health."""
    st = eng.init_wire_state(X) if eng.stateful else None
    res = None
    for r in range(n_rounds):
        res = eng.mix(X if res is None else res.x, theta=THETA, seed=11 + r,
                      state=st if res is None else res.state,
                      presence=presence)
    return {"x": res.x, "state": res.state, "health": res.health}


def gathered(out, n, tiered=False):
    """A round's result whole: the model and every state or health leaf
    with a leading dim of ``n / R`` rows gathered; a tiered round's state
    (the owned-shard residual, the step) is whole on every rank."""
    from repro_torch import convert, tree
    from repro_torch.comm import workers
    b = n // workers.blocks()

    def on_workers(key, t):
        return tree.map(lambda a: isinstance(a, torch.Tensor)
                        and a.dim() >= 1 and a.shape[0] == b
                        and (key == "x" or not tiered), t)
    return convert.gather_state(out, {k: on_workers(k, v)
                                      for k, v in out.items()})


def compare(got, want, rtol=None, atol=None):
    """(equal?, detail): leaf by leaf on the CPU, the largest gap; equal is
    bitwise unless ``rtol`` (of the leaf's largest entry) or ``atol`` is
    given."""
    from repro_torch import tree
    ga, wa = tree.leaves(got), tree.leaves(want)
    if len(ga) != len(wa):
        return False, f"{len(ga)} leaves != {len(wa)}"
    worst, ok = 0.0, True
    for a, b in zip(ga, wa):
        if isinstance(a, torch.Tensor):
            a, b = a.cpu(), b.cpu()
            if a.shape != b.shape:
                return False, f"shape {tuple(a.shape)} != {tuple(b.shape)}"
            if not torch.equal(a, b):
                gap = float((a.double() - b.double()).abs().max())
                worst = max(worst, gap)
                bound = (atol if atol is not None
                         else rtol * (float(b.double().abs().max()) or 1.0)
                         if rtol is not None else -1.0)
                if gap > bound:
                    ok = False
        elif a != b:
            return False, f"{a!r} != {b!r}"
    return ok, f"max gap {worst:.3e}"


# -- the cases ----------------------------------------------------------------

class Runner:
    def __init__(self, rank: int, world: int, workdir: str,
                 device: str = "cpu"):
        from repro_torch.launch import mesh as M
        from repro_torch.models.sharding import ShardingRules
        self.rank, self.world, self.workdir = rank, world, workdir
        self.device = device
        self.M = M
        self.results = {}
        self.flat_mesh = M.make_host_mesh(data=world, model=1,
                                          device_type=device)
        self.flat_rules = ShardingRules("decentralized")
        self.tier_rules = ShardingRules("decentralized", tiers=2)
        self.tier_mesh = M.make_two_tier_mesh(world // 2, 2, 1,
                                              device_type=device)

    def block(self, n):
        b = n // self.world
        return self.rank * b, (self.rank + 1) * b

    def split(self, fn, X, n, tiered=False):
        """``fn(X_rows)`` under the mesh context, its result gathered."""
        lo, hi = self.block(n)
        mesh, rules = ((self.tier_mesh, self.tier_rules) if tiered
                       else (self.flat_mesh, self.flat_rules))
        with self.M.mesh_context(mesh, rules):
            return gathered(fn(rows(X, lo, hi)), n, tiered)

    def record(self, name, fn):
        try:
            ok, detail = fn()
        except Exception:                     # reported per case
            ok, detail = False, traceback.format_exc()[-2000:]
        self.results[name] = [bool(ok), detail]

    def round_case(self, fn, n=N, tiered=False, rtol=None):
        X = as_torch(tree_np(n), self.device)
        got = self.split(fn, X, n, tiered)
        if self.rank:
            return True, "checked on rank 0"
        want = gathered(fn(as_torch(tree_np(n), self.device)), n, tiered)
        return compare(got, want, rtol)

    def cases(self):
        """``{name: fn}`` of every case at this world size."""
        from repro_torch.core.topology import exponential, ring, two_tier
        out = {}
        for wire in WIRES:
            n_rounds = 2 if wire in ("ef_qsgd", "onebit") else 1
            for path in ("bucketed", "per_leaf"):
                for k in (1, 4):
                    out[f"mix-{wire}-{path}-k{k}"] = (
                        lambda e=engine(ring(N), wire, path, k),
                        r=n_rounds: self.round_case(
                            lambda X: rounds(e, X, r)))
            out[f"masked-{wire}"] = (
                lambda e=engine(ring(N), wire), r=n_rounds:
                self.round_case(lambda X: rounds(e, X, r, PRESENCE)))
        eng = engine(ring(N), "moniqua", "per_leaf")
        out["masked-moniqua-per_leaf"] = lambda: self.round_case(
            lambda X: rounds(eng, X, 1, PRESENCE))
        eng_x = engine(exponential(N), "moniqua")
        out["exponential-moniqua"] = lambda: self.round_case(
            lambda X: rounds(eng_x, X, 1))
        out["stale"] = lambda: self.round_case(
            lambda X: self.stale(X, None))
        out["stale-masked"] = lambda: self.round_case(
            lambda X: self.stale(X, PRESENCE))
        for wire in ("moniqua", "ef_qsgd"):
            # the EF residual's L2 norm sums in the collective's order
            out[f"telemetry-{wire}"] = (
                lambda e=engine(ring(N), wire, telemetry=True), w=wire:
                self.round_case(lambda X: rounds(e, X, 2),
                                rtol=SUM_RTOL if w == "ef_qsgd" else None))
        for rule in RULES:
            out[f"rule-{rule}"] = lambda r=rule: self.round_case(
                lambda X: self.rule_steps(r, X),
                rtol=SUM_RTOL if r == "allreduce" else None)
        out["placements"] = self.placements
        out["constrain-dtensor"] = self.constrain_dtensor
        for n, k in TIERED[self.world]:
            for wire in TIER_WIRES:
                n_rounds = 2 if wire in ("ef_qsgd", "onebit") else 1
                out[f"tiered-{n}x{k}-{wire}"] = (
                    lambda e=engine(two_tier(n, k), wire, chunks=2), n=n,
                    r=n_rounds: self.round_case(
                        lambda X: rounds(e, X, r), n=n, tiered=True))
            pres = tuple(int(g != 1) for g in range(n // k))
            out[f"tiered-{n}x{k}-masked"] = (
                lambda e=engine(two_tier(n, k), "moniqua"), n=n, p=pres:
                self.round_case(lambda X: rounds(e, X, 1, p), n=n,
                                tiered=True))
        out["seeds"] = self.seeds
        for k in (1, 2):
            out[f"resnet-step-k{k}"] = lambda k=k: self.resnet(k)
        out["lm-trainer"] = self.lm_trainer
        out["lm-checkpoint"] = self.lm_checkpoint
        out["hierarchical-refused"] = self.hierarchical_refused
        return out

    def run(self):
        cases = self.cases()
        assert sorted(cases) == sorted(case_names(self.world))
        for name in (case_names(self.world) if self.device == "cpu"
                     else nccl_case_names(self.world)):
            self.record(name, cases[name])

    # -- cases with more than one round or a trainer --------------------------
    def stale(self, X, presence):
        eng = engine(__import__("repro_torch.core.topology",
                                fromlist=["ring"]).ring(N), "moniqua")
        carry = eng.init_gossip_carry(X)
        res = None
        for r in range(3):
            res = eng.mix_stale(X if res is None else res.x, carry
                                if res is None else res.state, theta=THETA,
                                seed=21 + r, presence=presence)
        return {"x": res.x, "state": res.state}

    def rule_steps(self, name, X):
        """Two steps of update rule ``name`` (its replicas, error buffers
        and uniforms drawn from the seed) on ring(8)."""
        from repro_torch import tree
        from repro_torch.core.algorithms import AlgoHyper, get_algorithm
        from repro_torch.core.topology import ring
        algo, hp = get_algorithm(name), AlgoHyper(topo=ring(N))
        g = tree.map(lambda a: 0.1 * a, X)
        extra = algo.init(X, hp)
        for k in range(2):
            X, extra = algo.step(X, extra, g, 0.1, k, 7 + k, hp)
        return {"x": X, "extra": extra}

    def placements(self):
        """``placements`` of the resolved worker spec shards a stacked leaf
        as ``shard_state`` cuts it."""
        from torch.distributed.tensor import distribute_tensor
        from repro_torch import convert
        from repro_torch.models.sharding import placements, safe_pspec
        X = as_torch(tree_np(N))
        spec = safe_pspec((N, 3, 29), self.flat_rules.pspec("worker", None,
                                                            None),
                          self.M.mesh_shape_dict(self.flat_mesh))
        dt = distribute_tensor(X["b"], self.flat_mesh,
                               placements(spec, self.flat_mesh))
        want = convert.shard_state({"params": X}, self.rank,
                                   self.world)["params"]["b"]
        return torch.equal(dt.to_local(), want), f"spec {spec!r}"

    def constrain_dtensor(self):
        """Inside the mesh context ``constrain`` redistributes a replicated
        DTensor to the rows of its worker spec; outside it is the
        identity."""
        from torch.distributed.tensor import Replicate, distribute_tensor
        from repro_torch.models import sharding as SH
        X = as_torch(tree_np(N))["b"]
        dt = distribute_tensor(X, self.flat_mesh, [Replicate(), Replicate()])
        same = SH.constrain(dt, "worker", None, None) is dt
        with self.M.mesh_context(self.flat_mesh, self.flat_rules):
            out = SH.constrain(dt, "worker", None, None)
        lo, hi = self.block(N)
        return (same and torch.equal(out.to_local(), X[lo:hi]),
                f"placements {out.placements}")

    def seeds(self):
        """The per-step seed every rank draws from its state's generator
        is the same (all-gathered)."""
        import torch.distributed as dist
        tr = self.resnet_trainer(self.flat_mesh)
        gen = tr.init_state()["gen"]
        seeds = torch.randint(0, 2 ** 32, (3,), generator=gen)
        got = [torch.empty_like(seeds) for _ in range(self.world)]
        dist.all_gather(got, seeds)
        return all(torch.equal(g, got[0]) for g in got), str(seeds.tolist())

    def resnet_trainer(self, mesh, chunks=1):
        from repro_torch.data.synthetic import stacked_cifar_like
        from repro_torch.models.resnet import ResNetModel
        from repro_torch.train.trainer import Trainer, TrainerConfig
        if not hasattr(self, "batches"):
            self.batches = [stacked_cifar_like(k, 16, N, seed=0,
                                               device="cpu")
                            for k in range(2)]
        tc = TrainerConfig(algo="moniqua", topology="ring", n_workers=N,
                           bits=8, steps=2, log_every=1, chunks=chunks,
                           comm_path="bucketed")
        return Trainer(ResNetModel(depth=8, width=8, device="cpu"), tc,
                       lambda k: self.batches[k], mesh=mesh,
                       rules=self.flat_rules if mesh is not None else None)

    def resnet(self, chunks):
        """Two ResNet Moniqua steps, the main path, at ring(8)."""
        tr = self.resnet_trainer(self.flat_mesh, chunks)
        out = tr.run()
        got = tr.gather_state(out["state"])
        if self.rank:
            return True, "checked on rank 0"
        ref = self.resnet_trainer(None, chunks).run()
        same_loss = ([h["loss"] for h in out["history"]]
                     == [h["loss"] for h in ref["history"]])
        ok, detail = compare(got["params"], ref["state"]["params"],
                             atol=RESNET_ATOL)
        return ok and same_loss, f"{detail}; losses equal {same_loss}"

    def lm_trainer_of(self, mesh, ckpt=None):
        from repro_torch.configs import get_config
        from repro_torch.configs.base import InputShape
        from repro_torch.models.model_factory import Model
        from repro_torch.train.trainer import Trainer, TrainerConfig
        cfg = get_config("llama3.2-3b").reduced()
        tc = TrainerConfig(algo="moniqua", topology="ring",
                           n_workers=LM_WORKERS, bits=8, steps=2, log_every=1,
                           checkpoint_path=ckpt,
                           checkpoint_every=2 if ckpt else 0)
        return Trainer(Model(cfg, self.device), tc,
                       InputShape("lm", LM_SEQ, LM_WORKERS, "train"),
                       mesh=mesh,
                       rules=self.flat_rules if mesh is not None else None)

    def lm_trainer(self):
        """Two reduced-llama Moniqua steps through ``Trainer(model, tc,
        shape, mesh=, rules=)``; the gathered state against one process
        (on the cards: one process on rank 0's card, to ``LM_CARD_RTOL``)."""
        tr = self.lm_trainer_of(self.flat_mesh)
        out = tr.run()
        got = tr.gather_state(out["state"])
        if self.rank:
            return True, "checked on rank 0"
        ref = self.lm_trainer_of(None).run()
        rtol = None if self.device == "cpu" else LM_CARD_RTOL
        keys = ("params", "mom", "g_inf")
        ok, detail = compare({k: got[k] for k in keys},
                             {k: ref["state"][k] for k in keys}, rtol)
        losses = [[h["loss"] for h in r["history"]] for r in (out, ref)]
        ok_loss, d_loss = compare(torch.tensor(losses[0], dtype=torch.float64),
                                  torch.tensor(losses[1], dtype=torch.float64),
                                  rtol)
        return ok and ok_loss, f"{detail}; losses {d_loss} {losses}"

    def lm_checkpoint(self):
        """The gathered checkpoint is the file one process writes, and
        ``restore_state`` gives back each rank's block."""
        import torch.distributed as dist
        from repro_torch.checkpoint import ckpt
        path = os.path.join(self.workdir, "lm")
        mesh = self.flat_mesh
        tr = self.lm_trainer_of(mesh, path)
        out = tr.run()
        back = tr.restore_state()
        ok_back, d_back = compare({k: back[k] for k in ("params", "mom")},
                                  {k: out["state"][k]
                                   for k in ("params", "mom")})
        flags = torch.tensor([int(ok_back)])
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        if self.rank:
            return True, "checked on rank 0"
        ref_path = os.path.join(self.workdir, "lm_ref")
        self.lm_trainer_of(None, ref_path).run()
        a = np.load(path + ".state.npz")
        b = np.load(ref_path + ".state.npz")
        same_file = (sorted(a.files) == sorted(b.files)
                     and all(np.array_equal(a[k], b[k]) for k in a.files))
        meta_same = ckpt.load_meta(path) == ckpt.load_meta(ref_path)
        return (bool(flags.item()) and same_file and meta_same,
                f"restore {d_back}; file equal {same_file}")

    def hierarchical_refused(self):
        """Hierarchical rules shard ``embed`` on ``data`` (FSDP): the
        trainer raises, naming #13e."""
        from repro_torch.models.sharding import ShardingRules
        from repro_torch.train.trainer import Trainer
        tr = self.resnet_trainer(None)
        try:
            Trainer(tr.model, tr.tc, tr.batch_fn, mesh=self.flat_mesh,
                    rules=ShardingRules("hierarchical"))
        except NotImplementedError as e:
            return "#13e" in str(e), str(e)[:200]
        return False, "no NotImplementedError"


def launch_nccl(outdir: str, timeout: float = 900.0) -> int:
    """Every card a rank: ``NCCL_CASES`` across all of them (module
    docstring)."""
    import subprocess
    import time
    from repro_torch.kernels import build
    world = nccl_worlds(torch.cuda.device_count())
    if not world:
        print("the NCCL cases need two CUDA cards")
        return 1
    build.build_all()
    os.makedirs(outdir, exist_ok=True)
    out = os.path.join(outdir, "nccl_cases.json")
    store = os.path.join(outdir, "nccl_store")
    for f in (out, store):
        if os.path.exists(f):
            os.remove(f)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               store, str(r), str(world), out, "nccl"])
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"{world} ranks, exit codes {rcs}, "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs) or not os.path.exists(out):
        return 1
    with open(out) as f:
        res = json.load(f)
    for case in nccl_case_names(world):
        print(case, *res.get(case, [False, "did not run"]))
    ok = (sorted(res) == sorted(nccl_case_names(world))
          and all(v[0] for v in res.values()))
    print("NCCL cases", "ok" if ok else "FAILED")
    return 0 if ok else 1


def main(argv) -> int:
    if argv[1] == "--nccl":
        return launch_nccl(argv[2])
    store_path, rank, world, out = argv[1], int(argv[2]), int(argv[3]), \
        argv[4]
    nccl = argv[5:] == ["nccl"]
    torch.set_num_threads(1)
    import torch.distributed as dist
    if nccl:
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world)
    # a collective that waits this long is a fault: fail, do not hang
    dist.init_process_group("nccl" if nccl else "gloo", store=store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        workdir = os.path.dirname(out) or tempfile.gettempdir()
        runner = Runner(rank, world, workdir, "cuda" if nccl else "cpu")
        runner.run()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(runner.results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
