"""Cases of ``tests/test_torch_tensor_parallel.py``, run in gloo ranks.

``python tests/torch_tp_cases.py STORE RANK WORLD INPUTS OUT``: the process
joins a gloo group of WORLD ranks (2 or 4) through the ``FileStore`` at
STORE, lays them out as the mesh ``(data, model) = MESHES[WORLD]``, reads
the cases' inputs from the ``.npz`` at INPUTS (stacked float32 params of
the reduced dense archs, of their head counts that ``model`` = 2 does not
split cleanly (``SPLIT_ARCHS``) and of reduced dbrx-132b, token batches,
the round and step seeds, serving tokens;
``tests/test_torch_tensor_parallel.py`` draws them from the JAX
reference's init), runs every case of ``CASES``
on its block of workers and
its shards of the weights (the eight other update rules and the masked
rounds on reduced llama3.2-3b through ``torch_rule_cases``, with the
reference's rounding uniforms and rule seeds from the inputs), gathers
each result whole and, on rank 0,
writes the arrays to ``OUT + ".npz"`` and the checks made in the ranks
(``{case: [ok, detail]}``) to ``OUT + ".json"``.  Only the port is
imported, one CPU thread a process.

``python tests/torch_tp_cases.py --nccl OUTDIR``, on a host with four
cards: builds the kernels, draws the inputs with the port's own init, starts
one NCCL rank a card on the mesh ``(data=2, model=2)``, and rank 0 holds
every case against the same case run in one process on its card
(``CARD_TOL``); then it times the full-width training cell (llama3.2-3b
widths, 2 layers, ring(4), Moniqua 8-bit, bfloat16, 2048 tokens a worker)
split over the four cards, and the same cell in one process on one card.
Writes ``OUTDIR/tp_cases.json`` and exits non-zero unless every case held.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

import torch_rule_cases as R

ARCHS = ("llama3.2-3b", "chatglm3-6b", "dbrx-132b")
MOE_ARCH = ARCHS[2]            # reduced: E 4, top-2, group 64
N, B, S = 4, 2, 32            # workers, sequences a worker, tokens
THETA, LR = 2.0, 0.1
SERVE_B, SERVE_S, DECODE = 2, 24, 4
# the decode ring of the ``ring-`` cases: RING_STEPS tokens from an empty
# ring of RING slots, past every rank's RING / M slots of a kv_seq cache
# and past the ring's end (the oldest slots overwritten)
RING, RING_STEPS = 8, 12
# a ring that model = 2 does not divide: its spec replicates the cache,
# every KV head over all of its slots on every rank (the ``ring9-`` cases)
RING_WHOLE = 9
MESHES = {2: (1, 2), 4: (2, 2)}
ROUNDS = {"moniqua8": (8, True), "moniqua1": (1, False), "full": None}
# head counts that model = 2 does not split cleanly, each run as an arch of
# its own (gradients, a train step, serving): 3 query heads, which run
# context-parallel (the keys split over model, the attention weights whole
# on every rank, the decode cache on its sequence dim); 6 query heads over
# 3 KV heads, whose groups of 2 a rank's 3 query heads cannot read whole
# (each rank projects the KV heads it reads and expands them to its heads)
SPLIT_ARCHS = {"llama3.2-3b@h3": ("llama3.2-3b",
                                  dict(num_heads=3, num_kv_heads=3)),
               "chatglm3-6b@h6kv3": ("chatglm3-6b",
                                     dict(num_heads=6, num_kv_heads=3))}
ALL_ARCHS = ARCHS + tuple(SPLIT_ARCHS)
REFUSALS = ("hierarchical-whisper", "family-vlm", "wire-qsgd",
            "path-bucketed", "telemetry")
# the families still refused on a split (ROADMAP #13e.4) by their configs
FAMILY_ARCHS = {"whisper": "whisper-base", "vlm": "phi-3-vision-4.2b"}
# the full-width cell of the NCCL run (chip_smoke.py phase 21's)
CELL_LAYERS, CELL_SEQ, CELL_STEPS = 2, 2048, 3
# its split losses against the one-card run's: chip_smoke.py phase 26's
# bf16 bound (the bytes/step equal)
CELL_RTOL = 1e-3
# one process on a card against the split on four cards: float32
# gradients and logits within this share of their largest entry (cuBLAS
# splits other sums), the rounds bitwise
CARD_TOL = 1e-4


def case_names():
    """Every case of a world: the checks the ranks make themselves, and
    the arrays the test holds against the reference."""
    return (["ops"] + [f"grads-{a}" for a in ALL_ARCHS]
            + [f"round-{w}" for w in ROUNDS] + ["step", "trainer"]
            + [f"round-moniqua8-{MOE_ARCH}"]
            + [f"step-{a}" for a in (MOE_ARCH,) + tuple(SPLIT_ARCHS)]
            + [f"serve-{a}" for a in ALL_ARCHS]
            + [f"ring-{a}" for a in SPLIT_ARCHS]
            + [f"ring{RING_WHOLE}-{a}" for a in SPLIT_ARCHS]
            + R.rule_names()
            + [f"refuse-{r}" for r in REFUSALS])


def arch_of(name):
    """``(arch, overrides)`` of an entry of ``ALL_ARCHS``."""
    return SPLIT_ARCHS.get(name, (name, {}))


def config(name, **over):
    """The reduced arch of ``name`` (``arch_of``) in float32, the flash
    route (its plain version on the CPU)."""
    from repro_torch.configs import get_config
    arch, kw = arch_of(name)
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               flash_attention=True, **dict(kw, **over))


def abstract(cfg):
    """The params' treedef and leaf shapes (one worker)."""
    from repro_torch import tree
    from repro_torch.models.model_factory import Model
    from repro_torch.train.train_step import abstract_params
    leaves, td = tree.flatten(abstract_params(Model(cfg, "cpu")))
    return td, [tuple(a.shape) for a in leaves]


def port_inputs(path: str, seed: int = 0) -> None:
    """The inputs from the port's own init (the NCCL run: no JAX on the
    host), laid out as the test writes them from the reference's."""
    from repro_torch import tree
    from repro_torch.models.model_factory import Model
    rng = np.random.default_rng(seed)
    out = {"seed_round": np.array(0x5EED1), "seed_step": np.array(0x5EED2)}
    for a in ALL_ARCHS:
        cfg = config(a)
        p = Model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
        for i, leaf in enumerate(tree.leaves(p)):
            leaf = leaf.numpy()
            out[f"{a}/X/{i}"] = (leaf[None] + 0.02 * rng.standard_normal(
                (N,) + leaf.shape)).astype(np.float32)
        toks = rng.integers(0, cfg.vocab_size, (N, B, S + 1)).astype(
            np.int32)
        out[f"{a}/tokens"] = toks[..., :-1].copy()
        out[f"{a}/labels"] = toks[..., 1:].copy()
        out[f"{a}/serve"] = rng.integers(
            0, cfg.vocab_size, (SERVE_B, SERVE_S + DECODE)).astype(np.int32)
        if a == ARCHS[0]:
            R.port_inputs(out, a, [(N,) + s for s in abstract(cfg)[1]], rng)
    np.savez(path, **out)


class Runner:
    def __init__(self, rank, world, inputs, workdir, device="cpu",
                 split=True):
        from repro_torch.launch import mesh as M
        from repro_torch.models.sharding import ShardingRules
        self.rank, self.world, self.workdir = rank, world, workdir
        self.device, self.split = device, split
        self.inp = dict(np.load(inputs))
        self.rules = ShardingRules("decentralized")
        self.M = M
        data, model = MESHES[world] if split else (1, 1)
        self.mesh = (M.make_host_mesh(data=data, model=model,
                                      device_type=device)
                     if split else None)
        self.data, self.model_size = data, model
        self.arrays, self.checks = {}, {}

    # -- the split ------------------------------------------------------------
    def coords(self):
        """(worker block index, model rank) of this process."""
        if self.mesh is None:
            return 0, 0
        return (int(self.mesh.get_local_rank("data")),
                int(self.mesh.get_local_rank("model")))

    def rows(self):
        b = N // self.data
        i, _ = self.coords()
        return i * b, (i + 1) * b

    def model(self, arch, **over):
        from repro_torch.models.model_factory import Model
        return Model(config(arch, **over), self.device)

    def specs(self, model):
        from repro_torch.train.train_step import params_pspecs
        return params_pspecs(model, self.rules, self.shape(), stacked=True)

    def shape(self):
        return {"data": self.data, "model": self.model_size}

    def context(self, model):
        import contextlib
        if self.mesh is None:
            return contextlib.nullcontext()
        return self.M.mesh_context(self.mesh, self.rules,
                                   params=self.specs(model))

    def whole(self, model, arch, key="X"):
        """The stacked inputs tree ``arch/key`` of every worker."""
        from repro_torch import tree
        td, shapes = abstract(model.cfg)
        return tree.unflatten(td, [torch.from_numpy(
            self.inp[f"{arch}/{key}/{i}"]) for i in range(len(shapes))])

    def cut(self, model, X):
        """This rank's rows and shards of a whole stacked tree, on its
        device."""
        from repro_torch import tree
        from repro_torch.comm import tensor_parallel as TP
        lo, hi = self.rows()
        X = tree.map(lambda a: a[lo:hi].to(self.device), X)
        _, r = self.coords()
        return TP.shard_tree(X, TP.axis_dims(self.specs(model), "model"),
                             r, self.model_size)

    def stacked(self, arch, model):
        """This rank's rows and shards of the stacked inputs."""
        lo, hi = self.rows()
        X = self.cut(model, self.whole(model, arch))
        batch = {k: torch.from_numpy(self.inp[f"{arch}/{k}"][lo:hi]).to(
            self.device) for k in ("tokens", "labels")}
        return X, batch

    def gather(self, X):
        """A stacked params-shaped tree whole (inside the context): rows
        over the workers, then shards over ``model``."""
        from repro_torch import tree
        from repro_torch.comm import tensor_parallel as TP
        from repro_torch.comm import workers
        X = tree.map(workers.gather_rows, X)
        dims = TP.leaf_dims(X, "model")
        if dims is None:
            return X
        leaves, td = tree.flatten(X)
        return tree.unflatten(td, [a if d is None
                                   else TP.gather_dim(a, d, "model")
                                   for a, d in zip(leaves, dims)])

    def put(self, case, tree_or_arrays):
        from repro_torch import tree
        for i, a in enumerate(tree.leaves(tree_or_arrays)):
            self.arrays[f"{case}/{i}"] = (
                a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))

    def replicated_equal(self, X, model):
        """Whether every replicated leaf is bitwise the same on every
        model rank (an all-reduce max of each leaf's |x - x_rank0|)."""
        from repro_torch import tree
        from repro_torch.comm import tensor_parallel as TP
        if TP.current("model") is None:
            return True
        worst = 0.0
        for a, d in zip(tree.leaves(X),
                        TP.axis_dims(self.specs(model), "model")):
            if d is None:
                gap = (TP.gather_dim(a.reshape(1, -1), 1, "model")
                       .reshape(self.model_size, -1))
                worst = max(worst, float(
                    (gap - gap[:1]).abs().max()))
        return worst == 0.0

    # -- the cases ------------------------------------------------------------
    def ops(self):
        """copy_to / reduce_sum / max_over on ``model`` under
        vmap(grad) on a column- then row-parallel pair against one
        process's autograd."""
        from repro_torch.comm import tensor_parallel as TP
        g = torch.Generator().manual_seed(3)
        n, d, f = 3, 8, 6 * self.model_size
        X = torch.randn(n, 5, d, generator=g)
        A = torch.randn(n, d, f, generator=g)
        Bw = torch.randn(n, f, d, generator=g)

        def loss(a, b, x):
            y = TP.reduce_sum(torch.tanh(TP.copy_to(x, "model") @ a) @ b,
                              "model")
            return ((y - TP.max_over(y.amax(), "model")) ** 2).sum()
        want = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
            A, Bw, X)
        model = self.model(ARCHS[0])
        with self.context(model):
            _, r = self.coords()
            k = f // self.model_size
            got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
                A[..., r * k:(r + 1) * k].to(self.device),
                Bw[:, r * k:(r + 1) * k].to(self.device), X.to(self.device))
        pairs = ((got[0].cpu(), want[0][..., r * k:(r + 1) * k]),
                 (got[1].cpu(), want[1][:, r * k:(r + 1) * k]),
                 (got[2].cpu(), want[2]))
        errs = [float((a - b).abs().max() / b.abs().max()) for a, b in pairs]
        return max(errs) <= 1e-5, f"relative gaps {errs}"

    def grads(self, arch):
        from repro_torch.comm import workers
        model = self.model(arch)
        X, batch = self.stacked(arch, model)
        with self.context(model):
            g, loss = torch.func.vmap(torch.func.grad_and_value(model.loss))(
                X, batch)
            same = self.replicated_equal(g, model)
            self.put(f"grads-{arch}/grads", self.gather(g))
            self.arrays[f"grads-{arch}/loss"] = workers.gather_rows(
                loss).cpu().numpy()
        return same, f"replicated gradients equal over model: {same}"

    def hyper(self, wire):
        from repro_torch.core.algorithms import AlgoHyper
        from repro_torch.core.moniqua import MoniquaCodec
        from repro_torch.core.quantizers import QuantSpec
        from repro_torch.core.topology import ring
        bits, stochastic = ROUNDS.get(wire) or (8, True)
        return AlgoHyper(topo=ring(N), codec=MoniquaCodec(
            QuantSpec(bits=bits, stochastic=stochastic)), theta=THETA)

    def round(self, wire, arch=None):
        """The round on this rank's shards; its case is ``round-WIRE``
        on the first arch, ``round-WIRE-ARCH`` on another."""
        case = f"round-{wire}" + (f"-{arch}" if arch else "")
        arch = arch or ARCHS[0]
        model = self.model(arch)
        X, _ = self.stacked(arch, model)
        hp = self.hyper(wire)
        seed = int(self.inp["seed_round"])
        with self.context(model):
            if wire == "full":
                out = hp.exact_engine().mix(X).x
            else:
                out = hp.engine().mix(X, theta=THETA, seed=seed).x
            same = self.replicated_equal(out, model)
            self.put(f"{case}/x", self.gather(out))
        return same, f"replicated leaves equal over model: {same}"

    def step(self, arch=None):
        """One Moniqua 8-bit train step; its case is ``step`` on the
        first arch, ``step-ARCH`` on another."""
        from repro_torch.optim import sgd
        from repro_torch.core.theta import ThetaSchedule
        from repro_torch.train import train_step as TS
        case = "step" + (f"-{arch}" if arch else "")
        arch = arch or ARCHS[0]
        model = self.model(arch)
        X, batch = self.stacked(arch, model)
        hp = self.hyper("moniqua8")
        step_fn = TS.make_train_step(model, hp, TS.TrainStepConfig(
            algo="moniqua", sgd=sgd.SGDConfig(momentum=0.9,
                                              weight_decay=5e-4),
            lr=LR, theta=ThetaSchedule(value=THETA)))
        state = {"params": X, "mom": sgd.init_momentum(X), "extra": {},
                 "step": 0, "g_inf": torch.ones((), device=self.device),
                 "gen": torch.Generator()}
        with self.context(model):
            state, met = step_fn(state, batch,
                                 seed=int(self.inp["seed_step"]))
            same = self.replicated_equal(state["params"], model)
            self.put(f"{case}/x", self.gather(state["params"]))
        self.arrays[f"{case}/loss"] = np.asarray(float(met["loss"]))
        self.arrays[f"{case}/wire_bytes"] = np.asarray(met["wire_bytes"])
        self.arrays[f"{case}/g_inf"] = np.asarray(float(met["g_inf"]))
        return same, f"replicated leaves equal over model: {same}"

    def trainer_of(self, ckpt=None, **over):
        from repro_torch.configs.base import InputShape
        from repro_torch.train.trainer import Trainer, TrainerConfig
        tc = TrainerConfig(**dict(dict(
            algo="moniqua", topology="ring", n_workers=N, bits=8, steps=2,
            log_every=1, seed=3, checkpoint_path=ckpt,
            checkpoint_every=2 if ckpt else 0), **over))
        return Trainer(self.model(ARCHS[0]), tc,
                       InputShape("lm", S, N * B, "train"), mesh=self.mesh,
                       rules=self.rules if self.mesh is not None else None)

    def trainer(self):
        """Two ``Trainer`` steps with a gathered checkpoint: the restored
        state is the live one bitwise (params, momentum, ``g_inf``, the
        step and the seed generator), so a resumed run repeats the
        computation; the checkpoint's params go to the test."""
        from repro_torch import tree
        path = os.path.join(self.workdir, f"tp{self.world}")
        tr = self.trainer_of(path)
        out = tr.run()
        back = tr.restore_state()
        live = out["state"]
        keys = ("params", "mom", "g_inf")
        same = all(torch.equal(a, b) for a, b in zip(
            tree.leaves({k: back[k] for k in keys}),
            tree.leaves({k: live[k] for k in keys})))
        same_run = (back["step"] == live["step"] and torch.equal(
            back["gen"].get_state(), live["gen"].get_state()))
        ck = np.load(path + ".state.npz")
        self.arrays["trainer/losses"] = np.array(
            [h["loss"] for h in out["history"]])
        self.arrays["trainer/bytes"] = np.asarray(out["bytes_per_step"])
        for f in ck.files:
            if f.startswith("params"):
                self.arrays[f"trainer/ckpt/{f}"] = ck[f]
        return (same and same_run,
                f"restore bitwise {same}; step and generator {same_run}")

    def serve(self, arch, ring=False):
        """Prefill and ``DECODE`` cached steps; with ``ring``, ``RING_STEPS``
        steps on a ring of ``ring`` slots instead (a ``ring-`` case at
        ``RING``, a ``ring9-`` case at ``RING_WHOLE``)."""
        from repro_torch.configs.base import InputShape
        from repro_torch import tree
        from repro_torch.train import serve_step as SS
        model = self.model(arch)
        td, shapes = abstract(model.cfg)
        P = tree.unflatten(td, [torch.from_numpy(
            self.inp[f"{arch}/X/{i}"][0]).to(self.device)
            for i in range(len(shapes))])
        kw = dict(mesh=self.mesh, rules=self.rules) if self.mesh else {}
        if self.mesh is not None:
            P = SS.shard_serving_params(model, P, self.mesh, self.rules)
        toks = torch.from_numpy(self.inp[f"{arch}/serve"]).to(self.device)
        tag = "ring" if ring == RING else f"ring{RING_WHOLE}"
        case, slots, steps = ((f"{tag}-{arch}", ring, RING_STEPS) if ring
                              else (f"serve-{arch}", SERVE_S + DECODE,
                                    DECODE))
        if not ring:
            prefill = SS.make_prefill_step(model, last_only=False, **kw)
            logits = prefill(P, {"tokens": toks[:, :SERVE_S]})
            self.arrays[f"{case}/prefill"] = logits.cpu().numpy()
        dshape = InputShape("d", slots, SERVE_B, "decode")
        cache = SS.make_cache(model, SERVE_B, dshape, **kw)
        # the cache a rank holds is the model-axis cut its specs name
        want = SS.cache_cut(model, dshape, self.rules, self.shape(),
                            axes=("model",))
        cut = all(a.shape == w.shape for a, w in zip(tree.leaves(cache),
                                                       tree.leaves(want)))
        step = SS.make_serve_step(model, shape=dshape, **kw)
        outs = []
        for s in range(steps):
            lg, cache = step(P, cache, toks[:, s:s + 1])
            outs.append(lg.cpu().numpy())
        self.arrays[f"{case}/decode"] = np.stack(outs)
        return cut, (f"cache k {tuple(cache['layers']['k'].shape)}, the "
                     f"specs' cut {tuple(want['layers']['k'].shape)}")

    def refuse(self, what):
        """Each out-of-scope case raises ``NotImplementedError`` naming
        #13e when the trainer (or the first serving step) is built."""
        from repro_torch.configs.base import InputShape
        from repro_torch.models.model_factory import Model
        from repro_torch.models.sharding import ShardingRules
        from repro_torch.train.trainer import Trainer, TrainerConfig
        shape = InputShape("lm", S, N * B, "train")
        model, rules = self.model(ARCHS[0]), self.rules
        tc = dict(algo="moniqua", n_workers=N, steps=1)
        if what.startswith(("hierarchical-", "family-")):
            # the hierarchical rules run the dense and MoE families (FSDP
            # over data); the other families are refused under either
            from repro_torch.configs import get_config
            kind, family = what.split("-", 1)
            if kind == "hierarchical":
                rules = ShardingRules("hierarchical")
            model = Model(get_config(FAMILY_ARCHS[family]).reduced(),
                          self.device)
        elif what == "wire-qsgd":
            tc["wire"] = "qsgd"
        elif what == "path-bucketed":
            tc["comm_path"] = "bucketed"
        elif what == "telemetry":
            tc["telemetry"] = True
        try:
            Trainer(model, TrainerConfig(**tc), shape, mesh=self.mesh,
                    rules=rules)
        except NotImplementedError as e:
            return "#13e" in str(e), str(e)
        return False, "no NotImplementedError"

    def cases(self):
        out = {"ops": self.ops, "step": self.step, "trainer": self.trainer}
        for a in ALL_ARCHS:
            out[f"grads-{a}"] = lambda a=a: self.grads(a)
            out[f"serve-{a}"] = lambda a=a: self.serve(a)
        for a in SPLIT_ARCHS:
            out[f"ring-{a}"] = lambda a=a: self.serve(a, ring=RING)
            out[f"ring{RING_WHOLE}-{a}"] = lambda a=a: self.serve(
                a, ring=RING_WHOLE)
        for r in R.RULES:
            out[f"rule-{r}"] = lambda r=r: R.rule_case(self, r, ARCHS[0], N,
                                                       THETA)
        out["round-masked"] = lambda: R.masked_round_case(self, ARCHS[0], N,
                                                          THETA)
        for w in ROUNDS:
            out[f"round-{w}"] = lambda w=w: self.round(w)
        out[f"round-moniqua8-{MOE_ARCH}"] = lambda: self.round("moniqua8",
                                                              MOE_ARCH)
        for a in (MOE_ARCH,) + tuple(SPLIT_ARCHS):
            out[f"step-{a}"] = lambda a=a: self.step(a)
        for r in REFUSALS:
            out[f"refuse-{r}"] = lambda r=r: self.refuse(r)
        return out

    def run(self, names=None):
        cases = self.cases()
        assert sorted(cases) == sorted(case_names())
        for name in names or case_names():
            if not self.split and name.startswith(("refuse-", "ops")):
                continue
            t0 = time.perf_counter()
            try:
                ok, detail = cases[name]()
            except Exception:                 # reported per case
                ok, detail = False, traceback.format_exc()[-3000:]
            self.checks[name] = [bool(ok), detail,
                                 round(time.perf_counter() - t0, 3)]


def compare(got: dict, want: dict, case: str, tol: float):
    """(ok, detail) of a case's arrays on the cards against one process:
    the rounds bitwise, the rest within ``tol`` of each array's largest
    entry.  The trainer's checkpointed params are left out: after its
    first step a code may round the other way on one side (the JAX test
    counts those); its losses and bytes are held."""
    if case.startswith("rule-"):
        return R.compare_rule(got, want, case, tol, MESHES[4][0] > 1)
    keys = sorted(k for k in want if k.startswith(case + "/")
                  and not k.startswith("trainer/ckpt/"))
    if not keys or any(k not in got for k in keys):
        return False, "arrays missing"
    # a head count the split attends otherwise (context-parallel, or KV
    # expanded): its step's round may round a code one cell the other way
    # where the gradients differ in the last bits, counted as the CPU
    # tests count them (Lemma 2's 2 (1 - w_ii) delta B, under 1e-4 of the
    # elements)
    cell = (lemma2_cell() if case.startswith("step-")
            and case[5:] in SPLIT_ARCHS else 0.0)
    worst, ok, flips, total = 0.0, True, 0, 0
    for k in keys:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                          np.float64)
        if a.shape != b.shape:
            return False, f"{k}: {a.shape} != {b.shape}"
        gap = float(np.abs(a - b).max()) if a.size else 0.0
        scale = float(np.abs(b).max()) if b.size else 1.0
        bound = 0.0 if case.startswith("round-") else tol * (scale or 1.0)
        worst = max(worst, gap / (scale or 1.0))
        if cell and "/x/" in k:
            flips += int((np.abs(a - b) > bound).sum())
            total += a.size
            bound += cell * 1.001
        ok = ok and gap <= bound
    ok = ok and flips <= 1e-4 * max(total, 1)
    return ok, (f"largest gap {worst:.3e} of the largest entry"
                + (f", {flips} of {total} elements a code cell off"
                   if cell else ""))


def lemma2_cell() -> float:
    """Lemma 2's bound on what one 8-bit round moves a worker of ring(4)
    where one code rounds the other way: 2 (1 - w_ii) delta B."""
    from repro_torch.core import modulo
    from repro_torch.core.quantizers import delta_for_bits
    d = delta_for_bits(8, True)
    return 2 * (1 - 1 / 3) * d * float(modulo.b_theta(THETA, d, "cpu"))


# -- the full-width cell on the cards -----------------------------------------

def cell_trainer(mesh, rules):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.models.model_factory import Model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              num_layers=CELL_LAYERS)
    tc = TrainerConfig(algo="moniqua", bits=8, topology="ring",
                       n_workers=N, theta=2.0, lr=0.1, momentum=0.9,
                       weight_decay=5e-4, steps=CELL_STEPS, log_every=1,
                       seed=0)
    return Trainer(Model(cfg, "cuda"), tc,
                   InputShape("lm_train", CELL_SEQ, N, "train"), mesh=mesh,
                   rules=rules)


def cell_time(tr) -> dict:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = tr.run()
    walls = [h["wall"] for h in out["history"]]
    return {"step_ms": 1e3 * (walls[-1] - walls[0]) / (len(walls) - 1),
            "losses": [h["loss"] for h in out["history"]],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "bytes_per_step": out["bytes_per_step"]}


def main(argv) -> int:
    if argv[1] == "--nccl":
        return launch_nccl(argv[2])
    store_path, rank, world, inputs, out = (argv[1], int(argv[2]),
                                            int(argv[3]), argv[4], argv[5])
    nccl = argv[6:] == ["nccl"]
    torch.set_num_threads(1)
    import torch.distributed as dist
    if nccl:
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world)
    # a collective that waits this long is a fault: fail, do not hang
    dist.init_process_group("nccl" if nccl else "gloo", store=store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    device = "cuda" if nccl else "cpu"
    workdir = os.path.dirname(out) or "."
    try:
        runner = Runner(rank, world, inputs, workdir, device)
        runner.run()
        report = {"checks": runner.checks}
        if nccl:
            dist.barrier()
            report.update(nccl_compare(runner, rank, world, inputs,
                                       workdir))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(out + ".npz", **runner.arrays)
        with open(out + ".json", "w") as f:
            json.dump(report, f, indent=1)
    return 0


def nccl_compare(runner, rank, world, inputs, workdir) -> dict:
    """On the cards: every case's arrays against one process on rank 0's
    card, then the full-width cell split and (rank 0) whole."""
    from repro_torch.launch.mesh import make_host_mesh
    held = {}
    if rank == 0:
        one = Runner(0, world, inputs, workdir, "cuda", split=False)
        one.run([c for c in case_names() if not c.startswith("refuse-")
                 and c != "ops"])
        for case in case_names():
            if case.startswith(("refuse-", "ops")):
                continue
            held[case] = list(compare(runner.arrays, one.arrays, case,
                                      CARD_TOL))
        del one
    torch.cuda.empty_cache()
    cell = {}
    tr = cell_trainer(make_host_mesh(data=2, model=2, device_type="cuda"),
                      runner.rules)
    cell["split"] = cell_time(tr)
    del tr
    torch.cuda.empty_cache()
    import torch.distributed as dist
    dist.barrier()
    out = {"held": held, "cell": cell}
    if rank == 0:
        cell["one card"] = one = cell_time(cell_trainer(None, None))
        out["cell held"] = held_cell(cell["split"], one)
    return out


def held_cell(split: dict, one: dict) -> list:
    """``[ok, detail]``: the split cell's losses within ``CELL_RTOL`` of
    the one-card run's, its bytes/step equal."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(split["losses"],
                                                one["losses"])]
    ok = (len(gaps) == len(one["losses"]) == CELL_STEPS
          and max(gaps) <= CELL_RTOL
          and split["bytes_per_step"] == one["bytes_per_step"])
    return [ok, f"losses' largest relative gap {max(gaps):.3g} (rtol "
                f"{CELL_RTOL}), bytes/step {split['bytes_per_step']} vs "
                f"{one['bytes_per_step']}"]


def launch_nccl(outdir: str, timeout: float = 1500.0) -> int:
    """Four cards, one NCCL rank each (module docstring)."""
    import shutil
    import subprocess
    from repro_torch.kernels import build
    world = 4
    if torch.cuda.device_count() < world:
        print(f"the NCCL cases need {world} CUDA cards")
        return 1
    build.build_all()
    # the inputs, the checkpoints and the arrays (~100 MB) stay in a work
    # directory that is removed after; OUTDIR gets the report
    work = os.path.join(outdir, "work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    inputs = os.path.join(work, "tp_inputs.npz")
    port_inputs(inputs)
    out = os.path.join(work, "tp_cases")
    store = os.path.join(work, "tp_store")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               store, str(r), str(world), inputs, out,
                               "nccl"]) for r in range(world)]
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if not any(rcs) and os.path.exists(out + ".json"):
        shutil.copy(out + ".json", os.path.join(outdir, "tp_cases.json"))
    shutil.rmtree(work, ignore_errors=True)
    if any(rcs) or not os.path.exists(os.path.join(outdir,
                                                   "tp_cases.json")):
        return 1
    with open(os.path.join(outdir, "tp_cases.json")) as f:
        rep = json.load(f)
    ok = sorted(rep["checks"]) == sorted(case_names())
    for case in case_names():
        chk = rep["checks"].get(case, [False, "did not run"])
        held = rep["held"].get(case, [True, "checked in the ranks"])
        ok = ok and chk[0] and held[0]
        print(case, chk[0], held[0], chk[1][:200], "|", held[1])
    for name, c in rep["cell"].items():
        print(f"cell {name}: step {c['step_ms']:.3f} ms, peak "
              f"{c['peak_gib']:.2f} GiB, losses {c['losses']}, bytes/step "
              f"{c['bytes_per_step']}")
    cell_ok, detail = rep.get("cell held", [False, "not compared"])
    print("cell split vs one card", cell_ok, detail)
    ok = ok and cell_ok
    print("tensor-parallel NCCL cases", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    sys.exit(main(sys.argv))
