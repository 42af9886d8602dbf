"""Cases of ``tests/test_torch_fsdp.py``, run in gloo ranks.

``python tests/torch_fsdp_cases.py STORE RANK WORLD INPUTS OUT``: the
process joins a gloo group through the ``FileStore`` at STORE, lays it out
as the mesh and rules of ``WORLDS[WORLD]``, reads the inputs from the
``.npz`` at INPUTS (stacked float32 params of reduced qwen2-72b with GQA
4:2 and of reduced chatglm3-6b, token batches, the round and step seeds,
serving tokens; ``tests/test_torch_fsdp.py`` draws them from the JAX
reference's init), runs every case of ``case_names(WORLD)`` on its
workers, its batch rows and its shards of the weights, gathers each result
whole and, on rank 0, writes the arrays to ``OUT + ".npz"`` and the checks
made in the ranks (``{case: [ok, detail, seconds]}``) to ``OUT +
".json"``.  Only the port is imported, one CPU thread a process.

The worlds: ``d2`` and ``d2m2``, the hierarchical rules on one pod
(``(data=2, model=1)`` and ``(data=2, model=2)``: every rank holds every
worker, FSDP over ``data``); ``p2d2``, the hierarchical rules across pods
(``(pod=2, data=2, model=1)``: two workers a pod); ``m4``, replicated-KV
GQA (chatglm3-6b's 2 KV heads under 4 query heads on ``(data=1,
model=4)``, the decentralized rules).  ``d2m2`` and ``m4`` also run a
head count their ``model`` axis does not split cleanly (``SPLIT_WORLDS``:
its gradients, a train step and its serving): reduced qwen2-72b with 3
query heads over 1 KV head on ``d2m2``, context-parallel attention under
the hierarchical rules; reduced chatglm3-6b with 24 query heads over 6 KV
heads on ``m4``, KV groups of 4 that a rank's 6 query heads cannot read
whole.  ``d2m2`` and ``p2d2`` also run
reduced dbrx-132b (``MOE_WORLDS``: E 4, top-2, group 64): its gradients,
its Moniqua 8-bit and 1-bit rounds (the router's rows of 4 codes padded
to a byte, as one process pads them), a train step and its serving, on
the expert shards.  ``p2d2`` also runs the eight other update rules and
the masked rounds on reduced qwen2-72b (``RULE_WORLDS``,
``torch_rule_cases``).

``python tests/torch_fsdp_cases.py --cli STORE RANK WORLD FLAGS...``: one
rank of the training CLI on the production mesh with
``make_production_mesh`` swapped for the world's small gloo mesh and the
assigned shape for a small one (``tests/test_torch_launch_train.py``).

``python tests/torch_fsdp_cases.py --nccl OUTDIR``, on a host with four
cards: builds the kernels, draws the inputs with the port's own init,
starts one NCCL rank a card for each four-rank world, and rank 0 holds
every case against the same case run in one process on its card
(``CARD_TOL``, the rounds bitwise); on ``d2m2`` the MoE cell (dbrx-132b
at published widths, 1 layer, one worker, 2 x 1024 tokens, ``CELL_STEPS``
steps: losses equal on every rank, the first within ``CARD_TOL`` of one
process's forward on rank 0's card; step time and peak a card); then the
full-width cell (qwen2-72b
at published widths, 2 layers, two pods of one worker each on ``(pod=2,
data=2)``, Moniqua 8-bit, bfloat16) for ``CELL_STEPS`` steps, its step
time and peak a card, and each leaf's round bitwise against one process's
round of that leaf on rank 0's card.  Writes ``OUTDIR/fsdp_cases.json``
and exits non-zero unless every case held.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch

import torch_rule_cases as R

ARCH, KV_ARCH, MOE_ARCH = "qwen2-72b", "chatglm3-6b", "dbrx-132b"
ARCHS = (ARCH, KV_ARCH, MOE_ARCH)
# reduced qwen2-72b keeps 4 KV heads under 4 query heads: GQA 4:2 by
# override; reduced chatglm3-6b has 4 heads and 2 KV heads already
OVERRIDES = {ARCH: dict(num_kv_heads=2), KV_ARCH: {}, MOE_ARCH: {}}
# head counts that a world's model axis does not split cleanly, each an
# arch of its own: name -> (arch, overrides); the world that runs it
SPLIT_ARCHS = {"qwen2-72b@h3kv1": (ARCH, dict(num_heads=3, num_kv_heads=1)),
               "chatglm3-6b@h24kv6": (KV_ARCH, dict(num_heads=24,
                                                    num_kv_heads=6))}
SPLIT_WORLDS = {"d2m2": "qwen2-72b@h3kv1", "m4": "chatglm3-6b@h24kv6"}
ALL_ARCHS = ARCHS + tuple(SPLIT_ARCHS)
N, B, S = 4, 2, 32            # workers, sequences a worker, tokens
THETA, LR = 2.0, 0.1
SERVE_B, SERVE_S, DECODE = 2, 24, 4
# the decode ring of the ``ring-`` cases: RING_STEPS tokens from an empty
# ring of RING slots, past every rank's RING / M slots of a kv_seq cache
# and past the ring's end (the oldest slots overwritten)
RING, RING_STEPS = 8, 12
# world -> (ranks, mesh shape, rules mode, multi_pod, arch)
WORLDS = {
    "d2": (2, dict(data=2, model=1), "hierarchical", False, ARCH),
    "d2m2": (4, dict(data=2, model=2), "hierarchical", False, ARCH),
    "p2d2": (4, dict(pod=2, data=2, model=1), "hierarchical", True, ARCH),
    "m4": (4, dict(data=1, model=4), "decentralized", False, KV_ARCH),
}
ROUNDS = {"moniqua8": (8, True), "moniqua1": (1, False), "full": None}
# the worlds that also run the MoE family
MOE_WORLDS = ("d2m2", "p2d2")
# the world that runs the eight other update rules and the masked rounds
# (torch_rule_cases) on the world's arch: two workers a pod, FSDP on data
RULE_WORLDS = ("p2d2",)
# the families still refused on a split (ROADMAP #13e.4) by their configs
FAMILY_ARCHS = {"zamba": "zamba2-1.2b", "xlstm": "xlstm-125m",
                "whisper": "whisper-base", "vlm": "phi-3-vision-4.2b"}
REFUSALS = {
    "d2": ("hierarchical-xlstm", "wire-qsgd", "path-bucketed", "wire-onebit",
           "overlap-stale"),
    "d2m2": ("hierarchical-whisper", "family-zamba", "telemetry"),
    "p2d2": ("hierarchical-vlm", "tiers-2"),
    "m4": ("family-xlstm",),
}
# the NCCL run: one process on a card against the split on four cards,
# float32 gradients and logits within this share of their largest entry
CARD_TOL = 1e-4
# the full-width cell of the NCCL run
CELL_LAYERS, CELL_SEQ, CELL_STEPS, CELL_N = 2, 1024, 3, 2
# the MoE cell of the NCCL run: dbrx-132b at published widths, 1 layer,
# one worker, 2 x 1024 tokens a step on (data=2, model=2); its first loss
# against one process's forward on one card (9 GB of weights)
MOE_CELL_LAYERS, MOE_CELL_SEQ, MOE_CELL_ROWS = 1, 1024, 2


def case_names(world):
    arch = WORLDS[world][4]
    names = ["ops", f"grads-{arch}", "round-moniqua8", "step",
             f"serve-{arch}"]
    if arch == ARCH:
        names += ["round-moniqua1", "round-full", "trainer"]
    if world in MOE_WORLDS:
        names += [f"{c}-{MOE_ARCH}" for c in (
            "grads", "round-moniqua8", "round-moniqua1", "step", "serve")]
    if world in SPLIT_WORLDS:
        names += [f"{c}-{SPLIT_WORLDS[world]}" for c in (
            "grads", "step", "serve", "ring")]
    if world in RULE_WORLDS:
        names += R.rule_names()
    return names + [f"refuse-{r}" for r in REFUSALS[world]]


def arch_of(name):
    """``(arch, overrides)`` of an entry of ``ALL_ARCHS``."""
    return SPLIT_ARCHS.get(name, (name, OVERRIDES.get(name, {})))


def config(name, **over):
    """The reduced arch of ``name`` (with its overrides) in float32, the
    flash route (its plain version on the CPU)."""
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
        if a == ARCH:
            R.port_inputs(out, a, [(N,) + s for s in abstract(cfg)[1]], rng)
    np.savez(path, **out)


def _mesh(world, device):
    from repro_torch.launch.mesh import make_host_mesh
    _, shape, _, _, _ = WORLDS[world]
    return make_host_mesh(data=shape["data"], model=shape["model"],
                          pod=shape.get("pod", 0), device_type=device)


def _rules(world):
    from repro_torch.models.sharding import ShardingRules
    _, _, mode, multi_pod, _ = WORLDS[world]
    return ShardingRules(mode, multi_pod=multi_pod)


class Runner:
    def __init__(self, rank, world, inputs, workdir, device="cpu",
                 split=True):
        from repro_torch.launch import mesh as M
        self.rank, self.world, self.workdir = rank, world, workdir
        self.device, self.split = device, split
        self.inp = dict(np.load(inputs))
        self.arch = WORLDS[world][4]
        self.rules = _rules(world)
        self.M = M
        self.mesh = _mesh(world, device) if split else None
        self.arrays, self.checks = {}, {}

    # -- the split ------------------------------------------------------------
    def shape(self):
        shape = dict(WORLDS[self.world][1])
        return shape if self.mesh is not None else dict.fromkeys(shape, 1)

    def coord(self, axis):
        if self.mesh is None or axis not in self.mesh.mesh_dim_names:
            return 0
        return int(self.mesh.get_local_rank(axis))

    def rows(self):
        """This rank's workers ``[lo, hi)``."""
        from repro_torch.comm import workers
        if self.mesh is None:
            return 0, N
        wg = workers.WorkerGroup.of(self.mesh, self.rules.worker_axes,
                                    self.rules.fsdp_axis)
        b = N // wg.size
        return wg.index * b, (wg.index + 1) * b

    def inner(self, n):
        """This rank's ``[a, b)`` of ``n`` batch rows of a worker."""
        if self.mesh is None or self.rules.fsdp_axis is None:
            return 0, n
        d = self.shape()["data"]
        b = n // d
        return self.coord("data") * b, (self.coord("data") + 1) * b

    def model(self, arch=None, **over):
        from repro_torch.models.model_factory import Model
        return Model(config(arch or self.arch, **over), self.device)

    def specs(self, model):
        from repro_torch.train.train_step import params_pspecs
        return params_pspecs(model, self.rules, self.shape(), stacked=True)

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
        """This rank's workers and shards of a whole stacked tree, on its
        device."""
        from repro_torch import convert, tree
        lo, hi = self.rows()
        X = tree.map(lambda a: a[lo:hi].to(self.device), X)
        if self.mesh is None:
            return X
        return convert.shard_params(X, self.specs(model),
                                    self.M.split_groups(self.mesh,
                                                        self.rules))

    def stacked(self, model, arch=None):
        """This rank's workers, batch rows and shards of the inputs of
        ``arch`` (by default ``model``'s)."""
        arch = arch or model.cfg.name
        lo, hi = self.rows()
        a, z = self.inner(B)
        batch = {k: torch.from_numpy(
            self.inp[f"{arch}/{k}"][lo:hi, a:z]).to(self.device)
            for k in ("tokens", "labels")}
        return self.cut(model, self.whole(model, arch)), batch

    def gather(self, X):
        """A stacked params-shaped tree whole (inside the context): rows
        over the workers, then shards over ``model`` and ``data``."""
        from repro_torch import tree
        from repro_torch.comm import tensor_parallel as TP
        from repro_torch.comm import workers
        X = tree.map(workers.gather_rows, X)
        for g in TP.groups():
            leaves, td = tree.flatten(X)
            X = tree.unflatten(td, [
                a if d is None else TP.gather_dim(a, d, g.axis)
                for a, d in zip(leaves, TP.leaf_dims(X, g.axis))])
        return X

    def put(self, case, tree_or_arrays):
        from repro_torch import tree
        for i, a in enumerate(tree.leaves(tree_or_arrays)):
            self.arrays[f"{case}/{i}"] = (
                a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))

    def replicated_equal(self, X):
        """Whether every leaf is bitwise the same on every rank of each
        split axis it is not split over (an exact gather of each rank's
        copy)."""
        from repro_torch import tree
        from repro_torch.comm import tensor_parallel as TP
        worst = 0.0
        for g in TP.groups():
            for a, d in zip(tree.leaves(X), TP.leaf_dims(X, g.axis)):
                if d is None:
                    every = TP.gather_dim(a.reshape(1, -1), 0, g.axis)
                    worst = max(worst, float((every - every[:1]).abs()
                                             .max()))
        return worst == 0.0

    # -- the cases ------------------------------------------------------------
    def ops(self):
        """``fsdp.matmul`` (weights split on their rows, on their columns,
        and one read transposed), ``fsdp.gather`` (a split weight's rows
        looked up, a whole weight) and ``reduce_sum`` over ``data`` under
        ``vmap(grad)`` with the rows split over ``data`` and the hidden
        dim over ``model``, against one process's autograd."""
        from repro_torch.comm import fsdp
        from repro_torch.comm import tensor_parallel as TP
        g = torch.Generator().manual_seed(3)
        shape = self.shape()
        dn = shape["data"] if self.rules.fsdp_axis else 1
        mm = shape["model"]
        n, rows, d, f, v = 3, 4 * dn, 8 * dn, 6 * mm, 5
        X = torch.randn(n, rows, d, generator=g)
        A = torch.randn(n, d, f, generator=g)
        Bw = torch.randn(n, f, d, generator=g)
        c = torch.randn(n, d, generator=g)
        E = torch.randn(n, v, d, generator=g)
        ix = torch.randint(0, v, (rows,), generator=g)

        def loss(a, b, cc, e, x, i):
            h = torch.tanh(fsdp.matmul(TP.copy_to(x, "model"), a, 0))
            y = TP.reduce_sum(fsdp.matmul(h, b, 1), "model")
            y = y * fsdp.gather(cc, None) * fsdp.gather(e, 1)[i]
            z = fsdp.matmul(y, e, 1, k=-1)
            return TP.reduce_sum((y ** 2).sum() + (z ** 2).sum(), fsdp.AXIS)
        grad = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)),
                               in_dims=(0, 0, 0, 0, 0, None))
        want = grad(A, Bw, c, E, X, ix)
        model = self.model()
        r_d = self.coord("data") if self.rules.fsdp_axis else 0
        r_m = self.coord("model")
        dk, fk, rk = d // dn, f // mm, rows // dn
        cut_a = (slice(None), slice(r_d * dk, (r_d + 1) * dk),
                 slice(r_m * fk, (r_m + 1) * fk))
        cut_b = (slice(None), slice(r_m * fk, (r_m + 1) * fk),
                 slice(r_d * dk, (r_d + 1) * dk))
        cut_e = (slice(None), slice(None), slice(r_d * dk, (r_d + 1) * dk))
        cut_x = (slice(None), slice(r_d * rk, (r_d + 1) * rk))
        dev = self.device
        with self.context(model):
            got = grad(A[cut_a].to(dev), Bw[cut_b].to(dev), c.to(dev),
                       E[cut_e].to(dev), X[cut_x].to(dev),
                       ix[r_d * rk:(r_d + 1) * rk].to(dev))
        pairs = ((got[0], want[0][cut_a]), (got[1], want[1][cut_b]),
                 (got[2], want[2]), (got[3], want[3][cut_e]),
                 (got[4], want[4][cut_x]))
        errs = [float((a.cpu() - b).abs().max() / b.abs().max())
                for a, b in pairs]
        return max(errs) <= 1e-5, f"relative gaps {errs}"

    def grads(self, arch=None):
        from repro_torch.comm import workers
        arch = arch or self.arch
        model = self.model(arch)
        X, batch = self.stacked(model, arch)
        with self.context(model):
            g, loss = torch.func.vmap(torch.func.grad_and_value(model.loss))(
                X, batch)
            same = self.replicated_equal(g)
            self.put(f"grads-{arch}/grads", self.gather(g))
            self.arrays[f"grads-{arch}/loss"] = workers.gather_rows(
                loss).cpu().numpy()
        return same, f"unsplit gradients equal over the ranks: {same}"

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
        on the world's arch, ``round-WIRE-ARCH`` on another."""
        model = self.model(arch)
        X, _ = self.stacked(model)
        hp = self.hyper(wire)
        seed = int(self.inp["seed_round"])
        case = f"round-{wire}" + (f"-{arch}" if arch else "")
        with self.context(model):
            if wire == "full":
                out = hp.exact_engine().mix(X).x
            else:
                out = hp.engine().mix(X, theta=THETA, seed=seed).x
            same = self.replicated_equal(out)
            self.put(f"{case}/x", self.gather(out))
        return same, f"unsplit leaves equal over the ranks: {same}"

    def step(self, arch=None):
        """One Moniqua 8-bit train step; its case is ``step`` on the
        world's arch, ``step-ARCH`` on another."""
        from repro_torch.optim import sgd
        from repro_torch.core.theta import ThetaSchedule
        from repro_torch.train import train_step as TS
        model = self.model(arch)
        case = "step" + (f"-{arch}" if arch else "")
        X, batch = self.stacked(model, arch)
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
            same = self.replicated_equal(state["params"])
            self.put(f"{case}/x", self.gather(state["params"]))
        self.arrays[f"{case}/loss"] = np.asarray(float(met["loss"]))
        self.arrays[f"{case}/wire_bytes"] = np.asarray(met["wire_bytes"])
        return same, f"unsplit leaves equal over the ranks: {same}"

    def trainer_of(self, ckpt=None, **over):
        from repro_torch.configs.base import InputShape
        from repro_torch.train.trainer import Trainer, TrainerConfig
        tc = TrainerConfig(**dict(dict(
            algo="moniqua", topology="ring", n_workers=N, bits=8, steps=2,
            log_every=1, seed=3, checkpoint_path=ckpt,
            checkpoint_every=2 if ckpt else 0), **over))
        return Trainer(self.model(), tc,
                       InputShape("lm", S, N * B, "train"), mesh=self.mesh,
                       rules=self.rules if self.mesh is not None else None)

    def trainer(self):
        """Two ``Trainer`` steps with a gathered checkpoint: the restored
        state is the live one bitwise (params, momentum, ``g_inf``, the
        step and the seed generator); the checkpoint's params, the losses
        and the bytes go to the test."""
        from repro_torch import tree
        path = os.path.join(self.workdir, f"fsdp{self.world}")
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

    def serve(self, arch=None, ring=False):
        """Prefill and ``DECODE`` cached steps of this rank's rows of the
        serving batch on its shards; the logits gathered over ``data``.
        With ``ring``, ``RING_STEPS`` steps on a ring of ``RING`` slots
        instead."""
        from repro_torch import tree
        from repro_torch.comm import fsdp
        from repro_torch.comm import tensor_parallel as TP
        from repro_torch.configs.base import InputShape
        from repro_torch.train import serve_step as SS
        arch = arch or self.arch
        model = self.model(arch)
        td, shapes = abstract(model.cfg)
        P = tree.unflatten(td, [torch.from_numpy(
            self.inp[f"{arch}/X/{i}"][0]).to(self.device)
            for i in range(len(shapes))])
        kw = dict(mesh=self.mesh, rules=self.rules) if self.mesh else {}
        if self.mesh is not None:
            P = SS.shard_serving_params(model, P, self.mesh, self.rules)
        lo, hi = SS.batch_rows(SERVE_B, **kw)
        toks = torch.from_numpy(self.inp[f"{arch}/serve"][lo:hi]).to(
            self.device)
        case, slots, steps = ((f"ring-{arch}", RING, RING_STEPS) if ring
                              else (f"serve-{arch}", SERVE_S + DECODE,
                                    DECODE))
        logits = []
        if not ring:
            prefill = SS.make_prefill_step(model, last_only=False, **kw)
            logits = [prefill(P, {"tokens": toks[:, :SERVE_S]})]
        dshape = InputShape("d", slots, SERVE_B, "decode")
        cache = SS.make_cache(model, hi - lo, dshape, **kw)
        # the cache a rank holds is the cut its specs name over model, its
        # batch dim (dim 1 of K and V) the rows it serves
        want = SS.cache_cut(model, dshape, self.rules, self.shape(),
                            axes=("model",))
        cut = all(a.shape[:1] + a.shape[2:] == w.shape[:1] + w.shape[2:]
                  for a, w in zip(tree.leaves(cache), tree.leaves(want)))
        step = SS.make_serve_step(model, shape=dshape, **kw)
        outs = []
        for s in range(steps):
            lg, cache = step(P, cache, toks[:, s:s + 1])
            outs.append(lg)
        with self.context(model):
            whole = [TP.gather_dim(t, 0, fsdp.AXIS)
                     for t in logits + outs]
        if not ring:
            self.arrays[f"{case}/prefill"] = whole[0].cpu().numpy()
        self.arrays[f"{case}/decode"] = torch.stack(
            whole[len(logits):]).cpu().numpy()
        return cut, (f"cache k {tuple(cache['layers']['k'].shape)}, the "
                     f"specs' cut {tuple(want['layers']['k'].shape)}")

    def refuse(self, what):
        """Each out-of-scope case raises ``NotImplementedError`` naming
        #13e when the trainer is built."""
        from repro_torch.configs import get_config
        from repro_torch.configs.base import InputShape
        from repro_torch.models.model_factory import Model
        from repro_torch.train.trainer import Trainer, TrainerConfig
        shape = InputShape("lm", S, N * B, "train")
        model = self.model()
        tc = dict(algo="moniqua", n_workers=N, steps=1)
        family = what.split("-", 1)[1] if what.startswith(
            ("hierarchical-", "family-")) else None
        if family is not None:
            model = Model(get_config(FAMILY_ARCHS[family]).reduced(),
                          self.device)
        elif what == "wire-qsgd":
            tc["wire"] = "qsgd"
        elif what == "path-bucketed":
            tc["comm_path"] = "bucketed"
        elif what == "wire-onebit":
            tc["wire"] = "onebit"
        elif what == "overlap-stale":
            tc["overlap"] = "stale"
        elif what == "telemetry":
            tc["telemetry"] = True
        elif what == "tiers-2":
            tc["tiers"] = 2
        try:
            Trainer(model, TrainerConfig(**tc), shape, mesh=self.mesh,
                    rules=self.rules)
        except NotImplementedError as e:
            return "#13e" in str(e), str(e)
        return False, "no NotImplementedError"

    def cases(self):
        out = {"ops": self.ops, "step": self.step, "trainer": self.trainer,
               f"grads-{self.arch}": self.grads,
               f"serve-{self.arch}": self.serve}
        for w in ROUNDS:
            out[f"round-{w}"] = lambda w=w: self.round(w)
        a = MOE_ARCH
        out.update({f"grads-{a}": lambda: self.grads(a),
                    f"round-moniqua8-{a}": lambda: self.round("moniqua8", a),
                    f"round-moniqua1-{a}": lambda: self.round("moniqua1", a),
                    f"step-{a}": lambda: self.step(a),
                    f"serve-{a}": lambda: self.serve(a)})
        s = SPLIT_WORLDS.get(self.world)
        if s is not None:
            out.update({f"grads-{s}": lambda: self.grads(s),
                        f"step-{s}": lambda: self.step(s),
                        f"serve-{s}": lambda: self.serve(s),
                        f"ring-{s}": lambda: self.serve(s, ring=True)})
        for r in R.RULES:
            out[f"rule-{r}"] = lambda r=r: R.rule_case(self, r, self.arch, N,
                                                       THETA)
        out["round-masked"] = lambda: R.masked_round_case(self, self.arch, N,
                                                          THETA)
        for r in REFUSALS[self.world]:
            out[f"refuse-{r}"] = lambda r=r: self.refuse(r)
        return out

    def run(self, names=None):
        cases = self.cases()
        for name in names or case_names(self.world):
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
    entry; the trainer's checkpointed params are left out (a code may
    round the other way after step 1; the losses and bytes are held)."""
    if case.startswith("rule-"):
        return R.compare_rule(got, want, case, tol, True)
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


# -- the CLI on a small production mesh ---------------------------------------

CLI_SHAPE = (32, 8)           # tokens, global batch of the CLI's run


def cli_rank(world, flags) -> int:
    """One rank of ``repro_torch.launch.train --mesh production``: the
    production mesh swapped for ``world``'s small gloo mesh, the assigned
    shape for ``CLI_SHAPE``, then the CLI's own ``main``."""
    from repro_torch.configs import base
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as LT

    def small_mesh(*, multi_pod=False, device_type="cuda"):
        if multi_pod != ("pod" in WORLDS[world][1]):
            raise ValueError(f"--multi-pod {multi_pod} on world {world}")
        return _mesh(world, device_type)
    M.make_production_mesh = small_mesh
    base.get_input_shape = lambda name: base.InputShape(
        name, CLI_SHAPE[0], CLI_SHAPE[1], "train")
    return LT.main(flags)


# -- the full-width cell on the cards -----------------------------------------

def cell_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), num_layers=CELL_LAYERS)


def cell_trainer(mesh, rules):
    from repro_torch.configs.base import InputShape
    from repro_torch.models.model_factory import Model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tc = TrainerConfig(algo="moniqua", bits=8, topology="ring",
                       n_workers=CELL_N, theta=2.0, lr=0.1, momentum=0.9,
                       weight_decay=5e-4, steps=CELL_STEPS, log_every=1,
                       seed=0)
    return Trainer(Model(cell_config(), "cuda"), tc,
                   InputShape("lm_train", CELL_SEQ, 2 * CELL_N, "train"),
                   mesh=mesh, rules=rules)


def moe_cell_trainer(mesh=None, rules=None):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.models.model_factory import Model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_CELL_LAYERS)
    tc = TrainerConfig(algo="moniqua", bits=8, topology="ring", n_workers=1,
                       theta=2.0, lr=0.1, momentum=0.9, weight_decay=5e-4,
                       steps=CELL_STEPS, log_every=1, seed=0)
    return Trainer(Model(cfg, "cuda"), tc, InputShape(
        "lm_train", MOE_CELL_SEQ, MOE_CELL_ROWS, "train"), mesh=mesh,
        rules=rules)


def moe_cell(rank, mesh, rules) -> dict:
    """The MoE cell split over the four cards, then (rank 0) one
    process's loss of step 0's batch at the same init, a forward alone."""
    import torch.distributed as dist
    tr = moe_cell_trainer(mesh, rules)
    out = cell_run(tr)
    del tr
    torch.cuda.empty_cache()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out["losses"])
    out["losses_equal"] = all(x == every[0] for x in every)
    if rank == 0:
        one = moe_cell_trainer()
        state = one.init_state()
        del state["mom"]
        with torch.no_grad():
            first = float(torch.func.vmap(one.model.loss)(
                state["params"], one.batch_fn(0))[0])
        out["one_first_loss"] = first
        out["first_gap"] = abs(out["losses"][0] - first) / abs(first)
        del one, state
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def cell_run(tr) -> dict:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = tr.run()
    walls = [h["wall"] for h in out["history"]]
    return {"step_ms": 1e3 * (walls[-1] - walls[0]) / (len(walls) - 1),
            "losses": [h["loss"] for h in out["history"]],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "bytes_per_step": out["bytes_per_step"]}


def cell_rounds(rank) -> dict:
    """The full-width cell's Moniqua 8-bit round, leaf by leaf, on this
    rank's shard (its pod's worker, its ``data`` shard) of seeded params,
    gathered whole and held (rank 0) bitwise against one process's round
    of the whole leaf on rank 0's card; the encode and decode-reduce
    launches of the split rounds on this rank."""
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.comm import fsdp
    from repro_torch.comm import tensor_parallel as TP
    from repro_torch.comm import workers
    from repro_torch.core.algorithms import AlgoHyper
    from repro_torch.core.moniqua import MoniquaCodec
    from repro_torch.core.quantizers import QuantSpec
    from repro_torch.core.topology import ring
    from repro_torch.kernels import moniqua_decode_reduce as kdr
    from repro_torch.kernels import moniqua_encode as kenc
    from repro_torch.launch.mesh import make_host_mesh, mesh_context
    from repro_torch.models.model_factory import Model
    from repro_torch.train.train_step import abstract_params, params_pspecs
    model = Model(cell_config(), "cuda")
    rules = _rules("p2d2")
    mesh = make_host_mesh(data=2, model=1, pod=2, device_type="cuda")
    specs = tree.leaves(params_pspecs(model, rules, dict(WORLDS["p2d2"][1]),
                                      stacked=True))
    shapes = [tuple(a.shape) for a in tree.leaves(abstract_params(model))]
    hp = AlgoHyper(topo=ring(CELL_N), codec=MoniquaCodec(QuantSpec(8, True)),
                   theta=THETA, path="per_leaf")
    pod, r_d = int(mesh.get_local_rank("pod")), int(
        mesh.get_local_rank("data"))
    n_enc = n_dr = differing = 0
    for i, (shape, spec) in enumerate(zip(shapes, specs)):
        g = torch.Generator(device=model.dev).manual_seed(100 + i)
        whole = torch.randn((CELL_N,) + shape, generator=g,
                            device=model.dev).to(torch.bfloat16)
        d = TP.axis_dims((spec,), fsdp.AXIS)[0]
        x = TP.shard(whole[pod:pod + 1], d, r_d, 2).contiguous().clone()
        e0, d0 = kenc.encode.launches, kdr.decode_reduce.launches
        with mesh_context(mesh, rules, params=(spec,)):
            out = hp.engine().mix((x,), theta=THETA, seed=0x5EED3).x[0]
            n_enc += kenc.encode.launches - e0
            n_dr += kdr.decode_reduce.launches - d0
            if d is not None:
                out = TP.gather_dim(out, d, fsdp.AXIS)
            out = workers.gather_rows(out)
        if rank == 0:
            one = hp.engine().mix((whole,), theta=THETA, seed=0x5EED3).x[0]
            differing += int(not torch.equal(one, out))
            del one
        del whole, x, out
        torch.cuda.empty_cache()
        dist.barrier()
    return {"held": differing == 0, "leaves": len(shapes),
            "leaves_differing": differing, "encode_launches": n_enc,
            "decode_reduce_launches": n_dr}


def main(argv) -> int:
    if argv[1] == "--nccl":
        return launch_nccl(argv[2])
    cli = argv[1] == "--cli"
    if cli:
        argv = argv[1:]
    store_path, rank, world = argv[1], int(argv[2]), argv[3]
    nccl = argv[-1] == "nccl"
    torch.set_num_threads(1)
    import torch.distributed as dist
    if nccl:
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, WORLDS[world][0])
    # a collective that waits this long is a fault: fail, do not hang
    dist.init_process_group("nccl" if nccl else "gloo", store=store,
                            rank=rank, world_size=WORLDS[world][0],
                            timeout=datetime.timedelta(seconds=120))
    try:
        if cli:
            return cli_rank(world, argv[4:])
        inputs, out = argv[4], argv[5]
        device = "cuda" if nccl else "cpu"
        workdir = os.path.dirname(out) or "."
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
    card; on the multi-pod world also the full-width cell."""
    import torch.distributed as dist
    held = {}
    if rank == 0:
        one = Runner(0, world, inputs, workdir, "cuda", split=False)
        names = [c for c in case_names(world)
                 if not c.startswith(("refuse-", "ops"))]
        one.run(names)
        for case in names:
            held[case] = list(compare(runner.arrays, one.arrays, case,
                                      CARD_TOL))
        del one
    torch.cuda.empty_cache()
    out = {"held": held}
    if world == "d2m2":
        dist.barrier()
        out["moe_cell"] = moe_cell(rank, runner.mesh, runner.rules)
    if world != "p2d2":
        return out
    dist.barrier()
    out["cell_rounds"] = cell_rounds(rank)
    from repro_torch.launch.mesh import make_host_mesh
    tr = cell_trainer(make_host_mesh(data=2, model=1, pod=2,
                                     device_type="cuda"), _rules("p2d2"))
    out["cell"] = cell_run(tr)
    del tr
    torch.cuda.empty_cache()
    return out


def launch_nccl(outdir: str, timeout: float = 500.0) -> int:
    """Four cards, one NCCL rank each, for each four-rank world (module
    docstring)."""
    import shutil
    import subprocess
    from repro_torch.kernels import build
    if torch.cuda.device_count() < 4:
        print("the NCCL cases need 4 CUDA cards")
        return 1
    build.build_all()
    work = os.path.join(outdir, "work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    inputs = os.path.join(work, "fsdp_inputs.npz")
    port_inputs(inputs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    report, ok = {"card": card}, True
    for world in ("d2m2", "m4", "p2d2"):
        out = os.path.join(work, f"fsdp_{world}")
        store = os.path.join(work, f"store_{world}")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   store, str(r), world, inputs, out,
                                   "nccl"])
                 for r in range(WORLDS[world][0])]
        deadline = time.monotonic() + timeout
        try:
            rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                   for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        secs = time.perf_counter() - t0
        print(f"{world}: exit codes {rcs}, {secs:.1f} s")
        if any(rcs) or not os.path.exists(out + ".json"):
            report[world] = {"failed": rcs}
            ok = False
            continue
        with open(out + ".json") as f:
            rep = json.load(f)
        rep["seconds"] = secs
        report[world] = rep
        for case in case_names(world):
            chk = rep["checks"].get(case, [False, "did not run"])
            h = rep["held"].get(case, [True, "checked in the ranks"])
            ok = ok and chk[0] and h[0]
            print(world, case, chk[0], h[0], chk[1][:200], "|", h[1])
        if world == "d2m2":
            c = rep["moe_cell"]
            print(f"MoE cell {MOE_ARCH} ({MOE_CELL_LAYERS} layer, "
                  f"{MOE_CELL_ROWS} x {MOE_CELL_SEQ} tokens, (data=2, "
                  f"model=2)): step {c['step_ms']:.3f} ms, peak "
                  f"{c['peak_gib']:.2f} GiB a card, losses {c['losses']}, "
                  f"equal on every rank {c['losses_equal']}; one process's "
                  f"first loss {c['one_first_loss']} (gap "
                  f"{c['first_gap']:.3e}), bytes/step {c['bytes_per_step']}")
            ok = ok and c["losses_equal"] and c["first_gap"] <= CARD_TOL \
                and all(math.isfinite(v) for v in c["losses"])
        if world == "p2d2":
            c, r = rep["cell"], rep["cell_rounds"]
            print(f"cell (pod=2, data=2): step {c['step_ms']:.3f} ms, peak "
                  f"{c['peak_gib']:.2f} GiB a card, losses {c['losses']}, "
                  f"bytes/step {c['bytes_per_step']}")
            print(f"cell rounds: {r}")
            ok = ok and r["held"] and all(
                v == v and abs(v) < 1e3 for v in c["losses"])
    with open(os.path.join(outdir, "fsdp_cases.json"), "w") as f:
        json.dump(report, f, indent=1)
    shutil.rmtree(work, ignore_errors=True)
    print("FSDP NCCL cases", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    sys.exit(main(sys.argv))
