"""Roofline terms of one step of the port on one NVIDIA H100, from counts.

The counterpart of the reference's ``repro.analysis.roofline``.  Three terms
per (arch x shape), all *per card per step, in seconds*:

    compute    = FLOPs / peak_FLOPs
    memory     = bytes accessed / HBM bandwidth
    collective = the gossip round's wire bytes / link bandwidth

The reference reads FLOPs and bytes from XLA's ``compiled.cost_analysis()``
(``cost_analysis_dict``, ``roofline_from_compiled``) and the collectives
from the partitioned HLO text (``parse_collectives``, ``_shape_bytes``).
The port emits neither XLA objects nor HLO, so those have no counterpart
here: the counts come from the dry run (``repro_torch.launch.dryrun``:
``torch.utils.flop_counter``, a dispatch-mode tracker of bytes and the
kernels' own formulas) and go in through :func:`roofline_from_counts`; the
collectives of a step come from the gossip round's plan
(:func:`collectives_of`), whose bytes are ``CommEngine.bytes_per_round``.

Hardware constants (:data:`HW`): NVIDIA's data sheet for the H100 SXM,
"NVIDIA H100 80GB HBM3" at its 700 W power limit: 989 TFLOP/s dense bf16 on
the tensor cores, 3.35 TB/s of HBM.  They are data-sheet numbers, not
measurements; a card set below 700 W runs slower under load.  On one card
the workers are a tensor axis and the gossip is a roll of the payload in
HBM, each wire byte read once and written once, so the default link prices
a wire byte at twice the HBM time.  :func:`hw_with_ici` swaps in another
link (a ``repro_torch.sim.network.LinkModel`` or bytes/s), as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch import tree

HBM_BW = 3.35e12                        # B/s, H100 SXM data sheet
HW = {
    "peak_flops": 989e12,               # dense bf16 / card (data sheet)
    "hbm_bw": HBM_BW,
    "ici_bw": HBM_BW / 2,               # a roll: each byte read + written
}


def hw_with_ici(ici) -> Dict[str, float]:
    """HW table with another interconnect bandwidth.

    ``ici`` is a :class:`repro_torch.sim.network.LinkModel` (e.g. the output
    of a ``sim/calibrate.py`` fit on measured collective times) or a plain
    bytes/s float.  Pass the result as ``roofline_from_counts(..., hw=)``
    to price the collective term on that link rather than on the card's
    own HBM."""
    beta = getattr(ici, "beta_Bps", None)
    if beta is None:
        beta = float(ici)
    if beta <= 0:
        raise ValueError(f"ici bandwidth must be positive, got {beta}")
    return dict(HW, ici_bw=beta)


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def summary(self) -> str:
        parts = [f"{op}x{self.counts[op]}:{self.bytes_by_op[op]/1e6:.1f}MB"
                 for op in sorted(self.counts)]
        return " ".join(parts) if parts else "none"


def _rolls_per_offset(engine, X) -> int:
    """Payload rolls one round makes toward each neighbor offset: one a
    chunk (bucketed) or a leaf (per-leaf), times the payload tensors the
    wire ships (the codes; qsgd and ef_qsgd add a scale, onebit a lo/hi
    pair); a tiered round sums its owned shards' chunks."""
    name = engine.codec.name
    n_payload = {"qsgd": 2, "ef_qsgd": 2, "onebit": 3}.get(name, 1)
    if engine.tiered:
        layout = engine.layout(X)
        k = engine.topo.n_intra
        chunks = 0
        for j in range(k):
            shard = layout.shard(k, j)
            if shard.size == 0:
                continue
            sub = (engine.chunks if engine._shard_bucketed(shard)
                   else max(engine.chunks, len(shard.slots)))
            chunks += len(shard.chunks(sub))
        return chunks * n_payload
    if engine.resolved_path(X) == "bucketed" and (
            name != "full" or engine.layout(X).uniform_dtype):
        return len(engine.layout(X).chunks(engine.chunks)) * n_payload
    return len(tree.leaves(X)) * n_payload


def collectives_of(engine, X) -> CollectiveStats:
    """The collectives of one gossip round of ``engine`` on the stacked tree
    ``X`` (leaves ``[n, ...]``, real or ``meta``), from the round's plan:
    a ``collective-permute[+o]`` per neighbor offset ``o`` of the wire's
    tier (its count the payload rolls toward ``o``, its bytes one
    broadcast, ``payload_bytes_per_broadcast``), and on a tiered engine the
    fast axis's ``reduce-scatter`` and ``all-gather`` (together
    ``fast_bytes_per_round``).  The total is
    ``engine.bytes_per_round(X)``."""
    counts: Dict[str, int] = {}
    by: Dict[str, int] = {}
    offsets = engine.gossip_topo.neighbor_offsets()
    if tree.leaves(X) and offsets:
        per = engine.payload_bytes_per_broadcast(X)
        rolls = _rolls_per_offset(engine, X)
        for o in offsets:
            op = f"collective-permute[{o:+d}]"
            counts[op] = rolls
            by[op] = per
    fast = engine.fast_bytes_per_round(X)
    if fast:
        counts["reduce-scatter"] = counts["all-gather"] = 1
        by["all-gather"] = fast // 2
        by["reduce-scatter"] = fast - fast // 2
    return CollectiveStats(counts, by)


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device
    collective_bytes: float      # per device
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float           # 6 N D (useful math, global)
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs (recompute/redundancy waste
        detector)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """Model-FLOPs utilisation if the step ran at the roofline bound."""
        denom = self.bound_s * self.chips * HW["peak_flops"]
        return self.model_flops / denom if denom else 0.0


def roofline_from_counts(flops: float, bytes_accessed: float,
                         collective_bytes: float, model_flops: float,
                         chips: int = 1, hw: Dict[str, float] = HW
                         ) -> Roofline:
    """The three terms from per-card counts (the reference's
    ``roofline_from_compiled`` with the counts handed in)."""
    return Roofline(
        flops=float(flops),
        bytes_accessed=float(bytes_accessed),
        collective_bytes=float(collective_bytes),
        compute_s=flops / hw["peak_flops"],
        memory_s=bytes_accessed / hw["hbm_bw"],
        collective_s=collective_bytes / hw["ici_bw"],
        model_flops=model_flops,
        chips=chips,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE); D = tokens/step.

    Audio (enc-dec) processes enc_len + dec_len tokens per example, not
    ``seq_len`` (the raw audio length) — mirrors Model.batch_spec.
    """
    n = cfg.active_param_count()
    if cfg.family == "audio":
        enc_len = shape.seq_len // cfg.encoder_downsample
        dec_len = min(cfg.decoder_len_cap, max(shape.seq_len // 8, 16))
        tokens_per_ex = enc_len + dec_len
    else:
        tokens_per_ex = shape.seq_len
    if shape.kind == "train":
        tokens = shape.global_batch * tokens_per_ex
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * tokens_per_ex
        return 2.0 * n * tokens       # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
