"""CommEngine: one gossip round for decentralized SGD, end to end.

Every decentralized algorithm reduces its communication to one gossip round:
encode the local model, circulate the payload along the topology
(``torch.roll`` of the stacked worker axis), decode each neighbor against the
local reference and accumulate the weighted consensus step

    X_{k+1/2}[i] = x_i + sum_{o != 0} w_o * (xhat_{i+o} - xhat_self)     (*)

Wires (``codec``):

* ``full`` (D-PSGD baseline): the raw model rides the wire and (*) collapses
  to the circulant ``X W`` of ``gossip.mix``;
* ``moniqua`` (Algorithm 1): the bit-packed modulo residue, ``bits/8`` bytes
  per parameter, through the CUDA encode and decode-reduce kernels on the
  card and their plain PyTorch versions on the CPU;
* ``qsgd``: packed codes plus one float32 max-norm scale per tensor;
* the stateful error-feedback wires ``ef_qsgd`` and ``onebit`` (1-bit
  Adam-style: full precision for ``warmup`` rounds, then sign codes with
  per-tensor cluster-mean levels).  They carry a per-worker ``WireState``
  (an f32 residual in the flat bucket domain and a step counter) that
  ``mix`` / ``pair_average`` take and return.

The scale+codes and EF wires are plain PyTorch ops, as they are jnp ops in
the reference (it has no kernel for them).

Gossip path (``path=``): ``"bucketed"`` flattens the whole stacked pytree
into one ``[n, D]`` buffer (``comm/bucket.py``) and runs the staged round of
:class:`RoundPlan`; ``"per_leaf"`` gossips leaf by leaf; ``"auto"``
(default) takes the reference's decision for the (layout, wire) pair:
bucket when the per-leaf tile-pad amplification clears the crossover the
reference derives from its committed ``BENCH_comm_fusion.json``.  That is a
parity rule, so that both packages take the same path by default; it is not
a speed of the card.  Stateful (EF) wires always bucket.  Moniqua's and the
EF wires' per-leaf rounds hash the same global element indices as the
bucketed round, so the paths agree bit for bit; the per-leaf ``qsgd`` round
hashes a seed per leaf, as the reference's does.

Staged rounds: ``chunks=K`` splits the flat buffer into K slot-aligned
windows, and :meth:`RoundPlan.run` issues encode(t), permute(t-1),
decode_reduce(t-2).  Every codec hashes global indices and chunk edges fall
on tensor and values-per-byte boundaries, so any K is bitwise the barrier
round (``K = 1``), WireState included.  On one card the permute is a local
roll, so the skew reorders launches on one stream; it overlaps nothing.

One-round-stale overlap (``mix_stale``, stateless Moniqua): step k applies
the consensus delta decoded from round k-1's payloads against the reference
and B they were encoded from, then encodes its own mixed model for k+1.

AD-PSGD's primitive is one edge exchange, :meth:`CommEngine.pair_average`
(Algorithm 3 lines 4-7), on every wire.

Elastic rounds (``presence=``, a host 0/1 tuple over the workers): an edge
survives only if both endpoints showed up; a dead edge's decoded diff never
enters the reduction (the receiver keeps that weight on itself: the
``Topology.with_presence`` matrix applied edge-wise), and an absent worker
comes back untouched, EF residual included.  Encode and permute do not
change.  ``None`` or an all-ones mask takes literally the unmasked code
path, which is the whole full-presence bitwise contract.  The masked
Moniqua round runs one single-weight decode-reduce per neighbor offset and
recombines the gated diffs in float32.

Two-tier rounds (``topo`` a :class:`HierarchicalTopology`): every ``mix``
is a :class:`TieredPlan`: a full-precision reduce along each node's intra
axis, then each worker's owned slot-aligned shard gossiped across nodes on
the inter tier (one :class:`RoundPlan` per shard, hashing global indices),
then an all-gather.  The EF residual lives in the owned-shard domain
``[n_inter, padded_elems]``, ``presence`` is per node, and the ledger splits
the fast (intra) and slow (inter) bytes.  With ``n_intra == 1`` the round is
bitwise the single-tier bucketed round on the inter topology.

Telemetry (``telemetry=True``): every ``mix`` / ``mix_stale`` result also
carries the round-health dict of ``repro_torch.obs.metrics`` (consensus
distance, theta headroom, the alias sentinel, EF residual norm, bytes),
read from the round's own flat buffer, payload and WireState.  It feeds
nothing back: outputs, payloads and WireState are bitwise the same with it
on or off.  The phases of a round run under ``obs.trace`` labels
(``comm.encode`` / ``comm.permute`` / ``comm.decode_reduce`` /
``comm.intra_reduce`` / ``comm.telemetry``) for ``torch.profiler``.

Tensor-parallel and FSDP rounds (``comm/tensor_parallel.py``,
``comm/fsdp.py``: a ``model`` and/or ``data`` split with the params'
specs): each rank gossips its shard of every split leaf and every
replicated leaf whole, per leaf, on the ``moniqua`` and ``full`` wires.
The layout, the counter offsets and the byte ledger are those of one
process's tree (``tensor_parallel.whole``); a shard hashes the ``(seed,
index)`` pairs its elements have in the whole leaf (the encode's
``idx_row_stride``, and for a leaf split on two dims its blocks of rows,
``tensor_parallel.split_view``), so the round is the shard of one
process's round bit for bit, and a replicated leaf comes out the same on
every rank; a presence mask gates each shard's rows as one process gates
the whole leaf's.  Other wires, the bucketed path, telemetry and two
tiers under a split raise ``NotImplementedError``
(``CommEngine.model_split_refusal``, ROADMAP #13e).

Randomness: the reference takes a JAX key; the port takes the uint32 hash
``seed`` the reference derives from it (``kops._key_to_seed``).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.comm import bucket, gossip, workers
from repro_torch.comm import tensor_parallel as TP
from repro_torch.comm.gossip import BytesLedger
from repro_torch.core import modulo
from repro_torch.core.quantizers import (_U32, QuantSpec,
                                         ef_qsgd_encode_segmented,
                                         onebit_decode_segmented,
                                         onebit_encode_segmented,
                                         onebit_payload_bytes,
                                         packed_last_dim, qsgd_decode,
                                         qsgd_decode_segmented, qsgd_encode,
                                         qsgd_encode_segmented,
                                         qsgd_payload_bytes)
from repro_torch.core.topology import (HierarchicalTopology, Topology,
                                       normalize_mask)
from repro_torch.kernels import ops as kops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

PyTree = Any

WIRES = ("full", "moniqua", "qsgd", "ef_qsgd", "onebit")
PATHS = ("bucketed", "per_leaf", "auto")


class MixResult(NamedTuple):
    """What one gossip round returns: ``x`` is the mixed model
    ``X_{k+1/2}``; ``state`` the post-round WireState (``{}`` for stateless
    wires) or, from :meth:`CommEngine.mix_stale`, the gossip carry;
    ``health`` the round-health dict of an engine with ``telemetry=True``
    (else ``None``)."""
    x: Any
    state: dict = {}
    health: Optional[dict] = None


class PairResult(NamedTuple):
    """Both endpoints of one :meth:`CommEngine.pair_average` exchange, and
    their post-exchange WireState carries (``{}`` for stateless wires)."""
    xi: torch.Tensor
    xj: torch.Tensor
    state_i: dict = {}
    state_j: dict = {}


@dataclasses.dataclass(frozen=True)
class FullPrecisionWire:
    """Identity codec: the raw model rides the wire (D-PSGD baseline)."""
    name = "full"

    def payload_bytes(self, shape: Tuple[int, ...], itemsize: int = 4) -> int:
        return int(np.prod(shape, dtype=np.int64)) * itemsize


@dataclasses.dataclass(frozen=True)
class MoniquaWire:
    """Algorithm 1's packed modulo residue: ``bits/8`` bytes/param, no scales."""
    spec: QuantSpec = QuantSpec()
    name = "moniqua"

    def payload_bytes(self, shape: Tuple[int, ...], itemsize: int = 4) -> int:
        if not shape:
            return 1
        inner = int(np.prod(shape[:-1], dtype=np.int64))
        return inner * packed_last_dim(shape[-1], self.spec.bits)


@dataclasses.dataclass(frozen=True)
class QSGDWire:
    """Scale+codes codec: packed codes + one f32 max-norm scale per tensor."""
    spec: QuantSpec = QuantSpec()
    name = "qsgd"

    def payload_bytes(self, shape: Tuple[int, ...], itemsize: int = 4) -> int:
        return qsgd_payload_bytes(shape, self.spec.bits)


@dataclasses.dataclass(frozen=True)
class EFQSGDWire:
    """Error-feedback QSGD: quantize ``x + residual`` with the scale+codes
    wire and keep ``residual' = x + residual - decode(sent)`` per worker,
    one f32 buffer a worker (Table 1's memory axis)."""
    spec: QuantSpec = QuantSpec()
    name = "ef_qsgd"
    stateful = True

    def payload_bytes(self, shape: Tuple[int, ...], itemsize: int = 4) -> int:
        return qsgd_payload_bytes(shape, self.spec.bits)


@dataclasses.dataclass(frozen=True)
class OneBitWire:
    """1-bit Adam-style wire: full-precision gossip for the first ``warmup``
    rounds, then 1-bit sign codes of the compensated value (per-segment
    cluster-mean levels) with an error-feedback residual.  The WireState's
    step counter selects the round's codec with ``torch.where``, so a
    checkpointed counter resumes the schedule bit for bit."""
    spec: QuantSpec = QuantSpec(bits=1, stochastic=False)
    warmup: int = 16
    name = "onebit"
    stateful = True

    def payload_bytes(self, shape: Tuple[int, ...], itemsize: int = 4) -> int:
        """Steady-state (post-warmup) bytes; warmup rounds ship f32."""
        return onebit_payload_bytes(shape)

    def warmup_payload_bytes(self, shape: Tuple[int, ...],
                             itemsize: int = 4) -> int:
        return int(np.prod(shape, dtype=np.int64)) * 4 if shape else 4


def make_wire(name: str, spec: Optional[QuantSpec] = None, warmup: int = 16):
    spec = spec or QuantSpec()
    if name == "full":
        return FullPrecisionWire()
    if name == "moniqua":
        return MoniquaWire(spec)
    if name == "qsgd":
        return QSGDWire(spec)
    if name == "ef_qsgd":
        return EFQSGDWire(spec)
    if name == "onebit":
        # the sign path is 1 bit by construction: keep the caller's
        # stochastic / nearest choice, pin the width
        return OneBitWire(dataclasses.replace(spec, bits=1), warmup=warmup)
    raise ValueError(f"unknown wire codec {name!r}; one of {WIRES}")


# -- path="auto": the reference's per-(layout, wire) crossover ----------------

# The reference's Pallas encode pads each launch to a grid of 256 x 1024
# tiles, and its "auto" rule weighs that padding.  These two numbers are the
# reference's decision rule, kept so both packages resolve "auto" alike; the
# port's kernels have no such grid.
REF_TILE_ROWS = 256
REF_TILE_COLS = 1024

# the reference's crossover for a tree without BENCH_comm_fusion.json
_FALLBACK_CROSSOVER = {"moniqua": 9.8, "qsgd": float("inf"),
                       "full": float("inf")}
_BENCH_COMM_FUSION = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "BENCH_comm_fusion.json")


def _tile_padded(elems: int) -> int:
    """Elements after padding a flat segment to the reference's encode
    tile grid."""
    rows = -(-elems // REF_TILE_COLS)
    return -(-rows // REF_TILE_ROWS) * REF_TILE_ROWS * REF_TILE_COLS


@functools.lru_cache(maxsize=1)
def _crossover_table() -> Dict[str, float]:
    """Per-wire pad-amplification threshold above which bucketing wins, as
    the reference derives it from the committed ``BENCH_comm_fusion.json``
    at the repo root: the geometric mean of the worst winning and the best
    losing model's ratio (per-leaf / bucketed tile-padded elements), ``inf``
    when bucketing never won, 1.0 when it never lost.  Without the file, the
    reference's fallback table."""
    try:
        with open(_BENCH_COMM_FUSION) as f:
            data = json.load(f)
    except FileNotFoundError:
        return dict(_FALLBACK_CROSSOVER)
    ratios = {o["model"]: (o["tile_padded_elems_per_leaf_path"]
                           / o["tile_padded_elems_bucketed"])
              for o in data["overhead"]}
    wire_of = {"moniqua-1bit": "moniqua", "moniqua-8bit": "moniqua",
               "qsgd-8bit": "qsgd", "fp32": "full"}
    wins: Dict[str, list] = {}
    losses: Dict[str, list] = {}
    for row in data["table"]:
        wire = wire_of.get(row["codec"])
        if wire is None or row["model"] not in ratios:
            continue
        side = wins if row["speedup_x"] >= 1.0 else losses
        side.setdefault(wire, []).append(ratios[row["model"]])
    table = {}
    for wire in ("moniqua", "qsgd", "full"):
        w, l = wins.get(wire), losses.get(wire)
        if not w:
            table[wire] = float("inf")
        elif not l:
            table[wire] = 1.0
        else:
            table[wire] = math.sqrt(max(l) * min(w))
    return table


@functools.lru_cache(maxsize=4096)
def _auto_bucketed_slots(slots: Tuple[bucket.LeafSlot, ...],
                         padded_elems: int, codec_name: str) -> bool:
    """``path="auto"`` on one contiguous slot window: bucket when its
    per-leaf pad amplification clears the wire's crossover.  A shard of the
    buffer resolves on its own leaves."""
    per_leaf = sum(_tile_padded(s.padded_size) for s in slots)
    ratio = per_leaf / max(_tile_padded(padded_elems), 1)
    return ratio >= _crossover_table().get(codec_name, float("inf"))


def _leaf_seed(base_seed: int, leaf_idx: int) -> int:
    """Distinct hash seed per pytree leaf (the per-leaf qsgd round)."""
    return (int(base_seed) ^ ((leaf_idx * 0x9E3779B1) & _U32)) & _U32


def _neighbor_weights_of(topo: Topology) -> Tuple[float, ...]:
    return tuple(w for o, w in zip(topo.offsets, topo.weights)
                 if o % topo.n != 0)


def _weighted_diffs(d_self: torch.Tensor, decoded, weights,
                    presence: Optional[Tuple[int, ...]] = None,
                    offsets=()) -> torch.Tensor:
    """``sum_o w_o * gate_o(decoded_o - d_self)``, offsets in order; under
    a mask the gate zeroes a dead edge's diff before the weight."""
    acc = None
    for k, (d, w) in enumerate(zip(decoded, weights)):
        t = d - d_self
        if presence is not None:
            t = _gate(presence, offsets[k], t)
        t = t * w
        acc = t if acc is None else acc + t
    return acc


# -- elastic rounds: presence masks ------------------------------------------

def _normalize_presence(presence, n: int) -> Optional[Tuple[int, ...]]:
    """``None`` or an all-ones mask -> ``None`` (the caller then takes the
    unmasked code path); a partial mask -> a validated 0/1 tuple."""
    if presence is None:
        return None
    vals = normalize_mask(presence, n)
    if all(vals):
        return None
    return vals


@functools.lru_cache(maxsize=256)
def _present_cols(presence: Tuple[int, ...], device: torch.device,
                  ndim: int = 2, lo: int = 0,
                  hi: Optional[int] = None) -> torch.Tensor:
    """Bool ``[hi - lo, 1, ..]`` mask of the present workers among rows
    ``[lo, hi)`` (a rank's block of a split worker dim; all of them in one
    process), on ``device``.  Cached per (mask, device, ndim, rows), so a
    round copies nothing to the card after its first; the cached tensors
    are shared, so nothing writes them."""
    pb = torch.tensor(presence[lo:hi], dtype=torch.bool, device=device)
    return pb.reshape((-1,) + (1,) * (ndim - 1))


@functools.lru_cache(maxsize=256)
def _alive_cols(presence: Tuple[int, ...], offset: int, device: torch.device,
                ndim: int = 2, lo: int = 0,
                hi: Optional[int] = None) -> torch.Tensor:
    """Bool mask of rows ``[lo, hi)``: worker ``i`` True iff both endpoints
    of its edge to ``i + offset`` showed up (row ``i`` of ``_roll(x, o)``
    is ``x[i + o]``).  The mask is a host tuple every rank holds whole, so
    its roll is an index on the host."""
    n = len(presence)
    alive = tuple(int(presence[i] and presence[(i + offset) % n])
                  for i in range(n))
    return _present_cols(alive, device, ndim, lo, hi)


def _rows(t: torch.Tensor) -> Tuple[int, int]:
    """Global rows ``[lo, hi)`` of ``t``'s leading dim (this rank's under
    a worker split)."""
    lo = workers.row_base(t.shape[0])
    return lo, lo + t.shape[0]


def _gate(presence: Tuple[int, ...], offset: int,
          t: torch.Tensor) -> torch.Tensor:
    """``t`` where the edge to ``i + offset`` survived the mask, else 0."""
    return torch.where(_alive_cols(presence, offset, t.device, t.dim(),
                                   *_rows(t)), t, 0.0)


def _if_present(presence: Tuple[int, ...], new: torch.Tensor, old):
    """``new`` on the present workers' rows, ``old`` on the absent ones'."""
    return torch.where(_present_cols(presence, new.device, new.dim(),
                                     *_rows(new)), new, old)


def _masked_circulant(x: torch.Tensor, topo: Topology,
                      presence: Tuple[int, ...]) -> torch.Tensor:
    """Full-precision elastic mix of one stacked leaf: identity plus the
    weighted diffs of the edges that survived the mask (the gate comes
    before the weight, and the diffs sum before the add to ``x``)."""
    f = x.float()
    acc = None
    for o, w in zip(topo.offsets, topo.weights):
        if o % topo.n == 0:
            continue
        t = _gate(presence, o, gossip._roll(f, o) - f) * w
        acc = t if acc is None else acc + t
    if acc is None:
        return x
    return (f + acc).to(x.dtype)


def _dropped_edge_count(presence: Tuple[int, ...], topo: Topology) -> int:
    """Directed gossip edges the mask killed (a host count)."""
    n = topo.n
    return sum(1
               for o in topo.neighbor_offsets()
               for i in range(n)
               if not (presence[i] and presence[(i + o) % n]))


@dataclasses.dataclass
class RoundPlan:
    """One gossip round on the flat bucket, staged per chunk as encode /
    permute / decode-reduce (built by :meth:`CommEngine.round_plan`).

    Chunk windows cover whole leaf slots, so per-tensor statistics (qsgd
    scales, onebit levels) see the segments the whole-buffer round sees;
    they start on values-per-byte boundaries, so chunk payloads are
    byte-exact windows of the whole payload; and every encode hashes global
    element indices (``idx_base`` = the chunk's offset, qsgd's worker axis
    strided by the whole buffer's width).  So each phase computes on its
    window exactly what the barrier round computes there.

    ``residual`` and ``step`` are the EF wires' WireState (the flat buffer
    is then float32).  ``presence`` is a normalized partial mask (``None``:
    everyone present, the unmasked arithmetic); it gates only which decoded
    neighbor diffs enter the reduction and, on the EF wires, which rows
    update.

    A shard plan of :class:`TieredPlan` has ``flat`` (and ``residual``) the
    owned-shard window starting at buffer element ``base`` and gossips on
    ``topo``, the inter tier.  Chunk offsets stay global (they are the
    encode's ``idx_base``), so windows are sliced at ``c.offset - base``.
    The defaults (``base=0``, ``topo`` the engine's gossip topology) are
    the single-tier round.

    Under a worker split (``comm/workers.py``) ``flat`` holds this rank's
    rows only: by default its block of the worker dim; a tiered shard plan
    passes ``bounds``, every rank's range of the inter-tier rows it holds,
    which ``run`` puts in force (``workers.row_bounds``).  The permute
    sends the rows each rank reads, and the gates and the qsgd hash read
    global row indices, so every row is computed as in one
    process.
    """
    engine: "CommEngine"
    layout: bucket.BucketLayout
    chunks: Tuple[bucket.BucketChunk, ...]
    flat: torch.Tensor
    B: Optional[torch.Tensor] = None
    seed: int = kops.NO_KEY_SEED
    residual: Optional[torch.Tensor] = None
    step: Optional[torch.Tensor] = None
    presence: Optional[Tuple[int, ...]] = None
    base: int = 0
    topo: Optional[Topology] = None
    bounds: Optional[workers.Bounds] = None

    def __post_init__(self):
        if self.topo is None:
            self.topo = self.engine.gossip_topo

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def _win(self, arr: torch.Tensor, c: bucket.BucketChunk) -> torch.Tensor:
        off = c.offset - self.base
        return arr[:, off:off + c.size]

    def encode_chunk(self, i: int) -> Tuple[torch.Tensor, ...]:
        """Encode chunk ``i`` of the staging buffer; returns the payload
        tuple (for the EF wires followed by the compensated value ``v``,
        which stays local and closes the residual)."""
        c = self.chunks[i]
        codec = self.engine.codec
        name = codec.name
        if name == "full":
            return (self._win(self.flat, c),)
        if name == "moniqua":
            return (kops.moniqua_encode_chunk(
                self.flat, c.offset - self.base, c.size, self.B, codec.spec,
                self.seed, idx_base=c.offset),)
        if name == "qsgd":
            return qsgd_encode_segmented(
                self._win(self.flat, c), codec.spec, self.seed,
                c.segment_sizes, idx_base=c.offset,
                idx_stride=self.layout.padded_elems,
                row_base=workers.row_base(self.flat.shape[0]))
        v = self._win(self.flat, c) + self._win(self.residual, c)
        if name == "ef_qsgd":
            packed, scales = ef_qsgd_encode_segmented(
                v, codec.spec, self.seed, c.segment_sizes, c.offset)
            return (packed, scales, v)
        packed, lo, hi = onebit_encode_segmented(
            v, self.seed, c.segment_sizes, c.offset, codec.spec.stochastic)
        return (packed, lo, hi, v)

    def permute(self, i: int, enc: Tuple[torch.Tensor, ...]):
        """Roll chunk ``i``'s payload along the worker axis: the round's only
        cross-worker traffic.  The EF wires' ``v`` never rides the wire."""
        topo = self.topo
        name = self.engine.codec.name
        if name == "full":
            # the raw wire reduces over ALL offsets (self included, where
            # _roll no-ops), exactly gossip.mix's circulant
            return tuple(gossip._roll(enc[0], o) for o in topo.offsets)
        offsets = topo.neighbor_offsets()
        if name == "moniqua":
            return torch.stack([gossip._roll(enc[0], o) for o in offsets])
        n_payload = 2 if name in ("qsgd", "ef_qsgd") else 3
        return tuple(tuple(gossip._roll(p, o) for p in enc[:n_payload])
                     for o in offsets)

    def decode_reduce(self, i: int, enc: Tuple[torch.Tensor, ...], nbrs):
        """Decode chunk ``i``'s circulated payloads against the local window
        and apply (*) on it.  Stateless wires return the mixed window, the
        EF wires ``(mixed window, new residual window)``."""
        c = self.chunks[i]
        eng = self.engine
        name = eng.codec.name
        topo = self.topo
        p = self.presence
        if name == "full":
            if p is None:
                out = None
                for w, r in zip(topo.weights, nbrs):
                    t = r * gossip.as_weight(w, r.dtype)
                    out = t if out is None else out + t
                return out.to(enc[0].dtype)
            # masked raw wire: identity plus the gated neighbor diffs, added
            # one offset at a time (a re-weighted sum of windows would put
            # an absent row one ulp off identity)
            win = enc[0]
            f = win.float()
            out = f
            for o, w, r in zip(topo.offsets, topo.weights, nbrs):
                if o % topo.n == 0:
                    continue
                out = out + _gate(p, o, r.float() - f) * w
            return out.to(win.dtype)
        spec = eng.codec.spec
        offsets = topo.neighbor_offsets()
        weights = _neighbor_weights_of(topo)
        if name == "moniqua":
            if p is None:
                return kops.moniqua_decode_reduce_chunk(
                    enc[0], nbrs, self.flat, c.offset - self.base, c.size,
                    self.B, weights, spec)
            # masked: one single-weight decode-reduce per offset,
            # recombined as win + sum of the gated diffs in float32
            win = self._win(self.flat, c).float()
            out = win
            for k, (o, w) in enumerate(zip(offsets, weights)):
                mixed_o = kops.moniqua_decode_reduce_chunk(
                    enc[0], nbrs[k:k + 1], self.flat, c.offset - self.base,
                    c.size, self.B, (w,), spec)
                out = out + _gate(p, o, mixed_o.float() - win)
            return out.to(self._win(self.flat, c).dtype)
        seg = c.segment_sizes
        win = self._win(self.flat, c)
        if name in ("qsgd", "ef_qsgd"):
            d_self = qsgd_decode_segmented(enc[0], enc[1], spec, seg)
            acc = _weighted_diffs(
                d_self, (qsgd_decode_segmented(q, s, spec, seg)
                         for q, s in nbrs), weights, p, offsets)
            if name == "qsgd":
                return (win.float() + acc).to(win.dtype)
            out, res = win + acc, enc[2] - d_self
            if p is not None:
                # an absent worker's model and EF residual pass through
                # the missed round untouched
                out = _if_present(p, out, win)
                res = _if_present(p, res, self._win(self.residual, c))
            return out, res
        # onebit: full-precision gossip during warmup, sign codes + EF
        # after.  Both are computed and selected with torch.where: a Python
        # branch on the step would wait for the card.
        packed, levels_lo, levels_hi, v = enc
        rwin = self._win(self.residual, c)
        warm = self.step < eng.codec.warmup
        out_warm = (gossip.mix(win, topo) if p is None
                    else _masked_circulant(win, topo, p))
        d_self = onebit_decode_segmented(packed, levels_lo, levels_hi, seg)
        acc = _weighted_diffs(
            d_self, (onebit_decode_segmented(q, l, h, seg)
                     for q, l, h in nbrs), weights, p, offsets)
        out = torch.where(warm, out_warm, win + acc)
        res = torch.where(warm, rwin, v - d_self)
        if p is not None:
            out = _if_present(p, out, win)
            res = _if_present(p, res, rwin)
        return out, res

    def run(self, with_payload: bool = False):
        """Run the round through the skewed pipeline: at tick t, encode(t),
        permute(t-1), decode_reduce(t-2).  Returns the mixed flat buffer,
        or ``(mixed flat buffer, new flat residual)`` for the EF wires.
        With one chunk it is the barrier round.  ``with_payload`` returns
        ``(result, payload)``: the barrier round's packed payload (None at
        K > 1), which the telemetry's alias sentinel reads."""
        K = self.num_chunks
        stateful = self.engine.stateful
        enc, nbr = {}, {}
        outs, ress = [None] * K, [None] * K
        payload = None
        with workers.row_bounds(self.bounds):
            for t in range(K + 2):
                if t < K:
                    with obs_trace.chunk_phase("comm.encode", t, K):
                        enc[t] = self.encode_chunk(t)
                    if with_payload and K == 1:
                        payload = enc[t][0]
                if 0 <= t - 1 < K:
                    with obs_trace.chunk_phase("comm.permute", t - 1, K):
                        nbr[t - 1] = self.permute(t - 1, enc[t - 1])
                if 0 <= t - 2 < K:
                    with obs_trace.chunk_phase("comm.decode_reduce",
                                               t - 2, K):
                        r = self.decode_reduce(t - 2, enc.pop(t - 2),
                                               nbr.pop(t - 2))
                    if stateful:
                        outs[t - 2], ress[t - 2] = r
                    else:
                        outs[t - 2] = r
        out = outs[0] if K == 1 else torch.cat(outs, dim=1)
        if stateful:
            out = out, (ress[0] if K == 1 else torch.cat(ress, dim=1))
        return (out, payload) if with_payload else out


@dataclasses.dataclass
class TieredPlan:
    """One two-tier round on the flat bucket (built by
    :meth:`CommEngine.tiered_plan`), on ``[n, D]`` viewed as
    ``[n_inter, n_intra, D]`` (worker ``w = g * n_intra + j``):

    1. intra reduce (fast axis, full precision): the intra tier's circulant
       mix along the node axis, the node mean for the default fully
       connected tier; a pure reshape when ``n_intra == 1``;
    2. inter shard gossip (slow axis, the wire): worker ``j`` owns the
       slot-aligned window ``layout.shard(n_intra, j)`` and gossips only it
       across nodes, one :class:`RoundPlan` per shard on the inter tier
       with ``base`` the shard's offset, sub-chunked by
       ``BucketChunk.chunks`` (slot-granular when the shard's own census
       resolves per-leaf);
    3. all-gather (fast axis): the mixed shards concatenate back and every
       worker of a node leaves with its node's model.

    The EF wires' residual lives in the owned-shard domain: one
    ``[n_inter, padded_elems]`` float32 buffer whose row ``g``, window
    ``j``, is worker ``(g, j)``'s residual for the shard it encodes.
    ``presence`` is per node (length ``n_inter``): an absent node keeps its
    intra average, drops out of the inter gossip, and its residual rows
    pass through untouched.
    """
    engine: "CommEngine"
    layout: bucket.BucketLayout
    flat: torch.Tensor                 # [n, D] staging buffer
    chunks: int = 1                    # per-shard sub-chunk count K
    B: Optional[torch.Tensor] = None
    seed: int = kops.NO_KEY_SEED
    residual: Optional[torch.Tensor] = None   # [n_inter, D] owned shards
    step: Optional[torch.Tensor] = None
    presence: Optional[Tuple[int, ...]] = None

    @property
    def topo(self) -> HierarchicalTopology:
        return self.engine.topo

    def intra_reduce(self) -> torch.Tensor:
        """Stage 1: the intra tier's circulant mix along the node axis
        (each node member's row moved by ``o`` inside its node, times its
        weight rounded to the buffer's dtype, added in offset order):
        ``[n_inter, n_intra, D]``, or under a worker split this rank's
        rows ``[n / R, D]``, the rows a node's members on other ranks read
        sent by ``workers.permute``."""
        intra = self.topo.intra
        g, k = self.topo.n_inter, self.topo.n_intra
        stage = out = self.flat
        if k > 1:
            out = None
            for o, w in zip(intra.offsets, intra.weights):
                r = stage if o % k == 0 else workers.permute(
                    stage, [(d // k) * k + (d % k + o) % k
                            for d in range(self.topo.n)])
                t = r * gossip.as_weight(w, stage.dtype)
                out = t if out is None else out + t
            out = out.to(stage.dtype)
        return out.reshape(g, k, -1) if workers.blocks() == 1 else out

    def _owner_rows(self, j: int, rows: int) -> Tuple[int, int]:
        """This rank's rows of shard ``j``'s owners (workers ``g k + j``)
        among its ``rows`` local workers: the first local index and the
        count (inter-tier node ``g`` for each, in order)."""
        k = self.topo.n_intra
        i0 = (j - workers.row_base(rows)) % k
        return i0, max(0, -(-(rows - i0) // k))

    def _node_bounds(self, j: int) -> workers.Bounds:
        """Every rank's range of the inter-tier nodes whose shard-``j``
        owner it holds (contiguous, possibly empty; all ``n_inter`` in one
        process)."""
        k, g = self.topo.n_intra, self.topo.n_inter
        return tuple((min(g, max(0, -(-(lo - j) // k))),
                      min(g, max(0, -(-(hi - j) // k))))
                     for lo, hi in workers.even_bounds(self.flat.shape[0]))

    def shard_plan(self, j: int, z: torch.Tensor) -> RoundPlan:
        """Stage 2 for shard ``j``: the owner rows' window as a RoundPlan
        over the ``n_inter`` nodes on the inter tier (under a worker split,
        over the nodes whose owner this rank holds, with their rows of the
        residual)."""
        shard = self.layout.shard(self.topo.n_intra, j)
        k = self.chunks
        if not self.engine._shard_bucketed(shard):
            # the shard's own census says per-leaf: one chunk a slot
            k = max(k, len(shard.slots))
        win = slice(shard.offset, shard.offset + shard.size)
        z2 = z.reshape(-1, z.shape[-1])
        i0, count = self._owner_rows(j, z2.shape[0])
        lo = (workers.row_base(z2.shape[0]) + i0) // self.topo.n_intra
        res = (None if self.residual is None
               else self.residual[lo:lo + count, win])
        return RoundPlan(engine=self.engine, layout=self.layout,
                         chunks=shard.chunks(k),
                         flat=z2[i0::self.topo.n_intra, win], B=self.B,
                         seed=self.seed, residual=res, step=self.step,
                         presence=self.presence, base=shard.offset,
                         topo=self.topo.inter, bounds=self._node_bounds(j))

    def run(self):
        """Run the tiered round: the mixed ``[n, D]`` buffer, or for the
        EF wires ``(mixed buffer, new [n_inter, D] residual)``.  Under a
        worker split: this rank's rows and the whole residual (every rank
        holds it, as the reference's specs replicate it); a rank that holds
        no owner of a shard takes no part in its gossip, the all-gather
        sends each node member its owners' windows (``workers.permute``),
        and each owner's new residual rows go to every rank."""
        k = self.topo.n_intra
        stateful = self.engine.stateful
        with obs_trace.named_phase("comm.intra_reduce"):
            z = self.intra_reduce().reshape(-1, self.flat.shape[-1])
        if not self.topo.inter.neighbor_offsets():
            # a single node: its intra average
            return (z, self.residual) if stateful else z
        out = torch.empty_like(z)
        res = torch.empty_like(self.residual) if stateful else None
        for j in range(k):
            shard = self.layout.shard(k, j)
            if shard.size == 0:
                continue            # more workers than slots: empty window
            win = slice(shard.offset, shard.offset + shard.size)
            i0, count = self._owner_rows(j, z.shape[0])
            buf = torch.empty_like(z[:, win])
            mine = None if res is None else res.new_empty((0, shard.size))
            if count:
                r = self.shard_plan(j, z).run()
                if stateful:
                    r, mine = r
                buf[i0::k] = r
            if stateful:
                with workers.row_bounds(self._node_bounds(j)):
                    res[:, win] = workers.gather_rows(mine)
            # every member of node g takes the window from owner g k + j
            out[:, win] = workers.permute(
                buf, [(d // k) * k + j for d in range(self.topo.n)])
        return (out, res) if stateful else out


@dataclasses.dataclass(frozen=True)
class CommEngine:
    """One gossip round, end to end: wire codec x topology x path x chunk
    count, plus the byte accounting.  Static configuration only; per-round
    inputs (``theta``, ``seed``, WireState, the ledger) are call
    arguments.

    ``topo`` may be a :class:`HierarchicalTopology`: every ``mix`` is then a
    two-tier round (:class:`TieredPlan`) in the staged flat-bucket domain,
    and ``path`` governs each owned shard's launch granularity through the
    shard's own leaf census.

    ``telemetry`` attaches a round-health dict (``repro_torch.obs``) to
    every returned :class:`MixResult`; the mix itself is bitwise the same
    with it on or off (module docstring)."""
    topo: Any                     # Topology | HierarchicalTopology
    codec: Any = dataclasses.field(default_factory=MoniquaWire)
    path: str = "auto"
    chunks: int = 1
    telemetry: bool = False

    def __post_init__(self) -> None:
        if self.path not in PATHS:
            raise ValueError(f"unknown path {self.path!r}; one of {PATHS}")
        if self.codec.name not in WIRES:
            raise ValueError(f"unknown wire {self.codec.name!r}; "
                             f"one of {WIRES}")
        if int(self.chunks) < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if not isinstance(self.topo, (Topology, HierarchicalTopology)):
            raise TypeError("the engine gossips on a circulant Topology or "
                            "a HierarchicalTopology")

    # -- hierarchy plumbing ------------------------------------------------
    @property
    def tiered(self) -> bool:
        """True when the topology is two-tier (every mix is a
        TieredPlan)."""
        return isinstance(self.topo, HierarchicalTopology)

    @property
    def gossip_topo(self) -> Topology:
        """The tier whose edges carry the wire's payloads: the inter tier
        of a hierarchy, or the flat topology."""
        return self.topo.inter if self.tiered else self.topo

    # -- persistent per-worker codec state (WireState) ---------------------
    @property
    def stateful(self) -> bool:
        """True for the EF wires, whose ``mix`` takes and returns a
        WireState carry."""
        return bool(getattr(self.codec, "stateful", False))

    def init_wire_state(self, X: PyTree) -> dict:
        """Fresh WireState for a stacked pytree on its device (``{}`` for
        stateless wires): the residual in the flat bucket domain
        ``[n, padded_elems]`` float32, which both paths read and write, and
        the step counter, a 0-dim int32.  A tiered engine keeps the
        owned-shard residual, ``[n_inter, padded_elems]``."""
        if not self.stateful:
            return {}
        layout = self.layout(X)
        dev = tree.leaves(X)[0].device
        rows = self.topo.n_inter if self.tiered else layout.n_workers
        return {"residual": torch.zeros((rows, layout.padded_elems),
                                        dtype=torch.float32, device=dev),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def wire_state_bytes(self, X: PyTree) -> int:
        """Per-worker bytes of persistent codec state (Table 1's memory
        column): 0 for full/moniqua/qsgd, residual + counter for EF wires.
        A tiered worker keeps only its owned shard: the ceil'd
        ``n_intra``-th of the residual."""
        if not self.stateful or not tree.leaves(X):
            return 0
        elems = self.layout(X).padded_elems
        if self.tiered:
            elems = -(-elems // self.topo.n_intra)
        return elems * 4 + 4

    def _check_wire_state(self, state) -> None:
        if not isinstance(state, dict) or "residual" not in state:
            raise ValueError(
                f"{self.codec.name} wire is stateful: pass "
                "state=engine.init_wire_state(X) and thread the returned "
                "MixResult.state carry across rounds")

    # -- gossip path resolution --------------------------------------------
    def resolved_path(self, X: PyTree,
                      shard: Optional[bucket.BucketChunk] = None) -> str:
        """The concrete path (``"bucketed"`` or ``"per_leaf"``) this engine
        takes for ``X``: the configured one, or under ``"auto"`` the
        reference's crossover for the layout and wire; stateful wires
        always bucket.  With ``shard`` (a ``BucketLayout.shard`` window)
        ``"auto"`` resolves on the shard's own leaf census.  Under a
        ``model`` split ``X`` resolves at one process's shapes."""
        if self.path != "auto":
            return self.path
        if self.stateful:
            return "bucketed"
        if X is not None:
            X = TP.whole(X)
        if shard is not None:
            slots, elems = shard.slots, max(shard.size, 1)
        else:
            layout = self.layout(X)
            slots, elems = layout.slots, layout.padded_elems
        return ("bucketed" if _auto_bucketed_slots(slots, elems,
                                                   self.codec.name)
                else "per_leaf")

    def _use_bucketed(self, X: PyTree) -> bool:
        return self.resolved_path(X) == "bucketed"

    def _shard_bucketed(self, shard: bucket.BucketChunk) -> bool:
        return self.resolved_path(None, shard=shard) == "bucketed"

    # -- the staged round --------------------------------------------------
    def _stage(self, X: PyTree, theta, seed, state, what: str):
        """The checks and per-round inputs both staged rounds share:
        ``(layout, flat, B, seed, residual, step)``."""
        layout = self.layout(X)
        name = self.codec.name
        if name == "full" and not layout.uniform_dtype:
            raise ValueError(
                f"no {what} for a mixed-dtype tree on the full wire "
                "(f32 staging would change the mixing arithmetic); "
                "use mix() on a flat topology, which falls back to the "
                "per-leaf circulant")
        if self.stateful:
            self._check_wire_state(state)
        flat = layout.flatten(X)
        B = residual = step = None
        if name != "full":
            self._require_seed(seed)
        if name == "moniqua":
            if theta is None:
                raise ValueError("MoniquaWire needs the a-priori bound theta")
            B = modulo.b_theta(theta, self.codec.spec.delta, flat.device)
        if self.stateful:
            flat = flat.float()
            residual, step = state["residual"], state["step"]
        return (layout, flat, B,
                kops.NO_KEY_SEED if seed is None else int(seed), residual,
                step)

    def round_plan(self, X: PyTree, theta=None, seed: Optional[int] = None,
                   state: Optional[dict] = None,
                   chunks: Optional[int] = None,
                   presence=None) -> RoundPlan:
        """Stage one gossip round on the flat bucket in ``chunks`` (default
        the engine's) slot-aligned chunks; ``state`` is the EF wires'
        WireState, ``presence`` the round's 0/1 worker mask.  A tiered
        engine stages per owned shard: use :meth:`tiered_plan` or
        ``mix``."""
        if self.tiered:
            raise ValueError(
                "a tiered engine stages per owned shard; use "
                "tiered_plan()/mix() instead of round_plan()")
        layout, flat, B, seed, residual, step = self._stage(
            X, theta, seed, state, "staged round")
        k = self.chunks if chunks is None else int(chunks)
        return RoundPlan(engine=self, layout=layout, chunks=layout.chunks(k),
                         flat=flat, B=B, seed=seed, residual=residual,
                         step=step,
                         presence=_normalize_presence(presence, self.topo.n))

    def tiered_plan(self, X: PyTree, theta=None, seed: Optional[int] = None,
                    state: Optional[dict] = None,
                    chunks: Optional[int] = None,
                    presence=None) -> TieredPlan:
        """Stage one two-tier round (intra reduce, per-shard inter gossip,
        all-gather); ``chunks`` is the per-shard sub-chunk count K and
        ``presence`` a per-node 0/1 mask of length ``n_inter``."""
        if not self.tiered:
            raise ValueError("tiered_plan needs a HierarchicalTopology "
                             "engine; use round_plan() on flat topologies")
        layout, flat, B, seed, residual, step = self._stage(
            X, theta, seed, state, "tiered round")
        k = self.chunks if chunks is None else int(chunks)
        return TieredPlan(engine=self, layout=layout, flat=flat,
                          chunks=max(k, 1), B=B, seed=seed,
                          residual=residual, step=step,
                          presence=_normalize_presence(presence,
                                                       self.topo.n_inter))

    def mix(self, X: PyTree, theta=None, seed: Optional[int] = None,
            ledger: Optional[BytesLedger] = None,
            state: Optional[dict] = None, presence=None) -> MixResult:
        """One gossip round on stacked models (leaves ``[n, ...]``).

        ``.x`` of the result is ``X_{k+1/2}`` (with the full-precision codec
        exactly the circulant ``X W`` of ``gossip.mix``); ``.state`` the
        post-round WireState of a stateful wire, which needs the ``state``
        carry from :meth:`init_wire_state`.  ``seed`` is the uint32 hash seed
        of stochastic rounding.  ``ledger`` (if given) is credited with
        payload-bytes * n_neighbors.

        ``presence`` (elastic rounds): a per-worker 0/1 mask, per node
        (length ``n_inter``) on a tiered engine; dead edges contribute
        identity and absent workers come back untouched (module
        docstring).  ``None`` or all-ones is the unmasked round.
        """
        if self.stateful:
            self._check_wire_state(state)
        splits = TP.leaf_splits(X)
        if splits is not None:
            self.check_model_split(X)
        if self.tiered:
            return self._mix_tiered(X, theta, seed, ledger, state, presence)
        presence = _normalize_presence(presence, self.topo.n)
        if not self.topo.neighbor_offsets() or not tree.leaves(X):
            return self._empty_round(X, state)
        if ledger is not None:
            self._record(X, ledger)
        name = self.codec.name
        if name == "moniqua" and theta is None:
            raise ValueError("MoniquaWire needs the a-priori bound theta")
        if self.stateful:
            Xm, new_state = self._mix_stateful(X, state, seed, presence)
            return MixResult(Xm, new_state, self._round_health(
                X, theta, seed, new_state, presence))
        layout = self.layout(TP.whole(X))
        full_mixed_dtype = name == "full" and not layout.uniform_dtype
        flat = payload = None
        if self._use_bucketed(X) and not full_mixed_dtype:
            plan = self.round_plan(X, theta=theta, seed=seed,
                                   presence=presence)
            if self.telemetry and name == "moniqua":
                out, payload = plan.run(with_payload=True)
            else:
                out = plan.run()
            Xm = layout.unflatten(out)
            flat = plan.flat
        elif name == "full":
            if presence is None:
                Xm = gossip.mix(X, self.topo)
            else:
                Xm = tree.map(
                    lambda l: _masked_circulant(l, self.topo, presence), X)
        else:
            self._require_seed(seed)
            base_seed = kops.NO_KEY_SEED if seed is None else int(seed)
            leaves, td = tree.flatten(X)
            if name == "moniqua":
                # global counter indices: leaf i's elements hash
                # (seed, layout.offset_i + e), the SAME pairs the bucketed
                # one-shot encode hashes: the bucketed-vs-per-leaf parity;
                # a split leaf's shard hashes its elements' pairs in the
                # whole leaf (tensor_parallel.split_view)
                splits = splits or ((),) * len(leaves)
                out = [self._mix_leaf(l, theta, base_seed,
                                      idx_base=layout.offsets[i],
                                      presence=presence, splits=splits[i])
                       for i, l in enumerate(leaves)]
            else:
                out = [self._mix_leaf(l, theta, _leaf_seed(base_seed, i),
                                      presence=presence)
                       for i, l in enumerate(leaves)]
            Xm = tree.unflatten(td, out)
        return MixResult(Xm, {}, self._round_health(
            X, theta, seed, None, presence, flat=flat, payload=payload))

    def model_split_refusal(self, X: PyTree) -> Optional[str]:
        """Why a round on ``X`` (one process's shapes, or the shards under
        a ``model`` split) does not run with the weights split over
        ``model``, or ``None`` (module docstring): the one list of what
        the split leaves out, read by ``mix`` and at ``Trainer``
        construction."""
        name = self.codec.name
        if self.tiered or self.stateful or name not in ("moniqua", "full"):
            return (f"the {name} wire"
                    + (" on a two-tier topology" if self.tiered else ""))
        if self.telemetry:
            return "round telemetry"
        if self.resolved_path(X) == "bucketed":
            return f"the bucketed path (path={self.path!r})"
        return None

    def check_model_split(self, X: PyTree) -> None:
        """Raise ``NotImplementedError`` naming #13e where
        :meth:`model_split_refusal` gives a reason."""
        from repro_torch.models.sharding import TODO_13E
        why = self.model_split_refusal(X)
        if why is not None:
            raise NotImplementedError(
                f"{why} with the weights split over 'model' or 'data': "
                f"{TODO_13E}")

    def _mix_tiered(self, X: PyTree, theta, seed: Optional[int],
                    ledger: Optional[BytesLedger], state: Optional[dict],
                    presence=None) -> MixResult:
        """A tiered engine's round: stage and run a :class:`TieredPlan`.
        Always in the flat bucket (the intra reduce and all-gather are
        whole-buffer operations); the step counter advances by one."""
        if not tree.leaves(X) or self.topo.n == 1:
            return self._empty_round(X, state)
        if self.codec.name == "moniqua" and theta is None:
            raise ValueError("MoniquaWire needs the a-priori bound theta")
        if ledger is not None:
            self._record(X, ledger)
        plan = self.tiered_plan(X, theta=theta, seed=seed, state=state,
                                presence=presence)
        layout = plan.layout
        new_state = None
        if self.stateful:
            out, res = plan.run()
            new_state = {"residual": res, "step": state["step"] + 1}
            Xm = layout.unflatten(out.to(layout.stage_dtype))
        else:
            Xm = layout.unflatten(plan.run())
        return MixResult(Xm, new_state if new_state is not None else {},
                         self._round_health(X, theta, seed, new_state,
                                            plan.presence, flat=plan.flat))

    def _empty_round(self, X: PyTree, state: Optional[dict]) -> MixResult:
        """A single worker or an empty pytree: nothing on the wire (with
        telemetry, an all-zero health dict)."""
        health = None
        if self.telemetry:
            leaves = tree.leaves(X)
            health = obs_metrics.round_health_zero(
                leaves[0].device if leaves else None)
        return MixResult(X, state if state is not None else {}, health)

    # -- step-level overlap: one-round-stale mixing ------------------------
    def _require_stale_wire(self) -> None:
        if self.stateful or self.codec.name != "moniqua":
            raise ValueError(
                "one-round-stale overlap needs the stateless moniqua wire "
                f"(got {self.codec.name!r})")
        if self.tiered:
            raise ValueError(
                "one-round-stale overlap is single-tier only: a tiered "
                "round's payloads are per owned shard, not whole-buffer")

    def init_gossip_carry(self, X: PyTree) -> dict:
        """Fresh carry for :meth:`mix_stale`, on ``X``'s device: the
        previous round's packed residue, the reference it was encoded from,
        the B it was encoded under, and a validity flag (the first round
        has nothing to decode)."""
        self._require_stale_wire()
        layout = self.layout(X)
        dev = tree.leaves(X)[0].device
        n, d = layout.n_workers, layout.padded_elems
        return {"packed": torch.zeros(
                    (n, d // self.codec.spec.values_per_byte),
                    dtype=torch.uint8, device=dev),
                "ref": torch.zeros((n, d), dtype=torch.float32, device=dev),
                "B": torch.zeros((), dtype=torch.float32, device=dev),
                "valid": torch.zeros((), dtype=torch.bool, device=dev)}

    def mix_stale(self, X: PyTree, carry: dict, theta=None,
                  seed: Optional[int] = None,
                  ledger: Optional[BytesLedger] = None,
                  presence=None) -> MixResult:
        """One-round-stale gossip: apply the PREVIOUS round's payloads to
        this round's model, then encode the mixed result for the next round.

        The result's ``.state`` is the new carry.  Step k's model moves by
        the consensus delta of round k-1's payloads, decoded against the
        reference they were encoded from under the B they were encoded
        under; the first round (``valid`` unset) applies none.  The delta
        is added through ``torch.where(valid, delta, 0.0)``: the first
        round's decode divides by its carry's B = 0, and the add turns a
        -0.0 of the model into +0.0, as the reference does.

        ``presence`` (elastic): this round's mask gates which of last
        round's payloads are applied, one single-weight decode-reduce per
        offset; an absent worker applies no delta.  Everyone still
        re-encodes.
        """
        self._require_stale_wire()
        if not isinstance(carry, dict) or "packed" not in carry:
            raise ValueError(
                "pass carry=engine.init_gossip_carry(X) and thread the "
                "returned MixResult.state across steps")
        offsets = self.topo.neighbor_offsets()
        if not offsets or not tree.leaves(X):
            return self._empty_round(X, carry)
        if theta is None:
            raise ValueError("MoniquaWire needs the a-priori bound theta")
        if ledger is not None:
            self._record(X, ledger)
        presence = _normalize_presence(presence, self.topo.n)
        self._require_seed(seed)
        hash_seed = kops.NO_KEY_SEED if seed is None else int(seed)
        spec = self.codec.spec
        layout = self.layout(X)
        weights = _neighbor_weights_of(self.topo)
        flat = layout.flatten(X).float()
        # decode round k-1 against its own reference and B, apply the delta
        with obs_trace.named_phase("comm.decode_reduce"):
            p_nbrs = torch.stack([gossip._roll(carry["packed"], o)
                                  for o in offsets])
            if presence is None:
                mixed_ref = kops.moniqua_decode_reduce_stacked(
                    carry["packed"], p_nbrs, carry["ref"], carry["B"],
                    weights, spec)
                delta = mixed_ref - carry["ref"]
            else:
                delta = torch.zeros_like(carry["ref"])
                for k, (o, w) in enumerate(zip(offsets, weights)):
                    mixed_o = kops.moniqua_decode_reduce_stacked(
                        carry["packed"], p_nbrs[k:k + 1], carry["ref"],
                        carry["B"], (w,), spec)
                    delta = delta + _gate(presence, o,
                                          mixed_o - carry["ref"])
                delta = _if_present(presence, delta, 0.0)
            out = flat + torch.where(carry["valid"], delta, 0.0)
        # encode round k from the mixed model, for consumption at k+1
        B = modulo.b_theta(theta, spec.delta, flat.device)
        with obs_trace.named_phase("comm.encode"):
            packed = kops.moniqua_encode_stacked(out, B, spec, hash_seed)
        new_carry = {"packed": packed, "ref": out, "B": B,
                     "valid": torch.ones((), dtype=torch.bool,
                                         device=flat.device)}
        return MixResult(layout.unflatten(out.to(layout.stage_dtype)),
                         new_carry, self._round_health(
                             X, theta, seed, None, presence, flat=flat))

    # -- round health (telemetry=True) -------------------------------------
    def _round_health(self, X: PyTree, theta, seed: Optional[int],
                      new_state: Optional[dict],
                      presence: Optional[Tuple[int, ...]] = None, *,
                      flat: Optional[torch.Tensor] = None,
                      payload: Optional[torch.Tensor] = None
                      ) -> Optional[dict]:
        """Health counters of the round just mixed (``obs.metrics``), or
        ``None`` with telemetry off.

        Read from the canonical flat buffer of the round's input ``X``
        (``flat``, when the round already staged it: its float32 copy on
        the EF wires and in ``mix_stale`` reads the same), so the values
        are the same on either path and at any K.  The alias sentinel
        tests the whole-buffer payload: a barrier bucketed Moniqua round
        hands in its own (``payload``, the same bits); elsewhere it is
        re-encoded once (``ops.moniqua_encode_stacked``, the kernel on the
        card).  As in the reference, the sentinel reads every neighbor
        offset even under a mask, and is pinned to 0 on tiered rounds
        (their payloads are per owned shard) and for ``delta >= 1/4``.
        """
        if not self.telemetry:
            return None
        with obs_trace.named_phase("comm.telemetry"):
            layout = self.layout(X)
            if flat is None:
                flat = layout.flatten(X)
            dev = flat.device
            offsets = self.topo.neighbor_offsets()
            h = obs_metrics.round_health_zero(dev)
            h["consensus_inf"] = obs_metrics.consensus_inf(flat, offsets)
            nbytes = self.payload_bytes_per_broadcast(X)
            h["bits_per_param"] = obs_metrics.scalar_f32(
                8.0 * nbytes / max(layout.total_elems, 1), dev)
            h["bytes_slow"] = obs_metrics.scalar_f32(
                nbytes * len(self.gossip_topo.neighbor_offsets()), dev)
            h["bytes_fast"] = obs_metrics.scalar_f32(
                self.fast_bytes_per_round(X), dev)
            if presence is not None:
                # a normalized partial mask (all-ones became None upstream)
                h["participation"] = obs_metrics.scalar_f32(
                    sum(presence) / len(presence), dev)
                h["dropped_neighbors"] = obs_metrics.scalar_i32(
                    _dropped_edge_count(presence, self.gossip_topo), dev)
            if self.codec.name == "moniqua" and theta is not None:
                spec = self.codec.spec
                theta_t = obs_metrics.f32_on(theta, dev)
                B = modulo.b_theta(theta_t, spec.delta)
                h["headroom"] = h["consensus_inf"] / B
                if spec.delta < 0.25 and not self.tiered:
                    if payload is None:
                        payload = kops.moniqua_encode_stacked(
                            flat, B, spec,
                            kops.NO_KEY_SEED if seed is None else int(seed))
                    h["alias_count"] = obs_metrics.moniqua_alias_count(
                        payload, flat, B, theta_t, spec, offsets)
            if new_state is not None:
                # across ranks the sum of squares is all-reduced, in the
                # collective's order: within float32 rounding of one
                # process's sum
                h["ef_residual_l2"] = torch.sqrt(workers.all_sum(torch.sum(
                    torch.square(new_state["residual"].float()))))
                if self.codec.name == "onebit":
                    # the counter was already bumped: -1 recovers the flag
                    # the round just ran under
                    h["warm"] = ((new_state["step"] - 1)
                                 < self.codec.warmup).float()
            return h

    def pair_health(self, xi: torch.Tensor, xj: torch.Tensor, theta=None,
                    seed: Optional[int] = None) -> dict:
        """Round health of one :meth:`pair_average` edge exchange, on the
        *pre-exchange* endpoints: their consensus distance and, on the
        Moniqua wire, the theta headroom and the alias sentinel in both
        directions on the payloads re-encoded under the exchange seed
        (the bits ``pair_average`` ships)."""
        with obs_trace.named_phase("comm.telemetry"):
            spec = (self.codec.spec
                    if self.codec.name == "moniqua" else None)
            h = obs_metrics.pair_health(xi, xj, theta=theta, spec=spec,
                                        seed=seed)
            if spec is None:
                bits = getattr(getattr(self.codec, "spec", None), "bits",
                               32)
                h["bits_per_param"] = obs_metrics.scalar_f32(
                    32.0 if self.codec.name == "full" else float(bits),
                    h["consensus_inf"].device)
            return h

    # -- stateful wires: error-feedback rounds on the flat bucket ----------
    def _mix_stateful(self, X: PyTree, state: dict, seed: Optional[int],
                      presence: Optional[Tuple[int, ...]] = None
                      ) -> Tuple[PyTree, dict]:
        """One EF gossip round; returns ``(X_{k+1/2}, new WireState)``.

        The bucketed path runs the staged plan chunk by chunk, the per-leaf
        path :meth:`_ef_flat_round` slot by slot on the same canonical flat
        residual: same per-segment statistics, same row-position uniforms,
        same accumulation order, so outputs and state agree bitwise.  The
        step counter advances for every worker, absent ones included."""
        layout = self.layout(X)
        if self._use_bucketed(X):
            out, res = self.round_plan(X, seed=seed, state=state,
                                       presence=presence).run()
        else:
            self._require_seed(seed)
            seed = kops.NO_KEY_SEED if seed is None else int(seed)
            flat = layout.flatten(X).float()
            outs, ress = [], []
            for s in layout.slots:
                w = slice(s.offset, s.offset + s.padded_size)
                o, r = self._ef_flat_round(flat[:, w], state["residual"][:, w],
                                           (s.padded_size,), s.offset, seed,
                                           state["step"], presence)
                outs.append(o)
                ress.append(r)
            out, res = torch.cat(outs, dim=1), torch.cat(ress, dim=1)
        new_state = {"residual": res, "step": state["step"] + 1}
        return layout.unflatten(out.to(layout.stage_dtype)), new_state

    def _ef_flat_round(self, v_base: torch.Tensor, residual: torch.Tensor,
                       segments: Tuple[int, ...], idx_base: int, seed: int,
                       step: torch.Tensor,
                       presence: Optional[Tuple[int, ...]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """EF round on one flat f32 slice (the per-leaf path): encode
        ``v = x + r``, gossip the codes, mix
        ``x + sum w_o (decode_o - decode_self)``, keep ``r' = v - decode_self``
        (onebit: the full-precision round and ``r`` during warmup).
        ``presence`` gates dead edges to identity and carries absent rows'
        models and residuals through untouched."""
        offsets = self.topo.neighbor_offsets()
        weights = _neighbor_weights_of(self.topo)
        spec = self.codec.spec

        def reduce(d_self, decoded):
            return v_base + _weighted_diffs(d_self, decoded, weights,
                                            presence, offsets)

        def mask_absent(out, res):
            if presence is None:
                return out, res
            return (_if_present(presence, out, v_base),
                    _if_present(presence, res, residual))

        v = v_base + residual
        if self.codec.name == "ef_qsgd":
            packed, scales = ef_qsgd_encode_segmented(v, spec, seed,
                                                      segments, idx_base)
            d_self = qsgd_decode_segmented(packed, scales, spec, segments)
            out = reduce(d_self, (qsgd_decode_segmented(
                gossip._roll(packed, o), gossip._roll(scales, o), spec,
                segments) for o in offsets))
            return mask_absent(out, v - d_self)
        warm = step < self.codec.warmup
        out_warm = (gossip.mix(v_base, self.topo) if presence is None
                    else _masked_circulant(v_base, self.topo, presence))
        packed, lo, hi = onebit_encode_segmented(v, seed, segments, idx_base,
                                                 spec.stochastic)
        d_self = onebit_decode_segmented(packed, lo, hi, segments)
        out_q = reduce(d_self, (onebit_decode_segmented(
            gossip._roll(packed, o), gossip._roll(lo, o),
            gossip._roll(hi, o), segments) for o in offsets))
        return mask_absent(torch.where(warm, out_warm, out_q),
                           torch.where(warm, residual, v - d_self))

    def _mix_leaf(self, x: torch.Tensor, theta, seed: int,
                  idx_base: int = 0,
                  presence: Optional[Tuple[int, ...]] = None,
                  idx_row_stride: Optional[int] = None,
                  splits=(), rows_per_block: Optional[int] = None,
                  block_stride: int = 0) -> torch.Tensor:
        if x.dim() == 1:     # scalar-per-worker leaf: give it a unit last axis
            return self._mix_leaf(x[:, None], theta, seed, idx_base,
                                  presence)[:, 0]
        if splits:      # a shard of a leaf split over model and/or data
            vpb = self._align()
            try:
                view, off, stride, rpb, bstride = TP.split_view(x, splits,
                                                                vpb)
            except ValueError as e:
                from repro_torch.models.sharding import TODO_13E
                raise NotImplementedError(
                    f"shard {tuple(x.shape)}: {e}: {TODO_13E}") from None
            return self._mix_leaf(view, theta, seed, idx_base + off,
                                  presence, stride, rows_per_block=rpb,
                                  block_stride=bstride).reshape(x.shape)
        spec = self.codec.spec
        offsets = self.topo.neighbor_offsets()
        weights = _neighbor_weights_of(self.topo)
        if self.codec.name == "moniqua":
            B = modulo.b_theta(theta, spec.delta, x.device)
            packed = kops.moniqua_encode_stacked(
                x, B, spec, seed, idx_base=idx_base,
                idx_row_stride=idx_row_stride, rows_per_block=rows_per_block,
                block_stride=block_stride)
            p_nbrs = torch.stack([gossip._roll(packed, o) for o in offsets])
            if presence is None:
                return kops.moniqua_decode_reduce_stacked(
                    packed, p_nbrs, x, B, weights, spec)
            # elastic: one single-weight decode-reduce per offset, gated
            f = x.float()
            out = f
            for k, (o, w) in enumerate(zip(offsets, weights)):
                mixed_o = kops.moniqua_decode_reduce_stacked(
                    packed, p_nbrs[k:k + 1], x, B, (w,), spec)
                out = out + _gate(presence, o, mixed_o.float() - f)
            return out.to(x.dtype)
        # qsgd: reference-free decode; each worker ships (codes, own scale)
        packed, scale = qsgd_encode(x, spec, seed,
                                    row_base=workers.row_base(x.shape[0]))
        last = x.shape[-1]
        acc = _weighted_diffs(
            qsgd_decode(packed, scale, spec, last),
            (qsgd_decode(gossip._roll(packed, o), gossip._roll(scale, o),
                         spec, last) for o in offsets), weights, presence,
            offsets)
        return (x.float() + acc).to(x.dtype)

    def _align(self) -> int:
        """Row alignment of the flat buffer: values-per-byte for packed
        codecs (keeps per-leaf byte boundaries), 1 for the raw wire."""
        spec = getattr(self.codec, "spec", None)
        return spec.values_per_byte if spec is not None else 1

    def layout(self, X: PyTree) -> bucket.BucketLayout:
        """The (memoized) flat-buffer layout this engine uses for ``X``."""
        return bucket.layout_of(X, self._align())

    def _require_seed(self, seed) -> None:
        """Stochastic rounding without a seed would reuse one seed every
        round and lose the across-step unbiasedness: fail loudly."""
        spec = getattr(self.codec, "spec", None)
        if seed is None and spec is not None and spec.stochastic:
            raise ValueError(
                f"{self.codec.name} wire with stochastic rounding needs a "
                "seed (pass seed=, or use a nearest-rounding QuantSpec)")

    # -- AD-PSGD's primitive: one edge exchange ----------------------------
    def init_edge_state(self, x: torch.Tensor) -> dict:
        """Per-endpoint WireState for :meth:`pair_average` on ``x``'s device:
        the residual in the padded flat domain of one model copy, and the
        step counter.  ``{}`` for stateless wires."""
        if not self.stateful:
            return {}
        vpb = self.codec.spec.values_per_byte
        padded = -(-x.numel() // vpb) * vpb
        return {"residual": torch.zeros((padded,), dtype=torch.float32,
                                        device=x.device),
                "step": torch.zeros((), dtype=torch.int32, device=x.device)}

    def pair_average(self, xi: torch.Tensor, xj: torch.Tensor, theta=None,
                     seed: Optional[int] = None,
                     state_i: Optional[dict] = None,
                     state_j: Optional[dict] = None,
                     presence=None) -> PairResult:
        """One gossip on edge (i, j) with the pair-averaging ``W_k``.

        ``full``: both endpoints take ``(x_i + x_j) / 2``.  ``moniqua``
        (Algorithm 3 lines 4-7): both payloads come from one encode launch
        of the stacked pair under the shared ``seed`` (the counter restarts
        per endpoint), and each endpoint decodes the other's payload
        against its own model (one remote point decode of the swapped
        payloads) and its own payload (one self point decode):
        ``x_i + (xhat_j - xhat_ii) / 2``.  The decodes run in float32, so
        a bfloat16 pair comes back in float32, as the reference promotes.
        ``qsgd``: both decode each other's codes and scale.  The EF wires
        take and return per-endpoint carries from :meth:`init_edge_state`.

        ``presence`` (elastic): a 2-mask ``(p_i, p_j)``.  If either endpoint
        is absent, or the message between them was dropped, the exchange is
        the identity: both models come back untouched and the EF carries
        (step counters included) do not advance.
        """
        if _normalize_presence(presence, 2) is not None:
            return PairResult(xi, xj,
                              state_i if self.stateful else {},
                              state_j if self.stateful else {})
        if self.stateful:
            return self._pair_average_stateful(xi, xj, seed, state_i,
                                               state_j)
        name = self.codec.name
        if name == "full":
            avg = 0.5 * (xi + xj)
            return PairResult(avg, avg)
        if name == "moniqua" and theta is None:
            raise ValueError("MoniquaWire needs the a-priori bound theta")
        self._require_seed(seed)
        seed = kops.NO_KEY_SEED if seed is None else int(seed)
        spec = self.codec.spec
        if name == "qsgd":
            pi, si = qsgd_encode(xi, spec, seed, worker_axis=False)
            pj, sj = qsgd_encode(xj, spec, seed, worker_axis=False)
            qi = qsgd_decode(pi, si, spec, xi.shape[-1])
            qj = qsgd_decode(pj, sj, spec, xj.shape[-1])
            return PairResult(xi + 0.5 * (qj - qi), xj + 0.5 * (qi - qj))
        x2 = torch.stack([xi, xj])
        B = modulo.b_theta(theta, spec.delta, x2.device)
        p2 = kops.moniqua_encode_stacked(x2, B, spec, seed)
        y2 = x2.float()
        remote = kops.moniqua_decode_remote(p2.flip(0), y2, B, spec)
        own = kops.moniqua_decode_self(p2, y2, B, spec)
        out = x2 + 0.5 * (remote - own)
        return PairResult(out[0], out[1])

    def _pair_average_stateful(self, xi: torch.Tensor, xj: torch.Tensor,
                               seed: Optional[int], state_i: Optional[dict],
                               state_j: Optional[dict]) -> PairResult:
        """EF edge exchange: each endpoint compensates with its own residual,
        ships codes of ``x + r`` and keeps ``r' = x + r - decode(sent)``
        (onebit: the plain average while either counter is in warmup)."""
        for s in (state_i, state_j):
            if not isinstance(s, dict) or "residual" not in s:
                raise ValueError(
                    f"{self.codec.name} wire is stateful: pass state_i/"
                    "state_j=engine.init_edge_state(x) and thread the "
                    "returned PairResult.state_i/.state_j across edges")
        self._require_seed(seed)
        seed = kops.NO_KEY_SEED if seed is None else int(seed)
        spec = self.codec.spec
        size = xi.numel()
        padded = state_i["residual"].shape[0]
        seg = (padded,)

        def flat(x):
            f = x.reshape(-1).float()
            return torch.nn.functional.pad(f, (0, padded - size))[None, :]

        def unflat(f, like):
            return f[0, :size].reshape(like.shape).to(like.dtype)

        fi, fj = flat(xi), flat(xj)
        ri0, rj0 = state_i["residual"][None, :], state_j["residual"][None, :]
        vi, vj = fi + ri0, fj + rj0
        if self.codec.name == "ef_qsgd":
            di = qsgd_decode_segmented(
                *ef_qsgd_encode_segmented(vi, spec, seed, seg), spec, seg)
            dj = qsgd_decode_segmented(
                *ef_qsgd_encode_segmented(vj, spec, seed, seg), spec, seg)
            oi, oj = fi + 0.5 * (dj - di), fj + 0.5 * (di - dj)
            ri, rj = vi - di, vj - dj
        else:
            # the earlier of the two counters decides warm vs quantized
            warm = torch.minimum(state_i["step"],
                                 state_j["step"]) < self.codec.warmup
            avg = 0.5 * (fi + fj)
            di = onebit_decode_segmented(*onebit_encode_segmented(
                vi, seed, seg, 0, spec.stochastic), seg)
            dj = onebit_decode_segmented(*onebit_encode_segmented(
                vj, seed, seg, 0, spec.stochastic), seg)
            oi = torch.where(warm, avg, fi + 0.5 * (dj - di))
            oj = torch.where(warm, avg, fj + 0.5 * (di - dj))
            ri = torch.where(warm, ri0, vi - di)
            rj = torch.where(warm, rj0, vj - dj)
        return PairResult(
            unflat(oi, xi), unflat(oj, xj),
            {"residual": ri[0], "step": state_i["step"] + 1},
            {"residual": rj[0], "step": state_j["step"] + 1})

    # -- gossip building blocks of the replica-mixing baselines -------------
    def _require_flat(self, what: str) -> None:
        if self.tiered:
            raise ValueError(
                f"{what} needs a flat circulant topology; the "
                "replica-mixing baselines do not support tiers")

    def neighbor_sum(self, X: PyTree, transform) -> PyTree:
        """``sum_{o != 0} w_o * transform(roll(X, -o), o)`` leaf-wise."""
        self._require_flat("neighbor_sum")
        return gossip.neighbor_sum(X, self.topo, transform)

    def self_weight(self) -> float:
        self._require_flat("self_weight")
        return gossip.self_weight(self.topo)

    # -- accounting --------------------------------------------------------
    def payload_bytes_per_broadcast(self, X: PyTree) -> int:
        """Bytes one worker ships to ONE neighbor per round.  The vpb row
        alignment makes the bucketed payload equal the per-leaf sum exactly
        (with one scale word, or a lo/hi level pair, per tensor), so the
        path never changes this number.  The EF wires gossip packed flat
        segments on both paths; onebit reports its steady state.  A tiered
        worker broadcasts only its owned shard on the slow axis: the ceil'd
        ``n_intra``-th of the staged payload.  Under a ``model`` split the
        one-process figure: each split leaf once in total, each replicated
        leaf once, not once a rank."""
        X = TP.whole(X)
        leaves = tree.leaves(X)
        if not leaves:
            return 0
        if self.tiered:
            return -(-self._staged_payload_bytes(self.layout(X))
                     // self.topo.n_intra)
        if self.stateful:
            return self._staged_payload_bytes(self.layout(X))
        if self._use_bucketed(X):
            layout = self.layout(X)
            if self.codec.name != "full" or layout.uniform_dtype:
                return self._staged_payload_bytes(layout)
        return sum(self.codec.payload_bytes(tuple(leaf.shape[1:]),
                                            leaf.element_size())
                   for leaf in leaves)

    def _staged_payload_bytes(self, layout: bucket.BucketLayout) -> int:
        """Whole-buffer payload on the staged path: packed codes plus the
        per-segment scale words (one f32 for qsgd/ef_qsgd, a lo/hi pair for
        onebit)."""
        if self.codec.name == "full":
            itemsize = torch.empty((), dtype=layout.stage_dtype).element_size()
            return layout.total_elems * itemsize
        nbytes = layout.padded_elems // self.codec.spec.values_per_byte
        if self.codec.name in ("qsgd", "ef_qsgd"):
            nbytes += 4 * layout.num_leaves
        elif self.codec.name == "onebit":
            nbytes += 8 * layout.num_leaves
        return nbytes

    def fast_bytes_per_round(self, X: PyTree) -> int:
        """Fast-axis (intra) bytes one worker sends per tiered round: the
        reduce-scatter and all-gather of the staging buffer,
        ``2 * (n_intra - 1) / n_intra`` of it in the staging dtype (float32
        for the EF wires).  0 on a flat engine or a trivial intra tier."""
        if not self.tiered or not tree.leaves(X):
            return 0
        X = TP.whole(X)
        k = self.topo.n_intra
        if k == 1:
            return 0
        layout = self.layout(X)
        itemsize = (4 if self.stateful else torch.empty(
            (), dtype=layout.stage_dtype).element_size())
        return 2 * itemsize * layout.padded_elems * (k - 1) // k

    def bytes_per_round(self, X: PyTree) -> int:
        """Payload bytes *sent* per worker per gossip round (all leaves):
        on a tiered engine the fast-axis bytes plus one owned-shard
        broadcast per inter neighbor."""
        return (self.fast_bytes_per_round(X)
                + self.payload_bytes_per_broadcast(X)
                * len(self.gossip_topo.neighbor_offsets()))

    def _record(self, X: PyTree, ledger: BytesLedger) -> None:
        ledger.add(self.payload_bytes_per_broadcast(X),
                   len(self.gossip_topo.neighbor_offsets()), tier="slow")
        fast = self.fast_bytes_per_round(X)
        if fast:
            ledger.add(fast, 1, tier="fast")
