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

Gossip path (``path=``): ``"bucketed"`` (default) flattens the whole stacked
pytree into one ``[n, D]`` buffer (``comm/bucket.py``) and runs the staged
round of :class:`RoundPlan`; ``"per_leaf"`` gossips leaf by leaf and is the
parity reference.  Moniqua's and the EF wires' per-leaf rounds hash the same
global element indices as the bucketed round, so the paths agree bit for
bit; the per-leaf ``qsgd`` round hashes a seed per leaf, as the reference's
does, and is held to the reference's per-leaf round only.

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

Randomness: the reference takes a JAX key; the port takes the uint32 hash
``seed`` the reference derives from it (``kops._key_to_seed``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.comm import bucket, gossip
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
from repro_torch.core.topology import Topology
from repro_torch.kernels import ops as kops

PyTree = Any

WIRES = ("full", "moniqua", "qsgd", "ef_qsgd", "onebit")
PATHS = ("bucketed", "per_leaf")


class MixResult(NamedTuple):
    """What one gossip round returns: ``x`` is the mixed model
    ``X_{k+1/2}``; ``state`` the post-round WireState (``{}`` for stateless
    wires) or, from :meth:`CommEngine.mix_stale`, the gossip carry."""
    x: Any
    state: dict = {}


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


def _leaf_seed(base_seed: int, leaf_idx: int) -> int:
    """Distinct hash seed per pytree leaf (the per-leaf qsgd round)."""
    return (int(base_seed) ^ ((leaf_idx * 0x9E3779B1) & _U32)) & _U32


def _neighbor_weights_of(topo: Topology) -> Tuple[float, ...]:
    return tuple(w for o, w in zip(topo.offsets, topo.weights)
                 if o % topo.n != 0)


def _weighted_diffs(d_self: torch.Tensor, decoded, weights) -> torch.Tensor:
    """``sum_o w_o * (decoded_o - d_self)``, offsets in order."""
    acc = None
    for d, w in zip(decoded, weights):
        t = (d - d_self) * w
        acc = t if acc is None else acc + t
    return acc


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
    is then float32).
    """
    engine: "CommEngine"
    layout: bucket.BucketLayout
    chunks: Tuple[bucket.BucketChunk, ...]
    flat: torch.Tensor
    B: Optional[torch.Tensor] = None
    seed: int = kops.NO_KEY_SEED
    residual: Optional[torch.Tensor] = None
    step: Optional[torch.Tensor] = None

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def _win(self, arr: torch.Tensor, c: bucket.BucketChunk) -> torch.Tensor:
        return arr[:, c.offset:c.offset + c.size]

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
            return (kops.moniqua_encode_chunk(self.flat, c.offset, c.size,
                                              self.B, codec.spec, self.seed),)
        if name == "qsgd":
            return qsgd_encode_segmented(
                self._win(self.flat, c), codec.spec, self.seed,
                c.segment_sizes, idx_base=c.offset,
                idx_stride=self.layout.padded_elems)
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
        topo = self.engine.topo
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
        topo = eng.topo
        if name == "full":
            out = None
            for w, r in zip(topo.weights, nbrs):
                t = r * gossip.as_weight(w, r.dtype)
                out = t if out is None else out + t
            return out.to(enc[0].dtype)
        spec = eng.codec.spec
        weights = _neighbor_weights_of(topo)
        if name == "moniqua":
            return kops.moniqua_decode_reduce_chunk(
                enc[0], nbrs, self.flat, c.offset, c.size, self.B, weights,
                spec)
        seg = c.segment_sizes
        win = self._win(self.flat, c)
        if name in ("qsgd", "ef_qsgd"):
            d_self = qsgd_decode_segmented(enc[0], enc[1], spec, seg)
            acc = _weighted_diffs(
                d_self, (qsgd_decode_segmented(p, s, spec, seg)
                         for p, s in nbrs), weights)
            if name == "qsgd":
                return (win.float() + acc).to(win.dtype)
            return win + acc, enc[2] - d_self
        # onebit: full-precision gossip during warmup, sign codes + EF
        # after.  Both are computed and selected with torch.where: a Python
        # branch on the step would wait for the card.
        packed, lo, hi, v = enc
        warm = self.step < eng.codec.warmup
        d_self = onebit_decode_segmented(packed, lo, hi, seg)
        acc = _weighted_diffs(
            d_self, (onebit_decode_segmented(p, l, h, seg)
                     for p, l, h in nbrs), weights)
        return (torch.where(warm, gossip.mix(win, topo), win + acc),
                torch.where(warm, self._win(self.residual, c), v - d_self))

    def run(self):
        """Run the round through the skewed pipeline: at tick t, encode(t),
        permute(t-1), decode_reduce(t-2).  Returns the mixed flat buffer,
        or ``(mixed flat buffer, new flat residual)`` for the EF wires.
        With one chunk it is the barrier round."""
        K = self.num_chunks
        stateful = self.engine.stateful
        enc, nbr = {}, {}
        outs, ress = [None] * K, [None] * K
        for t in range(K + 2):
            if t < K:
                enc[t] = self.encode_chunk(t)
            if 0 <= t - 1 < K:
                nbr[t - 1] = self.permute(t - 1, enc[t - 1])
            if 0 <= t - 2 < K:
                r = self.decode_reduce(t - 2, enc.pop(t - 2), nbr.pop(t - 2))
                if stateful:
                    outs[t - 2], ress[t - 2] = r
                else:
                    outs[t - 2] = r
        out = outs[0] if K == 1 else torch.cat(outs, dim=1)
        if stateful:
            return out, (ress[0] if K == 1 else torch.cat(ress, dim=1))
        return out


@dataclasses.dataclass(frozen=True)
class CommEngine:
    """One gossip round, end to end: wire codec x topology x path x chunk
    count, plus the byte accounting.  Static configuration only; per-round
    inputs (``theta``, ``seed``, WireState, the ledger) are call
    arguments."""
    topo: Topology
    codec: Any = dataclasses.field(default_factory=MoniquaWire)
    path: str = "bucketed"
    chunks: int = 1

    def __post_init__(self) -> None:
        if self.path not in PATHS:
            raise ValueError(f"unknown path {self.path!r}; one of {PATHS}")
        if self.codec.name not in WIRES:
            raise ValueError(f"unknown wire {self.codec.name!r}; "
                             f"one of {WIRES}")
        if int(self.chunks) < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if not isinstance(self.topo, Topology):
            raise TypeError("the port gossips on a flat circulant Topology")

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
        the step counter, a 0-dim int32."""
        if not self.stateful:
            return {}
        layout = self.layout(X)
        dev = tree.leaves(X)[0].device
        return {"residual": torch.zeros((layout.n_workers,
                                         layout.padded_elems),
                                        dtype=torch.float32, device=dev),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def wire_state_bytes(self, X: PyTree) -> int:
        """Per-worker bytes of persistent codec state (Table 1's memory
        column): 0 for full/moniqua/qsgd, residual + counter for EF wires."""
        if not self.stateful or not tree.leaves(X):
            return 0
        return self.layout(X).padded_elems * 4 + 4

    def _check_wire_state(self, state) -> None:
        if not isinstance(state, dict) or "residual" not in state:
            raise ValueError(
                f"{self.codec.name} wire is stateful: pass "
                "state=engine.init_wire_state(X) and thread the returned "
                "MixResult.state carry across rounds")

    # -- the staged round --------------------------------------------------
    def round_plan(self, X: PyTree, theta=None, seed: Optional[int] = None,
                   state: Optional[dict] = None,
                   chunks: Optional[int] = None) -> RoundPlan:
        """Stage one gossip round on the flat bucket in ``chunks`` (default
        the engine's) slot-aligned chunks; ``state`` is the EF wires'
        WireState."""
        layout = self.layout(X)
        name = self.codec.name
        if name == "full" and not layout.uniform_dtype:
            raise ValueError(
                "no staged round for a mixed-dtype tree on the full wire "
                "(f32 staging would change the mixing arithmetic); "
                "use mix(), which falls back to the per-leaf circulant")
        if self.stateful:
            self._check_wire_state(state)
        k = self.chunks if chunks is None else int(chunks)
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
        return RoundPlan(engine=self, layout=layout, chunks=layout.chunks(k),
                         flat=flat, B=B,
                         seed=kops.NO_KEY_SEED if seed is None else int(seed),
                         residual=residual, step=step)

    def mix(self, X: PyTree, theta=None, seed: Optional[int] = None,
            ledger: Optional[BytesLedger] = None,
            state: Optional[dict] = None) -> MixResult:
        """One gossip round on stacked models (leaves ``[n, ...]``).

        ``.x`` of the result is ``X_{k+1/2}`` (with the full-precision codec
        exactly the circulant ``X W`` of ``gossip.mix``); ``.state`` the
        post-round WireState of a stateful wire, which needs the ``state``
        carry from :meth:`init_wire_state`.  ``seed`` is the uint32 hash seed
        of stochastic rounding.  ``ledger`` (if given) is credited with
        payload-bytes * n_neighbors.
        """
        if self.stateful:
            self._check_wire_state(state)
        if not self.topo.neighbor_offsets() or not tree.leaves(X):
            return MixResult(X, state if state is not None else {})
        if ledger is not None:
            self._record(X, ledger)
        name = self.codec.name
        if name == "moniqua" and theta is None:
            raise ValueError("MoniquaWire needs the a-priori bound theta")
        if self.stateful:
            return MixResult(*self._mix_stateful(X, state, seed))
        layout = self.layout(X)
        full_mixed_dtype = name == "full" and not layout.uniform_dtype
        if self.path == "bucketed" and not full_mixed_dtype:
            return MixResult(layout.unflatten(
                self.round_plan(X, theta=theta, seed=seed).run()))
        if name == "full":
            return MixResult(gossip.mix(X, self.topo))
        self._require_seed(seed)
        seed = kops.NO_KEY_SEED if seed is None else int(seed)
        leaves, td = tree.flatten(X)
        if name == "moniqua":
            # global counter indices: leaf i's elements hash
            # (seed, layout.offset_i + e), the SAME pairs the bucketed
            # one-shot encode hashes: the bucketed-vs-per-leaf parity
            out = [self._mix_leaf(l, theta, seed, idx_base=layout.offsets[i])
                   for i, l in enumerate(leaves)]
        else:
            out = [self._mix_leaf(l, theta, _leaf_seed(seed, i))
                   for i, l in enumerate(leaves)]
        return MixResult(tree.unflatten(td, out))

    # -- step-level overlap: one-round-stale mixing ------------------------
    def _require_stale_wire(self) -> None:
        if self.stateful or self.codec.name != "moniqua":
            raise ValueError(
                "one-round-stale overlap needs the stateless moniqua wire "
                f"(got {self.codec.name!r})")

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
                  ledger: Optional[BytesLedger] = None) -> MixResult:
        """One-round-stale gossip: apply the PREVIOUS round's payloads to
        this round's model, then encode the mixed result for the next round.

        The result's ``.state`` is the new carry.  Step k's model moves by
        the consensus delta of round k-1's payloads, decoded against the
        reference they were encoded from under the B they were encoded
        under; the first round (``valid`` unset) applies none.  The delta
        is added through ``torch.where(valid, delta, 0.0)``: the first
        round's decode divides by its carry's B = 0, and the add turns a
        -0.0 of the model into +0.0, as the reference does.
        """
        self._require_stale_wire()
        if not isinstance(carry, dict) or "packed" not in carry:
            raise ValueError(
                "pass carry=engine.init_gossip_carry(X) and thread the "
                "returned MixResult.state across steps")
        offsets = self.topo.neighbor_offsets()
        if not offsets or not tree.leaves(X):
            return MixResult(X, carry)
        if theta is None:
            raise ValueError("MoniquaWire needs the a-priori bound theta")
        if ledger is not None:
            self._record(X, ledger)
        self._require_seed(seed)
        seed = kops.NO_KEY_SEED if seed is None else int(seed)
        spec = self.codec.spec
        layout = self.layout(X)
        flat = layout.flatten(X).float()
        p_nbrs = torch.stack([gossip._roll(carry["packed"], o)
                              for o in offsets])
        mixed_ref = kops.moniqua_decode_reduce_stacked(
            carry["packed"], p_nbrs, carry["ref"], carry["B"],
            _neighbor_weights_of(self.topo), spec)
        delta = mixed_ref - carry["ref"]
        out = flat + torch.where(carry["valid"], delta, 0.0)
        B = modulo.b_theta(theta, spec.delta, flat.device)
        packed = kops.moniqua_encode_stacked(out, B, spec, seed)
        new_carry = {"packed": packed, "ref": out, "B": B,
                     "valid": torch.ones((), dtype=torch.bool,
                                         device=flat.device)}
        return MixResult(layout.unflatten(out.to(layout.stage_dtype)),
                         new_carry)

    # -- stateful wires: error-feedback rounds on the flat bucket ----------
    def _mix_stateful(self, X: PyTree, state: dict,
                      seed: Optional[int]) -> Tuple[PyTree, dict]:
        """One EF gossip round; returns ``(X_{k+1/2}, new WireState)``.

        The bucketed path runs the staged plan chunk by chunk, the per-leaf
        path :meth:`_ef_flat_round` slot by slot on the same canonical flat
        residual: same per-segment statistics, same row-position uniforms,
        same accumulation order, so outputs and state agree bitwise."""
        layout = self.layout(X)
        if self.path == "bucketed":
            out, res = self.round_plan(X, seed=seed, state=state).run()
        else:
            self._require_seed(seed)
            seed = kops.NO_KEY_SEED if seed is None else int(seed)
            flat = layout.flatten(X).float()
            outs, ress = [], []
            for s in layout.slots:
                w = slice(s.offset, s.offset + s.padded_size)
                o, r = self._ef_flat_round(flat[:, w], state["residual"][:, w],
                                           (s.padded_size,), s.offset, seed,
                                           state["step"])
                outs.append(o)
                ress.append(r)
            out, res = torch.cat(outs, dim=1), torch.cat(ress, dim=1)
        new_state = {"residual": res, "step": state["step"] + 1}
        return layout.unflatten(out.to(layout.stage_dtype)), new_state

    def _ef_flat_round(self, v_base: torch.Tensor, residual: torch.Tensor,
                       segments: Tuple[int, ...], idx_base: int, seed: int,
                       step: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """EF round on one flat f32 slice (the per-leaf path): encode
        ``v = x + r``, gossip the codes, mix
        ``x + sum w_o (decode_o - decode_self)``, keep ``r' = v - decode_self``
        (onebit: the full-precision round and ``r`` during warmup)."""
        offsets = self.topo.neighbor_offsets()
        weights = _neighbor_weights_of(self.topo)
        spec = self.codec.spec
        v = v_base + residual
        if self.codec.name == "ef_qsgd":
            packed, scales = ef_qsgd_encode_segmented(v, spec, seed,
                                                      segments, idx_base)
            d_self = qsgd_decode_segmented(packed, scales, spec, segments)
            acc = _weighted_diffs(d_self, (qsgd_decode_segmented(
                gossip._roll(packed, o), gossip._roll(scales, o), spec,
                segments) for o in offsets), weights)
            return v_base + acc, v - d_self
        warm = step < self.codec.warmup
        packed, lo, hi = onebit_encode_segmented(v, seed, segments, idx_base,
                                                 spec.stochastic)
        d_self = onebit_decode_segmented(packed, lo, hi, segments)
        acc = _weighted_diffs(d_self, (onebit_decode_segmented(
            gossip._roll(packed, o), gossip._roll(lo, o),
            gossip._roll(hi, o), segments) for o in offsets), weights)
        return (torch.where(warm, gossip.mix(v_base, self.topo),
                            v_base + acc),
                torch.where(warm, residual, v - d_self))

    def _mix_leaf(self, x: torch.Tensor, theta, seed: int,
                  idx_base: int = 0) -> torch.Tensor:
        if x.dim() == 1:     # scalar-per-worker leaf: give it a unit last axis
            return self._mix_leaf(x[:, None], theta, seed, idx_base)[:, 0]
        spec = self.codec.spec
        offsets = self.topo.neighbor_offsets()
        weights = _neighbor_weights_of(self.topo)
        if self.codec.name == "moniqua":
            B = modulo.b_theta(theta, spec.delta, x.device)
            packed = kops.moniqua_encode_stacked(x, B, spec, seed,
                                                 idx_base=idx_base)
            p_nbrs = torch.stack([gossip._roll(packed, o) for o in offsets])
            return kops.moniqua_decode_reduce_stacked(packed, p_nbrs, x, B,
                                                      weights, spec)
        # qsgd: reference-free decode; each worker ships (codes, own scale)
        packed, scale = qsgd_encode(x, spec, seed)
        last = x.shape[-1]
        acc = _weighted_diffs(
            qsgd_decode(packed, scale, spec, last),
            (qsgd_decode(gossip._roll(packed, o), gossip._roll(scale, o),
                         spec, last) for o in offsets), weights)
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
        """
        if presence is not None:
            raise NotImplementedError(
                "pair_average(presence=...) is not ported yet (ROADMAP.md, "
                "Queue 1 #9)")
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
    def neighbor_sum(self, X: PyTree, transform) -> PyTree:
        """``sum_{o != 0} w_o * transform(roll(X, -o), o)`` leaf-wise."""
        return gossip.neighbor_sum(X, self.topo, transform)

    def self_weight(self) -> float:
        return gossip.self_weight(self.topo)

    # -- accounting --------------------------------------------------------
    def payload_bytes_per_broadcast(self, X: PyTree) -> int:
        """Bytes one worker ships to ONE neighbor per round.  The vpb row
        alignment makes the bucketed payload equal the per-leaf sum exactly
        (with one scale word, or a lo/hi level pair, per tensor), so the
        path never changes this number.  The EF wires gossip packed flat
        segments on both paths; onebit reports its steady state."""
        leaves = tree.leaves(X)
        if not leaves:
            return 0
        if self.stateful:
            return self._staged_payload_bytes(self.layout(X))
        if self.path == "bucketed":
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

    def bytes_per_round(self, X: PyTree) -> int:
        """Payload bytes *sent* per worker per gossip round (all leaves)."""
        return (self.payload_bytes_per_broadcast(X)
                * len(self.topo.neighbor_offsets()))

    def _record(self, X: PyTree, ledger: BytesLedger) -> None:
        ledger.add(self.payload_bytes_per_broadcast(X),
                   len(self.topo.neighbor_offsets()), tier="slow")
