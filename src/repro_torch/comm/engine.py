"""CommEngine: one gossip round for decentralized SGD, end to end.

Every decentralized algorithm reduces its communication to one gossip round:
encode the local model, circulate the payload along the topology
(``torch.roll`` of the stacked worker axis), decode each neighbor against the
local reference and accumulate the weighted consensus step

    X_{k+1/2}[i] = x_i + sum_{o != 0} w_o * (xhat_{i+o} - xhat_self)     (*)

The port carries two wires:

* ``full`` (D-PSGD baseline): the raw model rides the wire and (*) collapses
  to the circulant ``X W`` of ``gossip.mix``;
* ``moniqua`` (Algorithm 1): the bit-packed modulo residue, ``bits/8`` bytes
  per parameter, through the CUDA encode and decode-reduce kernels on the
  card and their plain PyTorch versions on the CPU.

Gossip path (``path=``): ``"bucketed"`` (default) flattens the whole stacked
pytree into one ``[n, D]`` buffer (``comm/bucket.py``), so a round is one
encode launch, one packed roll per neighbor offset, one fused decode-reduce
and one scatter back to the leaves; ``"per_leaf"`` gossips leaf by leaf and
is the parity reference.  Both draw the same stochastic-rounding uniforms per
element (global counter indices), so they are bit-exact against each other.

AD-PSGD's primitive is one edge exchange, :meth:`CommEngine.pair_average`
(Algorithm 3 lines 4-7), on the same two wires.

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
from repro_torch.core.quantizers import QuantSpec, packed_last_dim
from repro_torch.core.topology import Topology
from repro_torch.kernels import ops as kops

PyTree = Any

WIRES = ("full", "moniqua")
PATHS = ("bucketed", "per_leaf")
# wires of the reference that the port has not taken over yet
_LATER_WIRES = ("qsgd", "ef_qsgd", "onebit")


class MixResult(NamedTuple):
    """What one gossip round returns: ``x`` is the mixed model
    ``X_{k+1/2}``; ``state`` the post-round wire state (``{}`` for the
    stateless ``full`` and ``moniqua`` wires)."""
    x: Any
    state: dict = {}


class PairResult(NamedTuple):
    """Both endpoints of one :meth:`CommEngine.pair_average` exchange."""
    xi: torch.Tensor
    xj: torch.Tensor


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


def make_wire(name: str, spec: Optional[QuantSpec] = None):
    if name == "full":
        return FullPrecisionWire()
    if name == "moniqua":
        return MoniquaWire(spec or QuantSpec())
    if name in _LATER_WIRES:
        raise NotImplementedError(
            f"the {name} wire is not ported yet (ROADMAP.md, Queue 1 #8)")
    raise ValueError(f"unknown wire codec {name!r}; one of {WIRES}")


def _neighbor_weights_of(topo: Topology) -> Tuple[float, ...]:
    return tuple(w for o, w in zip(topo.offsets, topo.weights)
                 if o % topo.n != 0)


@dataclasses.dataclass
class RoundPlan:
    """One gossip round on the flat bucket, staged per chunk as encode /
    permute / decode-reduce (built by :meth:`CommEngine.round_plan`).

    Chunk windows cover whole leaf slots and start on values-per-byte
    boundaries, and the encode hashes global element indices
    (``idx_base`` = the chunk's offset), so each phase computes on its
    window exactly what the whole-buffer round computes there.
    """
    engine: "CommEngine"
    layout: bucket.BucketLayout
    chunks: Tuple[bucket.BucketChunk, ...]
    flat: torch.Tensor
    B: Optional[torch.Tensor] = None
    seed: int = kops.NO_KEY_SEED

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def _win(self, arr: torch.Tensor, c: bucket.BucketChunk) -> torch.Tensor:
        return arr[:, c.offset:c.offset + c.size]

    def encode_chunk(self, i: int) -> Tuple[torch.Tensor, ...]:
        """Encode chunk ``i`` of the staging buffer; returns the payload."""
        c = self.chunks[i]
        eng = self.engine
        if eng.codec.name == "full":
            return (self._win(self.flat, c),)
        return (kops.moniqua_encode_chunk(self.flat, c.offset, c.size, self.B,
                                          eng.codec.spec, self.seed),)

    def permute(self, i: int, enc: Tuple[torch.Tensor, ...]):
        """Roll chunk ``i``'s payload along the worker axis: the round's only
        cross-worker traffic."""
        topo = self.engine.topo
        if self.engine.codec.name == "full":
            # the raw wire reduces over ALL offsets (self included, where
            # _roll no-ops), exactly gossip.mix's circulant
            return tuple(gossip._roll(enc[0], o) for o in topo.offsets)
        return torch.stack([gossip._roll(enc[0], o)
                            for o in topo.neighbor_offsets()])

    def decode_reduce(self, i: int, enc: Tuple[torch.Tensor, ...], nbrs):
        """Decode chunk ``i``'s circulated payloads against the local window
        and apply (*) on it; returns the mixed window."""
        c = self.chunks[i]
        eng = self.engine
        topo = eng.topo
        if eng.codec.name == "full":
            out = None
            for w, r in zip(topo.weights, nbrs):
                t = r * gossip.as_weight(w, r.dtype)
                out = t if out is None else out + t
            return out.to(enc[0].dtype)
        return kops.moniqua_decode_reduce_chunk(
            enc[0], nbrs, self.flat, c.offset, c.size, self.B,
            _neighbor_weights_of(topo), eng.codec.spec)

    def run(self) -> torch.Tensor:
        """Run the round chunk by chunk; returns the mixed flat buffer."""
        outs = []
        for i in range(self.num_chunks):
            enc = self.encode_chunk(i)
            outs.append(self.decode_reduce(i, enc, self.permute(i, enc)))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


@dataclasses.dataclass(frozen=True)
class CommEngine:
    """One gossip round, end to end: wire codec x topology x path, plus the
    byte accounting.  Static configuration only; per-round inputs
    (``theta``, ``seed``, the ledger) are call arguments."""
    topo: Topology
    codec: Any = dataclasses.field(default_factory=MoniquaWire)
    path: str = "bucketed"

    def __post_init__(self) -> None:
        if self.path not in PATHS:
            raise ValueError(f"unknown path {self.path!r}; one of {PATHS}")
        if self.codec.name not in WIRES:
            raise ValueError(f"unknown wire {self.codec.name!r}; "
                             f"one of {WIRES}")
        if not isinstance(self.topo, Topology):
            raise TypeError("this slice of the port gossips on a flat "
                            "circulant Topology")

    def round_plan(self, X: PyTree, theta=None,
                   seed: Optional[int] = None) -> RoundPlan:
        """Stage one gossip round on the flat bucket (one chunk)."""
        layout = self.layout(X)
        if self.codec.name == "full" and not layout.uniform_dtype:
            raise ValueError(
                "no staged round for a mixed-dtype tree on the full wire "
                "(f32 staging would change the mixing arithmetic); "
                "use mix(), which falls back to the per-leaf circulant")
        flat = layout.flatten(X)
        B = None
        if self.codec.name == "moniqua":
            if theta is None:
                raise ValueError("MoniquaWire needs the a-priori bound theta")
            self._require_seed(seed)
            B = modulo.b_theta(theta, self.codec.spec.delta, flat.device)
        return RoundPlan(engine=self, layout=layout, chunks=layout.chunks(1),
                         flat=flat, B=B,
                         seed=kops.NO_KEY_SEED if seed is None else int(seed))

    def mix(self, X: PyTree, theta=None, seed: Optional[int] = None,
            ledger: Optional[BytesLedger] = None) -> MixResult:
        """One gossip round on stacked models (leaves ``[n, ...]``).

        ``.x`` of the result is ``X_{k+1/2}`` (with the full-precision codec
        exactly the circulant ``X W`` of ``gossip.mix``).  ``seed`` is the
        uint32 hash seed of stochastic rounding.  ``ledger`` (if given) is
        credited with payload-bytes * n_neighbors.
        """
        offsets = self.topo.neighbor_offsets()
        if not offsets or not tree.leaves(X):
            return MixResult(X)              # nothing on the wire
        if ledger is not None:
            self._record(X, ledger)
        if self.codec.name == "moniqua" and theta is None:
            raise ValueError("MoniquaWire needs the a-priori bound theta")
        layout = self.layout(X)
        full_mixed_dtype = (self.codec.name == "full"
                            and not layout.uniform_dtype)
        if self.path == "bucketed" and not full_mixed_dtype:
            return MixResult(layout.unflatten(
                self.round_plan(X, theta=theta, seed=seed).run()))
        if self.codec.name == "full":
            return MixResult(gossip.mix(X, self.topo))
        self._require_seed(seed)
        seed = kops.NO_KEY_SEED if seed is None else int(seed)
        leaves, td = tree.flatten(X)
        # global counter indices: leaf i's elements hash
        # (seed, layout.offset_i + e), the SAME pairs the bucketed
        # one-shot encode hashes — the bucketed-vs-per-leaf parity
        out = [self._mix_leaf(l, theta, seed, idx_base=layout.offsets[i])
               for i, l in enumerate(leaves)]
        return MixResult(tree.unflatten(td, out))

    def pair_average(self, xi: torch.Tensor, xj: torch.Tensor, theta=None,
                     seed: Optional[int] = None, presence=None) -> PairResult:
        """One gossip on edge (i, j) with the pair-averaging ``W_k``.

        ``full``: both endpoints take ``(x_i + x_j) / 2``.  ``moniqua``
        (Algorithm 3 lines 4-7): both payloads come from one encode launch
        of the stacked pair under the shared ``seed`` (the counter restarts
        per endpoint), and each endpoint decodes the other's payload
        against its own model (one remote point decode of the swapped
        payloads) and its own payload (one self point decode):
        ``x_i + (xhat_j - xhat_ii) / 2``.  The decodes run in float32, so
        a bfloat16 pair comes back in float32, as the reference promotes.
        """
        if presence is not None:
            raise NotImplementedError(
                "pair_average(presence=...) is not ported yet (ROADMAP.md, "
                "Queue 1 #9)")
        if self.codec.name == "full":
            avg = 0.5 * (xi + xj)
            return PairResult(avg, avg)
        if theta is None:
            raise ValueError("MoniquaWire needs the a-priori bound theta")
        self._require_seed(seed)
        spec = self.codec.spec
        x2 = torch.stack([xi, xj])
        B = modulo.b_theta(theta, spec.delta, x2.device)
        p2 = kops.moniqua_encode_stacked(
            x2, B, spec, kops.NO_KEY_SEED if seed is None else int(seed))
        y2 = x2.float()
        remote = kops.moniqua_decode_remote(p2.flip(0), y2, B, spec)
        own = kops.moniqua_decode_self(p2, y2, B, spec)
        out = x2 + 0.5 * (remote - own)
        return PairResult(out[0], out[1])

    # -- gossip building blocks of the replica-mixing baselines -------------
    def neighbor_sum(self, X: PyTree, transform) -> PyTree:
        """``sum_{o != 0} w_o * transform(roll(X, -o), o)`` leaf-wise."""
        return gossip.neighbor_sum(X, self.topo, transform)

    def self_weight(self) -> float:
        return gossip.self_weight(self.topo)

    def _mix_leaf(self, x: torch.Tensor, theta, seed: int,
                  idx_base: int = 0) -> torch.Tensor:
        if x.dim() == 1:     # scalar-per-worker leaf: give it a unit last axis
            return self._mix_leaf(x[:, None], theta, seed, idx_base)[:, 0]
        spec = self.codec.spec
        B = modulo.b_theta(theta, spec.delta, x.device)
        packed = kops.moniqua_encode_stacked(x, B, spec, seed,
                                             idx_base=idx_base)
        p_nbrs = torch.stack([gossip._roll(packed, o)
                              for o in self.topo.neighbor_offsets()])
        return kops.moniqua_decode_reduce_stacked(
            packed, p_nbrs, x, B, _neighbor_weights_of(self.topo), spec)

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
        if seed is None and self.codec.spec.stochastic:
            raise ValueError(
                "moniqua wire with stochastic rounding needs a seed "
                "(pass seed=, or use a nearest-rounding QuantSpec)")

    # -- accounting --------------------------------------------------------
    def payload_bytes_per_broadcast(self, X: PyTree) -> int:
        """Bytes one worker ships to ONE neighbor per round.  The vpb row
        alignment makes the bucketed Moniqua payload equal the per-leaf sum
        exactly, so the path never changes this number."""
        leaves = tree.leaves(X)
        if not leaves:
            return 0
        if self.path == "bucketed":
            layout = self.layout(X)
            if self.codec.name != "full" or layout.uniform_dtype:
                return self._staged_payload_bytes(layout)
        return sum(self.codec.payload_bytes(tuple(leaf.shape[1:]),
                                            leaf.element_size())
                   for leaf in leaves)

    def _staged_payload_bytes(self, layout: bucket.BucketLayout) -> int:
        """Whole-buffer payload on the bucketed path."""
        if self.codec.name == "full":
            itemsize = torch.empty((), dtype=layout.stage_dtype).element_size()
            return layout.total_elems * itemsize
        return layout.padded_elems // self.codec.spec.values_per_byte

    def bytes_per_round(self, X: PyTree) -> int:
        """Payload bytes *sent* per worker per gossip round (all leaves)."""
        return (self.payload_bytes_per_broadcast(X)
                * len(self.topo.neighbor_offsets()))

    def _record(self, X: PyTree, ledger: BytesLedger) -> None:
        ledger.add(self.payload_bytes_per_broadcast(X),
                   len(self.topo.neighbor_offsets()), tier="slow")
