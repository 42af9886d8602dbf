"""Round-health metrics for decentralized gossip, on the round's device.

Plain PyTorch on values the communication round already has (the flat
staging buffer, the packed payload, the EF residual), so the telemetry is
*observational*: it adds reductions next to the mix but never feeds back
into it.  The mix output is bitwise the same with telemetry on or off, and
the health values are the same on either gossip path and at any chunk
count (they are read from the canonical flat buffer).  The reference
computes them in plain jnp too (``repro.obs.metrics``); nothing here runs a
kernel but the encode of the sentinel's payload.

The health dict (``round_health_zero`` fixes its keys and dtypes):

``consensus_inf``
    ``max_{o, elements} |x_i - x_{i+o}|_inf`` over the topology's neighbor
    offsets: the quantity Lemma 1's hypothesis bounds by ``theta``.
``headroom``
    ``consensus_inf / B`` with ``B = 2*theta/(1-2*delta)`` (Moniqua wire
    only; 0 otherwise).  Safe iff ``headroom < (1-2*delta)/2``.
``alias_count``
    the modulo **alias sentinel**: elements whose Lemma-1 recovered
    neighbor difference lands in the outer band ``|cmod(q*B - y, B)| >=
    theta`` (``kernels/moniqua_decode_reduce.py::alias_band_mask``).  Safe
    runs count exactly zero while ``consensus_inf < theta - delta*B`` (the
    guard band); a nonzero count means the theta budget is exhausted or
    violated.  Computed from the payload and the local reference only.
    Pinned to 0 for ``delta >= 1/4`` (1-bit nearest, 2-bit stochastic),
    where the guard band vanishes.
``alias_total``
    cumulative ``alias_count`` across rounds (the algorithm-level carry;
    see ``init_health`` / ``accumulate_health``).
``ef_residual_l2``
    ``||residual||_2`` of the post-round WireState (EF wires; 0 otherwise).
``warm``
    1.0 while the onebit wire is inside its full-precision warmup.
``bits_per_param``
    payload bits per model parameter shipped per neighbor; on a tiered
    engine the slow-axis (gossip-link) number.
``bytes_fast`` / ``bytes_slow``
    per-tier bytes one worker sends per round, ``BytesLedger``'s split.
``participation``
    fraction of gossip-tier workers present in the round.  Neutral value
    **1.0**, the one exception to "everything at zero" in
    ``round_health_zero``: a round with no mask had full participation.
``dropped_neighbors``
    directed gossip edges the round's presence mask killed; 0 for full
    presence.

Counts are int32, everything else float32, on the device of the inputs.

Under a worker split (``comm/workers.py``) each rank reads its block of
rows; the maxima and the alias count are reduced over the ranks
(``workers.all_max`` / ``all_sum``), so every rank reports the
single-process value, bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.comm import gossip, workers
from repro_torch.core import modulo
from repro_torch.core.quantizers import QuantSpec

HEALTH_ROUND_KEYS = ("consensus_inf", "headroom", "alias_count",
                     "ef_residual_l2", "warm", "bits_per_param",
                     "bytes_fast", "bytes_slow", "participation",
                     "dropped_neighbors")
HEALTH_KEYS = HEALTH_ROUND_KEYS + ("alias_total",)


def scalar_f32(value: float, device) -> torch.Tensor:
    """A 0-dim float32 on ``device``, filled by a kernel (a copy of a host
    value to the card would wait for it)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def scalar_i32(value: int, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int32, device=device)


def f32_on(value, device) -> torch.Tensor:
    """``value`` (a number or a tensor) as a 0-dim float32 on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return scalar_f32(value, device)


def round_health_zero(device=None) -> Dict[str, torch.Tensor]:
    """Engine-level health dict with every counter at zero on ``device``
    (``participation`` at its neutral 1.0)."""
    z = scalar_f32(0.0, device)
    return {"consensus_inf": z, "headroom": z,
            "alias_count": scalar_i32(0, device),
            "ef_residual_l2": z, "warm": z, "bits_per_param": z,
            "bytes_fast": z, "bytes_slow": z,
            "participation": scalar_f32(1.0, device),
            "dropped_neighbors": scalar_i32(0, device)}


def init_health(device=None) -> Dict[str, torch.Tensor]:
    """Algorithm-level carry: the round dict plus the cumulative alias
    counter (``accumulate_health`` folds each round into it)."""
    h = round_health_zero(device)
    h["alias_total"] = scalar_i32(0, device)
    return h


def accumulate_health(prev: Dict[str, torch.Tensor],
                      round_h: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """New carry: this round's values, cumulative alias count threaded."""
    out = dict(round_h)
    out["alias_total"] = prev["alias_total"] + round_h["alias_count"]
    return out


# ---------------------------------------------------------------------------
# Consensus distance.
# ---------------------------------------------------------------------------

def consensus_inf(flat: torch.Tensor, offsets: Sequence[int]
                  ) -> torch.Tensor:
    """``max_o max_elements |x_i - x_{i+o}|`` on the stacked flat buffer."""
    x = flat.float()
    m = scalar_f32(0.0, x.device)
    for o in offsets:
        m = torch.maximum(m, torch.max(torch.abs(x - gossip._roll(x, o))))
    return workers.all_max(m)


def consensus_inf_segments(flat: torch.Tensor, offsets: Sequence[int],
                           segments: Sequence[int]) -> torch.Tensor:
    """Per-segment ``|x_i - x_j|_inf`` maxima, shape ``[num_segments]``;
    their max is :func:`consensus_inf`."""
    x = flat.float()
    d = torch.zeros_like(x)
    for o in offsets:
        d = torch.maximum(d, torch.abs(x - gossip._roll(x, o)))
    out, off = [], 0
    for s in segments:
        out.append(torch.max(d[:, off:off + s]))
        off += s
    return workers.all_max(torch.stack(out))


# ---------------------------------------------------------------------------
# The modulo alias sentinel.
# ---------------------------------------------------------------------------

def moniqua_alias_count(packed: torch.Tensor, flat: torch.Tensor, B, theta,
                        spec: QuantSpec, offsets: Sequence[int]
                        ) -> torch.Tensor:
    """Alias-band elements summed over every neighbor payload of the round.

    ``packed`` is the stacked wire payload (``[n, D/vpb]`` uint8, exactly
    what the round's encode produced), ``flat`` the local references the
    receivers decode against.  Each neighbor's payload is dequantized with
    the kernels' shared math and tested against the outer-band predicate
    (``kernels/moniqua_decode_reduce.py::alias_band_mask``).  Pinned to 0
    for ``spec.delta >= 1/4``, where quantization alone spans the band.
    """
    from repro_torch.kernels import moniqua_decode_reduce as _dr
    if spec.delta >= 0.25:          # no payload-only margin at this width
        return scalar_i32(0, flat.device)
    y = flat.float()
    count = scalar_i32(0, y.device)
    for o in offsets:
        qb = _dr.unpack_values(gossip._roll(packed, o), spec.bits, B)
        mask = _dr.alias_band_mask(qb, y, B, theta)
        count = count + torch.sum(mask, dtype=torch.int32)
    return workers.all_sum(count)


# ---------------------------------------------------------------------------
# AD-PSGD pair exchanges.
# ---------------------------------------------------------------------------

def pair_health(xi: torch.Tensor, xj: torch.Tensor, theta=None,
                spec: Optional[QuantSpec] = None,
                seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Health of one edge exchange: pre-round models of the two endpoints.

    With a Moniqua ``spec`` the payloads are re-encoded under the exchange
    seed (the bits ``CommEngine.pair_average`` ships: same encode, same
    seed, the counter restarting per endpoint), one encode launch an
    endpoint, and the alias band is tested in both decode directions;
    without one only the consensus distance is meaningful.  Returns the
    keys of ``round_health_zero``.
    """
    from repro_torch.kernels import moniqua_decode_reduce as _dr
    from repro_torch.kernels import ops as kops
    fi = xi.float()
    fj = xj.float()
    h = round_health_zero(fi.device)
    h["consensus_inf"] = torch.max(torch.abs(fi - fj))
    if spec is None or theta is None:
        return h
    theta = f32_on(theta, fi.device)
    B = modulo.b_theta(theta, spec.delta)
    h["headroom"] = h["consensus_inf"] / B
    if spec.delta < 0.25:   # guard band exists (see moniqua_alias_count)
        seed = kops.NO_KEY_SEED if seed is None else int(seed)
        n_last = xi.shape[-1] if xi.dim() else 1

        def value(x):
            x2 = x.reshape(1, -1, n_last)
            p = kops.moniqua_encode_stacked(x2, B, spec, seed)
            return _dr.unpack_values(p, spec.bits, B)[..., :n_last] \
                .reshape(x.shape)

        qi, qj = value(xi), value(xj)
        h["alias_count"] = (
            torch.sum(_dr.alias_band_mask(qj, fi, B, theta),
                      dtype=torch.int32)
            + torch.sum(_dr.alias_band_mask(qi, fj, B, theta),
                        dtype=torch.int32))
    h["bits_per_param"] = scalar_f32(float(spec.bits), fi.device)
    return h
