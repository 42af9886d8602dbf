"""Self-calibration: fit ``(alpha, beta)`` links from measured transfer times.

The scenario catalog's link constants are datasheet ballparks.  This module
closes the loop the ROADMAP opened: fit the alpha-beta model

    T(nbytes) = alpha + nbytes / beta

to *measured* (bytes, seconds) samples by ordinary least squares — the
model is linear in ``(alpha, 1/beta)``, so the fit is the closed-form
simple regression (no numpy, matching the pure-float discipline of
``repro_torch.sim``):

    slope     = cov(bytes, seconds) / var(bytes)        # = 1 / beta
    intercept = mean(seconds) - slope * mean(bytes)     # = alpha

Samples come from two places, mirroring the depth-probe fit pattern in
``launch/calibrate.py`` (probe a cheap observable twice, extrapolate the
model):

* :func:`samples_from_walltime` — the ``codec_table`` rows of
  ``benchmarks/bench_walltime.py`` sweep 6 wire codecs over the same
  payload, giving 6 (wire bytes, step seconds) probes per network column;
  subtracting the known compute + measured mix time leaves pure transfer
  time, and the fit recovers the column's bandwidth and latency;
* synthetic traces in tests (:func:`synthetic_samples`), where the
  round-trip contract is enforced: fitting on times generated by
  ``alpha + n/beta`` recovers both parameters within 5% even under
  deterministic jitter.

:func:`fit_network` lifts per-offset sample groups into a full
:class:`~repro_torch.sim.network.NetworkModel` (offsets fitted separately, the
pooled fit as default), and the CLI emits it as JSON the scenario catalog
loads back (``scenarios.calibrated_from_bench`` /
``NetworkModel.from_dict``):

    PYTHONPATH=src python -m repro_torch.sim.calibrate \\
        --walltime BENCH_walltime.json --network 100Mbps-5ms \\
        --out netmodel.json
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.sim.network import LinkModel, NetworkModel, sim_uniform

# sample = (nbytes, measured_seconds)
Sample = Tuple[float, float]

# stream tag for synthetic measurement noise (independent of sim streams)
STREAM_CAL = 0xCA11


@dataclasses.dataclass(frozen=True)
class LinkFit:
    """One fitted link plus goodness-of-fit diagnostics."""
    alpha_s: float
    beta_Bps: float
    r2: float
    n_samples: int

    def link(self, jitter_s: float = 0.0) -> LinkModel:
        return LinkModel(alpha_s=self.alpha_s, beta_Bps=self.beta_Bps,
                         jitter_s=jitter_s)


def fit_link(samples: Sequence[Sample]) -> LinkFit:
    """OLS fit of ``T = alpha + nbytes / beta`` on (bytes, seconds) pairs.

    Needs >= 2 distinct payload sizes; raises if the times do not grow
    with bytes (slope <= 0 means the data cannot identify a bandwidth).
    The intercept is floored at 0: latency cannot be negative, and small
    negative intercepts are fit noise on bandwidth-dominated samples.
    """
    if len(samples) < 2:
        raise ValueError(f"need >= 2 samples to fit, got {len(samples)}")
    xs = [float(b) for b, _ in samples]
    ys = [float(t) for _, t in samples]
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx == 0.0:
        raise ValueError("all samples share one payload size; "
                         "alpha and beta are not identifiable")
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    slope = sxy / sxx
    if slope <= 0.0:
        raise ValueError(
            f"transfer times do not grow with bytes (slope={slope:.3e}); "
            "cannot fit a bandwidth")
    alpha = max(my - slope * mx, 0.0)
    syy = sum((y - my) ** 2 for y in ys)
    if syy > 0.0:
        resid = sum((y - (alpha + slope * x)) ** 2
                    for x, y in zip(xs, ys))
        r2 = 1.0 - resid / syy
    else:
        r2 = 1.0
    return LinkFit(alpha_s=alpha, beta_Bps=1.0 / slope, r2=r2, n_samples=n)


def fit_network(samples_by_offset: Mapping[Optional[int], Sequence[Sample]],
                jitter_s: float = 0.0) -> NetworkModel:
    """Fit one link per hop-distance group; the pooled fit is the default.

    ``samples_by_offset`` keys are topology hop distances (as in
    ``NetworkModel.per_offset``); the ``None`` key, if present, feeds only
    the default link.  This is how a heterogeneous WAN calibrates: probe
    each hop class separately, pool everything for unmatched edges.
    """
    pooled: List[Sample] = []
    for ss in samples_by_offset.values():
        pooled.extend(ss)
    default = fit_link(pooled).link(jitter_s)
    per_offset = {
        int(o): fit_link(ss).link(jitter_s)
        for o, ss in samples_by_offset.items() if o is not None}
    net = NetworkModel(default)
    if per_offset:
        net = net.with_offset_links(per_offset)
    return net


def synthetic_samples(alpha_s: float, beta_Bps: float,
                      sizes: Sequence[int], jitter_s: float = 0.0,
                      seed: int = 0) -> List[Sample]:
    """Deterministic ``alpha + n/beta (+ jitter*u)`` probe measurements."""
    lm = LinkModel(alpha_s=alpha_s, beta_Bps=beta_Bps, jitter_s=jitter_s)
    return [(float(nb), lm.transfer_seconds(nb, sim_uniform(seed, STREAM_CAL,
                                                            k)))
            for k, nb in enumerate(sizes)]


# ---------------------------------------------------------------------------
# Calibrating from bench_walltime measurements.
# ---------------------------------------------------------------------------

def samples_from_walltime(result: Mapping, network: str,
                          compute_s: float = 0.05) -> List[Sample]:
    """(wire bytes, transfer seconds) probes from a bench_walltime result.

    Each ``codec_table`` row measured one codec's jitted mix time and
    modeled its step time on the named network column; subtracting the
    known compute term and the row's own measured mix time leaves the pure
    network time for that codec's exact wire bytes — one calibration probe
    per codec.
    """
    col = f"s/step {network}"
    rows = result.get("codec_table", [])
    samples: List[Sample] = []
    for r in rows:
        if col not in r:
            continue
        mix_s = float(r.get("mix_ms_measured", 0.0)) / 1e3
        t = float(r[col]) - compute_s - mix_s
        samples.append((float(r["wire_bytes_per_step"]), t))
    if len(samples) < 2:
        raise ValueError(
            f"no usable codec_table rows for network {network!r}")
    return samples


def calibrate_from_walltime(result: Mapping, network: str,
                            compute_s: float = 0.05) -> LinkFit:
    """Fit the effective per-round link of one bench_walltime network."""
    return fit_link(samples_from_walltime(result, network, compute_s))


def save_network_model(net: NetworkModel, path: str,
                       meta: Optional[Dict] = None) -> None:
    doc = {"network_model": net.to_dict(), "meta": meta or {}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)


def load_network_model(path: str) -> NetworkModel:
    with open(path) as f:
        doc = json.load(f)
    return NetworkModel.from_dict(doc["network_model"])


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--walltime", required=True,
                    help="bench_walltime result JSON (run() output)")
    ap.add_argument("--network", required=True,
                    help="network column to calibrate, e.g. 100Mbps-5ms")
    ap.add_argument("--compute-s", type=float, default=0.05,
                    help="per-step compute seconds to subtract")
    ap.add_argument("--out", default=None,
                    help="write the fitted NetworkModel JSON here")
    args = ap.parse_args(argv)
    with open(args.walltime) as f:
        result = json.load(f)
    fit = calibrate_from_walltime(result, args.network, args.compute_s)
    print(f"fit {args.network}: alpha={fit.alpha_s*1e3:.3f}ms "
          f"beta={fit.beta_Bps/1e6:.2f}MB/s r2={fit.r2:.4f} "
          f"({fit.n_samples} probes)")
    if args.out:
        save_network_model(
            NetworkModel(fit.link()), args.out,
            meta={"source": args.walltime, "network": args.network,
                  "compute_s": args.compute_s, "r2": fit.r2})
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
