"""Schema-versioned JSONL run logs (``repro.obs.runlog/v1``).

The port's copy of the reference's ``repro.obs.runlog``, with the same
schema string, so the reference's ``validate_records`` and
``tools/check_obs.py`` accept the port's logs and the port's
:func:`validate_records` accepts the reference's.

One JSON object per line.  The first record is always a ``header`` naming
the schema and the run configuration (including the theta policy, so a
report can plot the recorded per-round ``theta`` against it); subsequent
records are:

``step``    drained training metrics: ``{"kind": "step", "step": k,
            "wall_s": ..., "metrics": {"loss": ..., "theta": ...,
            "obs_headroom": ..., "obs_alias_count": ..., ...}}``
``span``    a host-side phase timing copied from a
            :class:`~repro_torch.obs.trace.SpanRecorder`
            (name/t0_s/dur_s/tid)
``event``   a one-off structured payload
``result``  final summary fields (bytes_per_step, steps, wall_s, ...)

Writer: ``train/trainer.py`` (``TrainerConfig.log_jsonl``).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

SCHEMA = "repro.obs.runlog/v1"
KINDS = ("header", "step", "span", "event", "result")


def _jsonable(v: Any) -> Any:
    """Coerce scalars (incl. numpy and torch 0-d values) to plain JSON
    types."""
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, int):
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class RunLogWriter:
    """Append-only JSONL writer; emits the schema header on open."""

    def __init__(self, path: str, run: Optional[Dict[str, Any]] = None,
                 tool: str = "trainer"):
        self.path = path
        self._f = open(path, "w")
        self._write({"kind": "header", "schema": SCHEMA, "tool": tool,
                     "run": {k: _jsonable(v)
                             for k, v in (run or {}).items()}})

    def _write(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def step(self, step: int, metrics: Dict[str, Any],
             wall_s: Optional[float] = None) -> None:
        rec: Dict[str, Any] = {"kind": "step", "step": int(step),
                               "metrics": {k: _jsonable(v)
                                           for k, v in metrics.items()}}
        if wall_s is not None:
            rec["wall_s"] = float(wall_s)
        self._write(rec)

    def span(self, name: str, t0_s: float, dur_s: float, tid: str = "host",
             args: Optional[Dict[str, Any]] = None) -> None:
        self._write({"kind": "span", "name": str(name),
                     "t0_s": float(t0_s), "dur_s": float(dur_s),
                     "tid": str(tid),
                     "args": {k: _jsonable(v)
                              for k, v in (args or {}).items()}})

    def spans_from(self, recorder) -> None:
        """Copy every span of a
        :class:`~repro_torch.obs.trace.SpanRecorder`."""
        for s in recorder.events:
            self.span(s["name"], s["t0_s"], s["dur_s"], s.get("tid", "host"),
                      s.get("args"))

    def event(self, name: str, args: Optional[Dict[str, Any]] = None) -> None:
        self._write({"kind": "event", "name": str(name),
                     "args": {k: _jsonable(v)
                              for k, v in (args or {}).items()}})

    def result(self, **fields: Any) -> None:
        self._write({"kind": "result",
                     **{k: _jsonable(v) for k, v in fields.items()}})

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "RunLogWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Reading + validation.
# ---------------------------------------------------------------------------

def read_runlog(path: str) -> List[Dict[str, Any]]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def validate_records(records: List[Dict[str, Any]]) -> List[str]:
    """Schema check; returns human-readable error strings (empty = valid)."""
    errors: List[str] = []
    if not records:
        return ["empty run log"]
    head = records[0]
    if not isinstance(head, dict) or head.get("kind") != "header":
        errors.append("first record is not a header")
    elif head.get("schema") != SCHEMA:
        errors.append(f"unknown schema {head.get('schema')!r} "
                      f"(expected {SCHEMA})")
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            errors.append(f"record {i}: not an object")
            continue
        kind = rec.get("kind")
        if kind not in KINDS:
            errors.append(f"record {i}: unknown kind {kind!r}")
            continue
        if kind == "header" and i != 0:
            errors.append(f"record {i}: duplicate header")
        if kind == "step":
            if not isinstance(rec.get("step"), int):
                errors.append(f"record {i}: step missing integer 'step'")
            m = rec.get("metrics")
            if not isinstance(m, dict):
                errors.append(f"record {i}: step missing 'metrics' object")
            else:
                for k, v in m.items():
                    if not isinstance(v, (int, float, str, bool,
                                          type(None))):
                        errors.append(
                            f"record {i}: metric {k!r} not JSON-scalar")
        if kind == "span":
            for fld in ("t0_s", "dur_s"):
                v = rec.get(fld)
                if not isinstance(v, (int, float)) or v < 0:
                    errors.append(f"record {i}: span {fld} invalid: {v!r}")
            if not isinstance(rec.get("name"), str):
                errors.append(f"record {i}: span missing 'name'")
        if kind == "event" and not isinstance(rec.get("name"), str):
            errors.append(f"record {i}: event missing 'name'")
    return errors


def validate_runlog(path: str) -> List[str]:
    try:
        records = read_runlog(path)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    return [f"{path}: {e}" for e in validate_records(records)]


def step_records(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [r for r in records if r.get("kind") == "step"]


def alias_events(records: List[Dict[str, Any]]) -> int:
    """Total modulo-alias events recorded in a run log.

    Prefers the cumulative ``obs_alias_total`` counter (exact even when
    only every ``log_every``-th round is drained); falls back to summing
    the per-round ``obs_alias_count`` of the logged steps.
    """
    steps = step_records(records)
    totals = [r["metrics"].get("obs_alias_total") for r in steps
              if isinstance(r.get("metrics"), dict)
              and r["metrics"].get("obs_alias_total") is not None]
    if totals:
        return int(max(totals))
    return int(sum(r["metrics"].get("obs_alias_count", 0) or 0
                   for r in steps if isinstance(r.get("metrics"), dict)))
