"""Phase labels, host-side spans and Chrome-trace JSON export.

Two timing domains, one file format:

* **On the card** — the engine wraps encode / permute / decode-reduce /
  intra-reduce and the round's telemetry in ``torch.profiler``
  ``record_function`` labels (``comm.encode``, ``comm.encode/chunk03of08``,
  ...), so a ``torch.profiler`` trace attributes the device time of each
  phase.  A ``record_function`` costs host time on every entry even with
  no profiler attached (~12 µs a label on the H100 machine, ``PERF.md``),
  so a phase label is entered only while a profiler is recording.  Labels
  never change the math.
* **On the host** — :class:`SpanRecorder` is a zero-dependency span
  recorder (``with rec.span("step", tid="train"): ...``) whose events
  export to the Chrome trace event format (``ph: "X"`` complete events,
  microsecond timestamps) that Perfetto / ``chrome://tracing`` open
  directly.

:func:`sim_trace_to_chrome` renders a ``repro_torch.sim`` event timeline
(:class:`~repro_torch.sim.events.SimTrace`) in the same format: one track
per worker (plus a barrier track for sync rounds), each event drawn as a
span from the worker's previous event to its timestamp.  Measured runs and
simulator predictions use distinct ``pid``s, so :func:`merge_chrome_traces`
puts them side by side in one Perfetto view.

The file formats (``TRACE_SCHEMA``, the event layout) are the reference's
(``repro.obs.trace``), so either package's tools read either's traces.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, Iterable, List, Optional

import torch

TRACE_SCHEMA = "repro.obs.trace/v1"

# the labels CommEngine.mix uses for the phases of one round
COMM_PHASES = ("comm.encode", "comm.permute", "comm.decode_reduce",
               "comm.telemetry")


def labels_on() -> bool:
    """Whether :func:`named_phase` enters a ``record_function`` now: while
    a profiler is recording."""
    return torch._C._autograd._profiler_enabled()


def named_phase(name: str):
    """``torch.profiler.record_function(name)`` for a gossip phase while a
    profiler records, else a no-op context."""
    if labels_on():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def chunk_phase(phase: str, chunk: Optional[int] = None,
                total: Optional[int] = None):
    """Label for one phase of one *chunk* of a staged gossip round.

    A chunk-pipelined round (``CommEngine.round_plan``) runs each phase K
    times; labelling them ``comm.encode/chunk03of08`` keeps the base
    ``COMM_PHASES`` name as a prefix (phase-based tooling still aggregates
    by prefix) while the profiler timeline shows the skewed
    encode(i+1)/permute(i)/decode(i-1) ladder span by span.  A barrier
    round (``chunk=None`` or a single chunk) keeps the plain phase label.
    """
    if chunk is None or (total or 0) <= 1:
        return named_phase(phase)
    suffix = (f"chunk{chunk:02d}of{total:02d}" if total is not None
              else f"chunk{chunk:02d}")
    return named_phase(f"{phase}/{suffix}")


def trace_annotation(name: str):
    """A host-side profiler label (``record_function``), always entered."""
    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# Host-side span recorder.
# ---------------------------------------------------------------------------

class SpanRecorder:
    """Lightweight wall-clock span recorder (``time.perf_counter`` based).

    Spans are dicts ``{name, t0_s, dur_s, tid, args}`` with times relative
    to the recorder's creation; ``to_chrome`` / ``save`` export them as a
    Chrome trace, and ``repro_torch.obs.runlog.RunLogWriter.spans_from``
    copies them into a JSONL run log.
    """

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    @contextlib.contextmanager
    def span(self, name: str, tid: str = "host", **args):
        t0 = self.now()
        try:
            yield
        finally:
            self.events.append({"name": name, "t0_s": t0,
                                "dur_s": self.now() - t0, "tid": tid,
                                "args": dict(args)})

    def instant(self, name: str, tid: str = "host", **args) -> None:
        self.events.append({"name": name, "t0_s": self.now(), "dur_s": 0.0,
                            "tid": tid, "args": dict(args),
                            "instant": True})

    def to_chrome(self, pid: int = 0, process_name: str = "measured"
                  ) -> Dict[str, Any]:
        return chrome_trace(self.events, pid=pid, process_name=process_name)

    def save(self, path: str, pid: int = 0,
             process_name: str = "measured") -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(pid, process_name), f)
        return path


# ---------------------------------------------------------------------------
# Chrome trace event format.
# ---------------------------------------------------------------------------

def chrome_trace(spans: Iterable[Dict[str, Any]], pid: int = 0,
                 process_name: str = "measured") -> Dict[str, Any]:
    """Span dicts -> Chrome trace JSON (object form, ``traceEvents`` list).

    Times are seconds in; the Chrome format wants microseconds.  Spans with
    ``instant: True`` (or zero duration) become ``ph: "i"`` instant
    events; everything else is a ``ph: "X"`` complete event.
    """
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": process_name}}]
    tids: Dict[str, int] = {}
    for s in spans:
        tid = tids.setdefault(str(s.get("tid", "host")), len(tids))
        ev: Dict[str, Any] = {"name": str(s["name"]), "pid": pid, "tid": tid,
                              "ts": float(s["t0_s"]) * 1e6,
                              "args": dict(s.get("args") or {})}
        if s.get("instant") or float(s.get("dur_s") or 0.0) <= 0.0:
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=float(s["dur_s"]) * 1e6)
        events.append(ev)
    for name, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA}}


def merge_chrome_traces(traces: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Concatenate trace objects (keep their distinct pids) into one view."""
    events: List[Dict[str, Any]] = []
    for t in traces:
        events.extend(t.get("traceEvents", []))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA}}


def validate_chrome(obj: Any) -> List[str]:
    """Structural check of a Chrome trace object; returns error strings."""
    errors: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["not a Chrome trace object (missing traceEvents)"]
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            errors.append(f"event {i}: missing ph/name")
            continue
        if ev["ph"] in ("X", "i"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errors.append(f"event {i} ({ev['name']}): bad ts {ts!r}")
            if ev["ph"] == "X":
                dur = ev.get("dur")
                if not isinstance(dur, (int, float)) or dur < 0:
                    errors.append(
                        f"event {i} ({ev['name']}): bad dur {dur!r}")
    return errors


def save_chrome_trace(obj: Dict[str, Any], path: str) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


# ---------------------------------------------------------------------------
# Simulator timelines in the same format.
# ---------------------------------------------------------------------------

def sim_trace_to_chrome(trace, pid: int = 1, process_name: str = "sim"
                        ) -> Dict[str, Any]:
    """Render a :class:`~repro_torch.sim.events.SimTrace` as a Chrome trace.

    Track layout: one tid per worker, plus a ``barrier`` track for the
    sync-round events (``worker == -1``).  Each event becomes a span from
    the track's previous event time to the event's timestamp — compute
    spans start at the worker's last round/update, transfer spans show the
    sender's NIC serialization, round spans the barrier wait.  Zero-length
    events render as instants.  ``args`` carry peer/step/nbytes so
    Perfetto's selection panel shows the payload.
    """
    spans: List[Dict[str, Any]] = []
    cursor: Dict[str, float] = {}
    for e in sorted(trace.events, key=lambda e: (e.t, e.kind, e.worker)):
        tid = "barrier" if e.worker < 0 else f"worker {e.worker}"
        t0 = cursor.get(tid, 0.0)
        dur = max(e.t - t0, 0.0)
        args: Dict[str, Any] = {"step": e.step}
        if e.peer >= 0:
            args["peer"] = e.peer
        if e.nbytes:
            args["nbytes"] = e.nbytes
        spans.append({"name": e.kind, "t0_s": min(t0, e.t), "dur_s": dur,
                      "tid": tid, "args": args, "instant": dur <= 0.0})
        cursor[tid] = e.t
    return chrome_trace(spans, pid=pid, process_name=process_name)
