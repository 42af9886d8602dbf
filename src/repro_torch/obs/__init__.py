"""repro_torch.obs: observability for modulo-quantized decentralized SGD.

The port's counterpart of ``repro.obs``, in three layers:

* :mod:`repro_torch.obs.metrics` — round-health counters on the round's
  device (consensus inf-distance, theta headroom, the modulo **alias
  sentinel**, EF residual norms, payload bits/param).  Computed inside
  ``CommEngine.mix`` when the engine's ``telemetry`` flag is set, carried
  under ``extra["health"]``, drained with the rest of the metrics at
  ``log_every``.  Purely observational: the mix output is bitwise the same
  with telemetry on or off.
* :mod:`repro_torch.obs.trace` — the engine's phase labels
  (``torch.profiler.record_function``), a host-side span recorder and
  Chrome-trace JSON export, plus the converter that renders a
  ``repro_torch.sim`` timeline in the same format.
* :mod:`repro_torch.obs.runlog` — schema-versioned JSONL run logs
  (``repro.obs.runlog/v1``, the reference's schema) written by the trainer.
"""
from repro_torch.obs import metrics, runlog, trace  # noqa: F401
