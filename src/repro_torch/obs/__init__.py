"""Unified observability layer (dependency-free): lifecycle span tracing,
a metrics registry, and Perfetto/JSON export.

Three pillars, consumed by the runtime (executor/allocator/scheduler), the
coordinator and the payload:

* ``trace`` — ``Tracer`` stamps every task with lifecycle spans
  (submitted -> queued -> granted -> dispatched -> device -> completed/
  preempted/retried), links coalesced rows to their fused-batch span, and
  records device-grant timelines; ``Telemetry`` bundles tracer + metrics +
  one injectable clock.
* ``metrics`` — ``MetricsRegistry`` of counters/gauges/streaming
  histograms (p50/p95/max without storing samples); the executor/
  allocator/scheduler stat sections are rebuilt on it.
* ``export`` — Chrome/Perfetto ``trace_event`` JSON (device, stage-band,
  task-kind, and protocol tracks) + flat metrics JSON; ``torchwatch`` adds
  kernel-build and first-call series.

A copy of the JAX package's ``repro.obs`` package, with ``torchwatch`` in
place of ``jaxwatch``.
"""

from repro_torch.obs.export import (trace_events, validate_trace,
                                    write_metrics, write_trace)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, aggregate_snapshot)
from repro_torch.obs.torchwatch import CompileWatcher
from repro_torch.obs.trace import LIFECYCLE, Telemetry, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "aggregate_snapshot", "CompileWatcher", "LIFECYCLE", "Telemetry",
    "Tracer", "trace_events", "validate_trace", "write_metrics",
    "write_trace",
]
