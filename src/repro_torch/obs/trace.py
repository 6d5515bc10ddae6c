"""Task-lifecycle span tracing with an injectable clock.

Every task's journey through the runtime is stamped as a chain of lifecycle
events on one trace record::

    submitted -> queued -> granted -> dispatched -> device -> completed
                                   (or: failed / canceled / preempted,
                                    with retried -> queued loops in between)

The executor owns the instrumentation points; protocols and payloads never
see the tracer. Records are plain dicts, linked three ways:

* task -> dispatch: a fused (coalesced) device batch gets its own dispatch
  span; every member row records the dispatch id it ran in (``dispatches``
  list — retries can put one task in several), and the dispatch records its
  member uids. A coalesced row is thus attributable to its origin pipeline
  (``pipeline``/``protocol`` on the task record) AND its fused batch.
* task -> task: trainer preempt/resume chains (``resumed_from``) and
  straggler duplicates (``speculative_of``) keep provenance across task
  objects.
* grant -> devices: every allocator grant is a span over the flat device
  indices it covered — the device-track timeline of the Perfetto export.

The clock is injected (``now_fn``, default ``time.monotonic``) so span
tests are deterministic against a fake clock, and so tasks, grants, and
dispatches share one timebase with the scheduler's fairness clock.

A disabled tracer (``enabled=False``, the default for bare executors) turns
every method into an early-out no-op — call sites stay unconditional and
the untraced hot path pays one attribute load + one branch per event.

A copy of the JAX package's ``repro.obs.trace`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# canonical lifecycle event names (the export's span phases)
LIFECYCLE = ("submitted", "queued", "granted", "dispatched", "completed",
             "failed", "canceled", "preempted", "retried")


class Tracer:
    def __init__(self, now_fn: Optional[Callable[[], float]] = None,
                 enabled: bool = True):
        self.now = now_fn if now_fn is not None else time.monotonic
        self.enabled = bool(enabled)
        self.t0 = self.now()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.tasks: Dict[int, dict] = {}       # task uid -> trace record
        self.dispatches: List[dict] = []       # fused-batch spans
        self.grants: List[dict] = []           # device-grant spans
        self._open_grants: Dict[int, dict] = {}  # submesh uid -> span

    # -- task lifecycle ----------------------------------------------------

    def task_submitted(self, task) -> None:
        """Open a task's trace record (executor ``submit``). The record is
        also attached to the task itself (``task.trace``) so downstream
        layers — coordinator routing, trainer resume — can annotate it
        without holding a tracer reference."""
        if not self.enabled:
            return
        rec = {"uid": task.uid, "kind": task.kind, "stage": task.stage,
               "band": task.band, "pipeline": task.pipeline_id,
               "preemptible": bool(task.preemptible),
               "speculative_of": task.speculative_of,
               "events": [("submitted", self.now())],
               "dispatches": []}
        task.trace = rec
        with self._lock:
            self.tasks[task.uid] = rec

    def mark(self, task, event: str, **extra: Any) -> None:
        """Append one lifecycle event to a task's trace (no-op for tasks
        submitted while the tracer was disabled)."""
        if not self.enabled:
            return
        rec = getattr(task, "trace", None)
        if rec is None:
            return
        rec["events"].append((event, self.now()))
        if extra:
            rec.update(extra)

    def mark_all(self, tasks, event: str) -> None:
        if not self.enabled:
            return
        t = self.now()
        for task in tasks:
            rec = getattr(task, "trace", None)
            if rec is not None:
                rec["events"].append((event, t))

    # -- fused dispatches --------------------------------------------------

    def dispatch_begin(self, leader, members, sub) -> Optional[dict]:
        """Open a fused-batch span: one per worker dispatch, covering every
        member row (coalesced + live-admitted). Returns the span record, or
        None when disabled."""
        if not self.enabled:
            return None
        span = {"id": next(self._ids), "kind": leader.kind,
                "stage": leader.stage, "band": leader.band,
                "submesh": sub.uid, "n_devices": sub.n_devices,
                "start": self.now(), "end": None,
                "members": [], "rows": 0, "status": None}
        self._link_members(span, members)
        with self._lock:
            self.dispatches.append(span)
        return span

    def _link_members(self, span: dict, members) -> None:
        for m in members:
            rec = getattr(m, "trace", None)
            if rec is not None and span["id"] not in rec["dispatches"]:
                rec["dispatches"].append(span["id"])
        span["members"].extend(m.uid for m in members
                               if m.uid not in span["members"])

    def dispatch_admit(self, span: Optional[dict], members) -> None:
        """Link live-admitted members into an already-open dispatch span."""
        if not self.enabled or span is None:
            return
        self._link_members(span, members)

    def dispatch_end(self, span: Optional[dict], status: str,
                     rows: int = 0) -> None:
        if not self.enabled or span is None:
            return
        span["end"] = self.now()
        span["status"] = status
        span["rows"] = int(rows)

    # -- device grants -----------------------------------------------------

    def grant_begin(self, sub, stage: Optional[str],
                    device_indices: List[int]) -> None:
        """Open a grant span: a sub-mesh carved for one dispatch, covering
        ``device_indices`` (flat positions in the allocator grid) — the
        per-device utilization timeline."""
        if not self.enabled:
            return
        span = {"submesh": sub.uid, "stage": stage,
                "n_devices": sub.n_devices,
                "devices": list(device_indices),
                "start": self.now(), "end": None}
        with self._lock:
            self._open_grants[sub.uid] = span
            self.grants.append(span)

    def grant_end(self, sub) -> None:
        if not self.enabled:
            return
        with self._lock:
            span = self._open_grants.pop(sub.uid, None)
        if span is not None:
            span["end"] = self.now()

    # -- views -------------------------------------------------------------

    def task_records(self) -> List[dict]:
        with self._lock:
            return list(self.tasks.values())

    def dispatch_records(self) -> List[dict]:
        with self._lock:
            return list(self.dispatches)

    def grant_records(self) -> List[dict]:
        with self._lock:
            return list(self.grants)

    def counts(self) -> dict:
        """Span tallies for report sections."""
        with self._lock:
            return {"tasks": len(self.tasks),
                    "dispatches": len(self.dispatches),
                    "grants": len(self.grants)}


class Telemetry:
    """The observability bundle the session threads through the runtime:
    one metrics registry (always on), one tracer (opt-in), one clock shared
    by both — so queue fairness, span timestamps, and grant timelines agree
    on what "now" means."""

    def __init__(self, registry=None, tracer: Optional[Tracer] = None,
                 now_fn: Optional[Callable[[], float]] = None):
        from repro_torch.obs.metrics import MetricsRegistry
        if tracer is not None and now_fn is None:
            now_fn = tracer.now
        self.now = now_fn if now_fn is not None else time.monotonic
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(
            now_fn=self.now, enabled=False)
