"""Trace/metrics export: Chrome/Perfetto ``trace_event`` JSON + flat
metrics JSON.

``write_trace`` serializes a ``Tracer``'s records into the trace-event
format both ``chrome://tracing`` and https://ui.perfetto.dev load:

* **device tracks** (pid 1): one track per flat device index; every
  allocator grant paints a complete ("X") slice on each device it covered,
  named by the stage it served — the device-grant utilization timeline.
* **stage-band tracks** (pid 2): one track per scheduler band; every fused
  dispatch is an async ("b"/"e") span named by task kind, with member
  uids/rows in its args.
* **task tracks** (pid 3): one track per task kind; every task is a nested
  async span chain — the outer span runs submitted -> terminal, with inner
  ``queued`` / ``granted`` / ``device`` phase spans — so a task's full
  lifecycle reads as one stacked timeline row.
* **protocol tracks** (pid 4): tasks grouped by the protocol binding the
  coordinator routed them through (multi-tenant attribution).
* **flow arrows**: each dispatch emits an "s"/"f" flow per member from the
  dispatch span to the member's device phase, so a coalesced row is
  visually attributable to its fused batch.

Timestamps are microseconds relative to the earliest event (the tracer's
monotonic clock has no epoch).

``write_metrics`` dumps a registry snapshot (flat ``name{labels}`` keys)
next to the trace. ``validate_trace`` is the parse-and-sanity-check used
by tests and the CI trace smoke (``tools/check_trace.py``).

A copy of the JAX package's ``repro.obs.export`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from repro_torch.obs.trace import Tracer

_PID_DEVICES, _PID_BANDS, _PID_TASKS, _PID_PROTOCOLS = 1, 2, 3, 4

# lifecycle phases drawn as inner spans on the task track, as
# (span name, start event, events that close it)
_PHASES = (
    ("queued", "queued", ("granted", "canceled", "failed")),
    ("granted", "granted", ("dispatched",)),
    ("device", "dispatched", ("completed", "failed", "canceled",
                              "preempted")),
)

_TERMINAL = ("completed", "failed", "canceled", "preempted")


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[dict]:
    evs = [{"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}]
    if tid is not None:
        evs.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": tname}})
    return evs


def trace_events(tracer: Tracer) -> List[dict]:
    """The tracer's records as a trace-event list (see module docstring)."""
    tasks = tracer.task_records()
    dispatches = tracer.dispatch_records()
    grants = tracer.grant_records()
    times = ([t for r in tasks for _, t in r["events"]]
             + [g["start"] for g in grants]
             + [d["start"] for d in dispatches])
    if not times:
        return []
    t0 = min(times)
    now = tracer.now()

    def us(t: float) -> float:
        return (t - t0) * 1e6

    events: List[dict] = []
    events += _meta(_PID_DEVICES, "devices")
    events += _meta(_PID_BANDS, "stage bands")
    events += _meta(_PID_TASKS, "tasks")
    events += _meta(_PID_PROTOCOLS, "protocols")

    # device tracks: one X slice per (grant, device)
    seen_dev = set()
    for g in grants:
        end = g["end"] if g["end"] is not None else now
        for d in g["devices"]:
            if d not in seen_dev:
                seen_dev.add(d)
                events += _meta(_PID_DEVICES, "devices", tid=d,
                                tname=f"device {d}")[1:]
            events.append({
                "ph": "X", "pid": _PID_DEVICES, "tid": d, "cat": "grant",
                "name": g["stage"] or "grant", "ts": us(g["start"]),
                "dur": max(0.0, us(end) - us(g["start"])),
                "args": {"submesh": g["submesh"],
                         "n_devices": g["n_devices"]}})

    # stage-band tracks: async span per fused dispatch + flow sources
    seen_band = set()
    for d in dispatches:
        band = int(d["band"])
        if band not in seen_band:
            seen_band.add(band)
            events += _meta(_PID_BANDS, "stage bands", tid=band,
                            tname=f"band {band}"
                                  + (f" ({d['stage']})" if d["stage"]
                                     else ""))[1:]
        end = d["end"] if d["end"] is not None else now
        args = {"dispatch": d["id"], "members": d["members"],
                "rows": d["rows"], "stage": d["stage"],
                "n_devices": d["n_devices"], "status": d["status"]}
        common = {"pid": _PID_BANDS, "tid": band, "cat": "dispatch",
                  "id": d["id"], "name": d["kind"]}
        events.append(dict(common, ph="b", ts=us(d["start"]), args=args))
        events.append(dict(common, ph="e", ts=us(end)))
        for uid in d["members"]:
            events.append({"ph": "s", "pid": _PID_BANDS, "tid": band,
                           "cat": "coalesce", "name": "member",
                           "id": d["id"] * 1000000 + uid,
                           "ts": us(d["start"])})

    # task + protocol tracks: nested async span chain per task
    kind_tids: Dict[str, int] = {}
    proto_tids: Dict[str, int] = {}
    for r in tasks:
        evs = dict()
        for name, t in r["events"]:
            evs.setdefault(name, t)     # first occurrence wins
        start = r["events"][0][1]
        end = next((t for n, t in reversed(r["events"])
                    if n in _TERMINAL), now)
        tid = kind_tids.setdefault(r["kind"], len(kind_tids) + 1)
        if kind_tids[r["kind"]] == len(kind_tids):
            events += _meta(_PID_TASKS, "tasks", tid=tid,
                            tname=r["kind"])[1:]
        targs = {"uid": r["uid"], "kind": r["kind"], "stage": r["stage"],
                 "pipeline": r["pipeline"], "protocol": r.get("protocol"),
                 "dispatches": r["dispatches"],
                 "events": [n for n, _ in r["events"]]}
        tracks = [(_PID_TASKS, tid, "task")]
        proto = r.get("protocol")
        if proto is not None:
            ptid = proto_tids.setdefault(proto, len(proto_tids) + 1)
            if proto_tids[proto] == len(proto_tids):
                events += _meta(_PID_PROTOCOLS, "protocols", tid=ptid,
                                tname=proto)[1:]
            tracks.append((_PID_PROTOCOLS, ptid, "protocol"))
        for pid, track, cat in tracks:
            common = {"pid": pid, "tid": track, "cat": cat, "id": r["uid"]}
            events.append(dict(common, ph="b", ts=us(start),
                               name=r["kind"], args=targs))
            for span, open_ev, close_evs in _PHASES:
                if open_ev not in evs:
                    continue
                close = min((evs[e] for e in close_evs if e in evs),
                            default=None)
                if close is None:
                    continue
                events.append(dict(common, ph="b", ts=us(evs[open_ev]),
                                   name=span))
                events.append(dict(common, ph="e", ts=us(close)))
            events.append(dict(common, ph="e", ts=us(end)))
        # flow targets: device phase start, one per dispatch membership
        if "dispatched" in evs:
            for did in r["dispatches"]:
                events.append({"ph": "f", "pid": _PID_TASKS, "tid": tid,
                               "cat": "coalesce", "name": "member",
                               "id": did * 1000000 + r["uid"], "bp": "e",
                               "ts": us(evs["dispatched"])})
    return events


def write_trace(tracer: Tracer, path: str) -> str:
    """Write the Perfetto-loadable trace JSON; returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = {"traceEvents": trace_events(tracer), "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return path


def write_metrics(registry, path: str) -> str:
    """Write the registry's flat snapshot next to the trace."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(registry.snapshot(), f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def validate_trace(path: str) -> dict:
    """Parse a written trace and sanity-check its structure. Returns
    summary info ({kinds: {kind: n_task_spans}, n_events, ...}); raises
    ``ValueError`` on malformed traces. Used by tests and the CI trace
    smoke."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a trace-event JSON document")
    evs = doc["traceEvents"]
    kinds: Dict[str, int] = {}
    chains = 0
    for e in evs:
        if not isinstance(e, dict) or "ph" not in e:
            raise ValueError(f"{path}: malformed trace event {e!r}")
        if e["ph"] == "b" and e.get("cat") == "task" \
                and "args" in e:
            kinds[e["name"]] = kinds.get(e["name"], 0) + 1
            names = e["args"].get("events", [])
            if {"queued", "granted", "dispatched",
                    "completed"} <= set(names):
                chains += 1
    return {"n_events": len(evs), "kinds": kinds,
            "full_chains": chains}
