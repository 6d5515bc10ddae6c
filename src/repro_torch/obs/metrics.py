"""Metrics registry: named counters, gauges, and streaming histograms.

The runtime's per-subsystem ad-hoc stat dicts (executor ``_coalesce_log``/
``_stage_log``, allocator ``_shape_log``) are rebuilt on this registry: one
get-or-create namespace of typed series, labelable by dimension (task
``kind``, pipeline ``stage``, scheduler ``band``), cheap enough to leave on
unconditionally — a counter bump is a dict lookup and a float add, orders
of magnitude below one jitted device dispatch.

Histograms are *streaming*: p50/p95/max come from a sparse log-bucketed
sketch (HDR-style, ~7% relative resolution at the default base) plus exact
count/sum/min/max — no sample list is ever stored, so a million task
completions cost the same memory as ten. Sketches merge associatively,
which is what lets ``aggregate_snapshot`` fold every registry created in a
process into one summary (the benchmark records embed that).

Thread safety: every mutation takes the owning series' lock; get-or-create
takes the registry lock. Reads (``snapshot``) are lock-consistent per
series, not globally atomic — fine for telemetry.

A copy of the JAX package's ``repro.obs.metrics`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Dict, Iterable, List, Optional, Tuple


def _series_key(name: str, labels: dict) -> Tuple:
    return (name,) + tuple(sorted(labels.items()))


def format_key(key: Tuple) -> str:
    """Flat string form of a series key: ``name{k=v,...}``."""
    name = key[0]
    if len(key) == 1:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key[1:]) + "}"


class Counter:
    """Monotonically-increasing value (int or float increments)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0):
        with self._lock:
            self.value += n

    def get(self) -> float:
        return self.value


class Gauge:
    """Last-set value (queue depth, free devices, occupancy)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self.value = float(v)

    def add(self, n: float = 1.0):
        with self._lock:
            self.value += n

    def get(self) -> float:
        return self.value


class Histogram:
    """Streaming distribution sketch: exact count/sum/min/max plus
    log-bucketed quantiles (p50/p95 by default) without storing samples.

    Bucket ``i`` holds values in ``(base**(i-1), base**i]``; non-positive
    values land in a dedicated zero bucket. Quantiles interpolate at the
    bucket's geometric midpoint, so relative error is bounded by the bucket
    width (~``base - 1``)."""

    __slots__ = ("count", "sum", "min", "max", "_buckets", "_zero",
                 "_log_base", "_lock")

    def __init__(self, base: float = 1.07):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self._log_base = math.log(base)
        self._lock = threading.Lock()

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if v <= 0.0:
                self._zero += 1
            else:
                i = math.ceil(math.log(v) / self._log_base - 1e-9)
                self._buckets[i] = self._buckets.get(i, 0) + 1

    def _quantiles(self, qs: Iterable[float]) -> List[float]:
        # rank-walk over (zero bucket, then ascending log buckets)
        out = []
        items = sorted(self._buckets.items())
        for q in qs:
            if self.count == 0:
                out.append(0.0)
                continue
            rank = q * (self.count - 1)
            if rank < self._zero or not items:
                out.append(0.0 if self._zero else float(self.min))
                continue
            seen = self._zero
            val = float(self.max)
            for i, n in items:
                seen += n
                if rank < seen:
                    # geometric midpoint of (base**(i-1), base**i]
                    val = math.exp((i - 0.5) * self._log_base)
                    break
            out.append(min(max(val, float(self.min)), float(self.max)))
        return out

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantiles((q,))[0]

    def merge(self, other: "Histogram"):
        with self._lock, other._lock:
            self.count += other.count
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
            self._zero += other._zero
            for i, n in other._buckets.items():
                self._buckets[i] = self._buckets.get(i, 0) + n

    def summary(self) -> dict:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                        "max": 0.0}
            p50, p95 = self._quantiles((0.5, 0.95))
            return {"count": self.count, "mean": self.sum / self.count,
                    "p50": p50, "p95": p95, "max": float(self.max)}


_REGISTRIES: "weakref.WeakSet" = weakref.WeakSet()
_RETIRED: Dict[Tuple, object] = {}    # merged series of GC'd registries
_retired_lock = threading.Lock()


def _merge_series(merged: Dict[Tuple, object], items) -> None:
    """Fold ``(key, series)`` pairs into ``merged``: counters sum, gauges
    keep the last value, histogram sketches merge."""
    for k, s in items:
        cur = merged.get(k)
        if isinstance(s, Histogram):
            if not isinstance(cur, Histogram):
                cur = Histogram()
                merged[k] = cur
            cur.merge(s)
        elif isinstance(s, Counter):
            if not isinstance(cur, Counter):
                cur = Counter()
                merged[k] = cur
            cur.inc(s.get())
        else:
            if not isinstance(cur, Gauge):
                cur = Gauge()
                merged[k] = cur
            cur.set(s.get())


def _retire(series: Dict[Tuple, object]) -> None:
    """``weakref.finalize`` hook: when a registry is collected, its final
    series fold into the retired accumulator, so ``aggregate_snapshot``
    still reflects completed (shut-down) sessions."""
    with _retired_lock:
        _merge_series(_RETIRED, list(series.items()))


class MetricsRegistry:
    """Get-or-create namespace of Counter/Gauge/Histogram series, each
    addressable by name plus optional labels::

        reg.counter("tasks.completed", kind="predict_batch").inc()
        reg.histogram("task.device_s", kind="predict_batch").observe(dt)
        reg.snapshot()  # flat {"tasks.completed{kind=predict_batch}": 3, ...}
    """

    def __init__(self):
        self._series: Dict[Tuple, object] = {}
        self._lock = threading.Lock()
        _REGISTRIES.add(self)
        weakref.finalize(self, _retire, self._series)

    def _get(self, cls, name: str, labels: dict):
        key = _series_key(name, labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = cls()
                self._series[key] = s
            elif not isinstance(s, cls):
                raise TypeError(
                    f"metric {format_key(key)} is {type(s).__name__}, "
                    f"not {cls.__name__}")
        return s

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def series(self, name: str) -> Dict[Tuple, object]:
        """Every series of ``name``, keyed by its full (name, labels) key."""
        with self._lock:
            return {k: v for k, v in self._series.items() if k[0] == name}

    def labeled(self, name: str, label: str) -> Dict[str, object]:
        """Series of ``name`` keyed by one label's value (series missing
        the label are skipped) — e.g. per-stage counters by stage."""
        out = {}
        for k, v in self.series(name).items():
            d = dict(k[1:])
            if label in d:
                out[d[label]] = v
        return out

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Current value of a counter/gauge, without creating it."""
        key = _series_key(name, labels)
        with self._lock:
            s = self._series.get(key)
        return default if s is None else s.get()

    def snapshot(self) -> dict:
        """Flat JSON-ready dict: counters/gauges as numbers, histograms as
        their summary dicts."""
        with self._lock:
            items = list(self._series.items())
        out = {}
        for k, s in items:
            out[format_key(k)] = (s.summary() if isinstance(s, Histogram)
                                  else s.get())
        return out


def aggregate_snapshot() -> dict:
    """Merge every registry this process created — live ones plus the
    retired accumulator of already-collected ones — into one flat
    snapshot: counters sum, gauges keep their last value, histograms merge
    sketches. The benchmark harness embeds this into each ``BENCH_*.json``
    record so perf records carry the telemetry of the run that produced
    them (including sessions already shut down)."""
    merged: Dict[Tuple, object] = {}
    with _retired_lock:
        _merge_series(merged, list(_RETIRED.items()))
    for reg in list(_REGISTRIES):
        with reg._lock:
            items = list(reg._series.items())
        _merge_series(merged, items)
    return {format_key(k): (s.summary() if isinstance(s, Histogram)
                            else s.get())
            for k, s in merged.items()}
