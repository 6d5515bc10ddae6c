"""Dynamic sub-mesh allocator over a grid of ``torch.device``s — the
analogue of the paper's dynamic resource allocation.

The pilot is the full device grid (the cards of one host). Tasks request
``n_devices``; the allocator carves a *contiguous axis-aligned block* out of
the grid and reclaims it on release. It supports elastic shrink on device
failure (failed devices leave the pool; affected allocations are reported so
their tasks can be requeued) and exposes the utilization accounting used by
the paper's Fig. 4/5.

Batch-aware shapes: batched tasks (``ResourceRequest.rows``) go through
``request_for_rows`` — the grant scales with the bucketed row count of the
device batch instead of a fixed per-kind device count, shrinking by halving
under device pressure (never below the request's floor). ``shape_stats``
summarizes the grants for the coordinator's report.

A copy of the JAX package's ``repro.runtime.allocator`` without its
``jax.sharding.Mesh``: a granted ``SubMesh`` carries its devices (an object
array shaped like the block), ``origin``, ``shape`` and ``uid``, which is
all the executor and the payload read.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import Telemetry

_uid = itertools.count()

# Batch-dim buckets batched payloads pad to.
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_rows(n: int) -> int:
    """Smallest bucket >= n (next power of two above the largest bucket)."""
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    b = BATCH_BUCKETS[-1]
    while b < n:
        b *= 2
    return b


# Sequence-length buckets masked batched payloads pad their token dim to.
LENGTH_BUCKETS = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def bucket_len(L: int, buckets=None) -> int:
    """Smallest length bucket >= L, from ``buckets`` or ``LENGTH_BUCKETS``;
    past the largest edge, rounds up to the next multiple of it."""
    bs = LENGTH_BUCKETS if buckets is None else tuple(buckets)
    L = max(1, int(L))
    for b in bs:
        if L <= b:
            return int(b)
    top = int(bs[-1])
    return -(-L // top) * top


@dataclass(eq=False)
class SubMesh:
    """The devices granted to one task: ``devices`` is an object array of
    ``torch.device`` shaped like the block (any sequence of devices is
    taken as a 1-D block), ``origin`` its corner in the allocator's grid."""
    devices: np.ndarray
    origin: Tuple[int, ...] = (0,)
    shape: Tuple[int, ...] = ()
    uid: int = field(default_factory=lambda: next(_uid))

    def __post_init__(self):
        if not isinstance(self.devices, np.ndarray):
            devs = list(self.devices)
            self.devices = np.empty(len(devs), dtype=object)
            self.devices[:] = devs
        if not self.shape:
            self.shape = tuple(self.devices.shape)

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


def _block_shapes(n: int, grid: Tuple[int, ...]):
    """Axis-aligned block shapes of exactly n devices fitting the grid,
    most-square first (locality)."""
    shapes = set()
    if len(grid) == 1:
        if n <= grid[0]:
            shapes.add((n,))
    else:
        for a in range(1, n + 1):
            if n % a == 0 and a <= grid[0]:
                for rest in _block_shapes(n // a, grid[1:]):
                    shapes.add((a,) + rest)
    return sorted(shapes, key=lambda s: (max(s) / min(s), s))


class DeviceAllocator:
    def __init__(self, devices, grid_shape: Optional[Tuple[int, ...]] = None,
                 telemetry: Optional[Telemetry] = None):
        devices = np.asarray(devices, dtype=object)
        if grid_shape is not None:
            devices = devices.reshape(grid_shape)
        elif devices.ndim == 1:
            pass
        self.grid = devices
        self.free = np.ones(self.grid.shape, bool)
        self.dead = np.zeros(self.grid.shape, bool)
        self.allocations: Dict[int, SubMesh] = {}
        self._lock = threading.Lock()
        # shared observability bundle: the metrics registry carries the
        # row-proportional grant counters (shape_stats), the tracer records
        # grant spans (device-track timelines), and its clock keys every
        # busy-log interval — same timebase as the executor's spans
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.now = self.telemetry.now
        self._t0 = self.now()
        # (start, end, ndev, stage) — stage is the pipeline stage the grant
        # served (None for unstaged tasks), feeding per-stage utilization
        self._busy_log: List[Tuple[float, float, int, Optional[str]]] = []
        self._open: Dict[int, Tuple[float, int, Optional[str]]] = {}
        self.telemetry.metrics.gauge("devices.free").set(self.n_free)

    # -- carving ---------------------------------------------------------

    def _find_block(self, shape):
        grid = self.grid.shape
        for origin in np.ndindex(*[g - s + 1 for g, s in zip(grid, shape)]):
            sl = tuple(slice(o, o + s) for o, s in zip(origin, shape))
            if self.free[sl].all():
                return origin, sl
        return None, None

    def request(self, n_devices: int,
                preferred_shape: Optional[Tuple[int, ...]] = None,
                stage: Optional[str] = None) -> Optional[SubMesh]:
        with self._lock:
            cands = ([preferred_shape] if preferred_shape else
                     _block_shapes(n_devices, self.grid.shape))
            for shape in cands:
                if len(shape) != self.grid.ndim:
                    shape = tuple([1] * (self.grid.ndim - len(shape))) + tuple(shape)
                origin, sl = self._find_block(shape)
                if origin is None:
                    continue
                self.free[sl] = False
                sub = SubMesh(devices=self.grid[sl], origin=tuple(origin),
                              shape=tuple(shape))
                self.allocations[sub.uid] = sub
                self._open[sub.uid] = (self.now(), sub.n_devices, stage)
                flat = np.arange(self.grid.size).reshape(
                    self.grid.shape)[sl].ravel().tolist()
                self.telemetry.tracer.grant_begin(sub, stage, flat)
                self.telemetry.metrics.gauge("devices.free").set(
                    int(self.free.sum()))
                return sub
            return None

    def release(self, sub: SubMesh):
        with self._lock:
            if sub.uid not in self.allocations:
                return
            sl = tuple(slice(o, o + s) for o, s in zip(sub.origin, sub.shape))
            self.free[sl] = ~self.dead[sl]
            del self.allocations[sub.uid]
            start, ndev, stage = self._open.pop(sub.uid)
            self._busy_log.append((start, self.now(), ndev, stage))
            self.telemetry.metrics.gauge("devices.free").set(
                int(self.free.sum()))
        self.telemetry.tracer.grant_end(sub)

    # -- batch-aware shapes ------------------------------------------------

    def grant_for_rows(self, rows: int, floor: int = 1) -> int:
        """Device count a batch of ``rows`` rows should run across: the
        largest power of two <= min(bucketed rows, healthy pool) — powers of
        two split bucketed batches evenly — never below ``floor`` (the
        request's fixed-size fallback)."""
        cap = min(bucket_rows(max(1, int(rows))), self.healthy_devices)
        n = 1
        while n * 2 <= cap:
            n *= 2
        return max(int(floor), n)

    def request_for_rows(self, rows: int, floor: int = 1,
                         stage: Optional[str] = None,
                         max_devices: Optional[int] = None
                         ) -> Optional[SubMesh]:
        """Carve a sub-mesh sized proportionally to a device batch's
        bucketed row count (replacing fixed per-kind device counts). Under
        device pressure the grant shrinks by halving toward ``floor``;
        returns None only when even ``floor`` devices cannot be carved.
        ``max_devices`` caps the grant from above (per-tenant quota
        enforcement: the row-proportional upsize must not blow through a
        tenant's remaining device budget), never below ``floor``. Every
        grant is recorded for ``shape_stats`` (and, keyed by ``stage``,
        for ``stage_shape_stats``)."""
        want = self.grant_for_rows(rows, floor)
        if max_devices is not None:
            want = max(int(floor), min(want, int(max_devices)))
        n = want
        while True:
            sub = self.request(n, stage=stage)
            if sub is not None:
                m = self.telemetry.metrics
                m.counter("alloc.grants").inc()
                m.counter("alloc.granted_devices").inc(n)
                m.counter("alloc.rows_per_device").inc(int(rows) / n)
                if n < want:
                    m.counter("alloc.downsized").inc()
                m.histogram("alloc.grant_devices").observe(n)
                if stage is not None:
                    m.counter("alloc.stage_grants", stage=stage).inc()
                    m.counter("alloc.stage_devices", stage=stage).inc(n)
                    m.counter("alloc.stage_rows", stage=stage).inc(int(rows))
                return sub
            if n <= floor:
                return None
            n = max(int(floor), n // 2)

    def shape_stats(self) -> dict:
        """Summary of row-proportional grants (coordinator report),
        rebuilt from the registry's ``alloc.*`` counters — same schema as
        the shape log it replaced."""
        m = self.telemetry.metrics
        n = m.value("alloc.grants")
        return {
            "grants": int(n),
            "mean_granted": m.value("alloc.granted_devices") / n if n
            else 0.0,
            "mean_rows_per_device": (
                m.value("alloc.rows_per_device") / n if n else 0.0),
            "downsized": int(m.value("alloc.downsized")),
        }

    def stage_shape_stats(self) -> Dict[str, dict]:
        """Per-stage grant summary: how many device grants each pipeline
        stage drew, their mean size, and mean rows per device — the shape
        evidence that heterogeneous stages really got heterogeneous
        allocations. Grants without a stage key are omitted."""
        m = self.telemetry.metrics
        out: Dict[str, dict] = {}
        for stage, c in m.labeled("alloc.stage_grants", "stage").items():
            devices = int(m.value("alloc.stage_devices", stage=stage))
            out[stage] = {
                "grants": int(c.get()),
                "devices": devices,
                "rows": int(m.value("alloc.stage_rows", stage=stage)),
            }
        for s in out.values():
            s["mean_granted"] = s["devices"] / s["grants"]
            s["mean_rows_per_device"] = s["rows"] / max(s["devices"], 1)
        return out

    def stage_utilization(self, until: Optional[float] = None
                          ) -> Dict[str, float]:
        """Busy device-seconds per stage / (devices × wall-clock) — the
        per-stage slice of ``utilization``. Unstaged grants land under the
        ``None`` key so the slices still sum to the total."""
        now = until or self.now()
        busy: Dict[Optional[str], float] = {}
        for s, e, n, st in list(self._busy_log):
            busy[st] = busy.get(st, 0.0) + (min(e, now) - s) * n
        with self._lock:
            for s, n, st in self._open.values():
                busy[st] = busy.get(st, 0.0) + (now - s) * n
        wall = max(now - self._t0, 1e-9)
        return {st: b / (self.total_devices * wall)
                for st, b in busy.items()}

    # -- failures / elasticity -------------------------------------------

    def mark_failed(self, device) -> List[SubMesh]:
        """Remove a device from the pool; return affected live allocations."""
        with self._lock:
            pos = None
            for idx in np.ndindex(*self.grid.shape):
                if self.grid[idx] is device or self.grid[idx] == device:
                    pos = idx
                    break
            if pos is None:
                return []
            self.dead[pos] = True
            self.free[pos] = False
            self.telemetry.metrics.gauge("devices.free").set(
                int(self.free.sum()))
            hit = []
            for sub in list(self.allocations.values()):
                sl = tuple(slice(o, o + s)
                           for o, s in zip(sub.origin, sub.shape))
                inside = all(s.start <= p < s.stop for s, p in zip(sl, pos))
                if inside:
                    hit.append(sub)
            return hit

    # -- stats -------------------------------------------------------------

    @property
    def total_devices(self) -> int:
        return int(self.grid.size)

    @property
    def healthy_devices(self) -> int:
        return int(self.grid.size - self.dead.sum())

    @property
    def n_free(self) -> int:
        return int(self.free.sum())

    def can_fit(self, n_devices: int) -> bool:
        if n_devices > self.n_free:
            return False
        for shape in _block_shapes(n_devices, self.grid.shape):
            if len(shape) != self.grid.ndim:
                shape = tuple([1] * (self.grid.ndim - len(shape))) + tuple(shape)
            if self._find_block(shape)[0] is not None:
                return True
        return False

    def utilization(self, until: Optional[float] = None) -> float:
        """Busy device-seconds / (devices × wall-clock) since construction."""
        now = until or self.now()
        busy = sum((min(e, now) - s) * n for s, e, n, _ in self._busy_log)
        with self._lock:
            busy += sum((now - s) * n for s, n, _ in self._open.values())
        wall = max(now - self._t0, 1e-9)
        return busy / (self.total_devices * wall)

    def busy_timeline(self, resolution: float = 0.05):
        """(times, busy_devices) series for utilization plots (Fig. 4/5)."""
        now = self.now()
        events = [(s, e, n) for s, e, n, _ in self._busy_log] + [
            (s, now, n) for s, n, _ in self._open.values()]
        if not events:
            return [], []
        t = self._t0
        ts, busy = [], []
        while t <= now:
            ts.append(t - self._t0)
            busy.append(sum(n for s, e, n in events if s <= t < e))
            t += resolution
        return ts, busy
