"""Task queue with priority + HPC-style backfill, a preemptible class, and
a weighted-fair pick across stage priority bands.

FIFO within priority, but when the head task does not fit the currently-free
devices, a smaller lower-priority task may be *backfilled* ahead of it — the
mechanism that lets IMPRESS sub-pipelines soak up idle devices while a big
pipeline waits for a large allocation (the paper's "offloading newly created
pipelines to the idle resources when possible").

Preemptible (trainer-class) tasks are a second scheduling class: they are
held back whenever any non-preemptible (design) task is queued — low-priority
opportunistic work must never delay design work, not even via backfill —
*unless* they have waited longer than ``aging_s`` (the starvation guard: a
continuous design load cannot park a trainer task forever).

Weighted-fair bands (heterogeneous stages): tasks carry a ``band`` id and
the queue can be given ``band_shares`` — a ``{band: weight}`` table. When
two or more bands have queued work, the pick walks bands in most-underserved
order (stride scheduling: serve the band with the smallest served/weight
virtual time, capping the lag of bands that were idle), so a flood of
expensive fold-stage tasks cannot starve cheap sampling-stage tasks — or
vice versa — beyond the configured shares. Any task that has waited past
``aging_s`` bypasses the fair pick entirely (nothing waits forever). With
no shares configured, or only one band present, the pick is exactly the
legacy priority/backfill scan — single-band campaigns are byte-identical.

The clock is injected (``now_fn``, default ``time.monotonic``) so aging and
fairness tests run deterministically against a fake clock instead of
sleeping.

A copy of the JAX package's ``repro.runtime.scheduler`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

import threading
import time
from bisect import insort
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.core.pipeline import Task

_order = (lambda t: (t.priority, t.uid))


class TaskQueue:
    def __init__(self, backfill: bool = True, aging_s: float = 60.0,
                 now_fn: Optional[Callable[[], float]] = None,
                 band_shares: Optional[Dict[int, float]] = None,
                 metrics=None):
        self._items: List[Task] = []
        self._lock = threading.Lock()
        self.backfill = backfill
        self.aging_s = aging_s
        self.now = now_fn if now_fn is not None else time.monotonic
        self.metrics = metrics  # optional obs.MetricsRegistry: the queue
        #   maintains queue.depth{band=...} gauges on push/pop/remove
        # weighted-fair state: {band: weight} plus per-band service counts
        # (in dispatches) and the global virtual time of the last pick
        self.band_shares: Dict[int, float] = dict(band_shares or {})
        self._served: Dict[int, float] = {}
        self._vtime = 0.0
        # optional admission predicate (per-tenant quota hard caps): a task
        # it rejects is skipped by every pick path — including the aging
        # bypass, so caps stay hard — and retried on the next pop
        self._admit: Optional[Callable[[Task], bool]] = None

    def set_admission(self, fn: Optional[Callable[[Task], bool]]):
        """Install (or clear, with None) an admission predicate applied to
        every dispatch pick. Unlike ``fits`` (a device-count check), the
        predicate sees the whole task — quota policies gate on its tenant.
        It is consulted only when the task would otherwise be popped, under
        the queue lock, so returning True is a commitment the policy can
        account against (reserve-at-pick). Rejected tasks stay queued and
        are reconsidered on each pop, so admission opens up as soon as the
        blocking condition clears."""
        with self._lock:
            self._admit = fn

    def _gauge_depths(self):
        """Refresh per-band depth gauges (call with ``_lock`` held)."""
        if self.metrics is None:
            return
        depths: Dict[int, int] = {}
        for t in self._items:
            depths[t.band] = depths.get(t.band, 0) + 1
        for band, g in self.metrics.labeled("queue.depth", "band").items():
            g.set(depths.pop(int(band), 0))
        for band, n in depths.items():
            self.metrics.gauge("queue.depth", band=band).set(n)

    def set_band_shares(self, shares: Optional[Dict[int, float]]):
        """Install (or clear, with None/empty) the weighted-fair band
        table. Service counters reset — shares describe the mix from now
        on, not retroactively."""
        with self._lock:
            self.band_shares = dict(shares or {})
            self._served = {}
            self._vtime = 0.0

    def push(self, task: Task):
        with self._lock:
            if self.band_shares and not any(t.band == task.band
                                            for t in self._items):
                # lag capping (fair queuing's "new flow starts at the
                # current virtual time"): a band returning from idle must
                # not monopolize the queue to repay service it never asked
                # for while empty
                w = self._weight(task.band)
                self._served[task.band] = max(
                    self._served.get(task.band, 0.0), self._vtime * w)
            insort(self._items, task, key=_order)  # O(n) vs full re-sort
            self._gauge_depths()

    def _weight(self, band: int) -> float:
        return max(float(self.band_shares.get(band, 1.0)), 1e-9)

    def _aged(self, task: Task, now: float) -> bool:
        queued = task.timestamps.get("QUEUED")
        return queued is not None and (now - queued) >= self.aging_s

    # -- the pick ----------------------------------------------------------

    def _scan(self, indices: Iterable[int], fits: Callable[[int], bool],
              design_waiting: bool, now: float) -> Optional[Task]:
        """Legacy pick over ``indices`` (already in priority order): pop the
        first fitting task, skipping unaged preemptible tasks while design
        work waits; without backfill, stop at the first non-fitting task."""
        for i in indices:
            task = self._items[i]
            if task.not_before > now:
                # retry backoff: not eligible yet — skip without blocking
                # the tasks behind it (a timing hold is not a resource wait,
                # so it never stops backfill either)
                continue
            if task.preemptible and design_waiting \
                    and not self._aged(task, now):
                continue
            if fits(task.resources.n_devices):
                # admission runs last, so admit=True implies the task IS
                # popped — quota policies can reserve atomically here (the
                # queue lock serializes picks); a rejected task is skipped,
                # never blocking co-tenants' tasks behind it
                if self._admit is not None and not self._admit(task):
                    continue
                return self._items.pop(i)
            if not self.backfill:
                return None
        return None

    def _band_order(self, bands: List[int]) -> List[int]:
        """Bands in most-underserved-first order (smallest virtual time
        served/weight wins; band id breaks ties deterministically)."""
        return sorted(bands, key=lambda b: (
            self._served.get(b, 0.0) / self._weight(b), b))

    def pop_fitting(self, fits: Callable[[int], bool]) -> Optional[Task]:
        """Pop the highest-priority task; if it doesn't fit and backfill is
        on, pop the first one that does. Preemptible tasks are skipped while
        any non-preemptible task waits, unless aged past ``aging_s``.

        With ``band_shares`` configured and more than one band queued, the
        pick is weighted-fair across bands (aged tasks bypass fairness)."""
        with self._lock:
            if not self._items:
                return None
            now = self.now()
            design_waiting = any(not t.preemptible for t in self._items)
            bands = sorted({t.band for t in self._items})
            if not self.band_shares or len(bands) <= 1:
                got = self._scan(range(len(self._items)), fits,
                                 design_waiting, now)
                if got is not None:
                    self._gauge_depths()
                return got
            # starvation guard first: any aged task (any band, any class)
            # pops ahead of the fair pick — nothing waits past aging_s
            aged = [i for i, t in enumerate(self._items)
                    if self._aged(t, now)]
            got = self._scan(aged, fits, design_waiting, now)
            if got is None:
                for band in self._band_order(bands):
                    idx = [i for i, t in enumerate(self._items)
                           if t.band == band]
                    got = self._scan(idx, fits, design_waiting, now)
                    if got is not None:
                        break
            if got is not None:
                self._served[got.band] = self._served.get(got.band, 0.0) + 1.0
                self._vtime = self._served[got.band] / self._weight(got.band)
                self._gauge_depths()
            return got

    def pop_matching(self, pred: Callable[[Task], bool],
                     rows: Optional[Callable[[Task], int]] = None,
                     budget: Optional[int] = None,
                     limit: Optional[int] = None) -> List[Task]:
        """Remove and return queued tasks satisfying ``pred``, in priority
        order, until ``budget`` rows / ``limit`` tasks are reached — the
        coalescing primitive: the executor drains compatible tasks into one
        fused device batch."""
        taken: List[Task] = []
        with self._lock:
            now = self.now()
            i = 0
            while i < len(self._items):
                if limit is not None and len(taken) >= limit:
                    break
                t = self._items[i]
                if t.not_before <= now and pred(t):
                    r = rows(t) if rows is not None else 1
                    if budget is None or r <= budget:
                        taken.append(self._items.pop(i))
                        if budget is not None:
                            budget -= r
                        continue
                i += 1
            if taken:
                self._gauge_depths()
        return taken

    def matching_rows(self, pred: Callable[[Task], bool],
                      rows: Optional[Callable[[Task], int]] = None) -> int:
        """Sum the batch-row footprint of queued tasks satisfying ``pred``
        *without* removing them — the executor peeks this before allocating
        so a row-proportional sub-mesh is sized for the rows the dispatch is
        about to coalesce, not just the task that was popped."""
        with self._lock:
            now = self.now()
            return sum((rows(t) if rows is not None else 1)
                       for t in self._items
                       if t.not_before <= now and pred(t))

    def remove(self, uid: int) -> Optional[Task]:
        with self._lock:
            for i, t in enumerate(self._items):
                if t.uid == uid:
                    got = self._items.pop(i)
                    self._gauge_depths()
                    return got
        return None

    def band_stats(self) -> Dict[int, dict]:
        """Per-band service counters (weighted-fair accounting): dispatches
        served and the configured weight — the fairness evidence surfaced
        by reports and the pipeline benchmark."""
        with self._lock:
            total = sum(self._served.values()) or 1.0
            return {b: {"served": int(n), "share": n / total,
                        "weight": self._weight(b)}
                    for b, n in sorted(self._served.items())}

    def __len__(self):
        with self._lock:
            return len(self._items)

    def snapshot(self) -> List[Task]:
        with self._lock:
            return list(self._items)
