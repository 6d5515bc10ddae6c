"""Asynchronous task executor over dynamically-allocated sub-meshes — the
RADICAL-Pilot analogue (DESIGN.md §2).

Two channels, as in the paper's implementation: a *submission* channel
(``submit``/TaskQueue) and a *completion* channel (``completions`` queue the
coordinator drains). Worker threads take QUEUED tasks, allocate a sub-mesh,
run the registered payload function, and emit the finished task. CUDA's async
launches mean workers overlap host logic with device compute; independent
sub-meshes execute concurrently.

Fault tolerance (the resilience substrate, ``repro_torch.resilience``): payload
exceptions are classified by a ``ResilienceManager`` — transient errors
requeue with an exponential-backoff ``not_before`` stamp the scheduler
honors (retries never busy-requeue), permanent errors fail fast, a
per-``(kind, stage)`` circuit breaker sheds retries of a persistently
failing kind, and tasks that exhaust their budget quarantine to a
``DeadLetterQueue`` surfaced in ``report()["resilience"]``. A *fused*
dispatch that fails always re-runs its members solo first (blame cannot be
attributed to one row) — that bisect step is how a poison row is isolated
while its batch-mates complete. ``inject_device_failure`` removes a device
(elastic shrink) and requeues the tasks whose allocation it hit (exactly
once — speculative duplicates of the victims are canceled). An optional
``FaultPlan`` injects deterministic chaos (errors / slowdowns / device
loss) right before each dispatch runs. Straggler mitigation: a watchdog
duplicates tasks running longer than ``straggler_factor`` × the median
duration of their kind when spare capacity exists; first finisher wins —
the same watchdog enforces the policy's task deadline (``deadline_s``),
failing runaway tasks with class ``deadline``.

Task coalescing: kinds registered via ``register_coalescable`` carry a
``CoalesceRule``. When a worker dequeues such a task it also drains every
*compatible* queued task (same ``rule.key``, typically same bucketed shape
— they may come from different pipelines) up to ``rule.max_rows`` batch
rows, runs the payload fn once on the merged payload, and fans the result
back out so each member task completes independently. Queued work thus
soaks spare batch capacity as rows instead of waiting for whole sub-meshes.

Rolling admission (continuous batching): a rule with ``admission_window``
> 0 holds the dispatch open for that many seconds after the dequeue-time
drain, re-admitting compatible tasks that other pipelines queue *during*
the window — late arrivals join the next device batch instead of waiting a
full protocol cycle. The window closes early once ``max_rows`` is reached.

Batch-aware allocation: tasks whose ``ResourceRequest.rows`` is set get a
sub-mesh sized by ``DeviceAllocator.request_for_rows`` — proportional to
the bucketed row count of the dispatch (the popped task's rows plus any
queued compatible rows it is about to coalesce), with ``n_devices`` as the
floor — instead of the fixed ``n_devices`` grant.

Preemption (model evolution): tasks marked ``preemptible`` (trainer-class
work soaking idle devices) run with the live ``Task`` injected into their
payload as ``payload["_task"]``. When a non-preemptible task cannot be
allocated — or waits in the queue while preemptible work holds devices —
the executor sets ``preempt_requested`` on every running preemptible task;
the payload fn checks the flag between steps and returns early (DONE, with
resume state in its result), releasing its sub-mesh within one step. The
scheduler additionally holds queued preemptible tasks back while design
work waits (see ``TaskQueue``), so trainer tasks never delay a queued
design task from either direction.

A copy of the JAX package's ``repro.runtime.executor`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

import queue
import statistics
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.pipeline import TERMINAL, Task, TaskState
from repro_torch.obs import Telemetry
from repro_torch.resilience.deadletter import DeadLetterQueue
from repro_torch.resilience.policy import ResilienceManager, RetryPolicy
from repro_torch.runtime.allocator import DeviceAllocator, SubMesh
from repro_torch.runtime.scheduler import TaskQueue


@dataclass(frozen=True)
class CoalesceRule:
    """How to fuse compatible queued tasks of one kind into a single
    dispatch. ``key`` defines compatibility; ``merge`` builds the fused
    payload from the member tasks; ``split`` maps the fused result back to
    one result per member; ``rows`` is a member's batch-row footprint.
    ``admission_window`` > 0 enables rolling admission: the dispatch stays
    open that many seconds so compatible tasks queued after the dequeue
    still join the batch (closing early once ``max_rows`` is reached).
    ``live`` goes further: the worker injects an ``AdmissionPort`` into the
    dispatch payload as ``payload["_admit"]``, letting the payload fn pull
    compatible queued tasks into the batch *while it is already running on
    device* (continuous batching — rows join a decode loop mid-flight).
    Members admitted through the port are fanned back out by ``split``
    exactly like dequeue-time members; their result rows must follow the
    initial members' rows in the fused result."""
    key: Callable[[Task], Any]
    merge: Callable[[List[Task]], dict]
    split: Callable[[List[Task], Any], List[Any]]
    rows: Callable[[Task], int]
    max_rows: int = 64
    admission_window: float = 0.0
    live: bool = False


class AdmissionPort:
    """Live-admission handle a worker injects into a running dispatch's
    payload (``payload["_admit"]``) when its rule has ``live=True``.

    The payload fn calls ``take(k)`` between device steps: up to ``k``
    batch rows of compatible queued tasks leave the queue and join the
    running dispatch. Admitted tasks are tracked/transitioned immediately
    (so ``cancel`` and failure injection can reach them) and appended to
    ``admitted`` — the worker merges them into the dispatch's member list
    before fanning the result back out. A payload fn that never polls the
    port admits nothing; the port is inert."""

    def __init__(self, executor: "AsyncExecutor", rule: CoalesceRule,
                 leader: Task, sub: SubMesh, budget: int,
                 dispatch_span: Optional[dict] = None):
        self._ex = executor
        self._rule = rule
        self._leader = leader
        self._pred = executor._compatible_with(leader, rule)
        self._sub = sub
        self._span = dispatch_span    # fused-batch trace span to link into
        self.budget = int(budget)
        self.admitted: List[Task] = []
        self._lock = threading.Lock()

    def take(self, k: int) -> List[Task]:
        """Admit up to ``k`` rows of compatible queued tasks; returns the
        newly admitted tasks (possibly empty)."""
        with self._lock:
            if self._leader.canceled:
                # the dispatch is doomed (device loss / cancel): never pull
                # healthy queued work — or the victims' own failover
                # clones — onto it
                return []
            k = min(int(k), self.budget)
            if k <= 0:
                return []
            taken = self._ex.queue.pop_matching(
                lambda t: not self._leader.canceled and self._pred(t),
                rows=self._rule.rows, budget=k)
            if not taken:
                return []
            self._ex._track(taken, self._sub)
            tel = self._ex.telemetry
            tel.tracer.dispatch_admit(self._span, taken)
            now = self._ex.now()
            for m in taken:
                m.set_state(TaskState.SCHEDULED, now)
                m.set_state(TaskState.EXEC_SETUP, now)
                m.set_state(TaskState.RUNNING, now)
            tel.tracer.mark_all(taken, "dispatched")
            tel.metrics.counter("admission.live_tasks").inc(len(taken))
            self.admitted.extend(taken)
            self.budget -= sum(self._rule.rows(m) for m in taken)
            return list(taken)


class AsyncExecutor:
    def __init__(self, allocator: DeviceAllocator, *, max_workers: int = 8,
                 max_retries: int = 1, backfill: bool = True,
                 straggler_factor: Optional[float] = None,
                 min_straggler_samples: int = 3, aging_s: float = 60.0,
                 band_shares: Optional[Dict[int, float]] = None,
                 now_fn: Optional[Callable[[], float]] = None,
                 telemetry: Optional[Telemetry] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 fault_plan=None):
        self.allocator = allocator
        # one observability bundle (metrics registry + span tracer + clock)
        # per executor: sessions inject a shared instance so allocator
        # grants and task spans land on the same registry and timebase; a
        # bare executor adopts the allocator's bundle (tracer disabled by
        # default), unless a custom clock forces a fresh one
        if telemetry is not None:
            self.telemetry = telemetry
        elif now_fn is not None:
            self.telemetry = Telemetry(now_fn=now_fn)
        else:
            self.telemetry = allocator.telemetry
        self.now = now_fn if now_fn is not None else self.telemetry.now
        self.queue = TaskQueue(backfill=backfill, aging_s=aging_s,
                               now_fn=self.now, band_shares=band_shares,
                               metrics=self.telemetry.metrics)
        self.completions: "queue.Queue[Task]" = queue.Queue()
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.min_straggler_samples = min_straggler_samples
        self._fns: Dict[str, Callable[[SubMesh, dict], Any]] = {}
        self._coalesce: Dict[str, CoalesceRule] = {}
        # stage-specific rules override the kind-wide rule for tasks that
        # carry that stage tag — different stages of one kind can fuse with
        # different shape keys / row caps
        self._coalesce_staged: Dict[Tuple[str, str], CoalesceRule] = {}
        self._tasks: Dict[int, Task] = {}
        self._durations: Dict[str, List[float]] = {}
        self._running: Dict[int, tuple] = {}  # uid -> (task, submesh, t0)
        self._preemptions = 0   # preempt_requested signals sent
        # allocation policy (per-tenant quotas): admission gate + device
        # cap + grant/release charging; None = unrestricted (the default)
        self._policy = None
        # recent cross-tenant fused dispatches: the tenant sets whose tasks
        # shared one device batch (bounded; coalesce_stats evidence)
        self._fused_tenant_sets: List[Tuple[str, ...]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        # retry taxonomy + quarantine + deterministic chaos: without an
        # injected policy, a legacy-compatible one is derived from
        # ``max_retries`` (no backoff, breaker disabled) so existing
        # campaigns keep their exact timing; failed tasks always land in
        # the dead-letter queue either way
        if retry_policy is None:
            retry_policy = RetryPolicy(max_transient_retries=max_retries,
                                       backoff_base_s=0.0, jitter=0.0,
                                       breaker_threshold=0)
        self.resilience = ResilienceManager(retry_policy, now_fn=self.now,
                                            metrics=self.telemetry.metrics)
        self.deadletter = DeadLetterQueue()
        self.fault_plan = fault_plan
        self._unjoined_workers = 0
        self._workers = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max_workers)]
        for w in self._workers:
            w.start()
        self._watchdog = None
        if straggler_factor or retry_policy.deadline_s:
            self._watchdog = threading.Thread(target=self._watch, daemon=True)
            self._watchdog.start()

    # -- registration / submission ---------------------------------------

    def register(self, kind: str, fn: Callable[[SubMesh, dict], Any]):
        self._fns[kind] = fn

    def register_coalescable(self, kind: str, rule: CoalesceRule,
                             stage: Optional[str] = None):
        """Allow queued tasks of ``kind`` to fuse into shared dispatches.
        With ``stage`` set, the rule applies only to tasks tagged with that
        stage (overriding any kind-wide rule for them)."""
        if stage is None:
            self._coalesce[kind] = rule
        else:
            self._coalesce_staged[(kind, stage)] = rule

    def _rule_for(self, task: Task) -> Optional[CoalesceRule]:
        if task.stage is not None:
            rule = self._coalesce_staged.get((task.kind, task.stage))
            if rule is not None:
                return rule
        return self._coalesce.get(task.kind)

    def registered_kinds(self) -> frozenset:
        """Task kinds with a registered payload fn — lets callers (the
        session facade) validate a protocol's handler registry against the
        executor before a campaign starts."""
        return frozenset(self._fns)

    def set_allocation_policy(self, policy):
        """Install (or clear, with None) a duck-typed allocation policy —
        the per-tenant quota hook. The policy sees every dispatch:
        ``admit(task)`` gates the queue pick (a hard cap holds tasks back
        without blocking co-tenants), ``device_cap(task)`` bounds the
        row-proportional grant, and ``granted``/``released`` charge the
        leader's tenant for the devices a dispatch holds. Coalesced
        co-members ride the leader's grant free — cross-tenant fusion is
        the throughput story, so quotas never tax it."""
        self._policy = policy
        self.queue.set_admission(policy.admit if policy is not None else None)

    def _device_cap(self, task: Task) -> Optional[int]:
        if self._policy is None:
            return None
        return self._policy.device_cap(task)

    def submit(self, task: Task):
        with self._lock:
            self._tasks[task.uid] = task
        tel = self.telemetry
        tel.tracer.task_submitted(task)
        tel.metrics.counter("tasks.submitted", kind=task.kind).inc()
        task.set_state(TaskState.QUEUED, self.now())
        tel.tracer.mark(task, "queued")
        self.queue.push(task)
        self._wake.set()
        # a design task that cannot fit right now must not wait out running
        # trainer work — signal at submit time too (the idle-worker check
        # alone misses the case where every worker stays busy)
        if not task.preemptible \
                and not self.allocator.can_fit(task.resources.n_devices):
            self.preempt_preemptible()

    def cancel(self, uid: int):
        t = self.queue.remove(uid)
        if t is not None:
            t.canceled = True
            t.set_state(TaskState.CANCELED, self.now())
            self.telemetry.tracer.mark(t, "canceled")
            self.completions.put(t)
            return
        with self._lock:
            entry = self._running.get(uid)
        if entry:
            entry[0].canceled = True  # cooperative

    # -- preemption --------------------------------------------------------

    def preempt_preemptible(self) -> int:
        """Ask every running preemptible task to yield its sub-mesh.
        Cooperative: payload fns check their injected
        ``payload["_task"].preempt_requested`` between steps and return
        early (DONE, with resume state) — unlike ``cancel``, the partial
        result is preserved. Returns how many tasks were signalled."""
        with self._lock:
            running = [t for t, _, _ in self._running.values()]
        n = 0
        for t in running:
            if t.preemptible and not t.preempt_requested:
                t.preempt_requested = True
                n += 1
        self._preemptions += n
        return n

    def _preempt_for_queued(self):
        """Idle-worker guard: if a queued non-preemptible task cannot fit
        while preemptible work is running (holding the devices it needs),
        preempt — the design task must not wait out a trainer task."""
        with self._lock:
            if not any(t.preemptible for t, _, _ in self._running.values()):
                return
        for t in self.queue.snapshot():
            if not t.preemptible \
                    and not self.allocator.can_fit(t.resources.n_devices):
                self.preempt_preemptible()
                return

    # -- worker loop -------------------------------------------------------

    def _compatible_with(self, task: Task, rule: CoalesceRule):
        # stage is part of compatibility at the executor level, so no rule
        # needs to key on it: same-stage tasks from different pipelines and
        # protocols fuse, cross-stage tasks never do (their payloads may be
        # shape-compatible but draw different params / run different models)
        key = rule.key(task)
        return lambda t: (t.kind == task.kind and t.stage == task.stage
                          and not t.canceled and t.retries == 0
                          and rule.key(t) == key)

    def _track(self, members: List[Task], sub: SubMesh):
        """Register dispatch members in ``_running`` as soon as they leave
        the queue — during an admission window too — so ``cancel`` and
        ``inject_device_failure`` can reach a dispatch while it is still
        being assembled (the worker loop later refreshes the timestamps)."""
        now = self.now()
        with self._lock:
            for m in members:
                self._running[m.uid] = (m, sub, now)
        self.telemetry.tracer.mark_all(members, "granted")

    def _coalesce_members(self, task: Task, sub: SubMesh):
        """Drain queued tasks compatible with ``task`` into one dispatch.
        Returns (member tasks, fused payload)."""
        rule = self._rule_for(task)
        if rule is None:
            return [task], task.payload
        # retried tasks run solo: if a fused dispatch failed, re-fusing the
        # members would let one poisoned payload fail every compatible task
        if task.retries > 0:
            return [task], task.payload
        members = [task]
        budget = rule.max_rows - rule.rows(task)
        pred = self._compatible_with(task, rule)
        if budget > 0:
            taken = self.queue.pop_matching(pred, rows=rule.rows,
                                            budget=budget)
            self._track(taken, sub)
            members += taken
            budget -= sum(rule.rows(m) for m in taken)
        # rolling admission: hold the dispatch open so compatible tasks
        # queued by other pipelines *after* this dequeue still join
        metrics = self.telemetry.metrics
        if rule.admission_window > 0 and budget > 0:
            deadline = self.now() + rule.admission_window
            n_late = 0
            # task.canceled guard: a device-loss victim must stop admitting
            # the moment it is canceled, or the still-open window would
            # pull queued tasks — including the victims' own failover
            # clones — onto the dead sub-mesh
            # checking the flag inside the pop predicate too closes the
            # race with a cancel that lands mid-pop: the victims' clones
            # only become visible in the queue after the cancel is (both
            # sides go through the queue lock)
            wpred = lambda t: not task.canceled and pred(t)  # noqa: E731
            while (budget > 0 and self.now() < deadline
                   and not task.canceled and not self._stop.is_set()):
                time.sleep(min(0.002, rule.admission_window))
                late = self.queue.pop_matching(wpred, rows=rule.rows,
                                               budget=budget)
                self._track(late, sub)
                members += late
                n_late += len(late)
                budget -= sum(rule.rows(m) for m in late)
            metrics.counter("admission.late_tasks").inc(n_late)
            metrics.histogram("admission.occupancy").observe(
                (rule.max_rows - budget) / max(rule.max_rows, 1))
        payload = rule.merge(members) if len(members) > 1 else task.payload
        rows = sum(rule.rows(m) for m in members)
        metrics.counter("coalesce.dispatches").inc()
        metrics.counter("coalesce.tasks").inc(len(members))
        metrics.counter("coalesce.rows").inc(rows)
        if len(members) > 1:
            metrics.counter("coalesce.fused_dispatches").inc()
            metrics.counter("coalesce.tasks_fused").inc(len(members))
        return members, payload

    def _maybe_regrow(self, task: Task, sub: SubMesh,
                      members: List[Task]) -> SubMesh:
        """Rolling admission can fuse more rows than were queued when the
        sub-mesh was granted. If the fused dispatch warrants more devices,
        upgrade the allocation before running (keeping the original mesh
        whenever the pool can't do better right now)."""
        res = task.resources
        rule = self._rule_for(task)
        if res.rows is None or rule is None or len(members) == 1:
            return sub
        rows = sum(rule.rows(m) for m in members)
        if self.allocator.grant_for_rows(rows, res.n_devices) <= sub.n_devices:
            return sub
        bigger = self.allocator.request_for_rows(rows, floor=res.n_devices,
                                                 stage=task.stage,
                                                 max_devices=self._device_cap(task))
        if bigger is None or bigger.n_devices <= sub.n_devices:
            if bigger is not None:
                self.allocator.release(bigger)
            return sub
        self.allocator.release(sub)
        return bigger

    def _allocate(self, task: Task) -> Optional[SubMesh]:
        """Sub-mesh for ``task``: the fixed ``n_devices`` grant, or — when
        the request carries ``rows`` — a shape proportional to the bucketed
        row count of the dispatch (its own rows plus queued compatible rows
        it is about to coalesce), with ``n_devices`` as the floor."""
        res = task.resources
        if res.rows is None:
            return self.allocator.request(res.n_devices, res.preferred_shape,
                                          stage=task.stage)
        rows = int(res.rows)
        rule = self._rule_for(task)
        if rule is not None and task.retries == 0:
            queued = self.queue.matching_rows(
                self._compatible_with(task, rule), rows=rule.rows)
            rows = min(rule.max_rows, rows + queued)
        return self.allocator.request_for_rows(rows, floor=res.n_devices,
                                               stage=task.stage,
                                               max_devices=self._device_cap(task))

    def _worker(self):
        while not self._stop.is_set():
            task = self.queue.pop_fitting(self.allocator.can_fit)
            if task is None:
                self._preempt_for_queued()
                self._wake.wait(timeout=0.01)
                self._wake.clear()
                continue
            sub = self._allocate(task)
            if sub is None:  # raced; try again later
                if self._policy is not None:
                    # refund the reservation admit() took for this pick —
                    # the task goes back to the queue unexecuted
                    self._policy.denied(task)
                if not task.preemptible:
                    # a design task lost its devices: trainer work yields
                    self.preempt_preemptible()
                self.queue.push(task)
                continue
            self._track([task], sub)
            members, payload = self._coalesce_members(task, sub)
            sub = self._maybe_regrow(task, sub, members)
            if self._policy is not None:
                # charge the leader's tenant for the final grant (after any
                # regrow) — co-members fused into this dispatch ride free
                self._policy.granted(task, sub)
            rule = self._rule_for(task)
            tel = self.telemetry
            span = tel.tracer.dispatch_begin(task, members, sub)
            port = None
            if rule is not None and rule.live and task.retries == 0:
                # continuous batching: the payload fn can pull compatible
                # queued tasks into the running dispatch via this port
                port = AdmissionPort(
                    self, rule, task, sub,
                    rule.max_rows - sum(rule.rows(m) for m in members),
                    dispatch_span=span)
                payload = dict(payload, _admit=port)
            if task.preemptible:
                # hand the payload fn its live task so it can observe
                # preempt_requested/canceled between steps
                payload = dict(payload, _task=task)
            t0 = self.now()
            for m in members:
                m.set_state(TaskState.SCHEDULED, t0)
            with self._lock:
                for m in members:
                    self._running[m.uid] = (m, sub, t0)
            finished: List[Task] = []
            try:
                now = self.now()
                for m in members:
                    m.set_state(TaskState.EXEC_SETUP, now)
                fn = self._fns[task.kind]
                now = self.now()
                for m in members:
                    m.set_state(TaskState.RUNNING, now)
                tel.tracer.mark_all(members, "dispatched")
                if self.fault_plan is not None:
                    # deterministic chaos seam: may sleep (slowdown), kill
                    # a device, or raise a classified payload error
                    self.fault_plan.on_dispatch(task, members, self)
                result = fn(sub, payload)
                if port is not None and port.admitted:
                    # live-admitted rows follow the initial members' rows
                    # in the fused result — same fan-out as dequeue-time
                    members = members + port.admitted
                results = (rule.split(members, result)
                           if len(members) > 1 else [result])
                now = self.now()
                for m, r in zip(members, results):
                    if getattr(m, "_deadline_exceeded", False):
                        # the watchdog flagged this run as over its
                        # deadline: fail it (class "deadline") so the
                        # owning pipeline degrades instead of wedging on
                        # a CANCELED completion
                        m.error = (f"DeadlineExceeded: ran past the "
                                   f"policy deadline "
                                   f"({self.resilience.policy.deadline_s}s)")
                        m.set_state(TaskState.FAILED, now)
                        tel.tracer.mark(m, "failed")
                        tel.metrics.counter("tasks.failed",
                                            kind=m.kind).inc()
                        tel.metrics.counter(
                            "tasks.failed", **{"class": "deadline"}).inc()
                        self.deadletter.record(m, error_class="deadline",
                                               error=m.error, now=now)
                    elif m.canceled:
                        m.set_state(TaskState.CANCELED, now)
                        tel.tracer.mark(m, "canceled")
                        tel.metrics.counter("tasks.canceled",
                                            kind=m.kind).inc()
                    else:
                        m.result = r
                        m.set_state(TaskState.DONE, now)
                        tel.tracer.mark(m, "completed")
                        self.resilience.on_success(m)
                        self._observe_done(m)
                        d = m.duration()
                        if d is not None:
                            self._durations.setdefault(m.kind, []).append(d)
                    finished.append(m)
                tel.tracer.dispatch_end(
                    span, "ok", rows=(sum(rule.rows(m) for m in members)
                                      if rule is not None else len(members)))
                self._record_stage(task, members, rule)
                self._record_tenants(members)
            except Exception as e:  # noqa: BLE001 — any payload failure
                if port is not None and port.admitted \
                        and port.admitted[-1] is not members[-1]:
                    members = members + port.admitted  # retry them too
                err = f"{type(e).__name__}: {e}\n" + traceback.format_exc()
                error_class = self.resilience.classify(e)
                fused = len(members) > 1
                retried: List[Task] = []
                now = self.now()
                for m in members:
                    m.error = err
                    action, detail = self.resilience.decide(
                        m, error_class, fused=fused)
                    if action == "retry":
                        # detail = backoff seconds; the scheduler honors
                        # not_before so the retry waits out its backoff in
                        # the queue instead of busy-requeueing
                        m.retries += 1
                        m.not_before = now + detail
                        retried.append(m)
                    else:
                        # detail = failure class: permanent / exhausted /
                        # budget / shed / canceled
                        m.set_state(TaskState.FAILED, now)
                        tel.tracer.mark(m, "failed")
                        tel.metrics.counter("tasks.failed",
                                            kind=m.kind).inc()
                        tel.metrics.counter("tasks.failed",
                                            **{"class": detail}).inc()
                        if detail != "canceled":
                            # quarantine: the dead-letter record is the
                            # report()["resilience"] evidence trail
                            self.deadletter.record(m, error_class=detail,
                                                   error=err, fused=fused,
                                                   now=now)
                            tel.tracer.mark(m, "quarantined")
                        finished.append(m)
                tel.tracer.dispatch_end(
                    span, "failed",
                    rows=(sum(rule.rows(m) for m in members)
                          if rule is not None else len(members)))
                with self._lock:
                    for m in members:
                        self._running.pop(m.uid, None)
                self.allocator.release(sub)
                if self._policy is not None:
                    self._policy.released(task, sub)
                now = self.now()
                for m in retried:  # retry members independently (solo)
                    tel.tracer.mark(m, "retried")
                    tel.metrics.counter("tasks.retried", kind=m.kind).inc()
                    m.set_state(TaskState.QUEUED, now)
                    tel.tracer.mark(m, "queued")
                    self.queue.push(m)
                self._wake.set()
                for m in finished:
                    self.completions.put(m)
                continue
            with self._lock:
                for m in members:
                    self._running.pop(m.uid, None)
            self.allocator.release(sub)
            if self._policy is not None:
                self._policy.released(task, sub)
            self._wake.set()
            for m in finished:
                self.completions.put(m)

    def _observe_done(self, m: Task):
        """Per-kind completion series: queue wait (RUNNING − QUEUED) and
        device time, as streaming histograms — the p50/p95 behind
        ``report()["telemetry"]``."""
        metrics = self.telemetry.metrics
        metrics.counter("tasks.completed", kind=m.kind).inc()
        q = m.timestamps.get("QUEUED")
        r = m.timestamps.get("RUNNING")
        if q is not None and r is not None:
            metrics.histogram("task.queue_wait_s", kind=m.kind).observe(
                max(0.0, r - q))
        d = m.duration()
        if d is not None:
            metrics.histogram("task.device_s", kind=m.kind).observe(d)
        if m.tenant is not None:
            # per-tenant slices (gateway): same series, tenant-labeled —
            # GET /metrics and report()["telemetry"]["tenants"] read these
            metrics.counter("tenant.tasks", tenant=m.tenant).inc()
            if q is not None and r is not None:
                metrics.histogram("tenant.queue_wait_s",
                                  tenant=m.tenant).observe(max(0.0, r - q))
            if d is not None:
                metrics.histogram("tenant.device_s",
                                  tenant=m.tenant).observe(d)

    def _record_tenants(self, members: List[Task]):
        """Cross-tenant fusion evidence: when one device batch held tasks
        from more than one tenant, count it and remember the tenant set —
        ``coalesce_stats()["cross_tenant"]`` is the proof the gateway's
        two-tenant benchmark and smoke test assert on."""
        tenants = sorted({m.tenant for m in members if m.tenant is not None})
        if len(tenants) < 2:
            return
        metrics = self.telemetry.metrics
        metrics.counter("coalesce.cross_tenant_dispatches").inc()
        metrics.counter("coalesce.cross_tenant_tasks").inc(len(members))
        with self._lock:
            self._fused_tenant_sets.append(tuple(tenants))
            del self._fused_tenant_sets[:-64]  # keep the recent evidence

    def _record_stage(self, task: Task, members: List[Task],
                      rule: Optional[CoalesceRule]):
        """Per-stage dispatch accounting (completed dispatches only):
        dispatches, member tasks, batch rows, device run time, and the
        queue-wait each member saw (RUNNING − QUEUED) — the executor half
        of the stage report (the allocator holds grant shapes/util)."""
        if task.stage is None:
            return
        metrics = self.telemetry.metrics
        stage = task.stage
        metrics.counter("stage.dispatches", stage=stage).inc()
        metrics.counter("stage.tasks", stage=stage).inc(len(members))
        metrics.counter("stage.rows", stage=stage).inc(
            sum(rule.rows(m) for m in members) if rule is not None
            else len(members))
        run_s = wait_s = 0.0
        for m in members:
            d = m.duration()
            if d is not None:
                run_s += d
            q = m.timestamps.get("QUEUED")
            r = m.timestamps.get("RUNNING")
            if q is not None and r is not None:
                wait_s += max(0.0, r - q)
        metrics.counter("stage.run_s", stage=stage).inc(run_s)
        metrics.counter("stage.wait_s", stage=stage).inc(wait_s)

    # -- straggler watchdog --------------------------------------------

    def _watch(self):
        while not self._stop.is_set():
            time.sleep(0.02)
            now = self.now()
            with self._lock:
                running = list(self._running.values())
            deadline = self.resilience.policy.deadline_s
            if deadline:
                # task deadlines (RetryPolicy.deadline_s): a run past its
                # deadline is cooperatively canceled and later surfaces as
                # FAILED with class "deadline" (see the worker done path) —
                # a hung payload degrades its pipeline instead of wedging
                # the campaign
                for task, sub, t0 in running:
                    if (now - t0) > deadline and not task.canceled \
                            and not task.preemptible:
                        task._deadline_exceeded = True
                        task.canceled = True  # cooperative stop signal
                        self.telemetry.tracer.mark(task, "deadline")
                        self.telemetry.metrics.counter(
                            "tasks.deadline_exceeded", kind=task.kind).inc()
            if not self.straggler_factor:
                continue
            for task, sub, t0 in running:
                hist = self._durations.get(task.kind, [])
                if len(hist) < self.min_straggler_samples:
                    continue
                med = statistics.median(hist)
                if (now - t0) > self.straggler_factor * med \
                        and task.speculative_of is None \
                        and not task.canceled \
                        and not task.preemptible \
                        and self.allocator.can_fit(task.resources.n_devices):
                    dup_ids = [t.speculative_of for t, _, _ in running]
                    if task.uid in dup_ids:
                        continue  # already duplicated
                    dup = Task(kind=task.kind, payload=task.payload,
                               resources=task.resources,
                               priority=task.priority - 1,
                               pipeline_id=task.pipeline_id,
                               speculative_of=task.uid,
                               stage=task.stage, band=task.band,
                               tenant=task.tenant)
                    self.submit(dup)

    # -- draining ----------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> Optional[Task]:
        try:
            return self.completions.get(timeout=timeout)
        except queue.Empty:
            return None

    def pending(self) -> int:
        with self._lock:
            return len(self.queue) + len(self._running)

    def inject_device_failure(self, device) -> List[Task]:
        """Simulate a node failure: shrink the pool, requeue affected
        tasks. Each victim is requeued exactly once (a second failure
        hitting an already-canceled run clones nothing), speculative
        duplicates are never cloned (their original still runs), and live
        speculative duplicates *of* a victim are canceled — the victim's
        clone is its only replacement, so pipelines never double-advance."""
        hit = self.allocator.mark_failed(device)
        requeued = []
        with self._lock:
            running = list(self._running.values())
        tel = self.telemetry
        for task, sub, _ in running:
            if not any(sub.uid == h.uid for h in hit):
                continue
            if task.canceled:
                continue  # already canceled (or already failed over once)
            task.canceled = True  # cooperative cancel of doomed run
            tel.tracer.mark(task, "device_lost")
            tel.metrics.counter("tasks.device_lost", kind=task.kind).inc()
            if task.speculative_of is not None:
                # a duplicate died with the device: the original is still
                # running elsewhere — no replacement needed
                continue
            # cancel this victim's speculative duplicates (queued or
            # running): the clone below is the single replacement
            with self._lock:
                dups = [t.uid for t, _, _ in self._running.values()
                        if t.speculative_of == task.uid]
            dups += [t.uid for t in self.queue.snapshot()
                     if t.speculative_of == task.uid]
            for uid in dups:
                self.cancel(uid)
            clone = Task(kind=task.kind, payload=task.payload,
                         resources=task.resources, priority=task.priority,
                         pipeline_id=task.pipeline_id,
                         preemptible=task.preemptible,
                         stage=task.stage, band=task.band,
                         tenant=task.tenant)
            clone.retries = task.retries
            self.submit(clone)
            requeued.append(clone)
        return requeued

    def resilience_summary(self) -> dict:
        """The ``report()["resilience"]`` section: retry/budget/breaker
        accounting from the ``ResilienceManager``, dead-letter quarantine
        records, and — when a ``FaultPlan`` is installed — the injected
        faults that actually fired."""
        out = self.resilience.summary()
        dl = self.deadletter.records()
        if dl:
            out["deadletter"] = dl
        if self.deadletter.dropped:
            out["deadletter_dropped"] = self.deadletter.dropped
        if self.fault_plan is not None:
            out["faults_injected"] = self.fault_plan.summary()
        return out

    def shutdown(self, wait: bool = True):
        """Stop workers. Workers still blocked on device compute after the
        2 s join timeout are counted (``stats()["unjoined_workers"]``) and
        logged instead of silently leaked — a leaked thread holds its
        sub-mesh, so the leak must be visible to the operator."""
        self._stop.set()
        self._wake.set()
        if wait:
            unjoined = 0
            for w in self._workers:
                w.join(timeout=2.0)
                if w.is_alive():
                    unjoined += 1
            self._unjoined_workers = unjoined
            if unjoined:
                self.telemetry.metrics.counter(
                    "executor.unjoined_workers").inc(unjoined)
                print(f"[executor] shutdown: {unjoined} worker(s) still "
                      f"blocked on device compute after join timeout "
                      f"(threads leaked, sub-meshes still held)",
                      flush=True)

    # -- metrics -----------------------------------------------------------

    def coalesce_stats(self) -> dict:
        """Coalescing summary, rebuilt from the metrics registry — the
        section schema is unchanged from the hand-rolled log it replaced."""
        m = self.telemetry.metrics
        n = m.value("coalesce.dispatches")
        out = {
            "dispatches": int(n),
            "fused_dispatches": int(m.value("coalesce.fused_dispatches")),
            "tasks_fused": int(m.value("coalesce.tasks_fused")),
            "rows_dispatched": int(m.value("coalesce.rows")),
            "mean_tasks_per_dispatch": (
                m.value("coalesce.tasks") / n if n else 0.0),
        }
        # multi-tenant evidence only when it happened — single-tenant runs
        # keep the legacy key set byte-identical (golden schema tests)
        xt = int(m.value("coalesce.cross_tenant_dispatches"))
        if xt:
            with self._lock:
                sets = [list(s) for s in self._fused_tenant_sets]
            out["cross_tenant"] = {
                "dispatches": xt,
                "tasks": int(m.value("coalesce.cross_tenant_tasks")),
                "tenant_sets": sets,
            }
        return out

    def stage_stats(self) -> Dict[str, dict]:
        """Per-stage dispatch counters (see ``_record_stage``), with mean
        occupancy (tasks per dispatch) and mean queue wait derived —
        rebuilt from the registry's ``stage.*`` series, same schema."""
        m = self.telemetry.metrics
        log: Dict[str, dict] = {}
        for stage, c in m.labeled("stage.dispatches", "stage").items():
            tasks = m.value("stage.tasks", stage=stage)
            log[stage] = {
                "dispatches": int(c.get()),
                "tasks": int(tasks),
                "rows": int(m.value("stage.rows", stage=stage)),
                "run_s": m.value("stage.run_s", stage=stage),
                "wait_s": m.value("stage.wait_s", stage=stage),
                "mean_tasks_per_dispatch": tasks / c.get(),
                "mean_wait_s": m.value("stage.wait_s", stage=stage) / tasks,
            }
        return log

    def stage_report(self) -> Dict[str, dict]:
        """The full stage-aware picture for coordinator reports: executor
        dispatch stats merged with the allocator's per-stage grant shapes
        and utilization slices, plus the queue's weighted-fair band
        accounting under the ``"__bands__"`` key."""
        report: Dict[str, dict] = self.stage_stats()
        shapes = self.allocator.stage_shape_stats()
        util = self.allocator.stage_utilization()
        for stage in set(report) | set(shapes):
            sec = report.setdefault(stage, {})
            if stage in shapes:
                sec["grants"] = shapes[stage]
            if stage in util:
                sec["utilization"] = util[stage]
        bands = self.queue.band_stats()
        if bands:
            report["__bands__"] = bands
        return report

    def stats(self) -> dict:
        done = [t for t in self._tasks.values() if t.state == TaskState.DONE]
        setup = [t.setup_time() for t in done if t.setup_time()]
        run = [t.duration() for t in done if t.duration()]
        out = {
            "coalesce": self.coalesce_stats(),
            "n_tasks": len(self._tasks),
            "n_done": len(done),
            "n_failed": sum(1 for t in self._tasks.values()
                            if t.state == TaskState.FAILED),
            "n_retried": sum(t.retries for t in self._tasks.values()),
            "n_preempted": self._preemptions,
            "utilization": self.allocator.utilization(),
            "mean_exec_setup_s": sum(setup) / len(setup) if setup else 0.0,
            "mean_running_s": sum(run) / len(run) if run else 0.0,
        }
        if self._unjoined_workers:
            # only after a shutdown that leaked threads — the legacy key
            # set stays byte-identical otherwise (golden schema tests)
            out["unjoined_workers"] = self._unjoined_workers
        return out

    def telemetry_summary(self) -> dict:
        """The new observability section for ``report()["telemetry"]``:
        per-kind queue-wait / device-time quantile summaries, task
        counters, and span counts when tracing is on."""
        m = self.telemetry.metrics
        kinds: Dict[str, dict] = {}
        for kind, h in m.labeled("task.queue_wait_s", "kind").items():
            kinds.setdefault(kind, {})["queue_wait_s"] = h.summary()
        for kind, h in m.labeled("task.device_s", "kind").items():
            kinds.setdefault(kind, {})["device_s"] = h.summary()
        counters = {}
        for name in ("tasks.submitted", "tasks.completed", "tasks.failed",
                     "tasks.retried", "tasks.canceled"):
            by_kind = {k: int(c.get())
                       for k, c in m.labeled(name, "kind").items()}
            if by_kind:
                counters[name.split(".", 1)[1]] = by_kind
        out = {"kinds": kinds, "counters": counters}
        tenants: Dict[str, dict] = {}
        for tenant, c in m.labeled("tenant.tasks", "tenant").items():
            tenants[tenant] = {"tasks": int(c.get())}
        for tenant, h in m.labeled("tenant.queue_wait_s", "tenant").items():
            tenants.setdefault(tenant, {})["queue_wait_s"] = h.summary()
        for tenant, h in m.labeled("tenant.device_s", "tenant").items():
            tenants.setdefault(tenant, {})["device_s"] = h.summary()
        if tenants:  # multi-tenant gateway only — legacy schema otherwise
            out["tenants"] = tenants
        if self.telemetry.tracer.enabled:
            out["spans"] = self.telemetry.tracer.counts()
        return out
