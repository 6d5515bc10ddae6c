"""The port's resilience layer on the CPU: retry taxonomy, deterministic
backoff, circuit breaker, dead-letter quarantine, fault injection and
device-loss failover (mid-coalesce and with an open admission window).

The JAX package's ``tests/test_resilience.py`` scenarios, run against
``repro_torch.resilience``, the port's ``AsyncExecutor`` and its
``DeviceAllocator`` over four distinct CPU devices (``torch.device("cpu",
i)``: they compare unequal, so ``mark_failed`` loses exactly the one
named). Its two checkpoint scenarios have their twins in
``test_torch_checkpoint.py``. Last, a deterministic chaos campaign, the
port's counterpart of ``tools/check_resilience.py``: a reduced fp32
three-protocol session on those four devices under one spec of each
``FaultSpec`` op, against its fault-free control, both with the pipeline
uid counter pinned. It holds designs and evidence, never a wall clock."""

import collections
import itertools
import os
import re
import shutil
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pipeline import Task, TaskState  # noqa: E402
from repro_torch.resilience import (CircuitBreaker, DeadLetterQueue,  # noqa: E402
                                    FaultPlan, FaultSpec, PermanentError,
                                    ResilienceManager, RetryPolicy,
                                    TransientError, classify)
from repro_torch.runtime.allocator import DeviceAllocator  # noqa: E402
from repro_torch.runtime.executor import AsyncExecutor, CoalesceRule  # noqa: E402
from repro_torch.runtime.scheduler import TaskQueue  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from conftest import given, settings, st  # noqa: F401

CPUS = [torch.device("cpu", i) for i in range(4)]


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tensors here are small, and
    parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _executor(n_dev=4, **kw):
    alloc = DeviceAllocator(CPUS[:n_dev])
    kw.setdefault("max_workers", 2)
    return AsyncExecutor(alloc, **kw)


def _raiser(exc):
    def fn(sub, payload):
        raise exc
    return fn


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def test_classify_taxonomy():
    assert classify(TransientError("flaky")) == "transient"
    assert classify(PermanentError("poison")) == "permanent"
    # deterministic bugs never retry
    for exc in (ValueError("x"), TypeError("x"), KeyError("x"),
                AssertionError("x"), NotImplementedError("x")):
        assert classify(exc) == "permanent"
    # unclassified runtime trouble is assumed transient
    assert classify(RuntimeError("device hiccup")) == "transient"
    assert classify(OSError("io")) == "transient"


# ---------------------------------------------------------------------------
# backoff schedule
# ---------------------------------------------------------------------------

def test_backoff_monotone_bounded_deterministic():
    pol = RetryPolicy(backoff_base_s=0.05, backoff_mult=2.0,
                      backoff_cap_s=1.0, jitter=0.25, seed=7)
    sched = pol.schedule(10, token=42)
    assert sched == pol.schedule(10, token=42)  # deterministic per seed
    assert sched != RetryPolicy(backoff_base_s=0.05, backoff_mult=2.0,
                                backoff_cap_s=1.0, jitter=0.25,
                                seed=8).schedule(10, token=42)
    for a in range(1, len(sched)):
        assert sched[a] >= sched[a - 1]        # monotone non-decreasing
    for a, d in enumerate(sched):
        assert d <= 1.0 + 1e-12                # capped
        raw = 0.05 * (2.0 ** a)
        assert d >= min(1.0, raw) - 1e-12      # at least the raw delay
        assert d <= min(1.0, raw * 1.25) + 1.0e-12 or d <= 1.0
    assert pol.backoff_s(0) > 0


def test_backoff_zero_jitter_is_pure_exponential():
    pol = RetryPolicy(backoff_base_s=0.1, backoff_mult=2.0,
                      backoff_cap_s=100.0, jitter=0.0)
    assert pol.schedule(4) == pytest.approx([0.1, 0.2, 0.4, 0.8])


@settings(max_examples=50, deadline=None)
@given(st.integers(min_value=1, max_value=8),
       st.integers(min_value=0, max_value=2 ** 31 - 1),
       st.floats(min_value=1e-3, max_value=1.0),
       st.floats(min_value=1.0, max_value=3.0),
       st.floats(min_value=0.05, max_value=4.0),
       st.floats(min_value=0.0, max_value=1.0))
def test_backoff_schedule_properties(attempts, token, base, mult, cap,
                                     jitter):
    """Property: every schedule is monotone, bounded by the cap, within the
    jitter envelope, and bit-identical when recomputed."""
    pol = RetryPolicy(backoff_base_s=base, backoff_mult=mult,
                      backoff_cap_s=cap, jitter=jitter, seed=token % 97)
    sched = pol.schedule(attempts, token=token)
    assert len(sched) == attempts
    assert sched == pol.schedule(attempts, token=token)
    for a in range(1, attempts):
        assert sched[a] >= sched[a - 1]
    for a, d in enumerate(sched):
        assert 0.0 < d <= cap + 1e-9
        raw = base * (mult ** a)
        assert d >= min(cap, raw) - 1e-9


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def test_breaker_opens_probes_and_closes():
    clock = [0.0]
    br = CircuitBreaker(2, 5.0, lambda: clock[0])
    key = ("predict", None)
    assert br.allow(key)
    br.record_failure(key)
    assert br.allow(key)                    # one failure: still closed
    br.record_failure(key)                  # threshold reached
    assert not br.allow(key)                # open: shed
    clock[0] = 4.9
    assert not br.allow(key)                # cooldown not elapsed
    clock[0] = 5.0
    assert br.allow(key)                    # half_open: the single probe
    assert not br.allow(key)                # probe in flight: held
    br.record_success(key)                  # probe succeeded
    assert br.allow(key)
    assert br.states()["predict/-"]["state"] == "closed"


def test_breaker_probe_failure_reopens():
    clock = [0.0]
    br = CircuitBreaker(1, 2.0, lambda: clock[0])
    key = ("fold", "refine")
    br.record_failure(key)
    assert not br.allow(key)
    clock[0] = 2.0
    assert br.allow(key)                    # probe
    br.record_failure(key)                  # probe failed: re-open
    assert not br.allow(key)
    assert br.states()["fold/refine"]["state"] == "open"


def test_breaker_disabled_with_zero_threshold():
    br = CircuitBreaker(0, 1.0, lambda: 0.0)
    key = ("k", None)
    for _ in range(50):
        br.record_failure(key)
    assert br.allow(key)
    assert br.states() == {}


def test_breaker_gauge_exported():
    from repro_torch.obs import Telemetry
    tel = Telemetry()
    br = CircuitBreaker(1, 5.0, lambda: 0.0, metrics=tel.metrics)
    br.record_failure(("score", "s1"))
    assert tel.metrics.value("breaker.state", key="score/s1") == 1.0


# ---------------------------------------------------------------------------
# decision logic
# ---------------------------------------------------------------------------

def test_manager_decisions():
    pol = RetryPolicy(max_transient_retries=2, backoff_base_s=0.01,
                      jitter=0.0, breaker_threshold=0)
    mgr = ResilienceManager(pol)
    t = Task(kind="k", payload={})
    action, delay = mgr.decide(t, "transient", fused=False)
    assert action == "retry" and delay > 0
    assert mgr.decide(t, "permanent", fused=False) == ("fail", "permanent")
    t.retries = 2
    assert mgr.decide(t, "transient", fused=False) == ("fail", "exhausted")
    # fused failures always requeue solo (the bisect step), no backoff,
    # even for would-be-permanent classes
    t2 = Task(kind="k", payload={})
    assert mgr.decide(t2, "permanent", fused=True) == ("retry", 0.0)
    t3 = Task(kind="k", payload={})
    t3.canceled = True
    assert mgr.decide(t3, "transient", fused=False) == ("fail", "canceled")
    summary = mgr.summary()
    assert summary["retries"] == 2
    assert summary["failed_by_class"] == {"permanent": 1, "exhausted": 1,
                                          "canceled": 1}


def test_manager_kind_budget():
    pol = RetryPolicy(max_transient_retries=5, backoff_base_s=0.0,
                      jitter=0.0, breaker_threshold=0,
                      kind_budgets={"k": 1})
    mgr = ResilienceManager(pol)
    assert mgr.decide(Task(kind="k", payload={}), "transient",
                      fused=False)[0] == "retry"
    assert mgr.decide(Task(kind="k", payload={}), "transient",
                      fused=False) == ("fail", "budget")
    # other kinds are unaffected
    assert mgr.decide(Task(kind="other", payload={}), "transient",
                      fused=False)[0] == "retry"
    assert mgr.summary()["kind_budget_spent"] == {"k": 1}


def test_deadletter_cap_and_records():
    dlq = DeadLetterQueue(cap=2)
    for i in range(3):
        dlq.record(Task(kind="k", payload={}), error_class="permanent",
                   error=f"boom {i}\ntraceback...")
    assert len(dlq) == 2 and dlq.dropped == 1
    recs = dlq.records()
    assert recs[0]["error"] == "boom 1"     # newest kept, first line only
    assert recs[-1]["class"] == "permanent" and recs[-1]["kind"] == "k"


def test_scheduler_honors_not_before():
    clock = [0.0]
    q = TaskQueue(now_fn=lambda: clock[0])
    held = Task(kind="k", payload={})
    held.not_before = 5.0
    ready = Task(kind="k", payload={})
    q.push(held)
    q.push(ready)
    # the backing-off task is skipped without blocking the one behind it
    assert q.pop_fitting(lambda n: True) is ready
    assert q.pop_fitting(lambda n: True) is None
    clock[0] = 5.0
    assert q.pop_fitting(lambda n: True) is held


# ---------------------------------------------------------------------------
# executor integration (fake devices, plain-Python payloads)
# ---------------------------------------------------------------------------

def test_executor_transient_retry_with_backoff():
    pol = RetryPolicy(max_transient_retries=3, backoff_base_s=0.05,
                      backoff_mult=1.0, jitter=0.0, breaker_threshold=0)
    ex = _executor(retry_policy=pol)
    calls = []

    def fn(sub, payload):
        calls.append(time.monotonic())
        if len(calls) < 3:
            raise TransientError("flaky device")
        return "ok"

    ex.register("flaky", fn)
    ex.submit(Task(kind="flaky", payload={}))
    done = ex.drain(timeout=10)
    ex.shutdown()
    assert done is not None and done.state == TaskState.DONE
    assert done.retries == 2 and done.result == "ok"
    # backoff actually elapsed between attempts (scheduler held the retry)
    assert calls[1] - calls[0] >= 0.04
    assert calls[2] - calls[1] >= 0.04
    summ = ex.resilience_summary()
    assert summ["retries"] == 2
    assert "deadletter" not in summ
    assert ex.telemetry.metrics.value("tasks.retried", kind="flaky") == 2


def test_executor_permanent_fails_fast_to_deadletter():
    ex = _executor()
    ex.register("bad", _raiser(ValueError("deterministic bug")))
    ex.submit(Task(kind="bad", payload={}))
    done = ex.drain(timeout=10)
    ex.shutdown()
    assert done.state == TaskState.FAILED and done.retries == 0
    summ = ex.resilience_summary()
    assert summ["failed_by_class"] == {"permanent": 1}
    assert len(summ["deadletter"]) == 1
    rec = summ["deadletter"][0]
    assert rec["class"] == "permanent" and rec["uid"] == done.uid
    assert ex.telemetry.metrics.value(
        "tasks.failed", **{"class": "permanent"}) == 1


def test_executor_breaker_sheds_after_consecutive_failures():
    pol = RetryPolicy(max_transient_retries=1, backoff_base_s=0.0,
                      jitter=0.0, breaker_threshold=2,
                      breaker_cooldown_s=60.0)
    ex = _executor(max_workers=1, retry_policy=pol)
    ex.register("down", _raiser(TransientError("kind-wide outage")))
    for _ in range(2):   # each task retries once, then exhausts (counted)
        ex.submit(Task(kind="down", payload={}))
        assert ex.drain(timeout=10).state == TaskState.FAILED
    ex.submit(Task(kind="down", payload={}))
    done = ex.drain(timeout=10)
    ex.shutdown()
    # the third task's first failure is shed: breaker open, no retry burned
    assert done.state == TaskState.FAILED and done.retries == 0
    summ = ex.resilience_summary()
    assert summ["failed_by_class"].get("shed") == 1
    assert summ["breakers"]["down/-"]["state"] == "open"
    assert ex.telemetry.metrics.value("breaker.state", key="down/-") == 1.0
    assert ex.telemetry.metrics.value("tasks.shed", kind="down") == 1


def test_executor_deadline_fails_runaway_task():
    pol = RetryPolicy(deadline_s=0.15, breaker_threshold=0)
    ex = _executor(retry_policy=pol)
    holder = {}

    def hang(sub, payload):
        while not holder["t"].canceled:   # cooperative: watchdog cancels
            time.sleep(0.01)
        return "stopped late"

    ex.register("hang", hang)
    t = Task(kind="hang", payload={})
    holder["t"] = t
    ex.submit(t)
    done = ex.drain(timeout=10)
    ex.shutdown()
    assert done.state == TaskState.FAILED
    assert "Deadline" in done.error
    summ = ex.resilience_summary()
    assert summ["deadletter"][0]["class"] == "deadline"
    assert ex.telemetry.metrics.value(
        "tasks.deadline_exceeded", kind="hang") == 1


def test_fault_plan_error_injection_retries_to_done():
    plan = FaultPlan([FaultSpec(op="error", kind="work", at=1, count=2)])
    pol = RetryPolicy(max_transient_retries=3, backoff_base_s=0.0,
                      jitter=0.0, breaker_threshold=0)
    ex = _executor(retry_policy=pol, fault_plan=plan)
    ex.register("work", lambda sub, payload: "ok")
    ex.submit(Task(kind="work", payload={}))
    done = ex.drain(timeout=10)
    ex.shutdown()
    assert done.state == TaskState.DONE and done.retries == 2
    summ = ex.resilience_summary()
    assert summ["faults_injected"]["fired_by_op"] == {"error": 2}
    assert [e["op"] for e in summ["faults_injected"]["events"]] == \
        ["error", "error"]


def test_poison_row_quarantined_batchmates_complete():
    """A sticky poison row kills its fused dispatch; the bisect re-runs
    members solo: the poison row fails permanently into the dead-letter
    queue while its batch-mates complete."""
    plan = FaultPlan([FaultSpec(op="poison", kind="batch", at=1)])
    pol = RetryPolicy(max_transient_retries=2, backoff_base_s=0.0,
                      jitter=0.0, breaker_threshold=0)
    ex = _executor(max_workers=1, retry_policy=pol, fault_plan=plan)
    rule = CoalesceRule(
        key=lambda t: "x",
        merge=lambda ms: {"n": len(ms)},
        split=lambda ms, r: [r] * len(ms),
        rows=lambda t: 1, max_rows=8)
    gate = threading.Event()
    ex.register("block", lambda sub, payload: gate.wait(10))
    ex.register("batch", lambda sub, payload: "ok")
    ex.register_coalescable("batch", rule)
    ex.submit(Task(kind="block", payload={}))
    time.sleep(0.1)   # the single worker is now busy: next 3 will coalesce
    tasks = [Task(kind="batch", payload={"i": i}) for i in range(3)]
    for t in tasks:
        ex.submit(t)
    gate.set()
    results = [ex.drain(timeout=10) for _ in range(4)]
    ex.shutdown()
    assert all(r is not None for r in results)
    by_uid = {r.uid: r for r in results if r.kind == "batch"}
    failed = [r for r in by_uid.values() if r.state == TaskState.FAILED]
    done = [r for r in by_uid.values() if r.state == TaskState.DONE]
    assert len(failed) == 1 and len(done) == 2
    assert "poison" in failed[0].error
    # batch-mates completed on their solo re-run (the bisect step)
    assert all(r.retries == 1 for r in done)
    summ = ex.resilience_summary()
    assert len(summ["deadletter"]) == 1
    assert summ["deadletter"][0]["uid"] == failed[0].uid
    assert summ["deadletter"][0]["class"] == "permanent"
    assert summ["faults_injected"]["fired_by_op"]["poison"] >= 2


def test_device_loss_mid_coalesced_dispatch_requeues_exactly_once():
    """Satellite: a device failure mid-fused-dispatch cancels every member
    exactly once, submits one clone per victim, and a second failure on the
    same device clones nothing — no double completions."""
    ex = _executor(n_dev=4, max_workers=1)
    rule = CoalesceRule(
        key=lambda t: "x",
        merge=lambda ms: {"n": len(ms)},
        split=lambda ms, r: [r] * len(ms),
        rows=lambda t: 1, max_rows=8)
    phase = [1]
    started = threading.Event()

    def fn(sub, payload):
        started.set()
        t0 = time.monotonic()
        while phase[0] == 1 and time.monotonic() - t0 < 10:
            time.sleep(0.005)
        return "ok"

    gate = threading.Event()
    ex.register("block", lambda sub, payload: gate.wait(10))
    ex.register("batch", fn)
    ex.register_coalescable("batch", rule)
    ex.submit(Task(kind="block", payload={}))
    time.sleep(0.1)
    tasks = [Task(kind="batch", payload={"i": i}) for i in range(3)]
    for t in tasks:
        ex.submit(t)
    gate.set()
    assert started.wait(5)
    time.sleep(0.05)   # let the fused dispatch settle into _running
    with ex._lock:
        entry = ex._running.get(tasks[0].uid)
    assert entry is not None
    victim_dev = entry[1].devices.flat[0]
    requeued = ex.inject_device_failure(victim_dev)
    assert len(requeued) == 3
    assert all(t.canceled for t in tasks)
    # exactly once: a second failure of the same device clones nothing
    assert ex.inject_device_failure(victim_dev) == []
    phase[0] = 2
    results = [ex.drain(timeout=10) for _ in range(7)]
    ex.shutdown()
    assert all(r is not None for r in results)
    batch = [r for r in results if r.kind == "batch"]
    canceled = [r for r in batch if r.state == TaskState.CANCELED]
    done = [r for r in batch if r.state == TaskState.DONE]
    assert len(canceled) == 3 and len(done) == 3
    assert {r.uid for r in canceled} == {t.uid for t in tasks}
    assert {r.uid for r in done} == {c.uid for c in requeued}
    # no uid completed twice
    assert len({r.uid for r in batch}) == 6
    assert ex.telemetry.metrics.value(
        "tasks.device_lost", kind="batch") == 3


def test_device_loss_during_open_admission_window():
    """Satellite: a device failure while the dispatch's admission window is
    still open must stop the window from admitting more work — otherwise
    the victims' own failover clones get pulled onto the dead sub-mesh."""
    ex = _executor(n_dev=4, max_workers=1)
    calls = []
    rule = CoalesceRule(
        key=lambda t: "x",
        merge=lambda ms: {"n": len(ms)},
        split=lambda ms, r: [r] * len(ms),
        rows=lambda t: 1, max_rows=8,
        admission_window=1.0)

    def fn(sub, payload):
        calls.append(payload)
        return "ok"

    ex.register("batch", fn)
    ex.register_coalescable("batch", rule)
    leader = Task(kind="batch", payload={"i": 0})
    ex.submit(leader)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:   # wait for the window to open
        with ex._lock:
            if leader.uid in ex._running:
                break
        time.sleep(0.005)
    late = Task(kind="batch", payload={"i": 1})
    ex.submit(late)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:   # late task admitted into window
        with ex._lock:
            if late.uid in ex._running:
                break
        time.sleep(0.005)
    with ex._lock:
        entry = ex._running[leader.uid]
    requeued = ex.inject_device_failure(entry[1].devices.flat[0])
    assert len(requeued) == 2            # leader + admitted member
    results = [ex.drain(timeout=10) for _ in range(4)]
    ex.shutdown()
    assert all(r is not None for r in results)
    canceled = [r for r in results if r.state == TaskState.CANCELED]
    done = [r for r in results if r.state == TaskState.DONE]
    assert {r.uid for r in canceled} == {leader.uid, late.uid}
    assert {r.uid for r in done} == {c.uid for c in requeued}
    # the clones ran in their own dispatch, not the doomed window:
    # two separate payload-fn invocations
    assert len(calls) == 2


def test_live_admission_port_refuses_canceled_leader():
    """The continuous-batching port must go inert once its leader is
    canceled (device loss): take() returns nothing."""
    ex = _executor(n_dev=2, max_workers=1)
    rule = CoalesceRule(
        key=lambda t: "x",
        merge=lambda ms: {"n": len(ms)},
        split=lambda ms, r: [r] * len(ms),
        rows=lambda t: 1, max_rows=8, live=True)
    taken_before = []
    taken_after = []

    def fn(sub, payload):
        if holder.get("ran"):             # later dispatches (the refused
            return "ok"                   # task re-dispatched) stay inert
        holder["ran"] = True
        port = payload["_admit"]
        leader = holder["leader"]
        taken_before.extend(port.take(4))
        leader.canceled = True            # simulate a device-loss cancel
        ex.submit(Task(kind="batch", payload={"i": 9}))
        time.sleep(0.05)
        taken_after.extend(port.take(4))  # must refuse: leader canceled
        return "ok"

    holder = {}
    ex.register("batch", fn)
    ex.register_coalescable("batch", rule)
    leader = Task(kind="batch", payload={"i": 0})
    holder["leader"] = leader
    ex.submit(leader)
    results = [ex.drain(timeout=10) for _ in range(2)]
    ex.shutdown()
    assert taken_after == []
    states = sorted(r.state.name for r in results if r is not None)
    assert states == ["CANCELED", "DONE"]


def test_speculative_duplicate_of_victim_is_canceled():
    """Straggler duplicates of a device-loss victim are canceled: the
    failover clone is the single replacement, so the pipeline can never
    double-advance."""
    ex = _executor(n_dev=4, max_workers=2)
    release = threading.Event()
    ex.register("slow", lambda sub, payload: release.wait(10) and "ok"
                or "ok")
    victim = Task(kind="slow", payload={})
    ex.submit(victim)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with ex._lock:
            if victim.uid in ex._running:
                break
        time.sleep(0.005)
    # hand-made speculative duplicate (the watchdog path needs timing
    # history; submitting one directly exercises the same cancel logic)
    dup = Task(kind="slow", payload={}, speculative_of=victim.uid)
    ex.submit(dup)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with ex._lock:
            if dup.uid in ex._running:
                break
        time.sleep(0.005)
    with ex._lock:
        sub = ex._running[victim.uid][1]
    requeued = ex.inject_device_failure(sub.devices.flat[0])
    assert len(requeued) == 1 and requeued[0].kind == "slow"
    assert dup.canceled                   # duplicate dies with its victim
    release.set()
    results = [ex.drain(timeout=10) for _ in range(3)]
    ex.shutdown()
    done = [r for r in results if r is not None
            and r.state == TaskState.DONE]
    assert {r.uid for r in done} == {requeued[0].uid}


def test_shutdown_reports_unjoined_workers():
    """Satellite: shutdown() must not silently leak a blocked worker —
    the leak is counted in stats() and on the metrics registry."""
    ex = _executor(n_dev=2, max_workers=2)
    gate = threading.Event()
    ex.register("stuck", lambda sub, payload: gate.wait(30))
    ex.submit(Task(kind="stuck", payload={}))
    time.sleep(0.2)
    ex.shutdown(wait=True)
    try:
        assert ex._unjoined_workers == 1
        assert ex.stats()["unjoined_workers"] == 1
        assert ex.telemetry.metrics.value("executor.unjoined_workers") == 1
    finally:
        gate.set()


def test_shutdown_clean_keeps_legacy_stats_schema():
    ex = _executor(n_dev=2, max_workers=2)
    ex.register("quick", lambda sub, payload: "ok")
    ex.submit(Task(kind="quick", payload={}))
    assert ex.drain(timeout=10).state == TaskState.DONE
    ex.shutdown(wait=True)
    assert "unjoined_workers" not in ex.stats()



# ---------------------------------------------------------------------------
# the fault plan against the reference's, on one schedule
# ---------------------------------------------------------------------------

class _Dev:
    """A stand-in device for the reference's allocator: the fields its
    mesh reads, no backend."""

    def __init__(self, i):
        self.id = i
        self.platform = "cpu"
        self.process_index = 0

    def __repr__(self):
        return f"_Dev({self.id})"


def _pkg(name):
    """The names one package's fault scenario needs."""
    import importlib

    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    # the reference test's import order: its package has a cycle that
    # this order enters at the right end
    pl = mod("core.pipeline")
    res, alloc = mod("resilience"), mod("runtime.allocator")
    ex = mod("runtime.executor")
    devices = CPUS if name == "repro_torch" else [_Dev(i) for i in range(4)]
    return types.SimpleNamespace(
        Task=pl.Task, TaskState=pl.TaskState,
        ResourceRequest=pl.ResourceRequest, FaultPlan=res.FaultPlan,
        FaultSpec=res.FaultSpec, RetryPolicy=res.RetryPolicy,
        maybe_corrupt=res.maybe_corrupt,
        AsyncExecutor=ex.AsyncExecutor, CoalesceRule=ex.CoalesceRule,
        DeviceAllocator=alloc.DeviceAllocator,
        devices=devices)


def _fault_specs(P):
    """One schedule of every op: a transient and a permanent error and a
    slowdown on solo dispatches, a poison row designated on the second
    fused dispatch, a device lost under a two-device dispatch, and two
    corrupted checkpoints."""
    return P.FaultPlan([
        P.FaultSpec(op="error", kind="work", at=2, count=1),
        P.FaultSpec(op="slow", kind="work", at=3, delay_s=0.01),
        P.FaultSpec(op="error", kind="work", at=4, count=1,
                    error_class="permanent"),
        P.FaultSpec(op="poison", kind="batch", at=2),
        P.FaultSpec(op="device_loss", kind="dl", at=1, device_index=1),
        P.FaultSpec(op="corrupt_checkpoint", at=2, count=2),
    ], seed=11)


def _fault_scenario(name, ckpt_dir):
    """Drive one task stream through ``name``'s executor under
    ``_fault_specs``: four solo tasks, two fused dispatches of three rows,
    one two-device task, then four checkpoint writes. Returns what it saw,
    with task uids replaced by their rank among the stream's uids (each
    package counts uids on its own) and times dropped."""
    P = _pkg(name)
    plan = _fault_specs(P)
    pol = P.RetryPolicy(max_transient_retries=2, backoff_base_s=0.0,
                        jitter=0.0, breaker_threshold=0)
    ex = P.AsyncExecutor(P.DeviceAllocator(P.devices), max_workers=1,
                         retry_policy=pol, fault_plan=plan)
    ex.register("work", lambda sub, payload: payload["i"])
    ex.register("batch", lambda sub, payload: payload.get("n", 1))
    ex.register("dl", lambda sub, payload: sub.n_devices)
    gate = threading.Event()
    ex.register("block", lambda sub, payload: gate.wait(10))
    ex.register_coalescable("batch", P.CoalesceRule(
        key=lambda t: "x", merge=lambda ms: {"n": len(ms)},
        split=lambda ms, r: [r] * len(ms), rows=lambda t: 1, max_rows=8))
    results, uids = [], []

    def submit(t):
        uids.append(t.uid)
        ex.submit(t)

    try:
        for i in range(4):
            submit(P.Task(kind="work", payload={"i": i}))
            results.append(ex.drain(timeout=10))
        for rnd in range(2):
            gate.clear()
            submit(P.Task(kind="block", payload={}))
            time.sleep(0.1)   # the one worker is busy: the rows coalesce
            for i in range(3):
                submit(P.Task(kind="batch", payload={"i": i}))
            gate.set()
            results += [ex.drain(timeout=10) for _ in range(4)]
        submit(P.Task(kind="dl", payload={},
                      resources=P.ResourceRequest(2)))
        results += [ex.drain(timeout=10) for _ in range(2)]
    finally:
        ex.shutdown()
    assert all(r is not None for r in results), name
    uids += [r.uid for r in results]
    rank = {u: i for i, u in enumerate(sorted(set(uids)))}
    norm = lambda text: re.sub(  # noqa: E731
        r"uid=(\d+)", lambda m: f"uid=#{rank[int(m.group(1))]}", text)

    src = os.path.join(ckpt_dir, "src.bin")
    with open(src, "wb") as f:
        f.write(bytes(range(256)) * 3)
    flips = []
    for i in range(4):
        path = os.path.join(ckpt_dir, f"ckpt-{i}.bin")
        shutil.copyfile(src, path)
        hit = P.maybe_corrupt(path, plan)
        with open(path, "rb") as f:
            flips.append((hit, f.read()))
    assert P.maybe_corrupt(src, None) is False

    summ = ex.resilience_summary()
    for rec in summ.get("deadletter", []):
        rec.pop("t")
        rec["uid"] = rank[rec["uid"]]
        rec["error"] = norm(rec["error"])
    for ev in summ["faults_injected"]["events"]:
        if "uid" in ev:
            ev["uid"] = rank[ev["uid"]]
        if "path" in ev:
            ev["path"] = os.path.basename(ev["path"])
    alloc = ex.allocator
    return {
        "results": [(rank[r.uid], r.kind, r.state.name, r.retries,
                     r.result if r.state.name == "DONE" else None,
                     norm(r.error.splitlines()[0]) if r.error else None)
                    for r in results],
        "summary": summ,
        "dead_devices": [i for i, d in enumerate(alloc.dead.flat) if d],
        "device_lost": ex.telemetry.metrics.value("tasks.device_lost",
                                                  kind="dl"),
        "flips": flips,
    }


def test_fault_plan_matches_reference_on_one_schedule(tmp_path):
    """The same ``FaultSpec`` schedule and task stream through the
    reference's ``FaultPlan`` and ``AsyncExecutor`` and the port's: the
    same tasks fail, retry, cancel and clone; the same dispatch counts as
    each spec's ``at``; the same row is poisoned, fused and then solo; the
    same device is lost; the resilience summaries (retries, failure
    classes, dead-letter records, fired faults and their events) are
    equal; and the checkpoint seam flips the same byte of the same
    writes."""
    got = {}
    for name in ("repro", "repro_torch"):
        d = tmp_path / name
        d.mkdir()
        got[name] = _fault_scenario(name, str(d))
    ref, port = got["repro"], got["repro_torch"]
    assert port["results"] == ref["results"]
    assert port["summary"] == ref["summary"]
    assert port["dead_devices"] == ref["dead_devices"] == [1]
    assert port["device_lost"] == ref["device_lost"] == 1
    assert port["flips"] == ref["flips"]

    # the schedule really exercised every op, as the reference fires it
    fired = port["summary"]["faults_injected"]["fired_by_op"]
    assert set(fired) == {"error", "slow", "poison", "device_loss",
                          "corrupt_checkpoint"}
    assert fired["corrupt_checkpoint"] == 2
    assert [h for h, _ in port["flips"]] == [False, True, True, False]
    assert port["flips"][1][1] != port["flips"][0][1]
    poison = [e for e in port["summary"]["faults_injected"]["events"]
              if e["op"] == "poison"]
    assert poison[0]["fused"] and not poison[-1]["fused"]
    assert len(port["summary"]["deadletter"]) == 2
    states = collections.Counter(s for _, _, s, *_ in port["results"])
    assert states["CANCELED"] == 1 and states["FAILED"] == 2


# ---------------------------------------------------------------------------
# the chaos campaign (tools/check_resilience.py's scenario, deterministic)
# ---------------------------------------------------------------------------

def _f32_payload():
    """A reduced seeded port payload computing in fp32 in every namespace
    the chaos session uses, so a design never depends on which rows
    shared its batch."""
    import dataclasses

    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.payload import ProteinPayload

    f32 = lambda name: dataclasses.replace(get_reduced(name),  # noqa: E731
                                           compute_dtype="float32")
    pp = ProteinPayload(seed=0, gen_cfg=f32("progen-s"),
                        fold_cfg=f32("foldscore-s"), device=CPUS[0])
    pp.add_generator("binder", cfg=f32("progen-s"))
    pp.add_scorer("multimer", cfg=f32("foldscore-m"))
    return pp


@pytest.mark.parametrize("masked", [False, True])
def test_fold_row_scores_do_not_depend_on_their_batch(masked):
    """One row's ``predict_batch`` scores, bitwise, whatever shares its
    dispatch: alone, among 2-8 rows (fused tasks), split one row a device
    over a two-device grant, and as a solo ``predict``. The chaos session
    below fuses, retries solo and re-grants rows as faults and timing fall,
    and compares its designs' scores with its control's exactly; a
    one-row product rounding otherwise than the same row among others
    (the target descriptor's (B, 16) x (16, d) projection, ~1e-6 on the
    CPU) would make that comparison depend on the timing."""
    import numpy as np

    from repro_torch.runtime.allocator import SubMesh
    payload = _f32_payload()
    rng = np.random.default_rng(0)
    seqs = rng.integers(1, 20, (8, 16)).astype(np.int32)
    target = rng.standard_normal((8, 16)).astype(np.float32)

    def scores(rows, devices=CPUS[:1]):
        p = {"sequences": seqs[:rows], "target": target[:rows],
             "receptor_len": 12}
        if masked:
            p["seq_lens"] = np.full(rows, 16, np.int32)
        got = payload.predict_batch(SubMesh(devices=devices), p)["rows"]
        return [(r["plddt"], r["ptm"], r["pae"]) for r in got]

    alone = [scores(1)[0]]
    for rows in range(2, 9):
        assert scores(rows)[0] == alone[0], rows
    assert scores(2, CPUS[:2]) == scores(2)
    one = {"sequence": seqs[0], "target": target[0], "receptor_len": 12}
    if masked:
        one["seq_len"] = 16
    solo = payload.predict(SubMesh(devices=CPUS[:1]), one)
    assert (solo["plddt"], solo["ptm"], solo["pae"]) == alone[0]


def _chaos_plan():
    """check_resilience.py's schedule, plus a slow dispatch and a
    corrupted checkpoint: one spec of each op."""
    return FaultPlan([
        FaultSpec(op="error", kind="predict", at=2, count=1),
        FaultSpec(op="error", kind="generate", at=3, count=1),
        FaultSpec(op="slow", kind="generate", at=2, delay_s=0.05),
        FaultSpec(op="device_loss", at=4, device_index=3),
        FaultSpec(op="poison", kind="predict", at=5),
        FaultSpec(op="corrupt_checkpoint", at=2),
    ], seed=0)


def _chaos_run(payload, plan, uid0):
    from repro_torch.core import pipeline
    from repro_torch.session import (CampaignSpec, ImpressSession,
                                     ProtocolSpec)

    spec = CampaignSpec(
        structures=2, receptor_len=12, peptide_len=4,
        protocols=(ProtocolSpec("cont-v", n_cycles=2, n_candidates=3),
                   ProtocolSpec("multi-objective", n_cycles=2,
                                n_candidates=3),
                   ProtocolSpec("binder", n_cycles=1, n_candidates=2,
                                score_batch=2)),
        resilience={"max_transient_retries": 3, "backoff_base_s": 0.02,
                    "backoff_cap_s": 0.25, "jitter": 0.25,
                    "breaker_threshold": 0},
        max_workers=4, timeout=240, seed=0)
    with ImpressSession(spec, payload=payload, devices=CPUS,
                        fault_plan=plan) as sess:
        pipeline._uid = itertools.count(uid0)
        rep = sess.run(timeout=240)
        healthy = sess.allocator.healthy_devices
        histories = {pl.name: [dict(h) for h in pl.history]
                     for pl in sess.coordinator.pipelines.values()}
        kinds = collections.Counter(
            t.kind for t in sess.executor._tasks.values()
            if t.state == TaskState.DONE)
    return rep, histories, healthy, kinds


def _checkpoint_leg(plan, tmp_path):
    """The plan's corrupt_checkpoint spec on the second of two manager
    checkpoints: verify-on-restore rejects it and falls back to step 1."""
    from repro_torch.checkpoint.io import verify_checkpoint
    from repro_torch.checkpoint.manager import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    good = {"w": torch.arange(64, dtype=torch.float32)}
    for step, w in ((1, good["w"]), (2, good["w"] * 2)):
        mgr.save(step, {"w": w}, extra={"step": step}, block=True)
        plan.on_checkpoint_saved(mgr._base(step) + ".npz")
    assert verify_checkpoint(mgr._base(1))
    assert not verify_checkpoint(mgr._base(2))
    state, extra, step = mgr.restore({"w": torch.zeros(64)})
    assert step == 1 and extra == {"step": 1}
    assert torch.equal(state["w"], good["w"])


def test_chaos_campaign_matches_control(tmp_path):
    """A three-protocol session (cont-v, multi-objective, the staged
    binder) on four CPU devices under one fault of each op, against the
    same session without faults, both from one pipeline uid: it completes;
    every pipeline but the quarantined one accepts the control's designs,
    and the quarantined one's history is a prefix of its control's; the
    report's resilience evidence (retries, the dead-letter record naming
    the pipeline, the faults fired, the device lost) matches the schedule;
    the corrupted checkpoint falls back to the previous step."""
    from repro_torch.core import pipeline

    payload = _f32_payload()
    uid0 = next(pipeline._uid) + 1
    ctl_rep, control, ctl_healthy, _ = _chaos_run(payload, None, uid0)
    plan = _chaos_plan()
    rep, chaos, healthy, kinds = _chaos_run(payload, plan, uid0)

    assert ctl_rep.executor["n_failed"] == 0 and ctl_healthy == 4
    assert healthy == 3                        # one device lost
    res = rep["resilience"]
    dead = res.get("deadletter", [])
    poison = [r for r in dead if r["class"] == "permanent"
              and "poison" in (r["error"] or "")]
    assert len(poison) == 1, dead
    quarantined = poison[0]["pipeline"]
    assert quarantined in control
    assert res["retries"] >= 2                 # the two transient faults
    fired = res["faults_injected"]["fired_by_op"]
    assert fired["error"] == 2 and fired["device_loss"] == 1
    assert fired["slow"] == 1 and fired["poison"] >= 1
    assert "corrupt_checkpoint" not in fired   # no checkpoint written yet
    assert kinds["predict"] > 0 and kinds["generate"] > 0

    assert set(chaos) == set(control)
    for name, ctl in control.items():
        if name == quarantined:
            assert chaos[name] == ctl[:len(chaos[name])], name
        else:
            assert chaos[name] == ctl, name
    assert sum(len(h) for n, h in chaos.items() if n != quarantined) > 0

    _checkpoint_leg(plan, tmp_path)
    assert plan.summary()["fired_by_op"]["corrupt_checkpoint"] == 1
