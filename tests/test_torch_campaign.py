"""The port's campaign engine on the CPU: the copied modules (protocol,
coordinator, executor, scheduler, allocator, observability) run the JAX
package's own jax-free scenarios, each parametrised over both packages;
then a reduced im-rp campaign with real (reduced, fp32) payload models runs
in both packages, in its default form (dense ``generate``, solo
``predict``) and its batched form (paged ``generate_batch`` with live
admission, ``predict_batch`` of the top 3), and must give the same tasks,
events, occupancy reporting and accepted designs.

The port is fed the Gumbel draws the reference's key schedule makes from
each task's seed (``NoisedPayload``), so its tokens are the reference's.
Pipeline and task uids come from a counter in each package's
``core/pipeline.py`` and sampling seeds depend on them, so both campaigns
start their counters at the same value."""

import collections
import importlib
import itertools
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import payload as ref_payload  # noqa: E402
from repro_torch.core.payload import ProteinPayload  # noqa: E402
from test_torch_payload import jax_noise, payloads  # noqa: E402
from test_torch_sampler import schedule_noise  # noqa: E402

PKGS = ("repro", "repro_torch")


class Pkg:
    """One package's copies of the campaign engine's modules."""

    def __init__(self, name):
        self.name = name
        for attr, mod in (("pipeline", "core.pipeline"),
                          ("protocol", "core.protocol"),
                          ("coordinator", "core.coordinator"),
                          ("allocator", "runtime.allocator"),
                          ("executor", "runtime.executor"),
                          ("scheduler", "runtime.scheduler"),
                          ("obs", "obs"), ("metrics", "obs.metrics"),
                          ("synthetic", "data.synthetic")):
            setattr(self, attr, importlib.import_module(f"{name}.{mod}"))
        self.Task = self.pipeline.Task
        self.ResourceRequest = self.pipeline.ResourceRequest
        self.TaskState = self.pipeline.TaskState
        self.DeviceAllocator = self.allocator.DeviceAllocator
        self.AsyncExecutor = self.executor.AsyncExecutor

    def devices(self):
        """The package's own device list: the JAX CPU device, or the
        torch CPU device."""
        return (jax.devices()[:1] if self.name == "repro"
                else [torch.device("cpu")])

    def executor_on_devices(self, **kw):
        return self.AsyncExecutor(self.DeviceAllocator(self.devices()), **kw)

    def proto(self, adaptive=True, **kw):
        kw.setdefault("n_candidates", 4)
        kw.setdefault("n_cycles", 3)
        kw.setdefault("gen_devices", 1)
        kw.setdefault("predict_devices", 1)
        return self.protocol.ImpressProtocol(
            self.protocol.ProtocolConfig(adaptive=adaptive, **kw))


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


class FakeDev:
    """Stands in for a device in allocator-only tests."""
    _n = 0

    def __init__(self):
        FakeDev._n += 1
        self.id = FakeDev._n


def fake_grid(*shape):
    n = int(np.prod(shape))
    return np.array([FakeDev() for _ in range(n)],
                    dtype=object).reshape(shape)


def wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


# ---------------------------------------------------------------------------
# allocator (test_runtime.py's scenarios)
# ---------------------------------------------------------------------------

def test_carve_release_reuse(pkg):
    alloc = pkg.DeviceAllocator(fake_grid(4, 4))
    subs = [alloc.request(4) for _ in range(4)]
    assert all(s is not None for s in subs)
    assert alloc.n_free == 0
    assert alloc.request(1) is None
    alloc.release(subs[0])
    assert alloc.n_free == 4
    assert alloc.request(2) is not None


def test_block_shapes_prefers_square(pkg):
    assert pkg.allocator._block_shapes(4, (4, 4))[0] == (2, 2)


def test_failure_shrinks_pool_and_reports_hit(pkg):
    alloc = pkg.DeviceAllocator(fake_grid(2, 2))
    sub = alloc.request(2)
    assert sub.devices.shape == sub.shape and sub.n_devices == 2
    hit = alloc.mark_failed(sub.devices.flat[0])
    assert [h.uid for h in hit] == [sub.uid]
    alloc.release(sub)
    assert alloc.healthy_devices == 3
    assert alloc.n_free == 3
    assert alloc.request(4) is None


def test_allocator_conservation_invariant(pkg):
    """free + allocated == healthy devices, always; no device is granted
    twice (a seeded walk over test_runtime.py's property)."""
    rng = np.random.default_rng(0)
    alloc = pkg.DeviceAllocator(fake_grid(4, 4))
    live = []
    for _ in range(60):
        if rng.random() < 0.4 and live:
            alloc.release(live.pop(int(rng.integers(len(live)))))
        else:
            sub = alloc.request(int(rng.choice([1, 2, 4])))
            if sub is not None:
                live.append(sub)
        used = sum(s.n_devices for s in live)
        assert alloc.n_free + used == alloc.healthy_devices
        ids = [d.id for s in live for d in s.devices.flat]
        assert len(ids) == len(set(ids))


def test_utilization_accounting(pkg):
    alloc = pkg.DeviceAllocator(fake_grid(2))
    sub = alloc.request(2)
    time.sleep(0.05)
    alloc.release(sub)
    assert 0.0 < alloc.utilization() <= 1.0
    ts, busy = alloc.busy_timeline(resolution=0.01)
    assert len(ts) == len(busy) and max(busy) == 2


def test_request_for_rows_halving_under_contention(pkg):
    alloc = pkg.DeviceAllocator(fake_grid(8))
    hog = alloc.request(5)
    sub = alloc.request_for_rows(32)
    assert sub is not None and sub.n_devices == 2
    small = alloc.request_for_rows(8)
    assert small is not None and small.n_devices == 1
    assert alloc.request_for_rows(4) is None
    alloc.release(small)
    assert alloc.request_for_rows(64, floor=2) is None
    alloc.release(hog)
    alloc.release(sub)
    floored = alloc.request_for_rows(1, floor=4)
    assert floored.n_devices == 4


def test_shape_stats_across_mixed_grant_shapes(pkg):
    alloc = pkg.DeviceAllocator(fake_grid(8))
    subs = [alloc.request_for_rows(r) for r in (1, 3, 16)]
    assert [s.n_devices for s in subs] == [1, 4, 2]
    st = alloc.shape_stats()
    assert st["grants"] == 3 and st["downsized"] == 1
    assert st["mean_granted"] == (1 + 4 + 2) / 3
    assert abs(st["mean_rows_per_device"]
               - (1 / 1 + 3 / 4 + 16 / 2) / 3) < 1e-9


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def test_backfill_small_task_jumps_queue(pkg):
    Task, RR = pkg.Task, pkg.ResourceRequest
    q = pkg.scheduler.TaskQueue(backfill=True)
    big = Task(kind="x", payload={}, resources=RR(8), priority=0)
    small = Task(kind="x", payload={}, resources=RR(1), priority=5)
    q.push(big)
    q.push(small)
    assert q.pop_fitting(lambda n: n <= 2).uid == small.uid
    q2 = pkg.scheduler.TaskQueue(backfill=False)
    q2.push(Task(kind="x", payload={}, resources=RR(8)))
    q2.push(Task(kind="x", payload={}, resources=RR(1)))
    assert q2.pop_fitting(lambda n: n <= 2) is None


def test_priority_order(pkg):
    q = pkg.scheduler.TaskQueue()
    t1 = pkg.Task(kind="x", payload={}, priority=5)
    t2 = pkg.Task(kind="x", payload={}, priority=1)
    q.push(t1)
    q.push(t2)
    assert q.pop_fitting(lambda n: True).uid == t2.uid


# ---------------------------------------------------------------------------
# executor on the package's own device
# ---------------------------------------------------------------------------

@pytest.fixture
def executor(pkg):
    ex = pkg.executor_on_devices(max_workers=2, max_retries=2)
    yield ex
    ex.shutdown()


def test_executor_lifecycle_and_states(pkg, executor):
    executor.register("inc", lambda sm, p: p["x"] + 1)
    executor.submit(pkg.Task(kind="inc", payload={"x": 41},
                             resources=pkg.ResourceRequest(1)))
    done = executor.drain(timeout=10)
    assert done.result == 42 and done.state == pkg.TaskState.DONE
    for s in ("QUEUED", "SCHEDULED", "EXEC_SETUP", "RUNNING", "DONE"):
        assert s in done.timestamps


def test_executor_retries_then_succeeds(pkg, executor):
    calls = {"n": 0}

    def flaky(submesh, payload):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return "ok"

    executor.register("flaky", flaky)
    executor.submit(pkg.Task(kind="flaky", payload={}))
    done = executor.drain(timeout=10)
    assert done.state == pkg.TaskState.DONE and done.retries == 2


def test_executor_fails_after_max_retries(pkg, executor):
    def always(submesh, payload):
        raise ValueError("nope")

    executor.register("bad", always)
    executor.submit(pkg.Task(kind="bad", payload={}))
    done = executor.drain(timeout=10)
    assert done.state == pkg.TaskState.FAILED and "nope" in done.error


def test_cancel_queued_task(pkg, executor):
    gate = threading.Event()
    executor.register("slow", lambda sm, p: gate.wait(timeout=5))
    t1 = pkg.Task(kind="slow", payload={})
    t2 = pkg.Task(kind="slow", payload={})
    executor.submit(t1)
    time.sleep(0.1)
    executor.submit(t2)
    executor.cancel(t2.uid)
    gate.set()
    states = {executor.drain(timeout=10).state for _ in range(2)}
    assert pkg.TaskState.CANCELED in states
    assert pkg.TaskState.DONE in states


def test_device_failure_injection_requeues(pkg):
    ex = pkg.executor_on_devices(max_workers=2, max_retries=2)
    started = threading.Event()
    t = pkg.Task(kind="work", payload={})

    def fn(submesh, payload):
        started.set()
        for _ in range(200):
            if t.canceled:
                raise RuntimeError("killed by failure")
            time.sleep(0.01)
        return "finished"

    ex.register("work", fn)
    ex.submit(t)
    started.wait(timeout=5)
    requeued = ex.inject_device_failure(pkg.devices()[0])
    assert len(requeued) == 1
    assert ex.allocator.healthy_devices == 0
    ex.shutdown()


def test_stats_fields(pkg, executor):
    executor.register("inc", lambda sm, p: 1)
    executor.submit(pkg.Task(kind="inc", payload={}))
    executor.drain(timeout=10)
    s = executor.stats()
    assert s["n_done"] == 1 and s["n_tasks"] == 1
    assert 0 <= s["utilization"] <= 1.0


def test_coalesced_members_link_to_fused_dispatch_span(pkg):
    """test_obs.py's scenario: every member of a fused batch records the
    same dispatch span, which records every member uid."""
    tel = pkg.obs.Telemetry(tracer=pkg.obs.Tracer())
    ex = pkg.AsyncExecutor(pkg.DeviceAllocator(fake_grid(1), telemetry=tel),
                           max_workers=2, telemetry=tel)
    rule = pkg.executor.CoalesceRule(
        key=lambda t: t.kind,
        merge=lambda ms: {"xs": [m.payload["x"] for m in ms]},
        split=lambda ms, r: list(r), rows=lambda t: 1, max_rows=16)
    ex.register("fuse", lambda sm, p: [x * 2 for x in p["xs"]])
    ex.register_coalescable("fuse", rule)
    gate = threading.Event()
    ex.register("blocker", lambda sm, p: gate.wait(timeout=30))
    ex.submit(pkg.Task(kind="blocker", payload={}))
    wait_for(lambda: ex.allocator.n_free == 0)
    for i in range(4):
        ex.submit(pkg.Task(kind="fuse", payload={"x": i}))
    gate.set()
    done = [ex.drain(timeout=10) for _ in range(5)]
    members = [d for d in done if d.kind == "fuse"]
    assert {d.result for d in members} == {0, 2, 4, 6}
    (span_id,) = {d.trace["dispatches"][0] for d in members}
    span = next(s for s in tel.tracer.dispatch_records()
                if s["id"] == span_id)
    assert sorted(span["members"]) == sorted(d.uid for d in members)
    assert span["rows"] == 4
    ex.shutdown()


def test_trace_export_validates_and_has_full_chains(pkg, tmp_path):
    tel = pkg.obs.Telemetry(tracer=pkg.obs.Tracer())
    ex = pkg.AsyncExecutor(pkg.DeviceAllocator(fake_grid(4), telemetry=tel),
                           max_workers=2, telemetry=tel)
    ex.register("noop", lambda sm, p: None)
    for _ in range(3):
        ex.submit(pkg.Task(kind="noop", payload={}))
    for _ in range(3):
        assert ex.drain(timeout=10) is not None
    wait_for(lambda: all(g["end"] is not None
                         for g in tel.tracer.grant_records()))
    ex.shutdown()
    info = pkg.obs.validate_trace(pkg.obs.write_trace(
        tel.tracer, str(tmp_path / "trace.json")))
    assert info["kinds"] == {"noop": 3} and info["full_chains"] == 3
    snap = json.load(open(pkg.obs.write_metrics(
        tel.metrics, str(tmp_path / "metrics.json"))))
    assert snap["tasks.completed{kind=noop}"] == 3


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_histogram_quantiles_match_numpy(pkg):
    sample = np.random.default_rng(0).lognormal(-2.0, 1.5, size=5_000)
    h = pkg.metrics.Histogram()
    for v in sample:
        h.observe(float(v))
    for q in (0.5, 0.95):
        exact = float(np.quantile(sample, q))
        assert abs(h.quantile(q) - exact) / exact < 0.10
    assert h.summary()["count"] == len(sample)


def test_registry_series_labels_and_snapshot(pkg):
    reg = pkg.metrics.MetricsRegistry()
    reg.counter("tasks.completed", kind="predict").inc(3)
    reg.counter("tasks.completed", kind="generate").inc()
    reg.gauge("queue.depth", band=0).set(7)
    snap = reg.snapshot()
    assert snap["tasks.completed{kind=predict}"] == 3
    assert snap["queue.depth{band=0}"] == 7
    assert {k: c.get() for k, c in reg.labeled(
        "tasks.completed", "kind").items()} == {"predict": 3, "generate": 1}
    with pytest.raises(TypeError):
        reg.gauge("tasks.completed", kind="predict")


# ---------------------------------------------------------------------------
# protocol decision logic (test_protocol.py's scenarios)
# ---------------------------------------------------------------------------

METRIC_GOOD = {"plddt": 80.0, "ptm": 0.8, "pae": 8.0}
METRIC_BAD = {"plddt": 40.0, "ptm": 0.4, "pae": 20.0}


def new_pl(p, name="X"):
    return p.new_pipeline(name, np.zeros((30, 16), np.float32),
                          np.zeros(16, np.float32), 24,
                          np.arange(1, 7, dtype=np.int32))


def gen_result(n=4, ll=None):
    seqs = np.tile(np.arange(24, dtype=np.int32), (n, 1))
    lls = np.asarray(ll if ll is not None
                     else -np.arange(n, dtype=np.float32))
    return seqs, lls


def test_generate_ranks_by_ll_when_adaptive(pkg):
    p = pkg.proto()
    pl = new_pl(p)
    tasks = p.on_generate_done(pl, gen_result(ll=[-3.0, -1.0, -2.0, -4.0]))
    assert len(tasks) == 1 and tasks[0].kind == "predict"
    _, lls = pl.meta["candidates"]
    assert list(lls) == sorted(lls, reverse=True)


def test_first_predict_always_accepts_then_requires_improvement(pkg):
    p = pkg.proto()
    pl = new_pl(p)
    p.on_generate_done(pl, gen_result())
    assert p.on_predict_done(pl, METRIC_BAD)["event"] == "accepted"
    p.on_generate_done(pl, gen_result())
    assert p.on_predict_done(pl, METRIC_BAD)["event"] == "reselect"
    out = p.on_predict_done(pl, METRIC_GOOD)
    assert out["event"] == "accepted" and pl.cycle == 2


@pytest.mark.parametrize("n,max_resel", [(3, 10), (40, 2)])
def test_prune_after_exhausting_candidates_or_budget(pkg, n, max_resel):
    p = pkg.proto(n_candidates=n, max_reselections=max_resel)
    pl = new_pl(p)
    p.on_generate_done(pl, gen_result(n))
    p.on_predict_done(pl, METRIC_GOOD)
    p.on_generate_done(pl, gen_result(n))
    events = [p.on_predict_done(pl, METRIC_BAD)["event"] for _ in range(3)]
    assert events == ["reselect", "reselect", "pruned"]
    assert not pl.active


def test_control_always_accepts_and_never_spawns(pkg):
    p = pkg.proto(adaptive=False)
    pl = new_pl(p)
    for _ in range(3):
        p.on_generate_done(pl, gen_result())
        out = p.on_predict_done(pl, METRIC_BAD)
        assert out["spawn"] is None
        assert out["event"] in ("accepted", "completed")
    assert not pl.active and len(pl.history) == 3


def test_sub_pipeline_spawn_and_structure_update(pkg):
    p = pkg.proto(runner_up_window=100.0, max_sub_pipelines=8)
    pl = new_pl(p)
    before = pl.meta["backbone"].copy()
    p.on_generate_done(pl, gen_result())
    out = p.on_predict_done(pl, METRIC_GOOD)
    after = pl.meta["backbone"]
    assert not np.allclose(before[:24], after[:24])
    np.testing.assert_array_equal(before[24:], after[24:])
    sub = p.spawn_pipeline(out["spawn"])
    assert sub.is_sub_pipeline and p.first_task(sub).kind == "predict"


@pytest.mark.parametrize("k", [1, 3])
def test_batched_scoring_walks_rows_in_ll_order(pkg, k):
    """score_batch=k: one predict_batch of the top-k rows; the decision
    walks the rows exactly as the per-candidate path would."""
    p = pkg.proto(score_batch=k)
    pl = new_pl(p)
    (task,) = p.on_generate_done(pl, gen_result())
    assert task.kind == "predict_batch"
    assert task.payload["sequences"].shape == (k, 30)
    p.on_predict_batch_done(pl, {"rows": [METRIC_GOOD] * k})
    (task,) = p.on_generate_done(pl, gen_result())
    out = p.on_predict_batch_done(pl, {"rows": [METRIC_BAD] * k})
    assert [e["event"] for e in out["events"]] == ["reselect"] * k


# ---------------------------------------------------------------------------
# coordinator with instant fake payloads
# ---------------------------------------------------------------------------

class FakePayload:
    """Deterministic instant payloads: predict quality improves with the
    mean structure feature, so adaptive runs hill-climb."""

    def __init__(self):
        self.rng = np.random.default_rng(0)
        self.n_pred = 0

    def generate(self, submesh, payload):
        n, L = payload["n"], payload["length"]
        seqs = self.rng.integers(1, 21, size=(n, L)).astype(np.int32)
        return seqs, -self.rng.random(n).astype(np.float32)

    def predict(self, submesh, payload):
        self.n_pred += 1
        s = float(np.mean(payload["sequence"])) + self.rng.normal(0, 2.0)
        return {"plddt": 50 + s, "ptm": 0.5, "pae": 15.0}


def run_coordinator(pkg, adaptive, n_struct=2, cycles=2):
    ex = pkg.executor_on_devices(max_workers=2)
    fp = FakePayload()
    ex.register("generate", fp.generate)
    ex.register("predict", fp.predict)
    p = pkg.proto(adaptive=adaptive, n_cycles=cycles, max_sub_pipelines=2)
    coord = pkg.coordinator.Coordinator(
        ex, p, max_inflight=None if adaptive else 1)
    for i in range(n_struct):
        coord.add_pipeline(new_pl(p, f"S{i}"))
    rep = coord.run(timeout=60)
    ex.shutdown()
    return rep, fp, coord


def test_coordinator_all_pipelines_terminate(pkg):
    rep, fp, _ = run_coordinator(pkg, adaptive=True)
    assert rep["n_pipelines"] == 2
    assert rep["trajectories"] == fp.n_pred
    assert rep["executor"]["n_failed"] == 0


def test_adaptive_explores_at_least_as_many_trajectories_as_control(pkg):
    rep_c, _, _ = run_coordinator(pkg, adaptive=False)
    rep_a, _, _ = run_coordinator(pkg, adaptive=True)
    assert rep_a["trajectories"] >= rep_c["trajectories"]
    assert rep_c["n_sub_pipelines"] == 0


def test_coordinator_state_roundtrip(pkg):
    _, _, coord = run_coordinator(pkg, adaptive=True, n_struct=1)
    state = json.loads(json.dumps(coord.state_dict()))
    ex2 = pkg.executor_on_devices(max_workers=1)
    coord2 = pkg.coordinator.Coordinator(ex2, pkg.proto(n_cycles=2),
                                         max_inflight=None)
    coord2.load_state_dict(state)
    assert len(coord2.pipelines) == len(state["pipelines"])
    assert "S0" in {pl.name for pl in coord2.pipelines.values()}
    ex2.shutdown()


# ---------------------------------------------------------------------------
# the port's compile watcher
# ---------------------------------------------------------------------------

def test_torchwatch_counts_builds_and_first_calls(monkeypatch):
    from repro_torch.kernels import _cuda
    from repro_torch.obs import CompileWatcher, MetricsRegistry
    monkeypatch.setattr(_cuda, "build_log", [4.0])   # before: not counted
    reg = MetricsRegistry()
    with CompileWatcher(reg) as w:
        assert w.supported
        _cuda.build_log.append(1.5)                  # as a build logs it
        w.absorb_compile_log({"predict_mb1_L32": [0.25, 0.5], "x": []},
                             start={"predict_mb1_L32": 1})
        w.absorb_counts("engine", {"admits": 3})
        w.absorb_counts("engine", {"admits": 5})
    _cuda.build_log.append(9.0)                      # after: not counted
    snap = reg.snapshot()
    assert snap["torch.kernel_builds{event=build}"] == 1
    assert snap["torch.kernel_build_s"]["max"] == 1.5
    assert snap["torch.payload_first_calls{kind=predict_mb1_L32}"] == 1
    assert snap["torch.probe_counts{event=admits,probe=engine}"] == 5
    assert not any(k.startswith("jax.") for k in snap)


class _YieldingCounts(dict):
    """A counter dict whose read hands the interpreter to another thread
    before the write that follows it: an increment that is not under the
    lock then loses updates."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counters_lose_no_update_across_threads(monkeypatch):
    """The executor's workers launch kernels at the same time, and the
    campaign's launch counts are held exactly: 8 threads counting through
    counters that yield between read and write lose no launch."""
    from repro_torch.kernels import _cuda
    monkeypatch.setattr(_cuda, "launches", _YieldingCounts(
        dict.fromkeys(_cuda.launches, 0)))
    monkeypatch.setattr(_cuda, "forms", {
        k: _YieldingCounts(dict.fromkeys(v, 0))
        for k, v in _cuda.forms.items()})

    def count():
        for _ in range(500):
            _cuda.check_launch("flash_attention_bhsd", 0, "decode")

    threads = [threading.Thread(target=count) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert _cuda.launches["flash_attention_bhsd"] == 4000
    assert _cuda.forms["flash_attention_bhsd"]["decode"] == 4000
    _cuda.reset_launches()
    assert _cuda.launches["flash_attention_bhsd"] == 0
    assert _cuda.forms["flash_attention_bhsd"]["decode"] == 0


# ---------------------------------------------------------------------------
# reduced im-rp campaign, both packages
# ---------------------------------------------------------------------------

class NoisedPayload(ProteinPayload):
    """The port's payload, each sampling task fed the Gumbel draws the
    reference's key schedule makes from the task's own seed: ``generate``
    with ``fold_in(PRNGKey(seed), 0)`` through ``progen_sample``'s splits,
    a paged row's candidate ``c`` with ``fold_in(PRNGKey(seed), c)`` and
    token ``i`` with ``fold_in`` of that by ``i`` (admitted rows too)."""

    def generate(self, submesh, payload):
        key = ref_payload._fold_in_keys(payload["seed"], 1)[0]
        return super().generate(submesh, dict(payload, noise=schedule_noise(
            key, int(payload["n"]), int(payload["length"]))))

    def _paged_parse(self, payload, length):
        bbs, seeds, rl, noise = super()._paged_parse(payload, length)
        if noise is None:
            noise = np.stack([[jax_noise(k, length) for k in
                               ref_payload._fold_in_keys(s, payload["n"])]
                              for s in seeds])
        return bbs, seeds, rl, noise


FORMS = {"default": {},
         "batched": {"generate_batch_size": 4, "score_batch": 3,
                     "decode_kernel": True}}


def run_campaign(pkg, pp, form, uid0):
    """test_integration.py's real-payload smoke: one structure, two
    cycles, three candidates, at most one sub-pipeline."""
    pkg.pipeline._uid = itertools.count(uid0)
    kw = dict(n_candidates=3, n_cycles=2, adaptive=True, gen_devices=1,
              predict_devices=1, max_sub_pipelines=1, **FORMS[form])
    task = pkg.synthetic.protein_design_tasks(1, receptor_len=16,
                                              peptide_len=4)[0]
    ex = pkg.executor_on_devices(max_workers=2)
    pp.register_all(ex, generate_batch_rows=kw.get("generate_batch_size"),
                    decode_kernel=kw.get("decode_kernel", False))
    proto = pkg.proto(**kw)
    coord = pkg.coordinator.Coordinator(ex, proto)
    coord.add_pipeline(proto.new_pipeline(
        task["name"], task["backbone"], task["target"],
        task["receptor_len"], task["peptide_tokens"]))
    rep = coord.run(timeout=240)
    kinds = collections.Counter(t.kind for t in ex._tasks.values()
                                if t.state == pkg.TaskState.DONE)
    ex.shutdown()
    events = collections.defaultdict(list)
    for e in rep["events"]:
        events[e.get("pipeline")].append((e["event"], e.get("cycle")))
    accepted = {pl.name: [(h["cycle"], h["sequence"], h["fitness"])
                          for h in pl.history]
                for pl in coord.pipelines.values()}
    return rep, kinds, dict(events), accepted


@pytest.mark.parametrize("form", sorted(FORMS))
def test_campaign_matches_reference(form):
    ref, port = payloads("float32")
    noised = NoisedPayload(gen_cfg=port.gen_cfg, fold_cfg=port.fold_cfg,
                           device="cpu", progen=port.gen_params,
                           foldscore=port.fold_params)
    uid0 = 1_000_000 + 1000 * sorted(FORMS).index(form)
    want = run_campaign(Pkg("repro"), ref, form, uid0)
    got = run_campaign(Pkg("repro_torch"), noised, form, uid0)
    (w_rep, w_kinds, w_events, w_acc), (g_rep, g_kinds, g_events, g_acc) = \
        want, got
    assert g_rep["executor"]["n_failed"] == w_rep["executor"]["n_failed"] \
        == 0
    assert g_kinds == w_kinds
    expect = {"default": {"generate", "predict"},
              "batched": {"generate_batch", "predict_batch"}}[form]
    assert set(g_kinds) == expect
    assert g_events == w_events
    for key in ("n_pipelines", "n_sub_pipelines", "trajectories",
                "batch_occupancy", "gen_batch_occupancy", "len_occupancy",
                "gen_len_occupancy", "n_generate_batches",
                "n_score_batches"):
        assert g_rep[key] == w_rep[key], key
    assert set(g_acc) == set(w_acc) and any(g_acc.values())
    for name, rows in w_acc.items():
        assert [r[:2] for r in g_acc[name]] == [r[:2] for r in rows]
        np.testing.assert_allclose([r[2] for r in g_acc[name]],
                                   [r[2] for r in rows], atol=1e-5)
    assert set(g_rep["cycles"]) == set(w_rep["cycles"])
