"""Model evolution in the port (``repro_torch.learn``, ``FinetunePayload``,
the session's ``evolution=True``) on the CPU, against the JAX reference.

``tests/test_evolution.py``'s jax-free scenarios run over both packages
(the replay buffer, the param store with its checkpoints, the scheduler's
preemptible class and aging guard, executor preemption, the trainer
service's gating and routing, "disabled evolution is event-sequence
identical"); its payload scenarios run on the port (publish-and-swap in
the dense and paged forms, preempt-and-resume reaching the full step
count, the end-to-end loop), as do ``test_integration.py::
test_finetune_task_evolves_generator`` and ``test_session.py::
test_session_evolution_wiring``. Then parity with the reference on the
same bridged weights: five ``finetune`` steps; and the flash kernel's
gradient (``flash_attention_grad``, whose backward is a port of the
reference's ``_flash_xla_bwd_inner``) against ``jax.grad`` through the
reference's ``_flash_xla`` and against autograd through ``attention_ref``.

Tolerances: the finetune's losses and log-likelihoods 1e-5 relative and
its parameters 1e-4 absolute after 5 steps at lr 1e-3 (a first AdamW step
moves a parameter by lr g / (|g| + eps), undetermined to a fraction of lr
where g is at fp32 roundoff's scale; see ``test_torch_optim.py``); the
flash gradients 2e-5 (fp32) and 2e-2 (bf16) relative to each gradient's
max, the reference kernel tests' tolerances."""

import importlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ProteinPayload as RefPayload  # noqa: E402
from repro.core.payload import FinetunePayload as RefFinetune  # noqa: E402
from repro.models.attention import _flash_xla  # noqa: E402
from repro.runtime import DeviceAllocator as RefAllocator  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.payload import (FinetunePayload,  # noqa: E402
                                      ProteinPayload)
from repro_torch.core.pipeline import Task  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import protein as prot  # noqa: E402
from repro_torch.runtime.allocator import SubMesh  # noqa: E402
from test_torch_payload import _cfgs  # noqa: E402

PKGS = ("repro", "repro_torch")
CPU = torch.device("cpu")
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tensors here are small, and
    parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Pkg:
    """One package's evolution, runtime and campaign modules."""

    def __init__(self, name):
        self.name = name
        for attr, mod in (("buffer", "learn.replay_buffer"),
                          ("store", "learn.param_store"),
                          ("trainer", "learn.trainer"),
                          ("manager", "checkpoint.manager"),
                          ("pipeline", "core.pipeline"),
                          ("coordinator", "core.coordinator"),
                          ("protocol", "core.protocol"),
                          ("scheduler", "runtime.scheduler"),
                          ("allocator", "runtime.allocator"),
                          ("executor", "runtime.executor")):
            setattr(self, attr, importlib.import_module(f"{name}.{mod}"))
        self.ReplayBuffer = self.buffer.ReplayBuffer
        self.ParamStore = self.store.ParamStore
        self.Task = self.pipeline.Task
        self.TaskState = self.pipeline.TaskState
        self.RR = self.pipeline.ResourceRequest

    def devices(self):
        return jax.devices()[:1] if self.name == "repro" else [CPU]

    def executor_(self, max_workers=1):
        return self.executor.AsyncExecutor(
            self.allocator.DeviceAllocator(self.devices()),
            max_workers=max_workers)


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


# ---------------------------------------------------------------------------
# replay buffer (both packages)
# ---------------------------------------------------------------------------

def _design(fit, ver=0, L=8, P=12, seed=0):
    rng = np.random.default_rng(seed)
    return dict(backbone=rng.normal(size=(P, 16)).astype(np.float32),
                sequence=rng.integers(1, 20, size=L).astype(np.int32),
                fitness=fit, gen_version=ver)


def test_buffer_evicts_lowest_fitness_when_full(pkg):
    buf = pkg.ReplayBuffer(capacity=3)
    for i, f in enumerate([0.5, 0.1, 0.9, 0.7]):
        d = _design(f, seed=i)
        buf.add(d["backbone"], d["sequence"], d["fitness"])
    assert len(buf) == 3
    st = buf.stats()
    assert st["added"] == 4 and st["evicted"] == 1
    assert st["mean_fitness"] == pytest.approx((0.5 + 0.9 + 0.7) / 3)
    batch = buf.sample(3, np.random.default_rng(0))
    assert batch["sequences"].shape == (3, 8)
    assert batch["weights"].min() > 0


def test_buffer_sampling_is_fitness_weighted(pkg):
    buf = pkg.ReplayBuffer(capacity=10)
    good, bad = _design(5.0, seed=1), _design(0.0, seed=2)
    buf.add(good["backbone"], good["sequence"], 5.0)
    buf.add(bad["backbone"], bad["sequence"], 0.0)
    rng = np.random.default_rng(0)
    hits = sum(np.array_equal(buf.sample(1, rng)["sequences"][0],
                              good["sequence"]) for _ in range(50))
    assert hits > 35  # strongly biased toward the fitter design


def test_buffer_groups_mixed_lengths_and_roundtrips(pkg):
    buf = pkg.ReplayBuffer(capacity=10)
    for i in range(3):
        d = _design(1.0, ver=i % 2, L=8, seed=i)
        buf.add(d["backbone"], d["sequence"], d["fitness"], d["gen_version"])
    odd = _design(1.0, L=11, seed=9)
    buf.add(odd["backbone"], odd["sequence"], 1.0)
    batch = buf.sample(8, np.random.default_rng(0))
    assert batch["sequences"].shape == (3, 8)  # modal-length group wins
    buf2 = pkg.ReplayBuffer()
    buf2.load_state_dict(buf.state_dict())
    assert len(buf2) == len(buf)
    assert buf2.stats()["by_gen_version"] == buf.stats()["by_gen_version"]


def test_buffer_samples_as_the_reference_does():
    """The same adds and the same generator draw the same batch."""
    bufs = [Pkg(n).ReplayBuffer(capacity=6) for n in PKGS]
    for i in range(9):
        d = _design(float(np.sin(i)), ver=i % 3, seed=i)
        for b in bufs:
            b.add(d["backbone"], d["sequence"], d["fitness"],
                  d["gen_version"])
    want, got = (b.sample(4, np.random.default_rng(5)) for b in bufs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert bufs[0].state_dict() == bufs[1].state_dict()


# ---------------------------------------------------------------------------
# param store (both packages)
# ---------------------------------------------------------------------------

def test_param_store_publish_retire_and_listeners(pkg):
    store = pkg.ParamStore({"w": np.zeros(2)}, keep=2)
    retired = []
    store.on_retire(retired.append)
    assert store.current()[0] == 0
    v1 = store.publish({"w": np.ones(2)})
    assert v1 == 1 and store.version == 1
    assert retired == []                       # keep=2: 0 and 1 both live
    v2 = store.publish({"w": np.full(2, 2.0)})
    assert v2 == 2 and retired == [[0]]        # version 0 retired
    assert store.get(0) is None
    np.testing.assert_array_equal(store.get(1)["w"], np.ones(2))
    # hot-swap: a snapshot taken before a publish keeps its params
    ver, params = store.current()
    store.publish({"w": np.full(2, 3.0)})
    assert ver == 2 and float(params["w"][0]) == 2.0


def test_param_store_checkpoint_roundtrip(pkg, tmp_path):
    store = pkg.ParamStore({"a": np.arange(3, dtype=np.float32),
                            "b": {"c": np.ones((2, 2), np.float32)}})
    store.publish({"a": np.arange(3, dtype=np.float32) + 5,
                   "b": {"c": np.full((2, 2), 7.0, np.float32)}})
    mgr = pkg.manager.CheckpointManager(str(tmp_path), async_write=False)
    assert store.save(mgr) == 1
    fresh = pkg.ParamStore({"a": np.zeros(3, np.float32),
                            "b": {"c": np.zeros((2, 2), np.float32)}})
    assert fresh.restore(mgr) == 1
    assert fresh.version == 1
    np.testing.assert_allclose(np.asarray(fresh.current()[1]["a"]),
                               np.arange(3) + 5)
    # publishing continues from the restored version number
    assert fresh.publish({"a": np.zeros(3, np.float32),
                          "b": {"c": np.zeros((2, 2), np.float32)}}) == 2


def test_param_store_restore_to_older_step_never_reuses_versions(pkg,
                                                                 tmp_path):
    """Restoring an older checkpoint must not hand out again the version
    numbers already published (and possibly tombstoned downstream)."""
    p = lambda x: {"w": np.full(2, float(x), np.float32)}
    store = pkg.ParamStore(p(0))
    mgr = pkg.manager.CheckpointManager(str(tmp_path), async_write=False)
    store.publish(p(1))
    store.save(mgr)                  # checkpoint at version 1
    store.publish(p(2))
    store.publish(p(3))
    retired = []
    store.on_retire(retired.extend)
    assert store.restore(mgr, step=1) == 1
    assert store.version == 1 and sorted(retired) == [2, 3]
    np.testing.assert_allclose(np.asarray(store.current()[1]["w"]), 1.0)
    # next publish continues past the highest version ever handed out
    assert store.publish(p(9)) == 4


def test_generator_store_restore_evicts_device_copies(tmp_path):
    """A generator's store saved and restored through the manager: the
    restored version is a module (``requires_grad=False``, bitwise the
    saved weights), and every version it replaces is announced, so the
    payload's cached copies of them go."""
    from repro_torch.checkpoint import CheckpointManager
    pp = ProteinPayload(reduced=True, device="cpu")
    ft = FinetunePayload(pp, lr=1e-3, steps=2)
    ft.finetune(SubMesh((CPU,)), _batch(pp))
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    assert pp.param_store.save(mgr) == 1
    saved = pp.param_store.current()[1]
    ft.finetune(SubMesh((CPU,)), _batch(pp, seed=1))
    pp._cache[(("gen", "default", 2), torch.device("meta"))] = object()
    assert pp.param_store.restore(mgr) == 1
    ver, got = pp.param_store.current()
    assert ver == 1 and got is not saved and type(got) is type(saved)
    for a, b in zip(saved.parameters(), got.parameters()):
        assert torch.equal(a, b) and not b.requires_grad
    assert not any(k[0] == ("gen", "default", 2) for k in pp._cache)
    assert ("gen", "default", 2) in pp._retired_versions


# ---------------------------------------------------------------------------
# scheduler and executor: the preemptible class (both packages)
# ---------------------------------------------------------------------------

def _queued(pkg, task):
    task.set_state(pkg.TaskState.QUEUED)
    return task


def test_preemptible_held_back_while_design_work_queued(pkg):
    q = pkg.scheduler.TaskQueue(backfill=True, aging_s=60.0)
    trainer = _queued(pkg, pkg.Task(kind="ft", payload={}, priority=100,
                                    preemptible=True,
                                    resources=pkg.RR(1)))
    q.push(trainer)
    assert q.pop_fitting(lambda n: n <= 1).uid == trainer.uid
    q.push(trainer)
    design = _queued(pkg, pkg.Task(kind="gen", payload={},
                                   resources=pkg.RR(1)))
    q.push(design)
    assert q.pop_fitting(lambda n: n <= 1).uid == design.uid
    big = _queued(pkg, pkg.Task(kind="gen", payload={}, resources=pkg.RR(8)))
    q.push(big)
    assert q.pop_fitting(lambda n: n <= 1) is None


def test_aging_guard_unparks_starved_trainer_task(pkg):
    clock = [0.0]
    q = pkg.scheduler.TaskQueue(backfill=True, aging_s=0.05,
                                now_fn=lambda: clock[0])
    big = _queued(pkg, pkg.Task(kind="gen", payload={}, resources=pkg.RR(8)))
    trainer = _queued(pkg, pkg.Task(kind="ft", payload={}, priority=100,
                                    preemptible=True,
                                    resources=pkg.RR(1)))
    big.timestamps["QUEUED"] = trainer.timestamps["QUEUED"] = clock[0]
    q.push(big)
    q.push(trainer)
    assert q.pop_fitting(lambda n: n <= 1) is None   # not aged yet
    clock[0] += 0.06
    got = q.pop_fitting(lambda n: n <= 1)             # aged: backfills
    assert got is not None and got.uid == trainer.uid


def _slow_trainer(started):
    def trainer_fn(sm, p):
        t = p["_task"]
        started.set()
        for step in range(400):               # ~4 s if never preempted
            if t.preempt_requested:
                return {"preempted": True, "steps_done": step}
            time.sleep(0.01)
        return {"preempted": False, "steps_done": 400}
    return trainer_fn


@pytest.mark.parametrize("workers", [2, 1], ids=["idle worker",
                                                 "all workers busy"])
def test_executor_preempts_running_trainer_for_design_task(pkg, workers):
    """A running preemptible trainer task yields its sub-mesh as soon as a
    design task queues, whether an idle worker notices (2 workers) or
    ``submit`` itself signals it (1 worker, stuck in the trainer)."""
    ex = pkg.executor_(max_workers=workers)
    started = threading.Event()
    ex.register("ft", _slow_trainer(started))
    ex.register("design", lambda sm, p: "designed")
    ft = pkg.Task(kind="ft", payload={}, priority=100, preemptible=True,
                  resources=pkg.RR(1))
    ex.submit(ft)
    assert started.wait(timeout=5)
    t0 = time.monotonic()
    design = pkg.Task(kind="design", payload={}, resources=pkg.RR(1))
    ex.submit(design)
    done = {t.uid: t for t in (ex.drain(timeout=10), ex.drain(timeout=10))}
    latency = time.monotonic() - t0
    ex.shutdown()
    assert done[design.uid].state == pkg.TaskState.DONE
    assert done[ft.uid].state == pkg.TaskState.DONE
    assert done[ft.uid].result["preempted"] is True
    assert latency < 2.0
    assert ex.stats()["n_preempted"] >= 1


# ---------------------------------------------------------------------------
# trainer service (both packages)
# ---------------------------------------------------------------------------

def _service(pkg, ex, finetune_every=1, min_designs=1, steps=3, **kw):
    store = pkg.ParamStore({"w": np.zeros(2, np.float32)})
    buf = pkg.ReplayBuffer(capacity=16)
    cfg = pkg.trainer.EvolutionConfig(finetune_every=finetune_every,
                                      min_designs=min_designs, batch_size=4,
                                      steps=steps, **kw)
    return pkg.trainer.TrainerService(ex, buf, store, cfg), buf


def test_trainer_service_gates_on_idle_and_threshold(pkg):
    ex = pkg.executor_()
    gate = threading.Event()
    ex.register("blocker", lambda sm, p: gate.wait(timeout=10))
    svc, buf = _service(pkg, ex, finetune_every=2)
    assert svc.tick() is None                 # nothing accepted yet
    svc.add_design(_design(1.0, seed=0))
    assert svc.tick() is None                 # below finetune_every
    svc.add_design(_design(0.5, seed=1))
    ex.submit(pkg.Task(kind="blocker", payload={}))
    time.sleep(0.1)
    ex.submit(pkg.Task(kind="blocker", payload={}))   # queued design work
    assert svc.tick() is None                 # queue non-empty: stand by
    gate.set()
    for _ in range(2):
        ex.drain(timeout=10)
    t = svc.tick()                            # idle now: submits
    assert t is not None and t.preemptible and t.kind == "finetune"
    assert svc.busy() and svc.tick() is None  # one inflight at a time
    ex.shutdown()


def test_trainer_service_completion_and_preemption_routing(pkg):
    ex = pkg.executor_()
    calls = {"n": 0}

    def fake_finetune(sm, p):
        calls["n"] += 1
        if "resume" not in p:
            return {"preempted": True, "steps_done": 1, "steps_run": 1,
                    "n_designs": 2, "n_devices": 1, "base_version": 0,
                    "elapsed_s": 0.01,
                    "resume": {"step": 1, "base_version": 0}}
        return {"preempted": False, "steps_done": 3, "steps_run": 2,
                "n_designs": 2, "n_devices": 1, "base_version": 0,
                "new_version": 1, "elapsed_s": 0.02,
                "loss_first": 2.0, "loss_last": 1.0,
                "mean_ll_first": -2.0, "mean_ll_last": -1.0}

    ex.register("finetune", fake_finetune)
    svc, buf = _service(pkg, ex)
    svc.add_design(_design(1.0, seed=0))
    svc.add_design(_design(0.7, seed=1))
    assert svc.tick() is not None
    done = ex.drain(timeout=10)
    assert svc.owns(done.uid)
    svc.on_complete(done)
    assert svc.preempted == 1 and svc.busy()  # continuation pending
    t2 = svc.tick()
    assert t2 is not None and "resume" in t2.payload
    done = ex.drain(timeout=10)
    svc.on_complete(done)
    ex.shutdown()
    assert svc.completed == 1 and not svc.busy()
    assert calls["n"] == 2
    assert svc.history[-1]["new_version"] == 1
    rep = svc.report(makespan=1.0, total_devices=1)
    assert rep["preempted"] == 1 and rep["completed"] == 1
    assert rep["steps_run"] == 3
    assert 0 < rep["trainer_utilization"] < 1


class _FastPayload:
    """Instant payload fns whose results depend only on payload content."""

    def generate(self, sm, p):
        seed = int(np.abs(np.asarray(p["backbone"])).sum() * 1e3) % (2**31)
        rng = np.random.default_rng(seed + p["length"])
        n, L = p["n"], p["length"]
        return {"seqs": rng.integers(1, 21, size=(n, L)).astype(np.int32),
                "lls": -rng.random(n).astype(np.float32),
                "gen_version": 0}

    def predict(self, sm, p):
        rng = np.random.default_rng(int(np.sum(p["sequence"])) % 100000)
        return {"plddt": 40.0 + 40.0 * rng.random(),
                "ptm": float(rng.random()), "pae": 5.0 + 20.0 * rng.random()}


def _coord_run(pkg, trainer):
    ex = pkg.executor_(max_workers=2)
    fp = _FastPayload()
    ex.register("generate", fp.generate)
    ex.register("predict", fp.predict)
    svc = None
    if trainer == "attached-disabled":
        svc = pkg.trainer.TrainerService(
            ex, pkg.ReplayBuffer(), pkg.ParamStore({"w": np.zeros(2)}),
            pkg.trainer.EvolutionConfig(finetune_every=0))
    proto = pkg.protocol.ImpressProtocol(pkg.protocol.ProtocolConfig(
        n_candidates=5, n_cycles=3, max_sub_pipelines=2, seed=11,
        gen_devices=1, predict_devices=1))
    coord = pkg.coordinator.Coordinator(ex, proto, max_inflight=1,
                                        trainer=svc)
    for i in range(3):
        coord.add_pipeline(proto.new_pipeline(
            f"P{i}", np.zeros((20, 16), np.float32), np.zeros(16, np.float32),
            14, np.arange(1, 5, dtype=np.int32)))
    rep = coord.run(timeout=60)
    ex.shutdown()
    return rep


def test_disabled_evolution_is_event_sequence_identical(pkg):
    """With evolution disabled (finetune_every=0), a fixed-seed run's
    decision-event sequence is identical to a run with no evolution
    machinery attached at all."""
    rep_off = _coord_run(pkg, trainer=None)
    rep_dis = _coord_run(pkg, trainer="attached-disabled")
    strip = lambda evs: [(e["event"], e.get("pipeline"), e.get("cycle"),
                          e.get("gen_version")) for e in evs]
    assert strip(rep_off["events"]) == strip(rep_dis["events"])
    assert rep_dis["evolution"]["submitted"] == 0
    assert rep_off["evolution"] is None
    assert list(rep_off["quality_by_version"]) == [0]


# ---------------------------------------------------------------------------
# the finetune payload (port)
# ---------------------------------------------------------------------------

def _fp32_payload(seed):
    """A reduced payload on the CPU with fp32 compute (the reduced
    configs' bf16 rounds each product, and a batch split differently rounds
    differently)."""
    _, _, pg, pf = _cfgs("float32")
    return ProteinPayload(seed=seed, gen_cfg=pg, fold_cfg=pf, device="cpu")


def _batch(payload, n=4, L=12, seed=0):
    rng = np.random.default_rng(seed)
    P = payload.gen_cfg.frontend_seq
    return {"backbones": rng.normal(size=(n, P, 16)).astype(np.float32),
            "sequences": rng.integers(1, 20, size=(n, L)).astype(np.int32),
            "weights": np.linspace(1.0, 0.2, n).astype(np.float32)}


@pytest.mark.parametrize("form", ["dense", "paged"])
def test_finetune_publishes_new_version_and_swaps_generator(form):
    """A finetune publishes version 1 (weights without gradients, on the
    payload's device); the next dispatch, dense ``generate`` or paged
    ``generate_batch``, samples on it; a second publish retires version 0
    and evicts its device copies, and a dispatch holding a version retired
    mid-flight does not re-insert its copy."""
    payload = ProteinPayload(seed=0, reduced=True, device="cpu")
    tuner = FinetunePayload(payload, lr=1e-3, steps=4)
    sub = SubMesh((CPU,))
    bb = np.random.default_rng(3).normal(size=(20, 16)).astype(np.float32)
    if form == "dense":
        gen = lambda: payload.generate(sub, {"backbone": bb, "n": 2,
                                             "length": 8, "seed": 5})
    else:
        gen = lambda: payload.generate_batch(sub, {
            "backbones": bb[None], "seeds": [5], "n": 2, "length": 8,
            "decode": "paged"})
    before = gen()
    assert before["gen_version"] == 0
    res = tuner.finetune(sub, _batch(payload))
    assert res["preempted"] is False
    assert res["new_version"] == 1 and res["base_version"] == 0
    assert res["loss_last"] < res["loss_first"]
    assert res["mean_ll_last"] > res["mean_ll_first"]
    evolved = payload.param_store.current()[1]
    assert all(not p.requires_grad and p.device == CPU
               for p in evolved.parameters())
    after = gen()
    assert after["gen_version"] == 1          # hot-swapped on next dispatch
    tuner.finetune(sub, _batch(payload, seed=1))
    assert payload.param_store.versions() == [1, 2]
    with payload._cache_lock:
        gen_vers = {k[0][2] for k in payload._cache
                    if isinstance(k[0], tuple) and k[0][0] == "gen"}
    assert 0 not in gen_vers
    ver1 = payload.param_store.get(1)
    payload._drop_gen_versions("default", [1])
    payload._params_on(("gen", "default", 1), ver1, torch.device("meta"))
    with payload._cache_lock:
        assert not any(isinstance(k[0], tuple)
                       and k[0] == ("gen", "default", 1)
                       for k in payload._cache)


def test_finetune_preempt_resume_reaches_full_step_count():
    """Preempted after its first step, resumed from the host-side state:
    8 steps in all, one version published, and the same losses and weights
    as an uninterrupted run."""
    payload = ProteinPayload(seed=1, reduced=True, device="cpu")
    tuner = FinetunePayload(payload, lr=1e-3, steps=8)
    sub = SubMesh((CPU,))
    batch = _batch(payload)
    task = Task(kind="finetune", payload={}, preemptible=True)
    task.preempt_requested = True             # yield after the first step
    r1 = tuner.finetune(sub, dict(batch, _task=task))
    assert r1["preempted"] is True and r1["steps_done"] == 1
    assert payload.param_store.version == 0   # nothing published yet
    res = r1["resume"]
    assert all(t.device == CPU for t in res["params"].values())
    assert all(t.device == CPU for t in res["opt_state"]["m"].values())
    r2 = tuner.finetune(sub, dict(batch, resume=res))
    assert r2["preempted"] is False
    assert r2["steps_done"] == 8 and r2["steps_run"] == 7
    assert r2["new_version"] == 1
    assert r2["loss_last"] < r2["loss_first"]  # progress was never lost
    whole = ProteinPayload(seed=1, reduced=True, device="cpu")
    r3 = FinetunePayload(whole, lr=1e-3, steps=8).finetune(sub, batch)
    for k in ("loss_first", "loss_last", "mean_ll_first", "mean_ll_last"):
        assert r2[k] == r3[k], k
    for a, b in zip(payload.gen_params.parameters(),
                    whole.gen_params.parameters()):
        assert torch.equal(a, b)


def test_finetune_split_across_two_devices_matches_one_device():
    """Three rows on a sub-mesh of two devices: padded to four with a
    weight-0 row, split two and two, each shard's loss normalized by the
    whole batch's weights, the gradients summed: the same losses and
    weights as on one device, in fp32."""
    out = []
    for devices in ((CPU,), (CPU, CPU)):
        payload = _fp32_payload(2)
        res = FinetunePayload(payload, lr=1e-3, steps=4).finetune(
            SubMesh(devices), _batch(payload, n=3))
        assert res["n_devices"] == len(devices) and res["n_designs"] == 3
        out.append((res, payload.gen_params))
    (r1, p1), (r2, p2) = out
    for k in ("loss_first", "loss_last", "mean_ll_first", "mean_ll_last"):
        assert r2[k] == pytest.approx(r1[k], rel=LOSS_RTOL), k
    for a, b in zip(p1.parameters(), p2.parameters()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=PARAM_ATOL)


def test_finetune_trains_outside_inference_mode_under_its_namespace(
        monkeypatch):
    """The task function trains from the store's module even when its
    weights are inference tensors (made under ``inference_mode``), without
    touching them; it runs with grad on, outside inference mode, under its
    generator's launch-count namespace, through the flash kernel's
    autograd Function."""
    with torch.inference_mode():
        payload = ProteinPayload(seed=0, reduced=True, device="cpu")
    master = payload.gen_params
    assert next(master.parameters()).is_inference()
    before = [p.clone() for p in master.parameters()]
    seen = []
    inner = prot.progen_logprobs

    def spy(*a, **k):
        seen.append((torch.is_grad_enabled(),
                     torch.is_inference_mode_enabled(),
                     getattr(_cuda._running, "namespace", None)))
        return inner(*a, **k)

    applied = []
    apply = fa.FlashAttention.apply
    monkeypatch.setattr(prot, "progen_logprobs", spy)
    monkeypatch.setattr(fa.FlashAttention, "apply",
                        lambda *a: applied.append(1) or apply(*a))
    res = FinetunePayload(payload, lr=1e-3, steps=2).finetune(
        SubMesh((CPU,)), _batch(payload))
    assert res["new_version"] == 1
    assert seen == [(True, False, "default")] * 2
    assert len(applied) == 2 * payload.gen_cfg.n_layers
    for a, b in zip(before, master.parameters()):
        assert torch.equal(a, b)


def test_finetune_task_evolves_generator():
    """§V bidirectional coupling (test_integration.py's scenario): a
    finetune task through the executor lowers the weighted NLL and swaps
    the generator's weights."""
    from repro_torch.core.pipeline import ResourceRequest, TaskState
    from repro_torch.runtime.allocator import DeviceAllocator
    from repro_torch.runtime.executor import AsyncExecutor
    ex = AsyncExecutor(DeviceAllocator([CPU]), max_workers=1)
    payload = ProteinPayload(seed=0, reduced=True, device="cpu")
    payload.register_all(ex)
    FinetunePayload(payload, lr=3e-4, steps=5).register(ex)
    rng = np.random.default_rng(0)
    before = payload.gen_params.embedding.tok.clone()
    t = Task(kind="finetune", payload={
        "backbones": rng.normal(size=(3, 16, 16)).astype(np.float32),
        "sequences": rng.integers(1, 20, size=(3, 12)).astype(np.int32),
        "weights": np.array([1.0, 0.5, 0.2], np.float32),
    }, resources=ResourceRequest(1))
    ex.submit(t)
    done = ex.drain(timeout=120)
    ex.shutdown()
    assert done.state == TaskState.DONE, done.error
    assert done.result["loss_last"] < done.result["loss_first"]
    assert not torch.allclose(before, payload.gen_params.embedding.tok)


def test_evolution_end_to_end_with_real_models():
    """Accepted designs feed the buffer, the trainer finetunes on idle
    devices, evolved weights hot-swap, and the report shows versioned
    provenance and trainer stats."""
    from repro_torch.core.coordinator import Coordinator
    from repro_torch.core.protocol import ImpressProtocol, ProtocolConfig
    from repro_torch.learn import (EvolutionConfig, ReplayBuffer,
                                   TrainerService)
    from repro_torch.runtime.allocator import DeviceAllocator
    from repro_torch.runtime.executor import AsyncExecutor
    backbone = np.random.default_rng(0).normal(size=(18, 16)).astype(
        np.float32)
    ex = AsyncExecutor(DeviceAllocator([CPU]), max_workers=2)
    payload = ProteinPayload(seed=0, reduced=True, device="cpu")
    payload.register_all(ex)
    FinetunePayload(payload, lr=1e-3, steps=5).register(ex)
    buf = ReplayBuffer(capacity=32)
    svc = TrainerService(ex, buf, payload.param_store, EvolutionConfig(
        finetune_every=1, min_designs=1, batch_size=4, steps=5))
    proto = ImpressProtocol(ProtocolConfig(
        n_candidates=3, n_cycles=2, adaptive=True, gen_devices=1,
        predict_devices=1, max_sub_pipelines=0, seed=0))
    coord = Coordinator(ex, proto, trainer=svc)
    coord.add_pipeline(proto.new_pipeline(
        "evo", backbone, np.zeros(16, np.float32), 12,
        np.arange(1, 5, dtype=np.int32)))
    rep = coord.run(timeout=240)
    ex.shutdown()
    assert rep["executor"]["n_failed"] == 0
    evo = rep["evolution"]
    assert evo is not None and evo["enabled"]
    assert len(buf) >= 1 and evo["buffer"]["size"] == len(buf)
    assert evo["completed"] >= 1
    assert evo["param_version"] >= 1
    ft = evo["finetunes"][-1]
    assert ft["loss_last"] < ft["loss_first"]
    assert rep["quality_by_version"]
    assert evo["trainer_utilization"] >= 0.0


def test_session_evolution_wiring():
    """``evolution=True`` attaches the buffer and the trainer; the trainer
    sees accepted designs and a finetune completes (test_session.py's
    scenario, with a finetune forced by the thresholds)."""
    from repro_torch.session import (CampaignSpec, ImpressSession,
                                     ProtocolSpec)
    spec = CampaignSpec(structures=1, receptor_len=12, max_workers=2,
                        protocols=(ProtocolSpec("im-rp", n_candidates=3,
                                                n_cycles=2,
                                                max_sub_pipelines=0),),
                        evolution=True, finetune_every=1, min_designs=1,
                        finetune_batch=4, finetune_steps=3)
    with ImpressSession(spec, payload=ProteinPayload(reduced=True,
                                                     device="cpu"),
                        devices=[CPU]) as sess:
        rep = sess.run(timeout=240)
    assert rep.evolution is not None and rep.evolution["enabled"]
    assert len(sess.buffer) >= 1
    assert rep.executor["n_failed"] == 0
    assert rep.evolution["completed"] >= 1
    assert rep.evolution["param_version"] >= 1
    assert rep.quality_by_version and sess.payload.param_store.version >= 1


def test_session_restore_warns_when_the_checkpoint_is_ahead():
    """A campaign checkpoint taken at generator version 1 restored into a
    session whose store is at 0: the reference's warning."""
    from repro_torch.session import (CampaignSpec, ImpressSession,
                                     ProtocolSpec)
    spec = CampaignSpec(structures=1, receptor_len=12, protocols=(
        ProtocolSpec("im-rp", n_candidates=3, n_cycles=1),))
    kw = dict(payload=ProteinPayload(reduced=True, device="cpu"),
              devices=[CPU])
    with ImpressSession(spec, **kw) as sess:
        state = sess.checkpoint()
    state["gen_version"] = 1
    with pytest.warns(RuntimeWarning, match="ParamStore.save/restore"):
        ImpressSession.from_checkpoint(
            state, payload=ProteinPayload(reduced=True, device="cpu"),
            devices=[CPU]).shutdown()


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def test_five_finetune_steps_match_reference():
    """Five ``finetune`` steps in each package from the same bridged fp32
    weights and batch: the same losses and log-likelihoods, and the same
    evolved weights."""
    rg, rf, pg, pf = _cfgs("float32")
    ref = RefPayload(jax.random.PRNGKey(0), gen_cfg=rg, fold_cfg=rf,
                     reduced=True)
    npy = lambda t: jax.tree.map(np.asarray, t)
    port = ProteinPayload(gen_cfg=pg, fold_cfg=pf, device="cpu",
                          progen=bridge.progen_from_ref(
                              npy(ref.gen_params), pg),
                          foldscore=bridge.foldscore_from_ref(
                              npy(ref.fold_params), pf))
    batch = _batch(port)
    sub = RefAllocator(jax.devices()[:1]).request(1)
    want = RefFinetune(ref, lr=1e-3, steps=5).finetune(sub, dict(batch))
    got = FinetunePayload(port, lr=1e-3, steps=5).finetune(
        SubMesh((CPU,)), dict(batch))
    for k in ("loss_first", "loss_last", "mean_ll_first", "mean_ll_last"):
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), k
    for k in ("steps_done", "steps_run", "n_designs", "base_version",
              "new_version", "preempted"):
        assert got[k] == want[k], k
    for a, b in zip(jax.tree.leaves(npy(ref.gen_params)),
                    jax.tree.leaves(bridge.ref_tree(port.gen_params))):
        np.testing.assert_allclose(b, a, atol=PARAM_ATOL)


FLASH_CASES = {   # (B, H, KV, S), kwargs, the reference's key block
    "finetune GQA S=54": ((2, 4, 2, 54), {}, 0),
    "ragged S=37": ((2, 4, 2, 37), {}, 0),
    "group 1": ((1, 4, 4, 40), {}, 8),
    "window 7": ((1, 4, 2, 64), {"window": 7}, 16),
    "two backward key blocks S=200": ((1, 2, 1, 200), {}, 40),
    "non-causal": ((2, 2, 1, 33), {"causal": False}, 0),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_gradient_matches_reference_and_autograd(case):
    """dq, dk, dv of ``flash_attention_grad`` (fp32) against ``jax.grad``
    through the reference's ``_flash_xla`` (its custom VJP, blocked by the
    key block given) and against autograd through ``attention_ref``, each
    to 2e-5 of the gradient's max; the forward to 2e-5."""
    (B, H, KV, S), kw, block = FLASH_CASES[case]
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, H, S, 16)).astype(np.float32)
    k, v = (rng.normal(size=(B, KV, S, 16)).astype(np.float32)
            for _ in range(2))
    g = rng.normal(size=(B, H, S, 16)).astype(np.float32)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention_grad(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    auto = torch.autograd.grad(fa.attention_ref(tq, tk, tv, **kw),
                               (tq, tk, tv), torch.tensor(g))
    pos = jnp.arange(S)
    causal, window = kw.get("causal", True), kw.get("window", 0)

    def ref_out(q_, k_, v_):   # the reference's model layout (B,S,H,hd)
        o = _flash_xla(q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
                       v_.transpose(0, 2, 1, 3), pos, pos, causal, window,
                       block)
        return o.transpose(0, 2, 1, 3)

    ref_o, vjp = jax.vjp(ref_out, jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
    ref_g = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_o),
                               atol=2e-5)
    for name, a, b, c in zip("qkv", got, auto, ref_g):
        scale = float(np.abs(np.asarray(c)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                   atol=2e-5 * scale, err_msg=f"d{name}")
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5 * scale,
                                   err_msg=f"d{name} vs autograd")


def test_flash_gradient_bf16_matches_autograd():
    """bf16 inputs: the gradients come back in bf16, within 2e-2 of
    autograd through ``attention_ref`` relative to each gradient's max."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, 54, 32, generator=gen).bfloat16()
    k, v = (torch.randn(2, 2, 54, 32, generator=gen).bfloat16()
            for _ in range(2))
    g = torch.randn(2, 4, 54, 32, generator=gen).bfloat16()
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(fa.flash_attention_grad(q, k, v), (q, k, v), g)
    want = torch.autograd.grad(fa.attention_ref(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2e-2 * float(b.float().abs().max())


def test_flash_gradient_refuses_softcap():
    q = torch.zeros(1, 2, 4, 16, requires_grad=True)
    k = v = torch.zeros(1, 2, 4, 16)
    with pytest.raises(NotImplementedError, match="softcap"):
        fa.flash_attention_grad(q, k, v, softcap=30.0)


def test_ops_routes_only_training_calls_through_the_function(monkeypatch):
    """``ops.flash_attention`` takes the autograd Function only with grad
    on and an input that requires grad; serving calls (inference mode, no
    grad, or plain inputs) take the wrapper as before."""
    used = []
    grad = fa.flash_attention_grad
    monkeypatch.setattr(fa, "flash_attention_grad",
                        lambda *a, **k: used.append(1) or grad(*a, **k))
    q = torch.randn(1, 5, 2, 16)
    k = v = torch.randn(1, 5, 2, 16)
    ops.flash_attention(q, k, v)
    with torch.inference_mode():
        ops.flash_attention(q, k, v)
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, v)
    assert used == []
    out = ops.flash_attention(q, k, v)
    assert used == [1] and out.requires_grad

