"""Heterogeneous multi-stage pipelines in the port, on the CPU.

The JAX package's ``tests/test_stages.py`` scenarios that need no payload
(weighted-fair band scheduling on a fake clock, aging, the idle band's
capped lag, stage-aware coalescing, stage-table validation and stamping,
seeds independent of the global uid counter) run over both packages. Then
the staged binder campaign, declared through ``CampaignSpec.stages``, runs
in both packages on the reference's reduced fp32 weights in every
namespace (the ``"binder"`` generator and the ``"multimer"`` foldscore-m
scorer carried across by ``bridge.payload_namespaces_from_ref``), the port
fed the reference's draws: the same accepted designs and stage task
counts, at one receptor length (exact-length forms) and at two (masked
forms, campaign-derived length buckets). Last, the port's composition
independence (coalescing on or off, with and without the rescore
co-tenant) and its bit-identical resume from a mid-fold checkpoint."""

import importlib
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.core.payload import ProteinPayload  # noqa: E402
from test_torch_session import ported_payload  # noqa: E402

PKGS = ("repro", "repro_torch")
CPU = torch.device("cpu")


class Pkg:
    def __init__(self, name):
        self.name = name
        for attr, mod in (("pipeline", "core.pipeline"),
                          ("stages", "core.stages"),
                          ("allocator", "runtime.allocator"),
                          ("executor", "runtime.executor"),
                          ("scheduler", "runtime.scheduler"),
                          ("session", "session")):
            setattr(self, attr, importlib.import_module(f"{name}.{mod}"))
        self.Task = self.pipeline.Task
        self.ResourceRequest = self.pipeline.ResourceRequest
        self.TaskQueue = self.scheduler.TaskQueue
        self.StageSpec = self.stages.StageSpec
        self.BinderConfig = self.stages.BinderConfig
        self.StagedBinderProtocol = self.stages.StagedBinderProtocol

    def devices(self):
        return jax.devices()[:1] if self.name == "repro" else [CPU]

    def task(self, band=0, n_devices=1, priority=0, preemptible=False,
             queued_at=None):
        t = self.Task(kind="x", payload={}, priority=priority,
                      resources=self.ResourceRequest(n_devices))
        t.band = band
        t.preemptible = preemptible
        if queued_at is not None:
            t.timestamps["QUEUED"] = queued_at
        return t


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


class FakeClock:
    """Injected ``now_fn``: time advances only when the test says so."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


# ---------------------------------------------------------------------------
# weighted-fair band scheduling (fake clock, no sleeps)
# ---------------------------------------------------------------------------

def test_fold_flood_cannot_starve_sampling_trickle(pkg):
    q = pkg.TaskQueue(backfill=True, aging_s=60.0, now_fn=FakeClock(),
                      band_shares={0: 1.0, 1: 1.0})
    flood = [pkg.task(band=1, queued_at=0.0) for _ in range(20)]
    trickle = [pkg.task(band=0, queued_at=0.0) for _ in range(5)]
    for t in flood + trickle:
        q.push(t)
    order = [q.pop_fitting(lambda n: True).band for _ in range(25)]
    assert sorted(order[:10])[:5] == [0] * 5
    stats = q.band_stats()
    assert stats[0]["served"] == 5 and stats[1]["served"] >= 4


def test_band_shares_weight_the_dispatch_mix(pkg):
    q = pkg.TaskQueue(backfill=True, now_fn=FakeClock(),
                      band_shares={0: 1.0, 1: 3.0})
    for _ in range(12):
        q.push(pkg.task(band=0, queued_at=0.0))
        q.push(pkg.task(band=1, queued_at=0.0))
    first16 = [q.pop_fitting(lambda n: True).band for _ in range(16)]
    assert first16.count(1) == 12 and first16.count(0) == 4
    assert abs(q.band_stats()[1]["share"] - 0.75) < 1e-9


def test_aged_task_bypasses_fair_pick(pkg):
    clock = FakeClock()
    q = pkg.TaskQueue(backfill=True, aging_s=10.0, now_fn=clock,
                      band_shares={0: 1.0, 1: 1.0})
    for _ in range(4):
        q.push(pkg.task(band=1, queued_at=0.0))
    for _ in range(4):
        assert q.pop_fitting(lambda n: True).band == 1
    clock.advance(50.0)
    starved = pkg.task(band=1, queued_at=0.0)
    q.push(starved)
    for _ in range(3):
        q.push(pkg.task(band=0, queued_at=49.0))
    assert q.pop_fitting(lambda n: True).uid == starved.uid
    assert q.pop_fitting(lambda n: True).band == 0


def test_preemptible_task_unparked_by_fake_clock(pkg):
    clock = FakeClock()
    q = pkg.TaskQueue(backfill=True, aging_s=5.0, now_fn=clock)
    q.push(pkg.task(n_devices=8, queued_at=0.0))          # never fits
    trainer = pkg.task(n_devices=1, priority=100, preemptible=True,
                       queued_at=0.0)
    q.push(trainer)
    assert q.pop_fitting(lambda n: n <= 1) is None
    clock.advance(4.9)
    assert q.pop_fitting(lambda n: n <= 1) is None
    clock.advance(0.2)
    got = q.pop_fitting(lambda n: n <= 1)
    assert got is not None and got.uid == trainer.uid


def test_single_band_with_shares_matches_legacy_order(pkg):
    q = pkg.TaskQueue(backfill=True, now_fn=FakeClock(),
                      band_shares={0: 1.0, 1: 2.0})
    lo = pkg.task(priority=5, queued_at=0.0)
    hi = pkg.task(priority=1, queued_at=0.0)
    q.push(lo)
    q.push(hi)
    assert q.pop_fitting(lambda n: True).uid == hi.uid
    assert q.pop_fitting(lambda n: True).uid == lo.uid


def test_idle_band_lag_is_capped_on_return(pkg):
    q = pkg.TaskQueue(backfill=True, now_fn=FakeClock(),
                      band_shares={0: 1.0, 1: 1.0})
    for _ in range(6):
        q.push(pkg.task(band=1, queued_at=0.0))
    for _ in range(6):
        q.pop_fitting(lambda n: True)
    for _ in range(3):
        q.push(pkg.task(band=0, queued_at=0.0))
        q.push(pkg.task(band=1, queued_at=0.0))
    picks = [q.pop_fitting(lambda n: True).band for _ in range(6)]
    assert picks[:2] != [0, 0]
    assert picks.count(0) == 3 and picks.count(1) == 3


# ---------------------------------------------------------------------------
# stage-aware coalescing (a toy kind on the real executor)
# ---------------------------------------------------------------------------

def _toy_rule(pkg, max_rows=8):
    return pkg.executor.CoalesceRule(
        key=lambda t: t.payload["k"],
        merge=lambda ms: {"k": ms[0].payload["k"],
                          "ids": [m.payload["id"] for m in ms]},
        split=lambda ms, res: [list(res["ids"]) for _ in ms],
        rows=lambda t: 1, max_rows=max_rows)


def _toy_task(pkg, i, stage=None):
    t = pkg.Task(kind="toy", payload={"k": 0, "id": i},
                 resources=pkg.ResourceRequest(1))
    t.stage = stage
    return t


def _run_gated(pkg, tasks, staged_rules=(), kind_rule=None):
    """Submit ``tasks`` behind a blocker holding the only device (one
    worker, so everything queued behind it fuses deterministically);
    returns {id: fused id list} per task."""
    ex = pkg.executor.AsyncExecutor(
        pkg.allocator.DeviceAllocator(pkg.devices()), max_workers=1)
    gate, running = threading.Event(), threading.Event()

    def blocker(sm, p):
        running.set()
        gate.wait(timeout=10)

    ex.register("blocker", blocker)
    ex.register("toy", lambda sm, p: {"ids": p.get("ids", [p.get("id")])})
    if kind_rule is not None:
        ex.register_coalescable("toy", kind_rule)
    for stage, rule in staged_rules:
        ex.register_coalescable("toy", rule, stage=stage)
    try:
        ex.submit(pkg.Task(kind="blocker", payload={},
                           resources=pkg.ResourceRequest(1)))
        assert running.wait(timeout=10)
        for t in tasks:
            ex.submit(t)
        gate.set()
        out = {}
        for d in [ex.drain(timeout=10) for _ in range(len(tasks) + 1)]:
            if d.kind == "toy":
                ids = (d.result["ids"] if isinstance(d.result, dict)
                       else d.result)
                out[d.payload["id"]] = sorted(ids)
        return out
    finally:
        ex.shutdown()


def test_same_stage_tasks_fuse_cross_stage_never(pkg):
    tasks = [_toy_task(pkg, 1, "fold"), _toy_task(pkg, 2, "fold"),
             _toy_task(pkg, 3, "seqdesign"), _toy_task(pkg, 4)]
    got = _run_gated(pkg, tasks, kind_rule=_toy_rule(pkg))
    assert got[1] == got[2] == [1, 2]
    assert got[3] == [3] and got[4] == [4]


def test_stage_rule_overlay_and_fallback(pkg):
    tasks = [_toy_task(pkg, i, "fold") for i in (1, 2, 3)] + [
        _toy_task(pkg, i, "other") for i in (4, 5)]
    got = _run_gated(pkg, tasks, staged_rules=[("fold", _toy_rule(pkg))])
    assert got[1] == got[2] == got[3] == [1, 2, 3]
    assert got[4] == [4] and got[5] == [5]
    got = _run_gated(pkg, [_toy_task(pkg, i, "fold") for i in (6, 7, 8)],
                     staged_rules=[("fold", _toy_rule(pkg, max_rows=2))])
    assert sorted(len(v) for v in got.values()) == [1, 2, 2]


# ---------------------------------------------------------------------------
# the staged binder protocol (unit level)
# ---------------------------------------------------------------------------

def test_stage_table_validation(pkg):
    with pytest.raises(ValueError):
        pkg.StagedBinderProtocol(pkg.BinderConfig(stages=(
            pkg.StageSpec(name="a", kind="backbone_batch"),
            pkg.StageSpec(name="b", kind="generate_batch"),
            pkg.StageSpec(name="c", kind="generate_batch"))))
    proto = pkg.StagedBinderProtocol(pkg.BinderConfig())
    assert [s.name for s in proto.stage_specs()] == [
        "backbone", "seqdesign", "fold"]
    assert [s.params for s in proto.stage_specs()] == [
        "default", "binder", "multimer"]


def test_stage_table_stamps_tasks(pkg):
    S = pkg.StageSpec
    proto = pkg.StagedBinderProtocol(pkg.BinderConfig(stages=(
        S(name="bb", kind="backbone_batch", band=2, n_devices=2),
        S(name="design", kind="generate_batch", params="binder"),
        S(name="score", kind="predict_batch", params="multimer", band=1),
    ), score_batch=2))
    rng = np.random.default_rng(0)
    pl = proto.new_pipeline("p0", rng.normal(size=(30, 16)),
                            rng.normal(size=(16,)), 24)
    t = proto.first_task(pl)
    assert (t.kind, t.stage, t.band) == ("backbone_batch", "bb", 2)
    assert t.resources.n_devices == 2 and t.resources.rows == 1
    assert "params" not in t.payload
    cands = np.stack([rng.normal(size=(30, 16)) for _ in range(4)])
    (gen,) = proto.handlers["backbone_batch"](
        pl, {"rows": [(cands, np.array([0.1, 0.9, 0.2, 0.0]))]}).tasks
    assert (gen.kind, gen.stage, gen.payload["params"]) == (
        "generate_batch", "design", "binder")
    np.testing.assert_allclose(pl.meta["backbone"], cands[1])
    seqs = rng.integers(1, 21, size=(4, 24)).astype(np.int32)
    (fold,) = proto.handlers["generate_batch"](
        pl, {"rows": [(seqs, np.array([0.5, 2.0, 1.0, 0.1],
                                      np.float32))]}).tasks
    assert (fold.kind, fold.stage, fold.band) == ("predict_batch", "score", 1)
    assert fold.payload["params"] == "multimer"
    assert fold.resources.rows == 2
    np.testing.assert_array_equal(fold.payload["sequences"][0][:24], seqs[1])


def test_seed_independent_of_global_uid_counter(pkg):
    rng = np.random.default_rng(0)
    bb, tgt = rng.normal(size=(30, 16)), rng.normal(size=(16,))

    def first_seed(burn_uids):
        for _ in range(burn_uids):
            pkg.Task(kind="x", payload={})
        proto = pkg.StagedBinderProtocol(pkg.BinderConfig(seed=3))
        pl = proto.new_pipeline("p", bb, tgt, 24)
        return proto.first_task(pl).payload["seeds"][0]

    assert first_seed(0) == first_seed(17)


# ---------------------------------------------------------------------------
# staged campaigns end to end
# ---------------------------------------------------------------------------

STAGES = ({"name": "bb", "kind": "backbone_batch"},
          {"name": "design", "kind": "generate_batch", "params": "binder"},
          {"name": "score", "kind": "predict_batch", "params": "multimer",
           "band": 1})


def binder(ps):
    return ps(kind="binder", n_cycles=2, n_candidates=4, score_batch=2)


def rescore(ps):
    return ps(kind="rescore", n_cycles=2, score_batch=4)


def histories(sess):
    return {p.name: [(h["cycle"], h["fitness"], h["sequence"])
                     for h in p.history if "sequence" in h]
            for p in sess.coordinator.pipelines.values()}


def campaign(pkg, protocols, payload, **kw):
    kw.setdefault("receptor_len", 24)
    spec = pkg.session.CampaignSpec(structures=2, protocols=protocols,
                                    seed=0, reduced=True, **kw)
    dev = {} if pkg.name == "repro" else {"devices": [CPU]}
    with pkg.session.ImpressSession(spec, payload=payload, **dev) as s:
        rep = s.run(timeout=300)
        return rep, histories(s), s


@pytest.fixture(scope="module")
def binder_payloads():
    """The reference's reduced fp32 payload with its "binder" generator and
    "multimer" (foldscore-m) scorer in fp32 too, and a ``NoisedPayload``
    holding the same weights in every namespace."""
    import dataclasses

    from repro.configs.registry import get_reduced
    ref, _ = ported_payload()
    f32 = lambda name: dataclasses.replace(get_reduced(name),
                                           compute_dtype="float32")
    ref.add_generator("binder", cfg=f32("progen-s"))
    ref.add_scorer("multimer", cfg=f32("foldscore-m"))
    return ported_payload()


@pytest.mark.parametrize("receptor_len", [24, (24, 32)],
                         ids=["exact", "masked"])
def test_staged_binder_campaign_matches_reference(binder_payloads,
                                                  receptor_len):
    """The three-stage binder campaign declared through
    ``CampaignSpec.stages`` (dict entries) in both packages: the same
    accepted designs, the same task counts by stage, every stage in the
    report, and foldscore-m as the "multimer" scorer."""
    ref, noised = binder_payloads
    runs = [campaign(Pkg(name), (binder(Pkg(name).session.ProtocolSpec),),
                     pp, stages=STAGES, receptor_len=receptor_len)
            for name, pp in (("repro", ref), ("repro_torch", noised))]
    (w_rep, w_hist, _), (g_rep, g_hist, g_sess) = runs
    assert g_rep.executor["n_failed"] == w_rep.executor["n_failed"] == 0
    assert all(len(h) == 2 for h in g_hist.values())     # n_cycles accepted
    assert set(g_hist) == set(w_hist)
    for name, rows in w_hist.items():
        got = g_hist[name]
        assert [(c, s) for c, _, s in got] == [(c, s) for c, _, s in rows]
        np.testing.assert_allclose([f for _, f, _ in got],
                                   [f for _, f, _ in rows], atol=1e-5)
    for name in ("bb", "design", "score"):
        assert g_rep["stages"][name]["tasks"] == \
            w_rep["stages"][name]["tasks"] >= 2, name
        assert 0.0 <= g_rep["stages"][name]["utilization"] <= 1.0
        assert g_rep["stages"][name]["grants"]["grants"] >= 1
    assert "__bands__" in g_rep["stages"]
    assert g_rep["compile"]["length_buckets"] == \
        w_rep["compile"]["length_buckets"]
    assert (g_rep["compile"]["length_buckets"] is None) == \
        (receptor_len == 24)
    cfg, scorer = g_sess.payload.fold_sets["multimer"]
    assert cfg.name == "foldscore-m" and len(scorer.layers) == cfg.n_layers


@pytest.fixture(scope="module")
def seeded_payload():
    """One reduced port payload (seeded weights, seeded draws) for the
    port-only campaigns: namespaces one campaign creates are the same
    objects in the next."""
    return ProteinPayload(seed=0, reduced=True, device="cpu")


def test_binder_composition_independent_of_coalescing(seeded_payload):
    P = Pkg("repro_torch")
    _, fused, _ = campaign(P, (binder(P.session.ProtocolSpec),),
                           seeded_payload, coalesce=True)
    _, solo, _ = campaign(P, (binder(P.session.ProtocolSpec),),
                          seeded_payload, coalesce=False)
    assert fused == solo and fused


def test_binder_composition_independent_of_cotenants(seeded_payload):
    """The binder's designs are the same alone and beside a rescore
    co-tenant flooding its fold stage, which really is shared."""
    P = Pkg("repro_torch")
    ps = P.session.ProtocolSpec
    _, solo, _ = campaign(P, (binder(ps),), seeded_payload)
    rep, fused, _ = campaign(P, (binder(ps), rescore(ps)), seeded_payload)
    assert {f"binder/{k}": v for k, v in solo.items()} == {
        k: v for k, v in fused.items() if k.startswith("binder/")}
    fold = rep["stages"]["fold"]
    assert fold["tasks"] > fold["dispatches"]   # fused dispatches
    assert rep["protocols"]["rescore"]["n_pipelines"] == 2


def test_binder_resume_mid_stage_bit_identical(seeded_payload):
    """A binder campaign checkpointed mid-cycle, with a fold task in flight,
    resumes through ``from_checkpoint`` at the stage it stopped at (the
    ``stage_cursor``), and its accepted designs are bit-identical to an
    uninterrupted run's."""
    from repro_torch.session import (CampaignSpec, ImpressSession,
                                     ProtocolSpec)
    spec = CampaignSpec(structures=2, receptor_len=24,
                        protocols=(binder(ProtocolSpec),), seed=0,
                        reduced=True)
    kw = {"payload": seeded_payload, "devices": [CPU]}
    with ImpressSession(spec, **kw) as sess:
        sess.run(timeout=300)
        baseline = histories(sess)
    assert baseline and all(len(h) == 2 for h in baseline.values())

    sess = ImpressSession(spec, **kw)
    try:
        sess._populate()
        coord = sess.coordinator

        def mid_fold():
            return [p for p in coord.pipelines.values() if p.active
                    and p.meta.get("stage_cursor") == "predict_batch"]

        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and not mid_fold():
            if not coord.step():
                break
        assert mid_fold(), "campaign finished before a mid-fold snapshot"
        state = json.loads(json.dumps(sess.checkpoint()))
    finally:
        sess.shutdown()

    resumed = ImpressSession.from_checkpoint(state, **kw)
    try:
        assert "predict_batch" in [p.meta.get("stage_cursor")
                                   for p in resumed.coordinator.pipelines
                                   .values() if p.active]
        resumed.run(timeout=300)
        assert histories(resumed) == baseline
    finally:
        resumed.shutdown()
