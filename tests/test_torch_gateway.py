"""The port's campaign gateway (``repro_torch.gateway``) on the CPU.

The JAX package's ``tests/test_gateway.py`` scenarios run against the port
(multi-tenant multiplexing, cross-campaign coalescing, per-tenant quotas,
bucket-table refresh, the HTTP API, checkpoint/resume), on a reduced
seeded port payload. The HTTP scenario submits, pauses, streams and
resumes before the drive thread starts, so no step races the campaign to
its end (the reference's copy can finish its one-cycle campaign before its
pause request arrives, and then the pause answers 409 without a "state").

Then one tenant's staged binder campaign runs through both packages'
gateways on the reference's reduced fp32 weights in every namespace, the
port fed the reference's draws, from one pipeline uid: the same
trajectories, tasks by kind and stage, and accepted designs. A gateway
checkpoint of either package loads in the other package's
``ImpressSession``. Last, what the reference does not test: the
supervisor's restart from an auto-checkpoint and its FAILED state without
a restart budget, ``GET /healthz`` without a token, retention's archive
and eviction, and a corrupted auto-checkpoint falling back to ``.1``."""

import collections
import itertools
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.core.payload import ProteinPayload  # noqa: E402
from repro_torch.gateway import (GatewayError, GatewayService,  # noqa: E402
                                 TenantQuota, make_server)
from test_torch_session import ported_payload  # noqa: E402

CPU = torch.device("cpu")
BINDER = {"kind": "binder", "n_cycles": 1, "n_candidates": 4,
          "score_batch": 2}
SPEC = {"structures": 2, "receptor_len": [24, 32], "peptide_len": 8,
        "protocols": [BINDER], "seed": 0, "reduced": True}
TERMINAL = ("COMPLETED", "CANCELED", "FAILED")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tensors here are small, and
    parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared_payload():
    return ProteinPayload(seed=0, reduced=True, device=CPU)


def _gw(payload, **kw):
    kw.setdefault("max_workers", 4)
    return GatewayService(payload=payload, devices=[CPU], **kw)


@pytest.fixture()
def gateway(shared_payload):
    gw = _gw(shared_payload, quotas={"alice": TenantQuota(share=1.0),
                                     "bob": TenantQuota(share=1.0)})
    gw.start()
    yield gw
    gw.shutdown()


def _wait(gw, cid, tenant=None, timeout=180.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        rep = gw.report(cid, tenant=tenant)
        if rep["state"] in TERMINAL:
            return rep
        time.sleep(0.02)
    raise AssertionError(f"campaign {cid} did not finish: {rep['state']}")


# -- cross-campaign coalescing -----------------------------------------------


def test_cross_tenant_fusion(gateway):
    """Two tenants' same-bucket same-stage tasks fuse into shared device
    batches; the coalesce evidence names members from both tenants in one
    dispatch. The one device is held busy while both tenants submit, so
    their first-stage tasks are queued together whatever the host's thread
    scheduling: on a loaded host bob's submission can land after alice's
    first dispatch has closed its 5 ms admission window, and the two
    campaigns then run out of phase without ever sharing a dispatch."""
    held = gateway.allocator.request(1)
    assert held is not None
    try:
        a = gateway.submit_campaign(dict(SPEC), tenant="alice")
        b = gateway.submit_campaign(dict(SPEC, seed=1), tenant="bob")
    finally:
        gateway.allocator.release(held)
    ra = _wait(gateway, a)
    rb = _wait(gateway, b)
    assert ra["trajectories"] > 0 and rb["trajectories"] > 0

    stats = gateway.coalesce_stats()
    assert "cross_tenant" in stats, "no cross-tenant dispatch ever fused"
    xt = stats["cross_tenant"]
    assert xt["dispatches"] >= 1
    assert any(set(s) >= {"alice", "bob"} for s in xt["tenant_sets"]), \
        xt["tenant_sets"]

    assert ra["tenant"] == "alice" and rb["tenant"] == "bob"
    assert ra["telemetry"]["tenant"].get("tasks", 0) > 0
    assert rb["telemetry"]["tenant"].get("tasks", 0) > 0
    assert ra["version"] >= 1
    assert all(e.get("protocol", "").startswith(a + "/")
               for e in ra["events"])

    snap = gateway.metrics_snapshot()
    assert snap["campaigns"][a]["tenant"] == "alice"
    assert set(snap["tenants"]) >= {"alice", "bob"}


def test_campaign_isolation_and_lifecycle(gateway):
    """Tenant scoping (no cross-tenant existence oracle) and the
    pause/resume/cancel state machine."""
    a = gateway.submit_campaign(dict(SPEC), tenant="alice")
    with pytest.raises(GatewayError) as ei:
        gateway.report(a, tenant="bob")
    assert ei.value.status == 404

    gateway.pause_campaign(a, tenant="alice")
    assert gateway.report(a)["state"] == "PAUSED"
    with pytest.raises(GatewayError) as ei:
        gateway.pause_campaign(a)        # double-pause is a state error
    assert ei.value.status == 409
    gateway.resume_campaign(a)
    assert gateway.report(a)["state"] == "RUNNING"

    gateway.cancel_campaign(a)
    rep = _wait(gateway, a)
    assert rep["state"] == "CANCELED"
    gateway.cancel_campaign(a)           # idempotent once terminal
    with pytest.raises(GatewayError) as ei:
        gateway.resume_campaign(a)
    assert ei.value.status == 409


# -- quotas ------------------------------------------------------------------


def _quota_pkg(name):
    """One package's quota manager, queue and task types."""
    import importlib

    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    pl = mod("core.pipeline")   # first: the reference's import cycle
    quotas = mod("gateway.quotas")
    return types.SimpleNamespace(
        Task=pl.Task, ResourceRequest=pl.ResourceRequest,
        QuotaManager=quotas.QuotaManager, TenantQuota=quotas.TenantQuota,
        tenant_band=quotas.tenant_band,
        TaskQueue=mod("runtime.scheduler").TaskQueue)


def _mk(P, tenant, band, n_dev=1):
    return P.Task(kind="x", payload={}, resources=P.ResourceRequest(n_dev),
                  tenant=tenant, band=band)


def _quota_flood(name):
    """A fake-clock simulation of the dispatch loop through ``name``'s
    ``QuotaManager`` and ``TaskQueue``: 40 one-device tasks of a tenant
    capped at two devices and 8 of an uncapped co-tenant, on four devices,
    each task holding its grant for one tick. Returns the dispatch order
    as (tick, tenant, index among the tenant's tasks), each tenant's queue
    waits, the flood tenant's held devices at each tick, and the
    manager's stats."""
    P = _quota_pkg(name)
    clock = {"t": 0.0}
    qm = P.QuotaManager({"flood": P.TenantQuota(share=1.0, max_devices=2),
                         "coop": P.TenantQuota(share=1.0)})
    fb, cb = P.tenant_band(0, 0), P.tenant_band(1, 0)
    q = P.TaskQueue(aging_s=1e9, now_fn=lambda: clock["t"],
                    band_shares={fb: 1.0, cb: 1.0})
    q.set_admission(qm.admit)

    index = {}
    for tenant, band, n in (("flood", fb, 40), ("coop", cb, 8)):
        for i in range(n):
            t = _mk(P, tenant, band)
            t.timestamps["QUEUED"] = clock["t"]
            index[t.uid] = i
            q.push(t)

    free = 4
    inflight = []   # (finish_time, task, sub)
    order, held = [], []
    waits = {"flood": [], "coop": []}
    while len(q) or inflight:
        for ft, task, sub in list(inflight):
            if ft <= clock["t"]:
                inflight.remove((ft, task, sub))
                qm.released(task, sub)
                free += sub.n_devices
        while True:
            task = q.pop_fitting(lambda n: n <= free)
            if task is None:
                break
            sub = types.SimpleNamespace(n_devices=task.resources.n_devices)
            qm.granted(task, sub)
            free -= sub.n_devices
            order.append((clock["t"], task.tenant, index[task.uid]))
            waits[task.tenant].append(
                clock["t"] - task.timestamps["QUEUED"])
            inflight.append((clock["t"] + 1.0, task, sub))
        held.append(sum(s.n_devices for _, t, s in inflight
                        if t.tenant == "flood"))
        clock["t"] += 1.0
    return {"order": order, "waits": waits, "held": held,
            "stats": qm.stats()}


def _quota_refund(name):
    """admit / denied / granted / released on one tenant capped at two
    devices: each call's answer and the stats after each step."""
    P = _quota_pkg(name)
    qm = P.QuotaManager({"a": P.TenantQuota(max_devices=2)})
    t1, t2 = _mk(P, "a", 0, n_dev=2), _mk(P, "a", 0, n_dev=2)
    sub = types.SimpleNamespace(n_devices=2)
    steps = [lambda: qm.admit(t1), lambda: qm.admit(t2),
             lambda: qm.denied(t1), lambda: qm.admit(t2),
             lambda: qm.granted(t2, sub), lambda: qm.released(t2, sub)]
    return [(step(), qm.stats()) for step in steps]


def test_quota_hard_cap_and_bounded_wait_fake_clock():
    """A fake-clock simulation of the dispatch loop: a tenant flooding the
    queue is pinned at its device cap while the co-tenant's p95 queue wait
    stays bounded (rejected flood tasks are skipped, not head-blocking)."""
    run = _quota_flood("repro_torch")
    waits, stats = run["waits"], run["stats"]
    assert max(run["held"]) <= 2, "flood tenant exceeded its device cap"
    assert stats["flood"]["peak_held"] <= 2
    assert stats["flood"]["rejections"] > 0
    assert stats["coop"]["held"] == 0 and stats["flood"]["held"] == 0
    assert len(waits["coop"]) == 8
    p95 = sorted(waits["coop"])[int(0.95 * len(waits["coop"]))]
    assert p95 <= 4.0, waits["coop"]
    assert max(waits["coop"]) < min(10.0, max(waits["flood"]))


def test_quota_admission_refund_on_denied_allocation():
    """admit() reserves; denied() refunds, or a racing allocation failure
    would leak reserved devices until the cap wedges shut."""
    run = _quota_refund("repro_torch")
    answers = [a for a, _ in run]
    assert answers[:2] == [True, False]
    assert answers[3] is True
    assert run[-1][1]["a"]["held"] == 0


@pytest.mark.parametrize("scenario", [_quota_flood, _quota_refund],
                         ids=["flood", "refund"])
def test_quota_manager_matches_reference_on_one_fake_clock(scenario):
    """The same admissions on one fake clock through the reference's
    ``QuotaManager`` and ``TaskQueue`` and the port's: the same dispatch
    order, queue waits, held devices, answers and stats."""
    assert scenario("repro_torch") == scenario("repro")


# -- bucket-table refresh ----------------------------------------------------


def test_stream_structures_refreshes_bucket_table(shared_payload):
    """Streaming novel-length structures into a running campaign extends
    the bucket table (new grid edges only), bumps its version, and leaves
    the original pipelines' results identical to an unstreamed control."""
    def run(stream):
        gw = _gw(shared_payload)
        gw.start()
        try:
            cid = gw.submit_campaign(dict(SPEC), tenant="alice")
            before = set(gw.report(cid)["bucket_table"])
            out = None
            if stream:
                out = gw.stream_structures(
                    cid, {"structures": 1, "receptor_len": 56, "seed": 9})
            return before, out, _wait(gw, cid)
        finally:
            gw.shutdown()

    before, _, control = run(stream=False)
    before2, out, streamed = run(stream=True)
    assert before == before2

    assert out["bucket_table_refreshed"] is True
    assert out["bucket_table_version"] == 1
    after = set(out["bucket_table"])
    assert after > before
    assert 64 in after                    # 56 and 56+8 snap to grid edge 64
    assert streamed["bucket_table_version"] == 1

    def core(rep):
        return {n: [(h["cycle"], round(h["fitness"], 9), h["sequence"])
                    for h in pl["history"]]
                for n, pl in rep["pipelines"].items()
                if not n.startswith("s1/")}
    assert core(streamed) == core(control)
    extra = [n for n in streamed["pipelines"] if n.startswith("s1/")]
    assert extra and all(streamed["pipelines"][n]["history"]
                         for n in extra)


def test_homogeneous_campaign_rejects_novel_length(gateway):
    """Exact-length campaigns refuse a novel streamed length (409) and
    welcome the same length."""
    cid = gateway.submit_campaign(
        dict(SPEC, receptor_len=24, structures=1), tenant="alice")
    with pytest.raises(GatewayError) as ei:
        gateway.stream_structures(cid, {"structures": 1,
                                        "receptor_len": 56})
    assert ei.value.status == 409
    assert "exact-length" in str(ei.value)
    out = gateway.stream_structures(cid, {"structures": 1,
                                          "receptor_len": 24})
    assert out["added"] == 1 and out["bucket_table_refreshed"] is False


# -- HTTP API ----------------------------------------------------------------


def _req(base, method, path, tok=None, body=None):
    data = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"}
    if tok:
        headers["Authorization"] = f"Bearer {tok}"
    r = urllib.request.Request(base + path, data=data, method=method,
                               headers=headers)
    try:
        with urllib.request.urlopen(r) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(gw, tokens):
    srv = make_server(gw, tokens=tokens)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, "http://%s:%d" % srv.server_address[:2]


def test_http_api_end_to_end(shared_payload):
    """The full wire surface: token auth, tenant-scoped 404, lifecycle
    verbs, report polling, structure streaming, metrics. The campaign is
    submitted, paused, streamed into and resumed before the drive thread
    starts, so each verb meets the state it expects."""
    gw = _gw(shared_payload)
    srv, base = _serve(gw, {"tok-a": "alice", "tok-b": "bob"})
    try:
        s, e = _req(base, "GET", "/metrics")
        assert s == 401                               # no token
        s, e = _req(base, "GET", "/metrics", tok="nope")
        assert s == 401                               # unknown token
        s, r = _req(base, "POST", "/campaigns", tok="tok-a",
                    body=dict(SPEC, structures=1))
        assert (s, r["state"]) == (201, "RUNNING")
        cid = r["id"]
        s, _ = _req(base, "GET", f"/campaigns/{cid}/report", tok="tok-b")
        assert s == 404                               # not bob's campaign
        s, r = _req(base, "POST", f"/campaigns/{cid}/pause", tok="tok-a")
        assert (s, r["state"]) == (200, "PAUSED")
        s, r = _req(base, "POST", f"/campaigns/{cid}/structures",
                    tok="tok-a", body={"structures": 1, "seed": 3})
        assert s == 200 and r["added"] == 1
        s, r = _req(base, "POST", f"/campaigns/{cid}/resume", tok="tok-a")
        assert (s, r["state"]) == (200, "RUNNING")
        s, r = _req(base, "GET", "/campaigns", tok="tok-a")
        assert [c["id"] for c in r["campaigns"]] == [cid]
        s, r = _req(base, "GET", "/campaigns", tok="tok-b")
        assert r["campaigns"] == []

        gw.start()
        deadline = time.time() + 180
        while time.time() < deadline:
            s, rep = _req(base, "GET", f"/campaigns/{cid}/report",
                          tok="tok-a")
            if rep["state"] == "COMPLETED":
                break
            time.sleep(0.05)
        assert rep["state"] == "COMPLETED" and rep["trajectories"] > 0
        assert len(rep["pipelines"]) == 2             # 1 + 1 streamed

        s, ck = _req(base, "POST", f"/campaigns/{cid}/checkpoint",
                     tok="tok-a")
        assert s == 200 and set(ck) >= {"schema_version", "spec",
                                        "coordinator"}
        s, m = _req(base, "GET", "/metrics", tok="tok-a")
        assert s == 200 and "quotas" in m and "coalesce" in m
        s, e = _req(base, "POST", "/campaigns", tok="tok-a",
                    body={"protocols": [{"kind": "not-a-kind"}]})
        assert s == 400
        s, e = _req(base, "GET", "/nope", tok="tok-a")
        assert s == 404
        s, e = _req(base, "POST", f"/campaigns/{cid}/pause", tok="tok-a")
        assert s == 409 and "state" not in e          # a COMPLETED campaign
    finally:
        srv.shutdown()
        gw.shutdown()


def test_healthz_answers_without_a_token(shared_payload):
    """``GET /healthz`` needs no token, even with a token table, and tells
    a gateway not started from one serving and from one stopped."""
    gw = _gw(shared_payload)
    srv, base = _serve(gw, {"tok-a": "alice"})
    try:
        s, h = _req(base, "GET", "/healthz")
        assert s == 200 and h["status"] == "not_started"
        assert h["devices"] == {"total": 1, "free": 1}
        gw.start()
        cid = gw.submit_campaign(dict(SPEC, structures=1), tenant="alice")
        _wait(gw, cid)
        s, h = _req(base, "GET", "/healthz")
        assert s == 200 and h["status"] == "ok" and h["drive_thread_alive"]
        assert h["campaigns"] == {"COMPLETED": 1}
        assert _req(base, "GET", "/metrics")[0] == 401
    finally:
        srv.shutdown()
        gw.shutdown()
    assert gw.health()["status"] == "stopped"


# -- checkpoint / resume -----------------------------------------------------


def test_gateway_checkpoint_resume(shared_payload):
    """shutdown() checkpoints live campaigns in the session-compatible
    schema; a fresh gateway resumes one and completes it."""
    gw = _gw(shared_payload)
    gw.start()
    cid = gw.submit_campaign(dict(SPEC), tenant="alice")
    gw.pause_campaign(cid)
    checkpoints = gw.shutdown()
    assert set(checkpoints) == {cid}
    ck = json.loads(json.dumps(checkpoints[cid]))   # wire-serializable
    assert ck["schema_version"] == 1
    assert set(ck["coordinator"]["protocols"]) == {"binder"}
    assert all(not p["protocol"].startswith(cid)
               for p in ck["coordinator"]["pipelines"])

    gw2 = _gw(shared_payload)
    gw2.start()
    try:
        cid2 = gw2.submit_campaign(ck["spec"], tenant="alice", state=ck)
        rep = _wait(gw2, cid2)
        assert rep["state"] == "COMPLETED"
        assert rep["trajectories"] > 0
        assert all(pl["history"] for pl in rep["pipelines"].values())
    finally:
        gw2.shutdown()


def test_gateway_checkpoint_loads_in_session(shared_payload):
    """The same checkpoint restores through the port's
    ``ImpressSession.from_checkpoint``."""
    from repro_torch.session import ImpressSession

    gw = _gw(shared_payload)
    gw.start()
    cid = gw.submit_campaign(dict(SPEC), tenant="alice")
    gw.pause_campaign(cid)
    ck = gw.shutdown()[cid]

    sess = ImpressSession.from_checkpoint(ck, payload=shared_payload,
                                          devices=[CPU])
    try:
        assert len(sess.coordinator.pipelines) == 2
        rep = sess.run()
        assert rep.trajectories > 0
    finally:
        sess.shutdown()


# -- the reference, on its weights -------------------------------------------


@pytest.fixture(scope="module")
def binder_payloads():
    """The reference's reduced fp32 payload with fp32 "binder" and
    "multimer" namespaces, and a port ``NoisedPayload`` on its weights in
    every namespace (the reference's draws)."""
    import dataclasses

    from repro.configs.registry import get_reduced
    ref, _ = ported_payload()
    f32 = lambda name: dataclasses.replace(get_reduced(name),  # noqa: E731
                                           compute_dtype="float32")
    ref.add_generator("binder", cfg=f32("progen-s"))
    ref.add_scorer("multimer", cfg=f32("foldscore-m"))
    return ported_payload()


def _pkg_gateway(name, payload, **kw):
    if name == "repro":
        from repro.gateway import GatewayService as Ref
        return Ref(payload=payload, max_workers=4, **kw)
    return _gw(payload, **kw)


def _campaign_run(name, payload, uid0, faults=()):
    """One tenant's binder campaign through ``name``'s gateway from pipeline
    uid ``uid0``, under ``name``'s ``FaultPlan`` of ``faults`` (keyword
    dicts of ``FaultSpec``) when there are any. Returns (report, DONE tasks
    by (kind, stage))."""
    import importlib

    pipeline = importlib.import_module(f"{name}.core.pipeline")
    kw = {}
    if faults:
        res = importlib.import_module(f"{name}.resilience")
        kw["fault_plan"] = res.FaultPlan(
            [res.FaultSpec(**f) for f in faults], seed=0)
    gw = _pkg_gateway(name, payload, **kw)
    try:
        pipeline._uid = itertools.count(uid0)
        cid = gw.submit_campaign(dict(SPEC), tenant="alice")
        gw.start()
        rep = _wait(gw, cid)
        done = collections.Counter(
            (t.kind, t.stage) for t in gw.executor._tasks.values()
            if t.state == pipeline.TaskState.DONE)
    finally:
        gw.shutdown()
    return rep, done


def _same_designs(got, want):
    """Every pipeline accepted the same sequences, cycle by cycle, with
    fitness within 1e-5."""
    assert set(got["pipelines"]) == set(want["pipelines"])
    for name, pl in want["pipelines"].items():
        want_h = [h for h in pl["history"] if "sequence" in h]
        got_h = [h for h in got["pipelines"][name]["history"]
                 if "sequence" in h]
        assert want_h and [(h["cycle"], list(h["sequence"]))
                           for h in got_h] \
            == [(h["cycle"], list(h["sequence"])) for h in want_h], name
        np.testing.assert_allclose([h["fitness"] for h in got_h],
                                   [h["fitness"] for h in want_h],
                                   atol=1e-5)


def test_binder_campaign_matches_reference_gateway(binder_payloads):
    """One tenant's staged binder campaign (mixed receptor lengths, so the
    grid buckets apply) through the reference's gateway and the port's, on
    the same fp32 weights and draws: the same trajectories, tasks by kind
    and stage, bucket table and accepted designs."""
    ref, noised = binder_payloads
    from repro.core import pipeline as ref_pipeline
    from repro_torch.core import pipeline as port_pipeline
    uid0 = max(next(ref_pipeline._uid), next(port_pipeline._uid)) + 1
    w_rep, w_done = _campaign_run("repro", ref, uid0)
    g_rep, g_done = _campaign_run("repro_torch", noised, uid0)
    assert w_rep["state"] == g_rep["state"] == "COMPLETED"
    assert g_rep["trajectories"] == w_rep["trajectories"] > 0
    assert g_done == w_done
    assert {k for k, _ in g_done} >= {"backbone_batch", "generate_batch",
                                      "predict_batch"}
    assert g_rep["bucket_table"] == w_rep["bucket_table"] == [24, 32, 48]
    _same_designs(g_rep, w_rep)


def test_faulted_binder_campaign_matches_reference_gateway(binder_payloads):
    """The same campaign under one fault schedule in each package's
    ``FaultPlan``: transient errors on the first generate and second
    predict dispatches, and a slowed first backbone dispatch. Both
    gateways fire the same faults with the same events, retry every failed
    row to done, quarantine nothing, and accept the fault-free designs.
    The retry count itself is not compared: it is the number of rows the
    failed dispatches had fused, which the worker threads' timing
    decides."""
    ref, noised = binder_payloads
    from repro.core import pipeline as ref_pipeline
    from repro_torch.core import pipeline as port_pipeline
    faults = ({"op": "error", "kind": "generate_batch", "at": 1},
              {"op": "error", "kind": "predict_batch", "at": 2},
              {"op": "slow", "kind": "backbone_batch", "at": 1,
               "delay_s": 0.02})
    uid0 = max(next(ref_pipeline._uid), next(port_pipeline._uid)) + 1
    c_rep, _ = _campaign_run("repro_torch", noised, uid0)
    w_rep, w_done = _campaign_run("repro", ref, uid0, faults)
    g_rep, g_done = _campaign_run("repro_torch", noised, uid0, faults)
    assert w_rep["state"] == g_rep["state"] == "COMPLETED"
    assert g_rep["trajectories"] == w_rep["trajectories"] > 0
    assert g_done == w_done
    w_res, g_res = w_rep["resilience"], g_rep["resilience"]
    assert g_res["faults_injected"] == w_res["faults_injected"]
    assert g_res["faults_injected"]["fired_by_op"] == {"error": 2,
                                                       "slow": 1}
    assert g_res["policy"] == w_res["policy"]
    for res in (w_res, g_res):
        assert res["retries"] >= 2 and not res["failed_by_class"]
        assert "deadletter" not in res
    _same_designs(g_rep, w_rep)
    _same_designs(g_rep, c_rep)


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_gateway_checkpoint_loads_in_other_package_session(
        binder_payloads, writer, reader):
    """A gateway checkpoint (schema 1) written by one package restores
    through the other package's ``ImpressSession.from_checkpoint`` and runs
    to a design in every pipeline."""
    import importlib

    ref, noised = binder_payloads
    pp = {"repro": ref, "repro_torch": noised}
    gw = _pkg_gateway(writer, pp[writer])
    cid = gw.submit_campaign(dict(SPEC), tenant="alice")
    gw.pause_campaign(cid)
    ck = json.loads(json.dumps(gw.shutdown()[cid]))
    assert ck["schema_version"] == 1

    session = importlib.import_module(f"{reader}.session")
    dev = {} if reader == "repro" else {"devices": [CPU]}
    sess = session.ImpressSession.from_checkpoint(ck, payload=pp[reader],
                                                  **dev)
    try:
        assert sorted(p.name for p in sess.coordinator.pipelines.values()) \
            == sorted(p["name"] for p in ck["coordinator"]["pipelines"])
        rep = sess.run(timeout=180)
        assert rep.trajectories > 0
        assert all(p.history for p in sess.coordinator.pipelines.values())
    finally:
        sess.shutdown()


# -- supervisor, retention, checkpoint fallback ------------------------------


def _raise_once(proto, kind):
    """Wrap ``proto``'s ``kind`` handler so that its first call raises."""
    inner = proto.handlers[kind]
    calls = []

    def handler(pl, result):
        calls.append(pl.name)
        if len(calls) == 1:
            raise RuntimeError("injected handler fault")
        return inner(pl, result)
    proto.handlers[kind] = handler
    return calls


@pytest.mark.parametrize("max_restarts", [1, 0])
def test_supervisor_restarts_or_fails_a_crashed_campaign(shared_payload,
                                                         max_restarts):
    """A protocol handler that raises once: with a restart budget the
    supervisor restarts the campaign from its auto-checkpoint and it
    completes (``restarts`` 1); with none the campaign is FAILED. Either
    way the co-tenant's campaign completes."""
    gw = _gw(shared_payload, checkpoint_every_s=0.01,
             max_restarts=max_restarts)
    try:
        a = gw.submit_campaign(dict(SPEC), tenant="alice")
        b = gw.submit_campaign(dict(SPEC, seed=1), tenant="bob")
        (proto,) = gw._campaigns[a].protocols.values()
        calls = _raise_once(proto, "predict_batch")
        gw.start()
        ra, rb = _wait(gw, a), _wait(gw, b)
    finally:
        gw.shutdown()
    assert calls and rb["state"] == "COMPLETED" and rb["trajectories"] > 0
    assert "injected handler fault" in ra["failure"]
    metrics = gw.telemetry.metrics
    assert metrics.value("gateway.protocol_crashes") == 1
    assert metrics.value("gateway.auto_checkpoints") >= 2
    if max_restarts:
        assert ra["state"] == "COMPLETED" and ra["restarts"] == 1
        assert ra["trajectories"] > 0
        assert all(p["history"] for p in ra["pipelines"].values())
        assert metrics.value("gateway.campaign_restarts") == 1
    else:
        assert ra["state"] == "FAILED" and "restarts" not in ra


def test_retention_archives_then_evicts(shared_payload, tmp_path):
    """``retention_max=1``: once a second campaign finishes, the older one
    is archived to ``report-<id>.json`` and evicted (404 after)."""
    gw = _gw(shared_payload, checkpoint_dir=str(tmp_path), retention_max=1)
    gw.start()
    try:
        a = gw.submit_campaign(dict(SPEC, structures=1), tenant="alice")
        ra = _wait(gw, a)
        b = gw.submit_campaign(dict(SPEC, structures=1), tenant="alice")
        _wait(gw, b)
        deadline = time.time() + 30
        while a in {c["id"] for c in gw.list_campaigns()} \
                and time.time() < deadline:
            time.sleep(0.02)
        with pytest.raises(GatewayError) as ei:
            gw.report(a)
        assert ei.value.status == 404
        assert [c["id"] for c in gw.list_campaigns()] == [b]
        assert gw.telemetry.metrics.value("gateway.campaigns_evicted") == 1
    finally:
        gw.shutdown()
    with open(tmp_path / f"report-{a}.json") as f:
        archived = json.load(f)
    assert archived["campaign"] == a and archived["state"] == "COMPLETED"
    assert archived["trajectories"] == ra["trajectories"] > 0
    assert not os.path.exists(tmp_path / f"report-{b}.json")


def test_corrupted_auto_checkpoint_falls_back_to_previous_copy(
        shared_payload, tmp_path):
    """A ``corrupt_checkpoint`` fault on the second auto-checkpoint written
    (the campaign's own second copy): right after it lands, the newest
    file fails verification and ``load_campaign_checkpoint`` returns the
    ``.1`` copy; ``restore_campaigns`` resubmits the campaign from it."""
    from repro_torch.checkpoint.io import CheckpointCorruptError
    from repro_torch.resilience import FaultPlan, FaultSpec

    plan = FaultPlan([FaultSpec(op="corrupt_checkpoint", at=2)], seed=0)
    gw = _gw(shared_payload, checkpoint_dir=str(tmp_path),
             checkpoint_every_s=0.01, fault_plan=plan)
    seen = {}
    inner = plan.on_checkpoint_saved

    def probe(path):
        hit = inner(path)
        if hit:
            cid = os.path.basename(path)[len("campaign-"):-len(".json")]
            with pytest.raises((CheckpointCorruptError, ValueError)):
                GatewayService._read_envelope(path)
            seen["previous"] = GatewayService._read_envelope(path + ".1")
            seen["loaded"] = gw.load_campaign_checkpoint(cid)
        return hit
    plan.on_checkpoint_saved = probe
    try:
        cid = gw.submit_campaign(dict(SPEC), tenant="alice")
        gw.start()
        assert _wait(gw, cid)["state"] == "COMPLETED"
    finally:
        gw.shutdown()
    assert plan.summary()["fired_by_op"] == {"corrupt_checkpoint": 1}
    state, tenant = seen["loaded"]
    assert (state, tenant) == seen["previous"] and tenant == "alice"
    assert state["schema_version"] == 1

    gw2 = _gw(shared_payload, checkpoint_dir=str(tmp_path))
    try:
        restored = gw2.restore_campaigns()
        assert set(restored) == {cid}
        assert gw2.list_campaigns()[0]["tenant"] in ("alice",)
    finally:
        gw2.shutdown()
