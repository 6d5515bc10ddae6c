"""The port's campaign facade (``repro_torch.session``) on the CPU.

The JAX package's ``tests/test_session.py`` scenarios run over both
packages where they are package-neutral (typed routing, legacy vs registry
routing, a custom protocol, the Pareto rule, the three-protocol session,
kind and handler validation). Then the three-protocol session (im-rp,
cont-v, multi-objective) runs in both packages on the reference's reduced
fp32 weights, the port fed the reference's draws (``NoisedPayload``), and
must give the same events, tasks by kind and accepted designs; its
checkpoint round-trips, and a reference checkpoint restores into a port
session. Last, what the port refuses before any thread starts, and
``python -m repro_torch.launch.serve --campaign`` on the CPU.

Sampling seeds of im-rp and multi-objective come from pipeline uids, which
one counter in each package's ``core/pipeline.py`` hands out to pipelines
and tasks alike. The parity session starts both counters at one value and
spawns no sub-pipeline: a sub-pipeline's uid is drawn mid-run, after a
number of tasks that depends on how the three protocols interleave."""

import collections
import importlib
import itertools
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import bridge  # noqa: E402
from test_torch_campaign import NoisedPayload  # noqa: E402
from test_torch_payload import payloads  # noqa: E402

PKGS = ("repro", "repro_torch")
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


class Pkg:
    """One package's session, protocols, coordinator and runtime."""

    def __init__(self, name):
        self.name = name
        for attr, mod in (("api", "core.api"), ("pipeline", "core.pipeline"),
                          ("protocol", "core.protocol"),
                          ("mo", "core.multi_objective"),
                          ("coordinator", "core.coordinator"),
                          ("allocator", "runtime.allocator"),
                          ("executor", "runtime.executor"),
                          ("session", "session")):
            setattr(self, attr, importlib.import_module(f"{name}.{mod}"))
        self.Task = self.pipeline.Task
        self.Pipeline = self.pipeline.Pipeline
        self.Decision = self.api.Decision
        self.Coordinator = self.coordinator.Coordinator
        self.CampaignSpec = self.session.CampaignSpec
        self.ProtocolSpec = self.session.ProtocolSpec
        self.ImpressSession = self.session.ImpressSession

    def devices(self):
        return jax.devices()[:1] if self.name == "repro" else [CPU]

    def session_kw(self):
        """What a session needs beyond its spec here: the port's entry
        points run on CUDA unless given the CPU."""
        return {} if self.name == "repro" else {"devices": [CPU]}

    def impress(self, seed=0, **kw):
        kw.setdefault("n_candidates", 4)
        kw.setdefault("n_cycles", 2)
        kw.setdefault("gen_devices", 1)
        kw.setdefault("predict_devices", 1)
        kw.setdefault("max_sub_pipelines", 2)
        return self.protocol.ImpressProtocol(
            self.protocol.ProtocolConfig(seed=seed, **kw))

    def fake_executor(self, seed=0, max_workers=2):
        ex = self.executor.AsyncExecutor(
            self.allocator.DeviceAllocator(self.devices()),
            max_workers=max_workers)
        fp = FakePayload(seed)
        ex.register("generate", fp.generate)
        ex.register("predict", fp.predict)
        return ex

    def take_first(self):
        """test_session.py's minimal third-party protocol, written against
        this package's ``DesignProtocol`` alone."""
        pkg = self

        class TakeFirstProtocol(pkg.api.DesignProtocol):
            def __init__(self):
                self.handlers = {"generate": self._gen_done,
                                 "predict": self._pred_done}

            def new_pipeline(self, name, backbone, target, receptor_len,
                             peptide_tokens=None, **kw):
                return pkg.Pipeline(name=name, meta={
                    "backbone": np.asarray(backbone, np.float32),
                    "target": np.asarray(target, np.float32),
                    "receptor_len": int(receptor_len), "trajectories": 0})

            def first_task(self, pl):
                return pkg.Task(kind="generate", pipeline_id=pl.uid, payload={
                    "backbone": pl.meta["backbone"], "n": 2,
                    "length": pl.meta["receptor_len"], "seed": 0,
                }, resources=pkg.pipeline.ResourceRequest(n_devices=1))

            def _gen_done(self, pl, result):
                seqs, lls = result
                pl.meta["best"] = np.asarray(seqs[int(np.argmax(lls))],
                                             np.int32)
                return pkg.Decision(tasks=[pkg.Task(
                    kind="predict", pipeline_id=pl.uid, payload={
                        "sequence": pl.meta["best"],
                        "target": pl.meta["target"],
                        "receptor_len": pl.meta["receptor_len"],
                    }, resources=pkg.pipeline.ResourceRequest(n_devices=1))])

            def _pred_done(self, pl, metrics):
                pl.meta["trajectories"] += 1
                pl.history.append(dict(metrics, fitness=1.0, cycle=pl.cycle,
                                       gen_version=0))
                pl.active = False
                return pkg.Decision(events=[{"event": "completed",
                                             "cycle": 0}],
                                    accepted_design=pl.history[-1])

        return TakeFirstProtocol()


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


class FakePayload:
    """Deterministic instant payloads (no devices touched)."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)

    def generate(self, submesh, payload):
        n, L = payload["n"], payload["length"]
        seqs = self.rng.integers(1, 21, size=(n, L)).astype(np.int32)
        return seqs, -self.rng.random(n).astype(np.float32)

    def predict(self, submesh, payload):
        s = float(np.mean(payload["sequence"])) + self.rng.normal(0, 2.0)
        return {"plddt": 50 + s, "ptm": 0.5, "pae": 15.0}


def new_pl(p, name="X"):
    return p.new_pipeline(name, np.zeros((30, 16), np.float32),
                          np.zeros(16, np.float32), 24,
                          np.arange(1, 7, dtype=np.int32))


# ---------------------------------------------------------------------------
# typed routing, pluggability, the Pareto rule (both packages)
# ---------------------------------------------------------------------------

def test_impress_declares_typed_handler_registry(pkg):
    p = pkg.impress()
    assert set(p.task_kinds()) == {"generate", "generate_batch",
                                   "predict", "predict_batch"}
    pl = new_pl(p)
    seqs = np.tile(np.arange(24, dtype=np.int32), (4, 1))
    d = p.handlers["generate"](pl, (seqs, -np.arange(4, dtype=np.float32)))
    assert isinstance(d, pkg.Decision)
    assert len(d.tasks) == 1 and d.tasks[0].kind == "predict"
    d = p.handlers["predict"](pl, {"plddt": 80.0, "ptm": 0.8, "pae": 8.0})
    assert d.events == [{"event": "accepted", "cycle": 1}]
    assert d.accepted_design is pl.history[-1]


def test_legacy_constructor_and_registry_routing_are_event_identical(pkg):
    """``Coordinator(ex, proto)`` and ``add_protocol`` give the identical
    event sequence (one task in flight: completion order is fixed)."""
    def run(legacy):
        ex = pkg.fake_executor(seed=7, max_workers=2)
        proto = pkg.impress(seed=7, n_cycles=3, n_candidates=5)
        if legacy:
            coord = pkg.Coordinator(ex, proto, max_inflight=1)
        else:
            coord = pkg.Coordinator(ex)
            coord.add_protocol(proto, max_inflight=1)
        for i in range(3):
            coord.add_pipeline(new_pl(proto, f"P{i}"))
        rep = coord.run(timeout=60)
        ex.shutdown()
        return rep

    rep_legacy, rep_registry = run(True), run(False)
    strip = lambda evs: [(e["event"], e.get("pipeline"), e.get("cycle"))
                         for e in evs]
    assert strip(rep_legacy["events"]) == strip(rep_registry["events"])
    assert all("protocol" not in e for e in rep_legacy["events"])
    assert all("protocol" not in e for e in rep_registry["events"])


def test_custom_protocol_runs_through_unmodified_coordinator(pkg):
    ex = pkg.fake_executor()
    proto = pkg.take_first()
    coord = pkg.Coordinator(ex)
    coord.add_protocol(proto, name="take-first")
    coord.add_pipeline(new_pl(proto, "T0"))
    rep = coord.run(timeout=30)
    ex.shutdown()
    assert rep["trajectories"] == 1
    assert [e["event"] for e in rep["events"]] == ["completed"]
    assert rep["protocols"]["take-first"]["n_pipelines"] == 1


def test_multi_objective_pareto_rule(pkg):
    dominates = pkg.mo.dominates
    assert dominates([2, 2, 2], [1, 2, 2])
    assert not dominates([1, 2, 2], [2, 2, 2])
    assert not dominates([2, 1, 1], [1, 2, 2])   # trade-off: no dominance
    p = pkg.mo.MultiObjectiveProtocol(pkg.mo.MultiObjectiveConfig(
        n_candidates=3, n_cycles=4, max_declines=1))
    pl = new_pl(p)
    seqs = np.tile(np.arange(24, dtype=np.int32), (3, 1))
    p.handlers["generate"](pl, (seqs, -np.arange(3, dtype=np.float32)))
    d = p.handlers["predict"](pl, {"plddt": 80.0, "ptm": 0.8, "pae": 8.0})
    assert d.events[0]["event"] == "accepted" and pl.cycle == 1
    p.handlers["generate"](pl, (seqs, -np.arange(3, dtype=np.float32)))
    d = p.handlers["predict"](pl, {"plddt": 70.0, "ptm": 0.7, "pae": 10.0})
    assert d.events[0]["event"] == "reselect"
    d = p.handlers["predict"](pl, {"plddt": 90.0, "ptm": 0.5, "pae": 9.0})
    assert d.events[0]["event"] == "accepted" and len(pl.meta["front"]) == 2
    assert d.accepted_design is pl.history[-1]


def test_session_validates_protocol_kinds_and_handlers(pkg):
    with pytest.raises(ValueError, match="unknown protocol kind"):
        pkg.ImpressSession(pkg.CampaignSpec(protocols=("no-such-kind",),
                                            receptor_len=12))

    base = type(pkg.take_first())

    class Unroutable(base):
        def __init__(self):
            super().__init__()
            self.handlers = dict(self.handlers,
                                 fold_and_dock=lambda pl, r: pkg.Decision())

    pkg.session.register_protocol("unroutable-demo",
                                  lambda ps, cs: (Unroutable(), None))
    with pytest.raises(ValueError, match="fold_and_dock"):
        pkg.ImpressSession(pkg.CampaignSpec(protocols=("unroutable-demo",),
                                            receptor_len=12),
                           **pkg.session_kw())


# ---------------------------------------------------------------------------
# the three-protocol session (both packages)
# ---------------------------------------------------------------------------

THREE = dict(structures=1, receptor_len=12, max_workers=4, seed=3)


def three_protocols(ps, max_sub_pipelines):
    return (ps("im-rp", n_candidates=3, n_cycles=2,
               max_sub_pipelines=max_sub_pipelines),
            ps("cont-v", n_candidates=3, n_cycles=2),
            ps("multi-objective", n_candidates=3, n_cycles=2))


def ported_payload():
    """The reference's reduced fp32 payload and a ``NoisedPayload`` on its
    weights in every namespace."""
    ref, port = payloads("float32")
    noised = NoisedPayload(gen_cfg=port.gen_cfg, fold_cfg=port.fold_cfg,
                           device="cpu", reduced=True)
    bridge.payload_namespaces_from_ref(ref, noised)
    return ref, noised


def test_session_runs_three_protocols_concurrently(pkg):
    """test_session.py's acceptance run (an im-rp with one sub-pipeline, a
    cont-v control and the multi-objective demo on one executor), on the
    package's own reduced payload."""
    ref, noised = ported_payload()
    spec = pkg.CampaignSpec(protocols=three_protocols(pkg.ProtocolSpec, 1),
                            **THREE)
    with pkg.ImpressSession(spec, payload=ref if pkg.name == "repro"
                            else noised, **pkg.session_kw()) as sess:
        report = sess.run(timeout=240)
    assert isinstance(report, pkg.session.CampaignReport)
    assert report.schema_version == 1
    assert set(report.protocols) == {"im-rp", "cont-v", "multi-objective"}
    for name, p in report.protocols.items():
        assert p["n_pipelines"] == 1, name
        assert p["trajectories"] >= 2, name
        assert p["cycles"], name
    assert report.executor["n_failed"] == 0
    tags = {e.get("protocol") for e in report.events}
    assert {"im-rp", "cont-v", "multi-objective"} <= tags
    assert report.protocols["cont-v"]["n_sub_pipelines"] == 0
    assert report["n_pipelines"] == report.n_pipelines


def run_three(pkg, payload, uid0):
    """The parity session: no sub-pipeline, uid counters from ``uid0``.
    Returns (report, tasks by kind, events by pipeline, accepted designs,
    checkpoint)."""
    spec = pkg.CampaignSpec(protocols=three_protocols(pkg.ProtocolSpec, 0),
                            **THREE)
    with pkg.ImpressSession(spec, payload=payload,
                            **pkg.session_kw()) as sess:
        pkg.pipeline._uid = itertools.count(uid0)
        rep = sess.run(timeout=240)
        kinds = collections.Counter(
            t.kind for t in sess.executor._tasks.values()
            if t.state == pkg.pipeline.TaskState.DONE)
        state = sess.checkpoint()
        accepted = {pl.name: [(h["cycle"], h["sequence"], h["fitness"])
                              for h in pl.history]
                    for pl in sess.coordinator.pipelines.values()}
    events = collections.defaultdict(list)
    for e in rep.events:
        events[e.get("pipeline")].append(
            (e.get("protocol"), e["event"], e.get("cycle")))
    return rep, kinds, dict(events), accepted, state


@pytest.fixture(scope="module")
def three_runs():
    ref, noised = ported_payload()
    uid0 = 2_000_000
    return (run_three(Pkg("repro"), ref, uid0),
            run_three(Pkg("repro_torch"), noised, uid0), noised)


def assert_same_designs(got, want):
    assert set(got) == set(want) and any(want.values())
    for name, rows in want.items():
        assert [r[:2] for r in got[name]] == [r[:2] for r in rows], name
        np.testing.assert_allclose([r[2] for r in got[name]],
                                   [r[2] for r in rows], atol=1e-5)


def test_three_protocol_session_matches_reference(three_runs):
    """im-rp, cont-v and multi-objective concurrently on one executor, in
    both packages on the same weights and draws: the same events, tasks by
    kind and accepted designs."""
    (w_rep, w_kinds, w_events, w_acc, _), (g_rep, g_kinds, g_events,
                                          g_acc, _), _ = three_runs
    assert g_rep.executor["n_failed"] == w_rep.executor["n_failed"] == 0
    assert g_kinds == w_kinds and set(g_kinds) == {"generate", "predict"}
    assert g_events == w_events
    assert set(g_rep.protocols) == {"im-rp", "cont-v", "multi-objective"}
    for name, p in w_rep.protocols.items():
        for key in ("n_pipelines", "n_sub_pipelines", "trajectories"):
            assert g_rep.protocols[name][key] == p[key], (name, key)
    assert g_rep.trajectories == w_rep.trajectories
    assert_same_designs(g_acc, w_acc)
    assert g_rep["compile"]["persistent_cache_dir"] is None


def _restored(state, payload, pkg=None):
    pkg = pkg or Pkg("repro_torch")
    return pkg.ImpressSession.from_checkpoint(
        json.loads(json.dumps(state)), payload=payload, **pkg.session_kw())


@pytest.mark.parametrize("origin", ["repro_torch", "repro"])
def test_checkpoint_restores_into_port_session(three_runs, origin):
    """A checkpoint of the port's session, and one of the reference's
    (schema 1 in both), survives JSON and rebuilds the same pipelines,
    protocol state and accepted designs in a port session; its run adds no
    trajectory (every pipeline had completed)."""
    want, got, noised = three_runs
    rep, _, _, accepted, state = want if origin == "repro" else got
    assert state["schema_version"] == 1
    assert set(state["coordinator"]["protocols"]) == {
        "im-rp", "cont-v", "multi-objective"}
    sess = _restored(state, noised)
    try:
        names = sorted(p.name for p in sess.coordinator.pipelines.values())
        assert names == sorted(r["name"]
                               for r in state["coordinator"]["pipelines"])
        for name, proto in sess.protocols.items():
            assert proto.state_dict() == \
                state["coordinator"]["protocols"][name]
        rep2 = sess.run(timeout=60)
        assert rep2.trajectories == rep.trajectories
        assert {pl.name: [(h["cycle"], h["sequence"], h["fitness"])
                          for h in pl.history]
                for pl in sess.coordinator.pipelines.values()} == accepted
    finally:
        sess.shutdown()


# ---------------------------------------------------------------------------
# what the port refuses, before any thread starts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,error,match", [
    ({"protocols": ("no-such-kind",)}, ValueError, "unknown protocol kind"),
    ({"compilation_cache_dir": "xla-cache"}, ValueError, "no counterpart"),
])
def test_port_refuses_before_threads_or_weights(kw, error, match):
    from repro_torch.session import CampaignSpec, ImpressSession
    before = threading.active_count()
    with pytest.raises(error, match=match):
        ImpressSession(CampaignSpec(receptor_len=12, **kw))
    assert threading.active_count() == before


def test_session_runs_on_cuda_by_default_and_raises_without_it(
        monkeypatch):
    """No ``devices``: every CUDA device. Without CUDA that raises; nothing
    falls back to the CPU."""
    from repro_torch.session import CampaignSpec, ImpressSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        ImpressSession(CampaignSpec(receptor_len=12))
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# serve --campaign
# ---------------------------------------------------------------------------

SERVE = [sys.executable, "-m", "repro_torch.launch.serve", "--campaign"]


def _serve(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(SERVE + args, cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)


def test_serve_campaign_runs_on_the_cpu_and_prints_a_report(tmp_path):
    out = _serve(["im-rp,cont-v", "--device", "cpu", "--structures", "1",
                  "--cycles", "1", "--candidates", "3", "--receptor-len",
                  "12"], tmp_path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[serve] campaign schema v1 on cpu: ")
    assert any(ln.startswith("[serve]   im-rp: 1 pipelines") for ln in lines)
    assert any(ln.startswith("[serve]   cont-v: 1 pipelines (+0 subs)")
               for ln in lines)


def test_serve_campaign_evolution_runs_the_trainer(tmp_path):
    """``--evolution`` runs the campaign with its trainer wired: the report
    shows evolution enabled and at least one finetune submitted."""
    out = _serve(["im-rp", "--device", "cpu", "--evolution", "--structures",
                  "1", "--cycles", "2", "--candidates", "3",
                  "--receptor-len", "12"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "NotImplementedError" not in out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[serve] campaign schema v1 on cpu: ")
    evo = [ln for ln in lines if ln.startswith("[serve]   evolution: ")]
    assert len(evo) == 1, out.stdout
    m = re.match(r"\[serve\]   evolution: enabled True, (\d+) finetunes "
                 r"submitted, (\d+) completed, generator version (\d+)$",
                 evo[0])
    assert m and int(m[1]) >= 1, evo[0]
