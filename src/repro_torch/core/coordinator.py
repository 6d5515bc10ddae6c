"""The IMPRESS pipelines coordinator (paper Fig. 1, boxes 1/3/6/7).

Maintains the global perspective over every pipeline's results, drains the
completion channel, applies each protocol's adaptive decisions, and submits
new tasks / sub-pipelines through the submission channel.

Multi-protocol campaigns: the coordinator is protocol-agnostic. Protocols
register through ``add_protocol`` (each with its own inflight cap —
``None`` = unbounded for IM-RP, ``1`` = strictly sequential for the CONT-V
control), pipelines carry a protocol binding, and completions are routed
through the owning protocol's **typed handler registry**
(``DesignProtocol.handlers[kind] -> Decision``) — there is no task-kind
dispatch in this file, so IM-RP, CONT-V, and any third protocol run
concurrently on one executor/allocator and new protocols plug in without
editing the coordinator. The legacy single-protocol constructor
``Coordinator(executor, protocol, max_inflight=...)`` is kept as a shim.

Sub-pipelines proposed by a protocol (``Decision.spawn``) are materialized
by that protocol (``spawn_pipeline``) only when idle resources exist
("offloading the newly created pipelines ... to the idle resources when
possible"), otherwise they are parked and retried on the next completion.

Batched completions: ``predict_batch`` and ``generate_batch`` tasks complete
with their pipeline's row slice of a (possibly cross-pipeline fused) device
batch; bucket occupancy — and, for masked length-bucketed dispatches, token
fill (``len_occupancy``) — is tracked per dispatch leader and reported
alongside the allocator's row-proportional shape stats.

Model evolution (paper §V): with a ``TrainerService`` attached, every
design a protocol declares accepted (``Decision.accepted_design``) is fed
to the replay buffer, the trainer is ticked each loop iteration (it submits
preemptible ``finetune`` tasks only when the middleware is idle), and
trainer-task completions are routed back to the service — they never touch
pipeline/inflight accounting, so a disabled or absent trainer leaves the
design run byte-identical. ``report`` surfaces design quality grouped by
generator version plus trainer utilization.

The coordinator state (trajectory pool, per-pipeline history, per-protocol
state) is JSON-serializable via ``state_dict`` for checkpoint/restart;
protocols own their pipelines' (de)serialization.

A copy of the JAX package's ``repro.core.coordinator`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.core.api import Decision, DesignProtocol
from repro_torch.core.pipeline import Pipeline, Task, TaskState
from repro_torch.runtime.executor import AsyncExecutor


class ProtocolCrash(RuntimeError):
    """A protocol handler raised while routing a completion, with crash
    isolation on (``Coordinator.crash_isolation``, set by long-lived
    multiplexers like the gateway). Carries the binding name so the
    supervisor can fail/restart just that campaign; without isolation the
    original exception propagates unchanged (standalone scripts keep
    their tracebacks)."""

    def __init__(self, binding: str, cause: BaseException):
        super().__init__(f"protocol handler crashed "
                         f"(binding {binding!r}): {cause!r}")
        self.binding = binding
        self.cause = cause


class _ProtocolBinding:
    """One registered protocol: its inflight budget, submission buffer, and
    parked sub-pipeline proposals."""

    def __init__(self, protocol: DesignProtocol, name: str,
                 max_inflight: Optional[int],
                 decorate: Optional[Callable[[Task], None]] = None):
        self.protocol = protocol
        self.name = name
        self.max_inflight = max_inflight   # None = unbounded (IM-RP)
        self.inflight = 0
        self.ready: List[Task] = []        # submission channel buffer
        self.parked: List[dict] = []       # spawn proposals awaiting devices
        self.decorate = decorate           # per-task stamp applied just
        #   before submission — the gateway installs one per campaign to
        #   set task.tenant and shift task.band into the tenant's stride
        self.paused = False                # paused: ready tasks stay
        #   buffered (nothing new submits); inflight work runs to completion


class Coordinator:
    def __init__(self, executor: AsyncExecutor,
                 protocol: Optional[DesignProtocol] = None,
                 *, max_inflight: Optional[int] = None, trainer=None):
        self.executor = executor
        self.trainer = trainer               # learn.TrainerService or None
        self.pipelines: Dict[int, Pipeline] = {}
        self._bindings: List[_ProtocolBinding] = []
        self._by_name: Dict[str, _ProtocolBinding] = {}
        self._task_pipeline: Dict[int, int] = {}
        self._task_binding: Dict[int, _ProtocolBinding] = {}
        self._pipeline_binding: Dict[int, _ProtocolBinding] = {}
        self._inflight = 0                   # total across bindings
        self.events: List[dict] = []
        self._done_task_uids: set = set()
        self._occupancy: List[float] = []   # predict_batch bucket occupancy
        self._gen_occupancy: List[float] = []  # generate_batch occupancy
        # token fill of masked length-bucketed dispatches (real tokens /
        # padded tokens), per kind; legacy exact-length dispatches are 1.0
        self._len_occupancy: List[float] = []
        self._gen_len_occupancy: List[float] = []
        if protocol is not None:  # legacy single-protocol shim
            self.add_protocol(protocol, max_inflight=max_inflight)

    # -- protocol registry -------------------------------------------------

    def add_protocol(self, protocol: DesignProtocol, *,
                     name: Optional[str] = None,
                     max_inflight: Optional[int] = None,
                     decorate: Optional[Callable[[Task], None]] = None
                     ) -> str:
        """Register a protocol for routing. ``max_inflight`` bounds this
        protocol's concurrently-submitted tasks (None = unbounded); each
        protocol gets its own budget, so a sequential control and an
        asynchronous campaign coexist on one executor. ``decorate`` (if
        given) is called on every task of this binding just before it is
        submitted — the gateway's tenant stamp."""
        name = name or f"protocol{len(self._bindings)}"
        if name in self._by_name:
            raise ValueError(f"protocol name {name!r} already registered")
        b = _ProtocolBinding(protocol, name, max_inflight, decorate)
        self._bindings.append(b)
        self._by_name[name] = b
        return name

    def pause_protocol(self, name: str):
        """Stop submitting this binding's tasks: ready tasks stay buffered
        and completions stop producing submissions (the handler still runs,
        so pipeline state keeps advancing to a checkpointable boundary);
        inflight device work runs to completion."""
        self._by_name[name].paused = True

    def resume_protocol(self, name: str):
        b = self._by_name[name]
        b.paused = False
        self._pump()
        self._drain_parked()

    def cancel_protocol(self, name: str):
        """Deactivate a binding's campaign: its pipelines stop advancing
        (inflight completions are dropped by ``_handle``), its buffered and
        parked work is discarded. The binding stays registered so late
        completions still route/decrement correctly."""
        b = self._by_name[name]
        for pl in self._binding_pipelines(b):
            pl.active = False
        b.ready = []
        b.parked = []

    def evict_pipelines(self, name: str):
        """Drop the named binding's pipelines from the registry. The
        gateway's restart path calls this between ``cancel_protocol`` and
        a checkpoint restore: the restored pipelines replace the canceled
        ones, and stale twins left behind would double-count history in
        every later report."""
        b = self._by_name[name]
        for pl in self._binding_pipelines(b):
            self.pipelines.pop(pl.uid, None)
            self._pipeline_binding.pop(pl.uid, None)

    def remove_protocol(self, name: str) -> bool:
        """Unregister an idle binding and drop its pipelines (gateway
        campaign GC). Refuses — returns False — while tasks are inflight,
        because late completions must still route and decrement through
        the binding; call again once the work drains. Unknown names
        return True (already gone), so retried sweeps converge."""
        b = self._by_name.get(name)
        if b is None:
            return True
        if b.inflight:
            return False
        self.cancel_protocol(name)
        self.evict_pipelines(name)
        self._bindings.remove(b)
        del self._by_name[name]
        return True

    @property
    def protocol(self) -> Optional[DesignProtocol]:
        """The default (first-registered) protocol — legacy accessor."""
        return self._bindings[0].protocol if self._bindings else None

    @property
    def max_inflight(self) -> Optional[int]:
        return self._bindings[0].max_inflight if self._bindings else None

    def _binding_of(self, protocol: Union[None, str, DesignProtocol]
                    ) -> _ProtocolBinding:
        if protocol is None:
            if not self._bindings:
                raise ValueError("no protocol registered; call add_protocol "
                                 "or pass one to the constructor")
            return self._bindings[0]
        if isinstance(protocol, str):
            return self._by_name[protocol]
        for b in self._bindings:
            if b.protocol is protocol:
                return b
        raise ValueError(
            "protocol object is not registered with this coordinator; "
            "call add_protocol first (a silent auto-register would bypass "
            "the registered binding's max_inflight cap)")

    # long-lived multiplexers (the gateway) set this so events are tagged
    # with their binding even while only one binding is registered yet —
    # campaign-sliced event streams must not depend on arrival order
    always_tag_events = False

    # crash isolation (the gateway's supervisor): when set, a protocol
    # handler exception surfaces as ProtocolCrash(binding) so the drive
    # loop can fail/restart that one campaign; off (the default), the
    # original exception propagates to the standalone caller unchanged
    crash_isolation = False

    def _event_tag(self, binding: Optional[_ProtocolBinding]) -> dict:
        """Events carry the protocol name only in multi-protocol campaigns
        (or when ``always_tag_events`` is set), so single-protocol event
        streams stay identical to the seed."""
        if binding is None or (len(self._bindings) <= 1
                               and not self.always_tag_events):
            return {}
        return {"protocol": binding.name}

    # -- submission channel ------------------------------------------------

    def add_pipeline(self, pl: Pipeline, first_task: Optional[Task] = None,
                     protocol: Union[None, str, DesignProtocol] = None):
        b = self._binding_of(protocol)
        self.pipelines[pl.uid] = pl
        self._pipeline_binding[pl.uid] = b
        task = first_task or b.protocol.first_task(pl)
        self._enqueue(b, task)

    def _enqueue(self, binding: _ProtocolBinding, task: Task):
        binding.ready.append(task)
        self._pump()

    def _pump(self):
        for b in self._bindings:
            while b.ready and not b.paused \
                    and (b.max_inflight is None
                         or b.inflight < b.max_inflight):
                task = b.ready.pop(0)
                self._task_pipeline[task.uid] = task.pipeline_id
                self._task_binding[task.uid] = b
                b.inflight += 1
                self._inflight += 1
                if b.decorate is not None:
                    b.decorate(task)   # tenant stamp / band shift
                self.executor.submit(task)
                if task.trace is not None:
                    # span tracing on: tag the record with the protocol
                    # binding that routed the task, so the Perfetto export
                    # can draw per-protocol tracks (multi-tenant
                    # attribution of coalesced rows)
                    task.trace["protocol"] = b.name
                    if task.tenant is not None:
                        task.trace["tenant"] = task.tenant

    # -- sub-pipelines -------------------------------------------------------

    def _try_spawn(self, binding: _ProtocolBinding, spawn: Optional[dict]):
        if spawn is None:
            return
        binding.parked.append(spawn)
        self._drain_parked()

    def _drain_parked(self):
        for b in self._bindings:
            still = []
            for spawn in b.parked:
                if not b.protocol.can_spawn():
                    continue  # cap reached while parked: drop the proposal
                if self.executor.allocator.n_free > 0:
                    sub = b.protocol.spawn_pipeline(spawn)
                    if sub is None:
                        continue
                    self.events.append(dict(
                        {"t": time.monotonic(), "event": "spawn",
                         "pipeline": sub.name,
                         "gen_version": sub.meta.get("gen_version", 0)},
                        **self._event_tag(b)))
                    self.add_pipeline(sub, protocol=b.protocol)
                else:
                    still.append(spawn)
            b.parked = still

    # -- completion channel ---------------------------------------------------

    def _record_occupancy(self, task: Task):
        """Per-dispatch bucket occupancy, counted once per completed task
        that led a device batch (fused members report leader=False) — even
        when the completion won't advance its pipeline (speculative-winner
        dedup, inactive pipeline), the dispatch still physically ran."""
        if task.state != TaskState.DONE or not isinstance(task.result, dict):
            return
        b = task.result.get("batch")
        if not b or not b.get("leader", True):
            return
        if task.kind == "generate_batch":
            self._gen_occupancy.append(float(b["occupancy"]))
            if "len_occupancy" in b:
                self._gen_len_occupancy.append(float(b["len_occupancy"]))
        elif task.kind == "predict_batch":
            self._occupancy.append(float(b["occupancy"]))
            if "len_occupancy" in b:
                self._len_occupancy.append(float(b["len_occupancy"]))

    def _handle(self, task: Task):
        self._record_occupancy(task)
        pl = self.pipelines.get(self._task_pipeline.get(task.uid, -1))
        if pl is None and task.pipeline_id is not None:
            # executor-created replacement (a device-loss clone carries a
            # fresh uid the coordinator never enqueued): route it by the
            # pipeline id it inherited, so the completion still advances
            # its pipeline instead of being dropped (which wedged the
            # campaign: an active pipeline with nothing inflight)
            pl = self.pipelines.get(task.pipeline_id)
        if task.speculative_of is not None:
            # speculative duplicate: only count if the original hasn't won
            if task.speculative_of in self._done_task_uids \
                    or task.state != TaskState.DONE:
                return
            # the duplicate won: the original (cancel is cooperative) will
            # still surface later as DONE — mark it handled now so the
            # pipeline doesn't double-advance
            self._done_task_uids.add(task.speculative_of)
            orig_pl = self.pipelines.get(task.pipeline_id)
            pl = orig_pl if orig_pl is not None else pl
        if task.uid in self._done_task_uids:
            # already handled via a winning speculative duplicate — even a
            # late FAILED/CANCELED original must not touch the pipeline
            return
        binding = self._task_binding.get(task.uid)
        if binding is None and pl is not None:
            binding = self._pipeline_binding.get(pl.uid)
        if binding is None and self._bindings:
            binding = self._bindings[0]
        if task.state in (TaskState.FAILED, TaskState.CANCELED):
            self.events.append(dict(
                {"t": time.monotonic(), "event": task.state.value,
                 "task": task.kind, "error": task.error},
                **self._event_tag(binding)))
            if pl is not None and task.state == TaskState.FAILED \
                    and (not task.canceled
                         or getattr(task, "_deadline_exceeded", False)):
                # graceful degradation: a genuine failure deactivates just
                # this pipeline (the campaign's other trajectories keep
                # going). A canceled victim surfacing as FAILED (its
                # payload noticed the device-loss cancel and raised) does
                # NOT — its executor-made clone is still inflight and will
                # advance the pipeline; deadline kills do (the run hung)
                pl.active = False
            return
        self._done_task_uids.add(task.uid)
        if pl is None or not pl.active or binding is None:
            return
        handler = binding.protocol.handlers.get(task.kind)
        if handler is None:
            self.events.append(dict(
                {"t": time.monotonic(), "event": "unroutable",
                 "task": task.kind, "pipeline": pl.name},
                **self._event_tag(binding)))
            return
        try:
            decision = handler(pl, task.result)
        except Exception as e:  # noqa: BLE001 — protocol code is untrusted
            if not self.crash_isolation:
                raise
            raise ProtocolCrash(binding.name, e) from e
        if not isinstance(decision, Decision):   # bare task-list shorthand
            decision = Decision(tasks=list(decision))
        for ev in decision.events:
            self.events.append(dict(
                {"t": time.monotonic(), "event": ev["event"],
                 "pipeline": pl.name, "cycle": ev["cycle"],
                 "gen_version": pl.meta.get("gen_version", 0)},
                **self._event_tag(binding)))
        for t in decision.tasks:
            t.pipeline_id = pl.uid
            self._enqueue(binding, t)
        # designs the protocol declares accepted are the §V training data
        if self.trainer is not None and decision.accepted_design is not None:
            self.trainer.add_design(decision.accepted_design)
        self._try_spawn(binding, decision.spawn)

    # -- main loop --------------------------------------------------------------

    def step(self, drain_timeout: float = 0.05) -> bool:
        """One iteration of the coordinator loop: tick the trainer, drain at
        most one completion, route it, pump submissions. Returns ``False``
        when the campaign pool is quiescent (no active pipeline, nothing
        inflight or buffered, trainer idle) — ``run`` stops there; a
        long-lived caller (the gateway's drive thread) keeps stepping, since
        new campaigns may register at any time."""
        if self.trainer is not None:
            self.trainer.tick()   # opportunistic model evolution
        active = any(p.active for p in self.pipelines.values())
        if not active and self._inflight == 0 \
                and not any(b.ready for b in self._bindings) \
                and (self.trainer is None or not self.trainer.busy()):
            return False
        task = self.executor.drain(timeout=drain_timeout)
        if task is None:
            if self._inflight == 0:
                self._pump()
            return True
        if self.trainer is not None and self.trainer.owns(task.uid):
            # trainer-task completion: routed to the service, never
            # counted against pipeline inflight
            self.trainer.on_complete(task)
            return True
        if task.speculative_of is None:
            b = self._task_binding.get(task.uid)
            if b is not None:
                b.inflight -= 1
                self._inflight -= 1
            # else: an executor-created replacement (device-loss clone)
            # the coordinator never enqueued — its original's CANCELED
            # completion owns the inflight decrement, so decrementing here
            # too would double-count and leave _inflight negative forever
        self._handle(task)
        self._pump()
        self._drain_parked()
        return True

    def run(self, timeout: float = 600.0) -> dict:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if not self.step():
                break
        return self.report(makespan=time.monotonic() - t0)

    # -- reporting ------------------------------------------------------------

    @staticmethod
    def _quality_by_version(pls: List[Pipeline]) -> Dict[int, dict]:
        """Accepted-design quality grouped by the generator version that
        produced each design — the paper's 'increased consistency in the
        quality of protein design' measured directly against evolution."""
        by_v: Dict[int, List[float]] = {}
        for p in pls:
            for h in p.history:
                by_v.setdefault(int(h.get("gen_version", 0)), []).append(
                    float(h["fitness"]))
        return {v: {"n": len(fs),
                    "fitness_median": float(np.median(fs)),
                    "fitness_mean": float(np.mean(fs)),
                    "fitness_std": float(np.std(fs))}
                for v, fs in sorted(by_v.items())}

    @staticmethod
    def _cycle_stats(pls: List[Pipeline]) -> Dict[int, dict]:
        per_cycle: Dict[int, List[dict]] = {}
        for p in pls:
            for h in p.history:
                per_cycle.setdefault(h["cycle"], []).append(h)
        cycles = {}
        for c, hs in sorted(per_cycle.items()):
            cycles[c] = {
                "fitness_median": float(np.median([h["fitness"] for h in hs])),
                "plddt_median": float(np.median([h["plddt"] for h in hs])),
                "ptm_median": float(np.median([h["ptm"] for h in hs])),
                "pae_median": float(np.median([h["pae"] for h in hs])),
                "plddt_std": float(np.std([h["plddt"] for h in hs])),
                "ptm_std": float(np.std([h["ptm"] for h in hs])),
                "pae_std": float(np.std([h["pae"] for h in hs])),
                "n": len(hs),
            }
        return cycles

    @staticmethod
    def _pool_summary(pls: List[Pipeline]) -> dict:
        top = [p for p in pls if not p.is_sub_pipeline]
        subs = [p for p in pls if p.is_sub_pipeline]
        return {
            "n_pipelines": len(top),
            "n_sub_pipelines": len(subs),
            "trajectories": sum(p.meta.get("trajectories", 0) for p in pls),
        }

    def _binding_pipelines(self, binding: _ProtocolBinding) -> List[Pipeline]:
        return [p for p in self.pipelines.values()
                if self._pipeline_binding.get(p.uid, self._bindings[0])
                is binding]

    def protocol_pipelines(self, name: str) -> List[Pipeline]:
        """Pipelines owned by the named binding — the gateway reads these
        to build per-campaign reports on the shared coordinator."""
        return self._binding_pipelines(self._by_name[name])

    def protocol_idle(self, name: str) -> bool:
        """True when the named binding has nothing left to do: no active
        pipeline, no inflight task, nothing buffered or parked — the
        gateway's per-campaign completion signal (the global loop keeps
        running for its co-tenants)."""
        b = self._by_name[name]
        return (b.inflight == 0 and not b.ready and not b.parked
                and not any(p.active for p in self._binding_pipelines(b)))

    def binding_name_of(self, task: Task) -> Optional[str]:
        b = self._task_binding.get(task.uid)
        return b.name if b is not None else None

    def _resilience_report(self) -> dict:
        """``report()["resilience"]``: the executor's retry / breaker /
        quarantine evidence, with dead-letter pipeline ids resolved to
        pipeline names (the executor only knows uids)."""
        if not hasattr(self.executor, "resilience_summary"):
            return {}
        res = self.executor.resilience_summary()
        for rec in res.get("deadletter", []):
            pl = self.pipelines.get(rec.get("pipeline_id"))
            if pl is not None:
                rec["pipeline"] = pl.name
        return res

    def report(self, makespan: float) -> dict:
        pls = list(self.pipelines.values())
        per_protocol = {}
        if self._bindings:
            for b in self._bindings:
                bpls = self._binding_pipelines(b)
                per_protocol[b.name] = dict(
                    self._pool_summary(bpls),
                    cycles=self._cycle_stats(bpls),
                    quality_by_version=self._quality_by_version(bpls))
        return dict(self._pool_summary(pls), **{
            "makespan_s": makespan,
            "utilization": self.executor.allocator.utilization(),
            "executor": self.executor.stats(),
            "batch_occupancy": (float(np.mean(self._occupancy))
                                if self._occupancy else None),
            "n_score_batches": len(self._occupancy),
            "gen_batch_occupancy": (float(np.mean(self._gen_occupancy))
                                    if self._gen_occupancy else None),
            "n_generate_batches": len(self._gen_occupancy),
            "len_occupancy": (float(np.mean(self._len_occupancy))
                              if self._len_occupancy else None),
            "gen_len_occupancy": (float(np.mean(self._gen_len_occupancy))
                                  if self._gen_len_occupancy else None),
            "allocator_shapes": self.executor.allocator.shape_stats(),
            # per-stage sections (dispatch/wait/grant/utilization/bands)
            # for staged campaigns; {} when nothing carried a stage label
            "stages": (self.executor.stage_report()
                       if hasattr(self.executor, "stage_report") else {}),
            "quality_by_version": self._quality_by_version(pls),
            # per-kind queue-wait/device-time quantiles, task counters, and
            # span tallies from the unified telemetry layer (obs/)
            "telemetry": (self.executor.telemetry_summary()
                          if hasattr(self.executor, "telemetry_summary")
                          else {}),
            # retry taxonomy / breaker / dead-letter quarantine evidence
            # (repro_torch.resilience); {} for executors without the substrate
            "resilience": self._resilience_report(),
            "evolution": (None if self.trainer is None else
                          self.trainer.report(
                              makespan=makespan,
                              total_devices=self.executor
                              .allocator.total_devices)),
            "cycles": self._cycle_stats(pls),
            "protocols": per_protocol,
            "events": self.events,
        })

    # -- checkpoint/restart -----------------------------------------------------

    def state_dict(self, names: Optional[List[str]] = None) -> dict:
        """Versioned, JSON-serializable campaign state. Pipelines serialize
        through their owning protocol (``DesignProtocol.pipeline_state``)
        and carry the protocol binding name; protocol-level state (e.g.
        spawn counters) is stored per binding. ``names`` restricts the
        checkpoint to those bindings — the gateway checkpoints one
        campaign's bindings without snapshotting its co-tenants."""
        bindings = (self._bindings if names is None
                    else [self._by_name[n] for n in names])
        recs = []
        for b in bindings:
            for p in self._binding_pipelines(b):
                recs.append(dict(b.protocol.pipeline_state(p),
                                 protocol=b.name))
        return {
            "version": 2,
            "protocols": {b.name: b.protocol.state_dict()
                          for b in bindings},
            "pipelines": recs,
        }

    def load_state_dict(self, state: dict):
        if "version" not in state:   # legacy (pre-v2) single-protocol form
            self._binding_of(None).protocol.load_state_dict(
                {"n_sub_spawned": state["n_sub_spawned"]})
            records = [(self._bindings[0], rec)
                       for rec in state["pipelines"]]
        else:
            for name, ps in state["protocols"].items():
                self._lookup(name).protocol.load_state_dict(ps)
            records = [(self._lookup(rec.get("protocol")), rec)
                       for rec in state["pipelines"]]
        for b, rec in records:
            pl = b.protocol.restore_pipeline(rec)
            self.pipelines[pl.uid] = pl
            self._pipeline_binding[pl.uid] = b
            if pl.active:
                self._enqueue(b, b.protocol.first_task(pl))

    def _lookup(self, name: Optional[str]) -> _ProtocolBinding:
        """Binding by checkpoint name, falling back to the default binding
        when the restoring coordinator registered under a different name
        (single-protocol restores stay permissive)."""
        if name in self._by_name:
            return self._by_name[name]
        if len(self._bindings) == 1:
            return self._bindings[0]
        raise KeyError(f"checkpoint references protocol {name!r} but no "
                       f"binding with that name is registered")
