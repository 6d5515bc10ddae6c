"""The campaign gateway service: one resident runtime, many campaigns.

Every entry point so far bound a campaign's lifecycle to a script's
process: build allocator/executor/payload, run, exit. ``GatewayService``
decouples them — it keeps ONE executor + allocator (+ optional trainer)
resident and multiplexes many tenants' campaigns as *protocol bindings*
on a single shared ``Coordinator``:

    tenant ──► campaign (CampaignSpec) ──► binding(s) ──► staged tasks
                                            │
                       one per protocol, named "<campaign>/<protocol>",
                       decorated so every task carries its tenant label
                       and its stage band shifted into the tenant's
                       fair-scheduling stride

Because campaigns share the executor, **cross-campaign coalescing needs
zero new executor code**: same-stage same-bucket tasks from different
tenants already satisfy the same coalesce key and fuse into one device
batch. The gateway's job is to make that sharing safe (per-tenant quotas,
fair-share bands), observable (tenant-sliced telemetry, per-campaign
reports), and durable (per-campaign checkpoints).

Length buckets on the canonical grid: gateway campaigns derive their
bucket tables by snapping lengths onto the global ``LENGTH_BUCKETS`` grid
(not the greedy per-campaign histogram fit). Two invariants follow:

  * co-tenant tasks padded to the same grid edge share a coalesce key —
    the cross-campaign fusion the two-tenant benchmark measures;
  * a *bucket-table refresh* (structures streamed into a running campaign
    with lengths outside the table) only ever ADDS edges: a new grid edge
    ``e`` covers lengths in ``(prev_edge, e]``, and any already-enrolled
    length in that range would have had ``e`` in the table from day one —
    so no in-flight pipeline's future task ever remaps, and the refresh
    cannot perturb in-flight results. Refreshes bump the campaign's
    ``bucket_table_version``; in-flight tasks keep the bucket their
    payloads were built with (bucketing is fixed at task creation).

Thread model: a single drive thread steps the shared coordinator; every
control operation (submit / pause / resume / cancel / stream / report /
checkpoint) takes the service lock, which the drive thread holds only for
one bounded ``Coordinator.step``. The coordinator itself is never touched
off-lock.

Resilience: the gateway is the long-lived deployment surface, so
it owns the crash-safety story. ``checkpoint_every_s`` auto-checkpoints
every RUNNING campaign on the drive thread; on-disk copies are
crc-enveloped ``campaign-<id>.json`` files with a ``.1`` previous-copy
rotation, verified on read with fallback. The drive loop runs with
``Coordinator.crash_isolation`` on: a protocol handler exception surfaces
as ``ProtocolCrash`` and the supervisor restarts just that campaign from
its last auto-checkpoint (up to ``max_restarts``) instead of killing the
drive thread for every tenant; with no checkpoint or budget left the
campaign lands in ``FAILED``. ``retention_s`` / ``retention_max`` bound
the terminal-campaign registry: evicted campaigns archive their final
report to ``report-<id>.json`` first, then release their pipelines,
binding, and event slices. ``health()`` backs the unauthenticated
``GET /healthz`` liveness probe.

A port of the JAX package's ``repro.gateway.service`` (free of JAX but for
two lines there), over the port's coordinator, executor, allocator and
payload. Where the reference reaches JAX:

* ``devices=None`` means every CUDA device (``torch.device("cuda", i)``),
  as in ``ImpressSession``; a process without CUDA raises. Tests pass
  ``devices=[torch.device("cpu")]`` (or distinct ``torch.device("cpu",
  i)``s) and a CPU payload.
* The seeded payload is ``ProteinPayload(seed=seed, reduced=reduced,
  device=devices[0])``. The reference's ``payload_length`` is not taken:
  its payload stores that length and never reads it.

Campaign checkpoints keep schema 1, so a gateway checkpoint of either
package loads in either package's ``ImpressSession``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import tempfile
import threading
import time
import zlib
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint.io import CheckpointCorruptError
from repro_torch.core.coordinator import Coordinator, ProtocolCrash
from repro_torch.core.payload import ProteinPayload
from repro_torch.data.synthetic import protein_design_tasks
from repro_torch.gateway.quotas import QuotaManager, TenantQuota, tenant_band
from repro_torch.obs import Telemetry, Tracer, write_metrics, write_trace
from repro_torch.resilience.faults import maybe_corrupt
from repro_torch.runtime.allocator import (LENGTH_BUCKETS, DeviceAllocator,
                                           bucket_len)
from repro_torch.runtime.executor import AsyncExecutor
from repro_torch.session import (SCHEMA_VERSION, CampaignSpec, _FACTORIES,
                                 _cuda_devices, _normalize_protocols,
                                 _receptor_lens)


class CampaignState(str, Enum):
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    COMPLETED = "COMPLETED"
    CANCELED = "CANCELED"
    FAILED = "FAILED"      # protocol crash with no restart budget left


class GatewayError(Exception):
    """Control-plane error with an HTTP-ish status code the server maps
    directly onto its JSON responses."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = int(status)


def _grid_buckets(lengths) -> tuple:
    """Bucket edges for ``lengths``, snapped onto the global grid (see the
    module docstring for why the grid, not the greedy histogram fit)."""
    return tuple(sorted({bucket_len(int(v), LENGTH_BUCKETS)
                         for v in lengths}))


def _campaign_lengths(spec: CampaignSpec) -> List[int]:
    lens = _receptor_lens(spec)
    return lens + [ln + int(spec.peptide_len) for ln in lens]


@dataclass
class _CampaignRecord:
    id: str
    tenant: str
    spec: CampaignSpec
    bindings: List[str]                  # "<id>/<protocol>" binding names
    protocols: Dict[str, Any]            # binding name -> protocol object
    state: CampaignState = CampaignState.RUNNING
    version: int = 0                     # incremental report version
    bucket_table: Optional[tuple] = None
    bucket_version: int = 0
    streams: int = 0                     # structure batches streamed in
    submitted_at: float = field(default_factory=time.time)
    _fingerprint: tuple = ()             # last content seen by report()
    restarts: int = 0                    # supervisor restarts consumed
    failure: Optional[str] = None        # last ProtocolCrash cause
    last_checkpoint: Optional[dict] = None   # newest auto-checkpoint
    last_checkpoint_t: float = 0.0
    finished_at: Optional[float] = None  # first seen in a terminal state
    archived: bool = False               # final report written to disk

    def short(self, binding: str) -> str:
        return binding.split("/", 1)[1]


class GatewayService:
    """A persistent multi-tenant design service over one shared runtime.

    ``quotas`` maps tenant name -> ``TenantQuota``; unknown tenants get
    the default (share 1.0, uncapped). ``devices=None`` takes every CUDA
    device. ``payload`` lets tests inject a shared reduced payload;
    otherwise one is built from ``seed`` / ``reduced`` on the first device.
    """

    def __init__(self, *, devices=None, max_workers: int = 8,
                 payload: Optional[ProteinPayload] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 reduced: bool = True, seed: int = 0,
                 aging_s: float = 60.0,
                 trace_dir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 retry_policy=None, fault_plan=None,
                 checkpoint_every_s: float = 0.0,
                 max_restarts: int = 1,
                 retention_s: Optional[float] = None,
                 retention_max: Optional[int] = None,
                 now_fn=None):
        devs = ([resolve_device(d) for d in devices]
                if devices is not None else _cuda_devices())
        self.trace_dir = trace_dir or os.environ.get(
            "IMPRESS_TRACE_DIR") or None
        self.checkpoint_dir = checkpoint_dir
        self.fault_plan = fault_plan
        self.checkpoint_every_s = float(checkpoint_every_s)
        self.max_restarts = int(max_restarts)
        self.retention_s = retention_s
        self.retention_max = retention_max
        clock = {"now_fn": now_fn} if now_fn is not None else {}
        self.telemetry = Telemetry(
            tracer=Tracer(enabled=bool(self.trace_dir), **clock), **clock)
        self.allocator = DeviceAllocator(devs, telemetry=self.telemetry)
        self.executor = AsyncExecutor(
            self.allocator, max_workers=max_workers, aging_s=aging_s,
            telemetry=self.telemetry,
            retry_policy=retry_policy, fault_plan=fault_plan,
            **({"now_fn": now_fn} if now_fn else {}))
        self.payload = payload if payload is not None else ProteinPayload(
            seed=seed, reduced=reduced, device=devs[0])
        # executor-wide rules keep the payload's global LENGTH_BUCKETS
        # table, so campaigns snapped onto the grid share coalesce keys
        self.payload.register_all(self.executor, coalesce=True)
        self.coordinator = Coordinator(self.executor)
        self.coordinator.always_tag_events = True
        # a protocol handler crash must not kill the drive thread for
        # every co-tenant: surface it as ProtocolCrash for the supervisor
        self.coordinator.crash_isolation = True
        self._started_at = time.time()
        self.quotas = QuotaManager(quotas)
        self.executor.set_allocation_policy(self.quotas)
        self._campaigns: Dict[str, _CampaignRecord] = {}
        self._tenant_idx: Dict[str, int] = {}
        self._ids = itertools.count()
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._draining = False

    # -- drive loop -------------------------------------------------------

    def start(self) -> "GatewayService":
        """Start the drive thread (idempotent). The service accepts
        campaigns before start(), but nothing executes until it runs."""
        if self._thread is None:
            self._thread = threading.Thread(target=self._drive, daemon=True)
            self._thread.start()
        return self

    def _drive(self):
        while not self._stop.is_set():
            with self._lock:
                try:
                    progressed = self.coordinator.step(drain_timeout=0.01)
                except ProtocolCrash as crash:
                    self._supervise(crash)
                    progressed = True
                self._refresh_states()
                self._auto_checkpoint()
                self._gc_campaigns()
            if not progressed:
                # quiescent: idle-wait off-lock so control ops never queue
                # behind a sleeping drive thread
                self._stop.wait(0.02)

    def _supervise(self, crash: ProtocolCrash):
        """A protocol handler crashed mid-route (lock held). Restart the
        owning campaign from its last auto-checkpoint when budget and a
        checkpoint exist; otherwise fail just that campaign. Either way
        the drive thread — and every co-tenant — keeps running."""
        cid = crash.binding.split("/", 1)[0]
        rec = self._campaigns.get(cid)
        self.telemetry.metrics.counter("gateway.protocol_crashes").inc()
        print(f"[gateway] {crash}", flush=True)
        if rec is None:
            return
        if rec.restarts >= self.max_restarts or rec.last_checkpoint is None:
            for b in rec.bindings:
                self.coordinator.cancel_protocol(b)
            rec.state = CampaignState.FAILED
            rec.failure = repr(crash.cause)
            self._push_band_shares()
            return
        rec.restarts += 1
        rec.failure = repr(crash.cause)
        self.telemetry.metrics.counter("gateway.campaign_restarts").inc()
        for b in rec.bindings:
            # discard the wedged in-memory state; the canceled pipelines
            # are evicted so their checkpoint restores don't double-count
            self.coordinator.cancel_protocol(b)
            self.coordinator.evict_pipelines(b)
        self._restore_campaign(rec, rec.last_checkpoint)
        rec.state = CampaignState.RUNNING
        print(f"[gateway] campaign {cid} restarted from auto-checkpoint "
              f"({rec.restarts}/{self.max_restarts})", flush=True)

    def _auto_checkpoint(self):
        """Periodic crash-safety snapshots of RUNNING campaigns (lock
        held, drive thread). The in-memory copy feeds the supervisor;
        with a ``checkpoint_dir`` it also lands on disk through the
        integrity-enveloped writer."""
        if not self.checkpoint_every_s:
            return
        now = time.time()
        for rec in self._campaigns.values():
            if rec.state is not CampaignState.RUNNING:
                continue
            if now - rec.last_checkpoint_t < self.checkpoint_every_s:
                continue
            rec.last_checkpoint = self.checkpoint_campaign(rec.id)
            rec.last_checkpoint_t = now
            self.telemetry.metrics.counter("gateway.auto_checkpoints").inc()
            if self.checkpoint_dir:
                self._write_campaign_checkpoint(rec)

    def _refresh_states(self):
        """Per-campaign completion detection (call with the lock held)."""
        now = time.time()
        for rec in self._campaigns.values():
            if rec.state is CampaignState.RUNNING and all(
                    self.coordinator.protocol_idle(b)
                    for b in rec.bindings):
                rec.state = CampaignState.COMPLETED
            if rec.state in (CampaignState.COMPLETED, CampaignState.CANCELED,
                             CampaignState.FAILED) \
                    and rec.finished_at is None:
                rec.finished_at = now

    # -- retention / GC ----------------------------------------------------

    def _gc_campaigns(self):
        """Bound the terminal-campaign registry (lock held). Without
        retention settings nothing is ever evicted."""
        if self.retention_s is None and self.retention_max is None:
            return
        now = time.time()
        terminal = [r for r in self._campaigns.values()
                    if r.finished_at is not None]
        expired = []
        if self.retention_s is not None:
            expired += [r for r in terminal
                        if now - r.finished_at >= self.retention_s]
        if self.retention_max is not None \
                and len(terminal) > self.retention_max:
            overflow = len(terminal) - self.retention_max
            for r in sorted(terminal, key=lambda r: r.finished_at)[:overflow]:
                if r not in expired:
                    expired.append(r)
        for rec in expired:
            self._evict(rec)

    def _evict(self, rec: _CampaignRecord) -> bool:
        """Archive then release one terminal campaign: final report to
        ``report-<id>.json`` (when a checkpoint_dir exists), pipelines,
        binding registrations, event slices, and on-disk checkpoint
        copies all dropped. Refuses while late completions are still
        inflight — the next GC pass retries."""
        if not rec.archived:
            if self.checkpoint_dir:
                os.makedirs(self.checkpoint_dir, exist_ok=True)
                path = os.path.join(self.checkpoint_dir,
                                    f"report-{rec.id}.json")
                with open(path, "w") as f:
                    json.dump(self.report(rec.id), f)
            rec.archived = True
        removed = [self.coordinator.remove_protocol(b)
                   for b in rec.bindings]
        if not all(removed):
            return False
        self.coordinator.events = [
            e for e in self.coordinator.events
            if not str(e.get("protocol", "")).startswith(rec.id + "/")]
        if self.checkpoint_dir:
            for suffix in ("", ".1"):
                try:
                    os.remove(self._campaign_path(rec.id) + suffix)
                except OSError:
                    pass
        del self._campaigns[rec.id]
        self.telemetry.metrics.counter("gateway.campaigns_evicted").inc()
        return True

    # -- tenants ----------------------------------------------------------

    def _tenant_base(self, tenant: str) -> int:
        if tenant not in self._tenant_idx:
            self._tenant_idx[tenant] = len(self._tenant_idx)
        return self._tenant_idx[tenant]

    def set_tenant_quota(self, tenant: str, quota: TenantQuota):
        with self._lock:
            self.quotas.set_quota(tenant, quota)
            self._push_band_shares()

    def _decorator(self, tenant: str, base_idx: int):
        def stamp(task):
            task.tenant = tenant
            task.band = tenant_band(base_idx, task.band)
        return stamp

    def _push_band_shares(self):
        """Rebuild the weighted-fair band table from every live campaign:
        band = tenant stride + stage band, share = tenant share x stage
        share. One tenant's fold flood then cannot starve a co-tenant's
        stages beyond the configured weights."""
        shares: Dict[int, float] = {}
        for rec in self._campaigns.values():
            if rec.state in (CampaignState.COMPLETED,
                             CampaignState.CANCELED):
                continue
            base = self._tenant_idx[rec.tenant]
            tshare = self.quotas.quota_for(rec.tenant).share
            for proto in rec.protocols.values():
                specs = proto.stage_specs()
                for s in specs:
                    b = tenant_band(base, s.band)
                    shares[b] = max(shares.get(b, 0.0), tshare * s.share)
                if not specs:   # unstaged protocols run on stage band 0
                    shares.setdefault(tenant_band(base, 0), tshare)
        self.executor.queue.set_band_shares(shares or None)

    # -- campaign registry ------------------------------------------------

    def _get(self, campaign_id: str,
             tenant: Optional[str] = None) -> _CampaignRecord:
        rec = self._campaigns.get(campaign_id)
        if rec is None or (tenant is not None and rec.tenant != tenant):
            # a foreign tenant's campaign is indistinguishable from a
            # missing one — no existence oracle across tenants
            raise GatewayError(404, f"no campaign {campaign_id!r}")
        return rec

    def _normalize_spec(self, spec) -> CampaignSpec:
        if isinstance(spec, dict):
            spec = dict(spec)
            spec.pop("schema_version", None)
            spec = CampaignSpec(**spec)
        protos = tuple(_normalize_protocols(spec))
        spec = dataclasses.replace(spec, protocols=protos)
        lens = _receptor_lens(spec)
        if spec.length_buckets:
            table = tuple(int(b) for b in spec.length_buckets)
        elif len(set(lens)) > 1:
            table = _grid_buckets(_campaign_lengths(spec))
        else:
            return spec          # homogeneous: the exact-length seed path
        return dataclasses.replace(spec, length_buckets=table)

    def submit_campaign(self, spec, *, tenant: str = "default",
                        state: Optional[dict] = None) -> str:
        """Register a campaign for ``tenant`` and start it. ``spec`` is a
        ``CampaignSpec`` or its dict form (the HTTP body). With ``state``
        (a campaign checkpoint), pipelines restore from it instead of
        being freshly populated — the resume path after a gateway
        restart. Returns the campaign id."""
        spec = self._normalize_spec(spec)
        unknown = [ps.kind for ps in spec.protocols
                   if ps.kind not in _FACTORIES]
        if unknown:
            raise GatewayError(400, f"unknown protocol kind(s) {unknown}")
        with self._lock:
            if self._draining:
                raise GatewayError(503, "gateway is draining")
            cid = f"c{next(self._ids):04d}"
            base = self._tenant_base(tenant)
            bindings: List[str] = []
            protocols: Dict[str, Any] = {}
            registered = self.executor.registered_kinds()
            for ps in spec.protocols:
                proto, max_inflight = _FACTORIES[ps.kind](ps, spec)
                missing = [k for k in proto.task_kinds()
                           if k not in registered]
                if missing:
                    raise GatewayError(
                        400, f"protocol {ps.kind!r} routes task kinds "
                        f"{missing} with no registered payload fn")
                bname = f"{cid}/{ps.name or ps.kind}"
                self.payload.register_stages(
                    self.executor, proto.stage_specs(),
                    coalesce=spec.coalesce)
                self.coordinator.add_protocol(
                    proto, name=bname, max_inflight=max_inflight,
                    decorate=self._decorator(tenant, base))
                bindings.append(bname)
                protocols[bname] = proto
            rec = _CampaignRecord(
                id=cid, tenant=tenant, spec=spec, bindings=bindings,
                protocols=protocols, bucket_table=spec.length_buckets)
            self._campaigns[cid] = rec
            self._push_band_shares()
            if state is not None:
                self._restore_campaign(rec, state)
            else:
                self._populate(rec, protein_design_tasks(
                    spec.structures, receptor_len=spec.receptor_len,
                    peptide_len=spec.peptide_len, seed=spec.seed))
            return cid

    def _populate(self, rec: _CampaignRecord, structures,
                  stream: Optional[int] = None):
        multi = len(rec.bindings) > 1
        for bname in rec.bindings:
            proto = rec.protocols[bname]
            short = rec.short(bname)
            for t in structures:
                name = f"{short}/{t['name']}" if multi else t["name"]
                if stream is not None:
                    name = f"s{stream}/{name}"
                pl = proto.new_pipeline(name, t["backbone"], t["target"],
                                        t["receptor_len"],
                                        t["peptide_tokens"])
                self.coordinator.add_pipeline(pl, protocol=bname)

    # -- lifecycle --------------------------------------------------------

    def pause_campaign(self, campaign_id: str,
                       tenant: Optional[str] = None):
        with self._lock:
            rec = self._get(campaign_id, tenant)
            if rec.state is not CampaignState.RUNNING:
                raise GatewayError(
                    409, f"cannot pause a {rec.state.value} campaign")
            for b in rec.bindings:
                self.coordinator.pause_protocol(b)
            rec.state = CampaignState.PAUSED

    def resume_campaign(self, campaign_id: str,
                        tenant: Optional[str] = None):
        with self._lock:
            rec = self._get(campaign_id, tenant)
            if rec.state is not CampaignState.PAUSED:
                raise GatewayError(
                    409, f"cannot resume a {rec.state.value} campaign")
            for b in rec.bindings:
                self.coordinator.resume_protocol(b)
            rec.state = CampaignState.RUNNING

    def cancel_campaign(self, campaign_id: str,
                        tenant: Optional[str] = None):
        with self._lock:
            rec = self._get(campaign_id, tenant)
            if rec.state in (CampaignState.COMPLETED,
                             CampaignState.CANCELED):
                return
            for b in rec.bindings:
                self.coordinator.cancel_protocol(b)
            rec.state = CampaignState.CANCELED
            self._push_band_shares()

    def list_campaigns(self, tenant: Optional[str] = None) -> List[dict]:
        with self._lock:
            return [{"id": r.id, "tenant": r.tenant,
                     "state": r.state.value, "version": r.version}
                    for r in self._campaigns.values()
                    if tenant is None or r.tenant == tenant]

    # -- structure streaming (+ bucket-table refresh) ---------------------

    def stream_structures(self, campaign_id: str, body: dict,
                          tenant: Optional[str] = None) -> dict:
        """Add structures to a live campaign. ``body`` is either the
        synthesize form ``{"structures": n, "receptor_len": ..,
        "seed": ..}`` or the explicit form ``{"items": [{name, backbone,
        target, receptor_len, peptide_tokens}, ...]}``. Lengths outside
        the campaign's bucket table trigger a versioned table extension
        for new tasks only (see the module docstring)."""
        with self._lock:
            rec = self._get(campaign_id, tenant)
            if rec.state not in (CampaignState.RUNNING,
                                 CampaignState.PAUSED):
                raise GatewayError(
                    409, f"cannot stream structures into a "
                    f"{rec.state.value} campaign")
            structures = self._coerce_structures(rec, body)
            refreshed = self._maybe_refresh_buckets(rec, structures)
            rec.streams += 1
            self._populate(rec, structures, stream=rec.streams)
            return {"added": len(structures) * len(rec.bindings),
                    "bucket_table_refreshed": refreshed,
                    "bucket_table_version": rec.bucket_version,
                    "bucket_table": (list(rec.bucket_table)
                                     if rec.bucket_table else None)}

    def _coerce_structures(self, rec: _CampaignRecord, body: dict) -> list:
        if "items" in body:
            items = []
            for i, it in enumerate(body["items"]):
                items.append({
                    "name": str(it.get("name", f"x{i:03d}")),
                    "backbone": np.asarray(it["backbone"], np.float32),
                    "target": np.asarray(it["target"], np.float32),
                    "receptor_len": int(it["receptor_len"]),
                    "peptide_tokens": np.asarray(
                        it.get("peptide_tokens",
                               np.arange(1, 1 + rec.spec.peptide_len)),
                        np.int32),
                })
            return items
        rl = body.get("receptor_len", rec.spec.receptor_len)
        if isinstance(rl, list):
            rl = tuple(int(v) for v in rl)
        return protein_design_tasks(
            int(body.get("structures", 1)), receptor_len=rl,
            peptide_len=rec.spec.peptide_len,
            seed=int(body.get("seed",
                              rec.spec.seed + 1000 + rec.streams)))

    def _maybe_refresh_buckets(self, rec: _CampaignRecord,
                               structures: list) -> bool:
        lens = [int(t["receptor_len"]) for t in structures]
        widths = [ln + int(np.asarray(t["peptide_tokens"]).shape[0])
                  for ln, t in zip(lens, structures)]
        if rec.bucket_table is None:
            known = set(_receptor_lens(rec.spec))
            novel = sorted(set(lens) - known)
            if novel:
                raise GatewayError(
                    409, f"campaign {rec.id} runs the exact-length path "
                    f"(homogeneous lengths {sorted(known)}); streaming "
                    f"novel lengths {novel} requires a campaign created "
                    f"with length_buckets (or mixed receptor_len)")
            return False
        needed = {bucket_len(v, LENGTH_BUCKETS) for v in lens + widths}
        missing = needed - set(rec.bucket_table)
        if not missing:
            return False
        new_table = tuple(sorted(set(rec.bucket_table) | missing))
        for proto in rec.protocols.values():
            cfg = getattr(proto, "cfg", None)
            if cfg is not None and getattr(cfg, "length_buckets", None):
                # frozen configs: rebind, never mutate — tasks already
                # built hold their payloads (and buckets) unchanged
                proto.cfg = dataclasses.replace(
                    cfg, length_buckets=new_table)
        rec.spec = dataclasses.replace(rec.spec,
                                       length_buckets=new_table)
        rec.bucket_table = new_table
        rec.bucket_version += 1
        return True

    # -- reporting --------------------------------------------------------

    def report(self, campaign_id: str,
               tenant: Optional[str] = None) -> dict:
        """Incremental versioned per-campaign report: ``version`` bumps
        whenever the campaign's observable content (state, accepted
        designs, bucket table) changed since the last read — pollers can
        skip unchanged bodies."""
        with self._lock:
            self._refresh_states()
            rec = self._get(campaign_id, tenant)
            pls = [p for b in rec.bindings
                   for p in self.coordinator.protocol_pipelines(b)]
            fp = (rec.state.value, sum(len(p.history) for p in pls),
                  rec.bucket_version)
            if fp != rec._fingerprint:
                rec.version += 1
                rec._fingerprint = fp
            per_protocol = {}
            for b in rec.bindings:
                bpls = self.coordinator.protocol_pipelines(b)
                per_protocol[rec.short(b)] = dict(
                    Coordinator._pool_summary(bpls),
                    cycles=Coordinator._cycle_stats(bpls),
                    quality_by_version=Coordinator.
                    _quality_by_version(bpls))
            per_pipeline = {p.name: {
                "protocol": rec.short(b), "active": bool(p.active),
                "history": [dict(h) for h in p.history]}
                for b in rec.bindings
                for p in self.coordinator.protocol_pipelines(b)
                if not p.is_sub_pipeline}
            tel = self.executor.telemetry_summary()
            events = [e for e in self.coordinator.events
                      if str(e.get("protocol", "")
                             ).startswith(rec.id + "/")]
            # crash-supervisor evidence rides along only when it exists,
            # so fault-free campaign reports keep the plain schema
            extra = {}
            if rec.restarts:
                extra["restarts"] = rec.restarts
            if rec.failure is not None:
                extra["failure"] = rec.failure
            res = self.coordinator._resilience_report()
            if res:
                extra["resilience"] = res
            return dict(
                Coordinator._pool_summary(pls),
                campaign=rec.id, tenant=rec.tenant,
                state=rec.state.value, version=rec.version, **extra,
                cycles=Coordinator._cycle_stats(pls),
                quality_by_version=Coordinator._quality_by_version(pls),
                protocols=per_protocol,
                pipelines=per_pipeline,
                bucket_table=(list(rec.bucket_table)
                              if rec.bucket_table else None),
                bucket_table_version=rec.bucket_version,
                telemetry={"tenant": tel.get("tenants", {}
                                             ).get(rec.tenant, {})},
                quota=self.quotas.stats().get(rec.tenant, {}),
                events=events)

    def metrics_snapshot(self) -> dict:
        """The GET /metrics body: the obs/ registry snapshot plus the
        gateway's cross-tenant views (coalesce evidence, quota
        accounting, per-tenant telemetry slices)."""
        with self._lock:
            return {
                "metrics": self.telemetry.metrics.snapshot(),
                "coalesce": self.executor.coalesce_stats(),
                "quotas": self.quotas.stats(),
                "tenants": self.executor.telemetry_summary().get(
                    "tenants", {}),
                "campaigns": {r.id: {"tenant": r.tenant,
                                     "state": r.state.value}
                              for r in self._campaigns.values()},
            }

    def coalesce_stats(self) -> dict:
        return self.executor.coalesce_stats()

    # -- checkpoint / shutdown --------------------------------------------

    def checkpoint_campaign(self, campaign_id: str,
                            tenant: Optional[str] = None) -> dict:
        """One campaign's checkpoint, in exactly the
        ``ImpressSession.checkpoint()`` schema (binding names
        de-prefixed), so a gateway checkpoint restores either through
        ``submit_campaign(..., state=...)`` on a fresh gateway or through
        ``ImpressSession.from_checkpoint`` standalone."""
        with self._lock:
            rec = self._get(campaign_id, tenant)
            scoped = self.coordinator.state_dict(names=rec.bindings)
            prefix = rec.id + "/"
            scoped["protocols"] = {
                n[len(prefix):]: st
                for n, st in scoped["protocols"].items()}
            for p in scoped["pipelines"]:
                p["protocol"] = p["protocol"][len(prefix):]
            store = getattr(self.payload, "param_store", None)
            return {
                "schema_version": SCHEMA_VERSION,
                "spec": dataclasses.asdict(rec.spec),
                "coordinator": scoped,
                "gen_version": store.version if store is not None else 0,
            }

    def _restore_campaign(self, rec: _CampaignRecord, state: dict):
        """Load a campaign checkpoint into this campaign's fresh bindings
        (lock held; called from submit_campaign)."""
        coord = dict(state["coordinator"])
        prefix = rec.id + "/"
        coord["protocols"] = {prefix + n: st
                              for n, st in coord["protocols"].items()}
        coord["pipelines"] = [dict(p, protocol=prefix + p["protocol"])
                              for p in coord["pipelines"]]
        self.coordinator.load_state_dict(coord)

    # -- durable on-disk campaign checkpoints ------------------------------

    def _campaign_path(self, cid: str) -> str:
        return os.path.join(self.checkpoint_dir, f"campaign-{cid}.json")

    def _write_campaign_checkpoint(self, rec: _CampaignRecord) -> str:
        """crc-enveloped atomic write of ``campaign-<id>.json`` with a
        ``.1`` previous-copy rotation: the last good file survives a
        corrupted write, and ``load_campaign_checkpoint`` falls back
        across the pair. The fault plan's corrupt_checkpoint seam runs on
        the fresh copy — the CI chaos path for exactly that fallback."""
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = self._campaign_path(rec.id)
        body = json.dumps(rec.last_checkpoint, sort_keys=True)
        envelope = {"crc32": zlib.crc32(body.encode()),
                    "tenant": rec.tenant, "body": body}
        if os.path.exists(path):
            os.replace(path, path + ".1")
        fd, tmp = tempfile.mkstemp(dir=self.checkpoint_dir)
        with os.fdopen(fd, "w") as f:
            json.dump(envelope, f)
        os.replace(tmp, path)
        maybe_corrupt(path, self.fault_plan)
        return path

    @staticmethod
    def _read_envelope(path: str) -> tuple:
        """(state, tenant) from one envelope file; raises
        CheckpointCorruptError on a crc mismatch."""
        with open(path) as f:
            env = json.load(f)
        if isinstance(env, dict) and "crc32" in env and "body" in env:
            if zlib.crc32(env["body"].encode()) != env["crc32"]:
                raise CheckpointCorruptError(
                    f"campaign checkpoint crc mismatch: {path}")
            return json.loads(env["body"]), env.get("tenant")
        return env, None   # legacy plain-JSON checkpoint: no evidence

    def load_campaign_checkpoint(self, cid: str) -> tuple:
        """Verified ``(state, tenant)`` read of ``campaign-<cid>.json``,
        falling back to the ``.1`` previous copy when the current one is
        corrupted or unreadable. Raises ``CheckpointCorruptError`` when
        every copy is bad, returns ``(None, None)`` when none exists."""
        path = self._campaign_path(cid)
        last_err = None
        for p in (path, path + ".1"):
            if not os.path.exists(p):
                continue
            try:
                return self._read_envelope(p)
            except (CheckpointCorruptError, ValueError) as e:
                last_err = e
                print(f"[gateway] campaign checkpoint {p} failed "
                      f"verification ({e}); trying previous copy",
                      flush=True)
        if last_err is not None:
            raise CheckpointCorruptError(
                f"no intact campaign checkpoint for {cid!r}") from last_err
        return None, None

    def restore_campaigns(self) -> Dict[str, str]:
        """Restart-recovery sweep: resubmit every ``campaign-*.json`` in
        ``checkpoint_dir`` under its recorded tenant. Corrupted current
        copies fall back to ``.1``; wholly-corrupt checkpoints are skipped
        with a note (one bad tenant must not block the rest). Returns
        old-id -> new-id for everything restored."""
        restored: Dict[str, str] = {}
        if not self.checkpoint_dir or not os.path.isdir(self.checkpoint_dir):
            return restored
        for fname in sorted(os.listdir(self.checkpoint_dir)):
            if not fname.startswith("campaign-") \
                    or not fname.endswith(".json"):
                continue
            old_id = fname[len("campaign-"):-len(".json")]
            try:
                state, tenant = self.load_campaign_checkpoint(old_id)
            except CheckpointCorruptError as e:
                print(f"[gateway] skipping {fname}: {e}", flush=True)
                continue
            if state is None:
                continue
            restored[old_id] = self.submit_campaign(
                state["spec"], tenant=tenant or "default", state=state)
        return restored

    def health(self) -> dict:
        """The unauthenticated ``GET /healthz`` body: liveness of the
        drive thread, campaign census by state, and device headroom —
        enough for a probe to distinguish 'serving', 'not started', and
        'drive thread died'."""
        with self._lock:
            self._refresh_states()
            by_state: Dict[str, int] = {}
            for r in self._campaigns.values():
                by_state[r.state.value] = by_state.get(r.state.value, 0) + 1
            alive = self._thread is not None and self._thread.is_alive()
            status = "ok" if alive else (
                "stopped" if self._stop.is_set() else "not_started")
            return {
                "status": status,
                "drive_thread_alive": alive,
                "draining": self._draining,
                "uptime_s": time.time() - self._started_at,
                "campaigns": by_state,
                "devices": {"total": self.allocator.total_devices,
                            "free": self.allocator.n_free},
            }

    def drain(self):
        """Stop accepting campaigns; existing ones run to completion."""
        with self._lock:
            self._draining = True

    def drained(self) -> bool:
        with self._lock:
            self._refresh_states()
            return all(r.state in (CampaignState.COMPLETED,
                                   CampaignState.CANCELED)
                       for r in self._campaigns.values())

    def shutdown(self, wait: bool = True) -> Dict[str, dict]:
        """Graceful shutdown: stop the drive loop, checkpoint every live
        campaign (written to ``checkpoint_dir`` as
        ``campaign-<id>.json`` when configured), flush the trace export,
        and release the executor. Returns the checkpoints by id."""
        self._stop.set()
        if self._thread is not None and wait:
            self._thread.join(timeout=5.0)
        checkpoints: Dict[str, dict] = {}
        with self._lock:
            for rec in self._campaigns.values():
                if rec.state in (CampaignState.RUNNING,
                                 CampaignState.PAUSED):
                    checkpoints[rec.id] = self.checkpoint_campaign(rec.id)
            if self.checkpoint_dir:
                for cid, ck in checkpoints.items():
                    rec = self._campaigns[cid]
                    rec.last_checkpoint = ck
                    self._write_campaign_checkpoint(rec)
            if self.trace_dir:
                os.makedirs(self.trace_dir, exist_ok=True)
                write_trace(self.telemetry.tracer,
                            os.path.join(self.trace_dir, "trace.json"))
                write_metrics(self.telemetry.metrics,
                              os.path.join(self.trace_dir,
                                           "metrics.json"))
        self.executor.shutdown(wait=wait)
        return checkpoints

    def __enter__(self) -> "GatewayService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
