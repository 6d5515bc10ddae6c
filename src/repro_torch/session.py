"""Declarative campaign facade: one spec in, one versioned report out.

``ImpressSession`` builds a campaign from a single declarative
``CampaignSpec``:

    from repro_torch.session import CampaignSpec, ImpressSession, ProtocolSpec

    spec = CampaignSpec(structures=4, receptor_len=24,
                        protocols=(ProtocolSpec("im-rp", n_cycles=3),
                                   ProtocolSpec("cont-v", n_cycles=3)),
                        evolution=True)
    with ImpressSession(spec) as session:     # every CUDA device
        report = session.run()                # -> CampaignReport (schema v1)

The session wires the middleware (allocator, executor, payload registry,
optional trainer, multi-protocol coordinator), registers every protocol
with the coordinator (IM-RP and CONT-V — the paper's comparison — run
*concurrently on one executor/allocator*, so cross-protocol task
coalescing applies under mixed load), validates each protocol's typed
handler registry against the executor's registered payload fns, owns
shutdown, and exposes checkpoint()/restore() for the whole campaign.

Protocol kinds are pluggable: ``register_protocol`` maps a kind name to a
factory, so new ``DesignProtocol`` implementations (see ``core/api.py``)
become spec-addressable without touching this file's built-ins ("im-rp",
"cont-v", "multi-objective", "binder", "rescore").

A port of the JAX package's ``repro.session``. The spec and the
checkpoint keep its schema 1, so a checkpoint from either package loads
in the other. Where the reference reaches JAX:

* ``devices=None`` means every CUDA device (``torch.device("cuda", i)``);
  a process without CUDA raises. Tests pass ``devices=[torch.device(
  "cpu")]`` and a CPU payload.
* The seeded payload is ``ProteinPayload(seed=spec.seed, reduced=...,
  device=devices[0])``.
* ``compilation_cache_dir`` (XLA's persistent cache) has no counterpart:
  the field stays so that spec dicts round-trip, a set value raises
  ``ValueError``, and the report's ``persistent_cache_dir`` is None.
* ``evolution=True`` wires model evolution as the reference does:
  ``FinetunePayload`` registered for the ``finetune`` kind, a
  ``ReplayBuffer`` and a ``TrainerService`` handed to the coordinator.

The compilation-cache knob is validated with the protocol kinds, before
any thread starts or any weight is drawn.
"""

from __future__ import annotations

import os
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.api import DesignProtocol
from repro_torch.core.coordinator import Coordinator
from repro_torch.core.multi_objective import (MultiObjectiveConfig,
                                              MultiObjectiveProtocol)
from repro_torch.core.payload import FinetunePayload, ProteinPayload
from repro_torch.core.protocol import ImpressProtocol, ProtocolConfig
from repro_torch.core.stages import (BinderConfig, RescoreConfig,
                                     RescoreProtocol, StagedBinderProtocol,
                                     StageSpec)
from repro_torch.data.synthetic import protein_design_tasks
from repro_torch.learn import EvolutionConfig, ReplayBuffer, TrainerService
from repro_torch.obs import (CompileWatcher, Telemetry, Tracer,
                             write_metrics, write_trace)
from repro_torch.runtime.allocator import (DeviceAllocator,
                                           choose_length_buckets)
from repro_torch.runtime.executor import AsyncExecutor

SCHEMA_VERSION = 1   # CampaignReport / checkpoint schema


@dataclass(frozen=True)
class ProtocolSpec:
    """One protocol entry of a campaign. ``kind`` selects a registered
    factory ("im-rp", "cont-v", "multi-objective", "binder", "rescore", or
    anything added via ``register_protocol``); the remaining fields
    parameterize it. ``seed`` of None inherits the campaign seed, so an
    IM-RP/CONT-V pair in one spec starts from identical sampling
    streams."""
    kind: str = "im-rp"
    name: Optional[str] = None        # binding name; defaults to kind
    n_candidates: int = 6
    n_cycles: int = 3
    max_reselections: int = 10
    max_sub_pipelines: int = 4
    score_batch: int = 0
    generate_batch_size: int = 0
    decode_kernel: bool = False       # paged KV continuous decode
    decode_slots: int = 0             # slots per paged engine (0: default)
    gen_devices: int = 1
    predict_devices: int = 1
    temperature: float = 1.0
    seed: Optional[int] = None
    stage_max_rows: Optional[int] = None   # staged protocols: per-dispatch
    #   row cap for the protocol's stage rules (device-memory bound)


@dataclass(frozen=True)
class CampaignSpec:
    """Everything a campaign needs, declaratively: the starting structures,
    the protocol mix, batching switches, and the device budget.

    ``receptor_len`` may be a tuple — one length per starting structure,
    cycled — which is the paper's realistic mixed-length campaign. A mixed
    campaign derives dense length-bucket edges from its own length
    histogram (``campaign_length_buckets``) and switches the batched task
    factories to the masked payload forms so different-length pipelines
    still fuse into dense device batches; a single int keeps the
    exact-length paths."""
    structures: int = 2
    receptor_len: Union[int, Tuple[int, ...]] = 24
    peptide_len: int = 6
    protocols: Tuple = (ProtocolSpec(),)   # ProtocolSpec entries or kind strs
    # -- heterogeneous stages (staged protocols, e.g. kind="binder") --
    stages: Tuple = ()   # StageSpec entries or dicts; () = the staged
    #   protocol's default table (core.stages.default_binder_stages). The
    #   session wires the union of all protocols' stage tables into the
    #   payload registry (param namespaces + per-stage coalesce rules)
    #   and, when fair_scheduling is on, the queue's band shares
    fair_scheduling: bool = True   # push the stage tables' priority-band
    #   shares into the TaskQueue (weighted-fair pick); False keeps plain
    #   FIFO even for staged campaigns
    # -- length bucketing (mixed-length campaigns) --
    length_buckets: Optional[Tuple[int, ...]] = None   # explicit edges;
    #   None = derive from the campaign's length histogram when mixed
    length_bucket_max_pad: float = 0.125   # max per-row padding fraction
    #   accepted when deriving bucket edges
    # -- model evolution (§V) --
    evolution: bool = False
    finetune_every: int = 2
    finetune_steps: int = 12
    finetune_lr: float = 1e-3
    finetune_batch: int = 8
    min_designs: int = 2
    replay_capacity: int = 128
    trainer_max_devices: int = 4
    # -- runtime --
    device_budget: Optional[int] = None    # first N devices; None = all
    max_workers: int = 4
    max_retries: int = 1
    straggler_factor: Optional[float] = None
    # retry taxonomy overrides (repro_torch.resilience.RetryPolicy kwargs);
    # None keeps the default derived from max_retries
    resilience: Optional[dict] = None
    coalesce: bool = True                  # register the coalesce rules
    reduced: bool = True                   # reduced-scale payload models
    seed: int = 0
    timeout: float = 600.0
    # XLA's persistent compilation cache in the reference; no counterpart
    # here (kernels build once into build/kernels/). Must stay None.
    compilation_cache_dir: Optional[str] = None
    # Span tracing + Perfetto export: when set (or via $IMPRESS_TRACE_DIR),
    # the session enables the obs.Tracer and run() writes trace.json and
    # metrics.json there. None/empty: tracing off.
    trace_dir: Optional[str] = None


# -- length bucketing -------------------------------------------------------


def _receptor_lens(spec: CampaignSpec) -> List[int]:
    rl = spec.receptor_len
    if isinstance(rl, (tuple, list)):
        return [int(v) for v in rl]
    return [int(rl)]


def campaign_length_buckets(spec: CampaignSpec
                            ) -> Optional[Tuple[int, ...]]:
    """Token-dim bucket edges for a campaign: the explicit
    ``spec.length_buckets`` override, or edges chosen densely from the
    campaign's own length histogram (receptor lengths + complex widths)
    when receptor lengths are mixed. None for a homogeneous campaign —
    which keeps every task on the exact-length path."""
    if spec.length_buckets:
        return tuple(int(b) for b in spec.length_buckets)
    lens = _receptor_lens(spec)
    if len(set(lens)) <= 1:
        return None
    hist = lens + [ln + int(spec.peptide_len) for ln in lens]
    return choose_length_buckets(hist, max_pad=spec.length_bucket_max_pad)


# -- protocol-kind registry (pluggable) ------------------------------------

ProtocolFactory = Callable[[ProtocolSpec, CampaignSpec],
                           Tuple[DesignProtocol, Optional[int]]]
_FACTORIES: Dict[str, ProtocolFactory] = {}


def register_protocol(kind: str, factory: ProtocolFactory):
    """Make ``kind`` spec-addressable. ``factory(protocol_spec, campaign
    _spec) -> (protocol, max_inflight)`` — max_inflight None = unbounded."""
    _FACTORIES[kind] = factory


def _impress_cfg(ps: ProtocolSpec, cs: CampaignSpec, *, adaptive: bool
                 ) -> ProtocolConfig:
    return ProtocolConfig(
        n_candidates=ps.n_candidates, n_cycles=ps.n_cycles,
        adaptive=adaptive,
        max_reselections=ps.max_reselections,
        max_sub_pipelines=ps.max_sub_pipelines if adaptive else 0,
        score_batch=ps.score_batch,
        generate_batch_size=ps.generate_batch_size,
        decode_kernel=ps.decode_kernel, decode_slots=ps.decode_slots,
        gen_devices=ps.gen_devices, predict_devices=ps.predict_devices,
        temperature=ps.temperature,
        length_buckets=campaign_length_buckets(cs),
        seed=cs.seed if ps.seed is None else ps.seed)


register_protocol("im-rp", lambda ps, cs: (
    ImpressProtocol(_impress_cfg(ps, cs, adaptive=True)), None))
# the sequential control: strictly one task in flight, no adaptivity
register_protocol("cont-v", lambda ps, cs: (
    ImpressProtocol(_impress_cfg(ps, cs, adaptive=False)), 1))
register_protocol("multi-objective", lambda ps, cs: (
    MultiObjectiveProtocol(MultiObjectiveConfig(
        n_candidates=ps.n_candidates, n_cycles=ps.n_cycles,
        max_declines=ps.max_reselections,
        gen_devices=ps.gen_devices, predict_devices=ps.predict_devices,
        temperature=ps.temperature,
        seed=cs.seed if ps.seed is None else ps.seed)), None))


def campaign_stages(spec: CampaignSpec) -> Tuple[StageSpec, ...]:
    """Normalize ``CampaignSpec.stages`` (StageSpec entries or dicts) into
    a StageSpec tuple. Empty means 'use the protocol's default table'."""
    return tuple(s if isinstance(s, StageSpec) else StageSpec(**s)
                 for s in spec.stages)


# the three-stage binder protocol: backbone-sample -> sequence-design ->
# fold/score, each stage with its own param namespace and priority band
register_protocol("binder", lambda ps, cs: (
    StagedBinderProtocol(BinderConfig(
        n_candidates=ps.n_candidates, n_cycles=ps.n_cycles,
        max_reselections=ps.max_reselections,
        score_batch=max(1, ps.score_batch),
        temperature=ps.temperature,
        length_buckets=campaign_length_buckets(cs),
        stages=campaign_stages(cs),
        seed=cs.seed if ps.seed is None else ps.seed)), None))
# the fold-flood co-tenant: n_cycles rounds of score_batch-row batched
# rescoring per pipeline on the fold stage
register_protocol("rescore", lambda ps, cs: (
    RescoreProtocol(RescoreConfig(
        n_rounds=ps.n_cycles, rows=max(1, ps.score_batch),
        length_buckets=campaign_length_buckets(cs),
        max_rows=ps.stage_max_rows,
        seed=cs.seed if ps.seed is None else ps.seed)), None))


def _normalize_protocols(spec: CampaignSpec) -> List[ProtocolSpec]:
    out = []
    for p in spec.protocols:
        if isinstance(p, str):
            p = ProtocolSpec(kind=p)
        elif isinstance(p, dict):
            p = ProtocolSpec(**p)
        out.append(p)
    return out


def _validate(spec: CampaignSpec, protocol_specs: List[ProtocolSpec]):
    """Refuse what the port cannot run, before threads or weights."""
    unknown = [ps.kind for ps in protocol_specs if ps.kind not in _FACTORIES]
    if unknown:
        raise ValueError(
            f"unknown protocol kind(s) {unknown}; registered: "
            f"{sorted(_FACTORIES)} (add via register_protocol)")
    if spec.compilation_cache_dir:
        raise ValueError(
            f"compilation_cache_dir={spec.compilation_cache_dir!r}: XLA's "
            f"persistent compilation cache has no counterpart in the port "
            f"(its kernels build once into build/kernels/); leave it None")


def _cuda_devices() -> list:
    """Every CUDA device of this process; raises without CUDA."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


# -- the report -------------------------------------------------------------

@dataclass
class CampaignReport:
    """Stable, versioned campaign result. ``protocols`` holds one
    per-protocol section (pipelines, trajectories, cycles, quality);
    campaign-wide aggregates mirror the coordinator report. ``raw`` keeps
    the full coordinator report; ``report[key]`` reads from it."""
    schema_version: int
    makespan_s: float
    utilization: float
    n_pipelines: int
    n_sub_pipelines: int
    trajectories: int
    protocols: Dict[str, dict]
    cycles: Dict[int, dict]
    quality_by_version: Dict[int, dict]
    executor: dict
    evolution: Optional[dict]
    events: List[dict]
    raw: dict = field(repr=False, default_factory=dict)

    @classmethod
    def from_raw(cls, raw: dict) -> "CampaignReport":
        return cls(
            schema_version=SCHEMA_VERSION,
            makespan_s=raw["makespan_s"], utilization=raw["utilization"],
            n_pipelines=raw["n_pipelines"],
            n_sub_pipelines=raw["n_sub_pipelines"],
            trajectories=raw["trajectories"], protocols=raw["protocols"],
            cycles=raw["cycles"],
            quality_by_version=raw["quality_by_version"],
            executor=raw["executor"], evolution=raw["evolution"],
            events=raw["events"], raw=raw)

    def __getitem__(self, key):
        return self.raw[key]

    def to_dict(self) -> dict:
        return dict(self.raw, schema_version=self.schema_version)


# -- the facade -------------------------------------------------------------

class ImpressSession:
    """Build and run a design campaign from one ``CampaignSpec``.

    Wiring (allocator, executor, payload registry, optional trainer,
    multi-protocol coordinator) happens in the constructor; pipelines for
    the starting structures are created lazily on the first ``run()``. The
    session is a context manager — leaving the block shuts the executor
    down.
    ``payload``/``devices`` injection is for benchmarks and tests that
    share a payload or run on the CPU. ``fault_plan`` passes through to the
    executor."""

    def __init__(self, spec: CampaignSpec, *, payload=None, devices=None,
                 fault_plan=None):
        self.spec = spec
        self.fault_plan = fault_plan
        self.protocol_specs = _normalize_protocols(spec)
        # validate the spec before paying for threads or weights
        _validate(spec, self.protocol_specs)
        devs = [resolve_device(d) for d in
                (devices if devices is not None else _cuda_devices())]
        if spec.device_budget:
            devs = devs[:spec.device_budget]
        # one telemetry bundle for the whole campaign: allocator grants,
        # queue depths, and task spans share one registry and one clock.
        # The tracer is enabled only when a trace dir is configured.
        self.trace_dir = (spec.trace_dir
                          or os.environ.get("IMPRESS_TRACE_DIR") or None)
        self.telemetry = Telemetry(
            tracer=Tracer(enabled=bool(self.trace_dir)))
        self.allocator = DeviceAllocator(devs, telemetry=self.telemetry)
        retry_policy = None
        if spec.resilience is not None:
            from repro_torch.resilience.policy import RetryPolicy
            policy_kwargs = dict(spec.resilience)
            policy_kwargs.setdefault("max_transient_retries",
                                     spec.max_retries)
            retry_policy = RetryPolicy(**policy_kwargs)
        self.executor = AsyncExecutor(
            self.allocator, max_workers=spec.max_workers,
            max_retries=spec.max_retries,
            straggler_factor=spec.straggler_factor,
            telemetry=self.telemetry,
            retry_policy=retry_policy, fault_plan=fault_plan)
        self._shutdown = False
        try:
            self._build(spec, payload, devs)
        except Exception:
            # never leak worker/watchdog threads from a failed constructor
            self.shutdown()
            raise

    def _build(self, spec: CampaignSpec, payload, devs):
        t0 = time.monotonic()
        from repro_torch.core import payload as payload_mod
        # per-key first-call watermarks: long-lived processes only
        # attribute first calls made after this session was built
        self._compile_log_start = {k: len(v) for k, v
                                   in payload_mod.compile_log.items()}
        self.length_buckets = campaign_length_buckets(spec)
        self.payload = payload if payload is not None else ProteinPayload(
            seed=spec.seed, reduced=spec.reduced, device=devs[0])
        gbs = max((ps.generate_batch_size for ps in self.protocol_specs),
                  default=0)
        self.payload.register_all(self.executor,
                                  generate_batch_rows=gbs or None,
                                  coalesce=spec.coalesce,
                                  length_buckets=self.length_buckets,
                                  decode_kernel=any(
                                      ps.decode_kernel
                                      for ps in self.protocol_specs))
        self.bootstrap_s = time.monotonic() - t0   # payload + registry setup
        self.buffer = None
        self.trainer = None
        if spec.evolution:
            FinetunePayload(self.payload, lr=spec.finetune_lr,
                            steps=spec.finetune_steps,
                            ).register(self.executor)
            self.buffer = ReplayBuffer(capacity=spec.replay_capacity)
            self.trainer = TrainerService(
                self.executor, self.buffer, self.payload.param_store,
                EvolutionConfig(finetune_every=spec.finetune_every,
                                min_designs=spec.min_designs,
                                batch_size=spec.finetune_batch,
                                steps=spec.finetune_steps,
                                max_devices=spec.trainer_max_devices,
                                seed=spec.seed))
        self.coordinator = Coordinator(self.executor, trainer=self.trainer)
        self.protocols: Dict[str, DesignProtocol] = {}
        registered = self.executor.registered_kinds()
        for ps in self.protocol_specs:
            proto, max_inflight = _FACTORIES[ps.kind](ps, spec)
            missing = [k for k in proto.task_kinds() if k not in registered]
            if missing:
                raise ValueError(
                    f"protocol {ps.kind!r} routes task kinds {missing} "
                    f"with no registered payload fn")
            name = ps.name or ps.kind
            self.coordinator.add_protocol(proto, name=name,
                                          max_inflight=max_inflight)
            self.protocols[name] = proto
        self._wire_stages(spec)
        self._populated = False

    def _wire_stages(self, spec: CampaignSpec):
        """Heterogeneous-stage wiring: the union of every protocol's stage
        table gets (1) its param-set namespaces + per-stage coalesce rules
        registered on the payload/executor and (2) its priority-band
        shares pushed into the task queue (unless ``fair_scheduling`` is
        off — the FIFO baseline). Unstaged campaigns: no-op."""
        self.stage_table = [s for proto in self.protocols.values()
                            for s in proto.stage_specs()]
        if not self.stage_table:
            return
        self.payload.register_stages(self.executor, self.stage_table,
                                     coalesce=spec.coalesce)
        if spec.fair_scheduling:
            shares: Dict[int, float] = {}
            for s in self.stage_table:
                shares[s.band] = max(shares.get(s.band, 0.0),
                                     float(s.share))
            self.executor.queue.set_band_shares(shares)

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "ImpressSession":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def shutdown(self):
        if not self._shutdown:
            self.executor.shutdown()
            self._shutdown = True

    # -- pipelines ---------------------------------------------------------

    def _populate(self):
        """One pipeline per (protocol, starting structure). Every protocol
        sees the same structures, so a multi-protocol campaign is a
        controlled comparison; names are prefixed with the binding name
        only when the campaign runs more than one protocol."""
        structures = protein_design_tasks(
            self.spec.structures, receptor_len=self.spec.receptor_len,
            peptide_len=self.spec.peptide_len, seed=self.spec.seed)
        multi = len(self.protocols) > 1
        for name, proto in self.protocols.items():
            for t in structures:
                pl_name = f"{name}/{t['name']}" if multi else t["name"]
                pl = proto.new_pipeline(pl_name, t["backbone"], t["target"],
                                        t["receptor_len"],
                                        t["peptide_tokens"])
                self.coordinator.add_pipeline(pl, protocol=name)
        self._populated = True

    # -- run ---------------------------------------------------------------

    def run(self, timeout: Optional[float] = None) -> CampaignReport:
        if not self.protocols:
            raise ValueError("CampaignSpec.protocols is empty")
        if not self._populated:
            self._populate()
        self._run_t0 = time.monotonic()
        from repro_torch.core import payload as payload_mod
        with CompileWatcher(self.telemetry.metrics) as watcher:
            raw = self.coordinator.run(
                timeout=self.spec.timeout if timeout is None else timeout)
            watcher.absorb_compile_log(payload_mod.compile_log,
                                       self._compile_log_start)
        raw["compile"] = {
            "persistent_cache_dir": None,
            "mean_exec_setup_s": raw["executor"]["mean_exec_setup_s"],
            "length_buckets": (list(self.length_buckets)
                               if self.length_buckets else None),
        }
        if self.trace_dir:
            raw["telemetry"] = dict(
                raw.get("telemetry", {}),
                trace_path=write_trace(
                    self.telemetry.tracer,
                    os.path.join(self.trace_dir, "trace.json")),
                metrics_path=write_metrics(
                    self.telemetry.metrics,
                    os.path.join(self.trace_dir, "metrics.json")))
        return CampaignReport.from_raw(raw)

    def metrics_snapshot(self) -> dict:
        """Live flat snapshot of the campaign's metrics registry — safe to
        call from another thread mid-run (serve's live metrics view)."""
        return self.telemetry.metrics.snapshot()

    def partial_report(self) -> CampaignReport:
        """Report over the campaign's *current* state, without requiring
        ``run()`` to have finished — the Ctrl-C path in ``launch/serve``
        emits this (plus a checkpoint) so an interrupted campaign still
        yields the designs it accepted so far."""
        makespan = time.monotonic() - getattr(self, "_run_t0",
                                              time.monotonic())
        return CampaignReport.from_raw(self.coordinator.report(makespan))

    # -- checkpoint / restore ----------------------------------------------

    def checkpoint(self) -> dict:
        """JSON-serializable campaign snapshot: the spec, the coordinator's
        multi-protocol state (pipelines serialized by their owning
        protocol), and the generator-version watermark. Model weights
        themselves persist separately via ``checkpoint.manager`` /
        ``ParamStore.save``."""
        store = getattr(self.payload, "param_store", None)
        return {
            "schema_version": SCHEMA_VERSION,
            "spec": asdict(self.spec),
            "coordinator": self.coordinator.state_dict(),
            "gen_version": store.version if store is not None else 0,
        }

    def restore(self, state: dict):
        """Load a ``checkpoint()`` snapshot into this session: pipelines
        are rebuilt under their protocol bindings and active ones resume
        from their protocol's ``first_task``."""
        if state.get("schema_version", 1) > SCHEMA_VERSION:
            raise ValueError(
                f"checkpoint schema {state['schema_version']} is newer "
                f"than this session's ({SCHEMA_VERSION})")
        want = int(state.get("gen_version", 0))
        store = getattr(self.payload, "param_store", None)
        if store is not None and store.version < want:
            import warnings
            warnings.warn(
                f"checkpoint was taken at generator version {want} but "
                f"this session's ParamStore is at {store.version}; restore "
                f"the evolved params too (ParamStore.save/restore via "
                f"checkpoint.manager) or resumed provenance will be wrong",
                RuntimeWarning, stacklevel=2)
        self.coordinator.load_state_dict(state["coordinator"])
        self._populated = True

    @classmethod
    def from_checkpoint(cls, state: dict, **kwargs) -> "ImpressSession":
        """Rebuild a session from a ``checkpoint()`` snapshot (the spec is
        embedded) and restore its campaign state."""
        sd = dict(state["spec"])
        sd["protocols"] = tuple(ProtocolSpec(**p) if isinstance(p, dict)
                                else p for p in sd["protocols"])
        sess = cls(CampaignSpec(**sd), **kwargs)
        sess.restore(state)
        return sess
