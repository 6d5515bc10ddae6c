"""Pipeline / task state machines (the RP-style task model).

RADICAL-Pilot exposes *tasks* as the first-class unit; IMPRESS builds a
Pipeline abstraction on top (the paper implements a Pipeline class for the
same reason — RP has no workflow notion). States and their timestamps mirror
RP's state model so utilization accounting is directly comparable to the
paper's Fig. 4/5 (Bootstrap / Exec setup / Running decomposition).

A copy of the JAX package's ``repro.core.pipeline`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

import enum
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class TaskState(enum.Enum):
    NEW = "NEW"
    QUEUED = "QUEUED"            # waiting for resources
    SCHEDULED = "SCHEDULED"      # resources assigned, awaiting worker
    EXEC_SETUP = "EXEC_SETUP"    # compilation / payload staging
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELED = "CANCELED"

TERMINAL = (TaskState.DONE, TaskState.FAILED, TaskState.CANCELED)

_uid = itertools.count()


@dataclass
class ResourceRequest:
    n_devices: int = 1
    preferred_shape: Optional[tuple] = None  # e.g. (2, 2) sub-mesh
    rows: Optional[int] = None  # batch-row footprint: when set, n_devices
    #   is the floor and the allocator scales the grant with the bucketed
    #   row count of the dispatch (see DeviceAllocator.request_for_rows)


@dataclass
class Task:
    kind: str                      # registered payload function name
    payload: Dict[str, Any]
    resources: ResourceRequest = field(default_factory=ResourceRequest)
    priority: int = 0              # lower = more urgent
    pipeline_id: Optional[int] = None
    uid: int = field(default_factory=lambda: next(_uid))
    state: TaskState = TaskState.NEW
    timestamps: Dict[str, float] = field(default_factory=dict)
    result: Any = None
    error: Optional[str] = None
    retries: int = 0
    speculative_of: Optional[int] = None  # straggler-mitigation duplicate
    canceled: bool = False
    preemptible: bool = False   # trainer-class task: held back while design
    #   work queues (scheduler aging guard excepted) and asked to yield its
    #   sub-mesh when a design task cannot fit (executor preemption)
    stage: Optional[str] = None  # pipeline stage this task belongs to
    #   (staged protocols: "backbone" / "seqdesign" / "fold" ...). Part of
    #   the executor's coalescing compatibility key — same-stage tasks from
    #   different pipelines/protocols fuse, cross-stage tasks never do —
    #   and the allocator's grant accounting (per-stage shape/util stats)
    band: int = 0               # scheduler priority band: the TaskQueue's
    #   weighted-fair pick divides dispatches across bands by configured
    #   shares, so an expensive stage cannot starve a cheap one (or vice
    #   versa) beyond its share. Band 0 with no shares = plain FIFO
    preempt_requested: bool = False  # cooperative yield signal: the payload
    #   fn checks this between steps and returns early with resume state
    tenant: Optional[str] = None  # owning tenant (multi-tenant gateway):
    #   the coordinator's binding decorator stamps it, the executor slices
    #   queue-wait/device-time metrics by it, and quota policies charge the
    #   dispatch leader's tenant for the devices a grant holds. None (the
    #   single-tenant scripts) changes nothing anywhere
    not_before: float = 0.0     # retry backoff: the scheduler skips this
    #   task (without blocking tasks behind it) until the executor clock
    #   passes this stamp — retries wait out their backoff in the queue
    #   instead of busy-requeueing. 0.0 (the default) = always eligible
    trace: Optional[Dict[str, Any]] = None  # lifecycle trace record, owned
    #   by the executor's ``obs.Tracer`` when span tracing is on: event
    #   chain, fused-dispatch links, protocol binding — see obs/trace.py.
    #   None (tracing off) costs nothing anywhere

    def set_state(self, state: TaskState, now: Optional[float] = None):
        """Transition and stamp. ``now`` lets clock-owning callers (the
        executor's injectable ``now_fn``) keep task timestamps on the same
        timebase as queue fairness and span traces — and makes wait/run
        timing tests deterministic under a fake clock."""
        self.state = state
        self.timestamps[state.value] = (time.monotonic() if now is None
                                        else now)

    def duration(self) -> Optional[float]:
        a = self.timestamps.get("RUNNING")
        b = self.timestamps.get("DONE") or self.timestamps.get("FAILED")
        return (b - a) if a and b else None

    def setup_time(self) -> Optional[float]:
        a = self.timestamps.get("EXEC_SETUP")
        b = self.timestamps.get("RUNNING")
        return (b - a) if a and b else None


@dataclass
class Pipeline:
    """A design trajectory: an ordered series of stages over M cycles.
    ``meta`` carries the protocol state (structure, candidates, history)."""
    name: str
    meta: Dict[str, Any] = field(default_factory=dict)
    uid: int = field(default_factory=lambda: next(_uid))
    parent: Optional[int] = None   # sub-pipelines record their parent
    cycle: int = 0
    active: bool = True
    tasks: List[int] = field(default_factory=list)
    history: List[Dict[str, float]] = field(default_factory=list)

    @property
    def is_sub_pipeline(self) -> bool:
        return self.parent is not None
