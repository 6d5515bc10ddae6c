"""Trainer service: opportunistic, preemptible model evolution.

Watches the executor from the coordinator's run loop (``tick`` per
iteration) and emits a low-priority **preemptible** ``finetune`` task only
when the middleware is idle — no queued design work and free devices — the
paper's "training run opportunistically on dynamically allocated idle
resources". A running trainer task yields its sub-mesh cooperatively the
moment design work queues (``AsyncExecutor.preempt_preemptible``); the
partial train state comes back in the task result and the service resubmits
the continuation on the next idle window, so training progress survives
preemption. The scheduler's aging guard (``TaskQueue.aging_s``) keeps a
parked trainer task from starving forever under a continuous design load.

Completed finetunes publish evolved params to the generator's
``ParamStore`` (done by the payload fn) and are recorded in ``history``
for the coordinator's quality-by-version report.

A copy of the JAX package's ``repro.learn.trainer`` (free of JAX there
too), with its imports rewritten to ``repro_torch`` and without its
optional ``checkpoint`` manager, which no session sets: evolved weights
persist through ``ParamStore.save``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.pipeline import ResourceRequest, Task, TaskState
from repro_torch.learn.replay_buffer import ReplayBuffer


@dataclass(frozen=True)
class EvolutionConfig:
    finetune_every: int = 0   # accepted designs between finetunes; 0 = off
    batch_size: int = 8       # designs per finetune batch (replay sample)
    min_designs: int = 4      # don't train before the buffer holds this many
    steps: int = 12           # train steps per finetune task
    priority: int = 100       # low urgency: design tasks sort first
    max_devices: int = 4      # cap on the trainer's data-parallel sub-mesh
    min_free_devices: int = 1  # idle threshold to emit a trainer task
    seed: int = 0


class TrainerService:
    def __init__(self, executor, buffer: ReplayBuffer, store,
                 cfg: EvolutionConfig):
        self.executor = executor
        self.buffer = buffer
        self.store = store
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed + 7)
        self._inflight: Optional[int] = None   # uid of the running task
        self._cur_payload: Optional[dict] = None
        self._resume: Optional[dict] = None    # resume state from preemption
        self._preempted_uid: Optional[int] = None  # uid the resume links to
        self._accepted_since = 0
        self.history: List[dict] = []          # one record per finetune
        self.submitted = 0
        self.completed = 0
        self.preempted = 0
        self.failed = 0
        self.steps_run = 0
        self.device_seconds = 0.0

    # -- coordinator-facing API -------------------------------------------

    def add_design(self, record: dict):
        """Feed one accepted design (a pipeline history row) into the
        replay buffer."""
        self.buffer.add(record["backbone"], record["sequence"],
                        record["fitness"], record.get("gen_version", 0))
        self._accepted_since += 1

    def owns(self, uid: int) -> bool:
        return uid == self._inflight

    def busy(self) -> bool:
        """True while a trainer task is in flight or a preempted finetune
        still has a continuation to run."""
        return self._inflight is not None or self._resume is not None

    def tick(self) -> Optional[Task]:
        """Submit a finetune task if evolution is due and the middleware is
        idle (no queued design work, free devices). Returns the submitted
        task, or None."""
        cfg = self.cfg
        if cfg.finetune_every <= 0 or self._inflight is not None:
            return None
        if self._resume is None:
            if self._accepted_since < cfg.finetune_every:
                return None
            if len(self.buffer) < max(1, cfg.min_designs):
                return None
        if len(self.executor.queue) > 0:      # design work queued: stand by
            return None
        if self.executor.allocator.n_free < cfg.min_free_devices:
            return None
        if self._resume is not None:
            payload = dict(self._cur_payload, resume=self._resume)
        else:
            batch = self.buffer.sample(cfg.batch_size, self._rng)
            if batch is None:
                return None
            payload = {"backbones": batch["backbones"],
                       "sequences": batch["sequences"],
                       "weights": batch["weights"],
                       "steps": cfg.steps}
            self._cur_payload = payload
            self._accepted_since = 0   # this batch consumes the trigger
        n = 1
        cap = min(self.executor.allocator.n_free, cfg.max_devices,
                  int(payload["sequences"].shape[0]))
        while n * 2 <= cap:
            n *= 2
        task = Task(kind="finetune", payload=payload, priority=cfg.priority,
                    preemptible=True, resources=ResourceRequest(n_devices=n))
        self._inflight = task.uid
        self.submitted += 1
        resuming = self._resume is not None
        self.executor.submit(task)
        if resuming and task.trace is not None:
            # span tracing on: link the continuation to the preempted task
            # it resumes, so the preempt/resume chain is walkable in traces
            task.trace["resumed_from"] = self._preempted_uid
        return task

    def on_complete(self, task: Task):
        """Route a drained trainer-task completion: stash resume state on
        preemption, record the finetune on success."""
        self._inflight = None
        if task.state != TaskState.DONE:
            self.failed += 1
            self._resume = None
            self._cur_payload = None
            return
        r = task.result
        self.steps_run += int(r.get("steps_run", 0))
        self.device_seconds += float(r.get("elapsed_s", 0.0)) \
            * int(r.get("n_devices", 1))
        if r.get("preempted"):
            self.preempted += 1
            self._resume = r["resume"]
            self._preempted_uid = task.uid
            self.executor.telemetry.tracer.mark(task, "preempted")
            self.executor.telemetry.metrics.counter(
                "tasks.preempted", kind=task.kind).inc()
            return
        self.completed += 1
        self._resume = None
        self._cur_payload = None
        self.history.append({k: r[k] for k in (
            "base_version", "new_version", "loss_first", "loss_last",
            "mean_ll_first", "mean_ll_last", "n_designs", "steps_done")})

    def wait_idle(self, timeout: float = 60.0):
        """Drain the executor until no trainer task is in flight — for
        callers (benchmarks) that run finetunes outside a coordinator
        loop. Non-trainer completions are not expected here."""
        import time
        t0 = time.monotonic()
        while self.busy() and time.monotonic() - t0 < timeout:
            self.tick()
            task = self.executor.drain(timeout=0.1)
            if task is not None and self.owns(task.uid):
                self.on_complete(task)

    # -- reporting ---------------------------------------------------------

    def report(self, makespan: float, total_devices: int) -> dict:
        """Trainer stats for ``Coordinator.report()``. ``trainer_utilization``
        is finetune device-seconds over the pilot's device-seconds — how much
        of the run's idle capacity evolution soaked up."""
        wall = max(float(makespan), 1e-9)
        return {
            "enabled": self.cfg.finetune_every > 0,
            "param_version": self.store.version,
            "buffer": self.buffer.stats(),
            "submitted": self.submitted,
            "completed": self.completed,
            "preempted": self.preempted,
            "failed": self.failed,
            "steps_run": self.steps_run,
            "device_seconds": self.device_seconds,
            "trainer_utilization": (
                self.device_seconds / (max(1, total_devices) * wall)),
            "finetunes": list(self.history),
        }
