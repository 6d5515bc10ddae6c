"""Deterministic, seed-driven fault injection for chaos runs.

A :class:`FaultPlan` is a list of :class:`FaultSpec` entries consulted at
the runtime's seams:

- ``on_dispatch(task, members, executor)`` — called by the executor
  worker right before the payload fn runs. Specs can raise a classified
  payload error (``op="error"``), designate and repeatedly kill a poison
  row (``op="poison"``), inject a slowdown (``op="slow"``), or kill a
  device mid-dispatch (``op="device_loss"`` → the executor's
  ``inject_device_failure``).
- ``on_checkpoint_saved(path)`` — called by checkpoint writers after a
  file lands; ``op="corrupt_checkpoint"`` specs flip a seed-chosen byte
  in it, exercising verify-on-restore and the fallback-to-previous-copy
  path.

Occurrence counting is per spec: a spec fires on the ``at``-th matching
dispatch (1-based) and for ``count`` consecutive matches after that.
Matching is by leader-task ``kind`` / ``stage`` (None = wildcard) plus an
optional ``where`` predicate. ``op="poison"`` is sticky: when it fires it
records the dispatch leader's uid and fails *every* later dispatch that
contains that task — fused first (so the executor's bisect re-runs the
members solo), then the solo retry (permanently, so the row quarantines
to the dead-letter queue while its batch-mates complete).

All injected errors derive from the policy module's classified types, so
the retry taxonomy treats them exactly like organic failures.

A copy of the JAX package's ``repro.resilience.faults`` (free of JAX there
too), with its imports rewritten to ``repro_torch``. ``device_loss`` takes
the ``device_index``-th device of the executor's allocator grid, which
``DeviceAllocator.mark_failed`` finds by identity or ``==``: a grid of
distinct devices (``torch.device("cpu", i)``, or the card's
``torch.device("cuda", i)``) loses exactly the one named.
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.resilience.policy import PermanentError, TransientError


class InjectedFault(Exception):
    """Mixin marker: every fault raised by a FaultPlan carries it."""


class InjectedTransientError(TransientError, InjectedFault):
    pass


class InjectedPermanentError(PermanentError, InjectedFault):
    pass


@dataclass
class FaultSpec:
    """One injected fault. ``op`` ∈ {error, poison, slow, device_loss,
    corrupt_checkpoint}; ``at`` is the 1-based matching-occurrence index
    it first fires on, ``count`` how many consecutive matches it fires
    for (device_loss and poison designation fire once regardless)."""
    op: str
    kind: Optional[str] = None        # leader task kind (None = any)
    stage: Optional[str] = None       # leader task stage (None = any)
    at: int = 1
    count: int = 1
    error_class: str = "transient"    # for op="error"
    delay_s: float = 0.05             # for op="slow"
    device_index: int = 0             # for op="device_loss" (flat index)
    where: Optional[Callable] = None  # extra leader-task predicate


class FaultPlan:
    """Deterministic chaos schedule. Install on an executor
    (``AsyncExecutor(..., fault_plan=plan)``) and/or hand to checkpoint
    writers; ``summary()`` reports what actually fired (the evidence in
    ``report()["resilience"]["faults_injected"]``)."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        # per-spec state: matching occurrences seen, times fired, and the
        # sticky poison uid once designated
        self._occ = [0] * len(self.specs)
        self._fired = [0] * len(self.specs)
        self._poison_uid: Dict[int, int] = {}
        self._ckpt_occ = 0
        self._events: List[dict] = []

    # -- matching ---------------------------------------------------------

    @staticmethod
    def _matches(spec: FaultSpec, task) -> bool:
        if spec.kind is not None and task.kind != spec.kind:
            return False
        if spec.stage is not None and task.stage != spec.stage:
            return False
        if spec.where is not None and not spec.where(task):
            return False
        return True

    def _note(self, op: str, detail: dict):
        self._events.append(dict({"op": op}, **detail))

    # -- the executor seam ------------------------------------------------

    def on_dispatch(self, task, members, executor):
        """Consult every spec for this dispatch (leader = ``task``). May
        sleep, kill a device, or raise an injected payload error."""
        raise_exc = None
        sleep_s = 0.0
        lose_device = None
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.op == "corrupt_checkpoint":
                    continue
                # sticky poison: once designated, fire on membership alone
                puid = self._poison_uid.get(i)
                if puid is not None:
                    if any(m.uid == puid for m in members):
                        self._fired[i] += 1
                        self._note("poison", {"uid": puid,
                                              "kind": task.kind,
                                              "fused": len(members) > 1})
                        raise_exc = InjectedPermanentError(
                            f"injected poison row (task uid={puid})")
                    continue
                if not self._matches(spec, task):
                    continue
                self._occ[i] += 1
                occ = self._occ[i]
                if occ < spec.at:
                    continue
                if spec.op == "poison":
                    self._poison_uid[i] = task.uid
                    self._fired[i] += 1
                    self._note("poison", {"uid": task.uid,
                                          "kind": task.kind,
                                          "fused": len(members) > 1})
                    raise_exc = InjectedPermanentError(
                        f"injected poison row (task uid={task.uid})")
                elif occ >= spec.at + spec.count:
                    continue
                elif spec.op == "error":
                    self._fired[i] += 1
                    self._note("error", {"class": spec.error_class,
                                         "kind": task.kind})
                    exc_type = (InjectedPermanentError
                                if spec.error_class == "permanent"
                                else InjectedTransientError)
                    raise_exc = exc_type(
                        f"injected {spec.error_class} fault "
                        f"(kind={task.kind}, occurrence={occ})")
                elif spec.op == "slow":
                    self._fired[i] += 1
                    self._note("slow", {"delay_s": spec.delay_s,
                                        "kind": task.kind})
                    sleep_s = max(sleep_s, spec.delay_s)
                elif spec.op == "device_loss" and self._fired[i] == 0:
                    self._fired[i] += 1
                    self._note("device_loss",
                               {"device_index": spec.device_index})
                    lose_device = spec.device_index
        if lose_device is not None:
            flat = list(executor.allocator.grid.flat)
            dev = flat[lose_device % len(flat)]
            executor.inject_device_failure(dev)
        if sleep_s > 0:
            time.sleep(sleep_s)
        if raise_exc is not None:
            raise raise_exc

    # -- the checkpoint seam ----------------------------------------------

    def on_checkpoint_saved(self, path) -> bool:
        """Maybe corrupt the just-written checkpoint file at ``path``.
        Returns True when a byte was flipped."""
        with self._lock:
            self._ckpt_occ += 1
            occ = self._ckpt_occ
            spec_i = None
            for i, spec in enumerate(self.specs):
                if spec.op != "corrupt_checkpoint":
                    continue
                if spec.at <= occ < spec.at + spec.count:
                    spec_i = i
                    break
            if spec_i is None:
                return False
            self._fired[spec_i] += 1
            self._note("corrupt_checkpoint", {"path": str(path)})
        try:
            with open(path, "r+b") as f:
                data = f.read()
                if not data:
                    return False
                off = zlib.crc32(f"{self.seed}:{occ}".encode()) % len(data)
                f.seek(off)
                f.write(bytes([data[off] ^ 0xFF]))
            return True
        except OSError:
            return False

    # -- reporting --------------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            by_op: Dict[str, int] = {}
            for spec, fired in zip(self.specs, self._fired):
                if fired:
                    by_op[spec.op] = by_op.get(spec.op, 0) + fired
            return {"fired_by_op": by_op,
                    "events": [dict(e) for e in self._events]}


def maybe_corrupt(path, plan: Optional[FaultPlan]) -> bool:
    """Checkpoint-writer helper: consult ``plan`` (None = no-op)."""
    return plan.on_checkpoint_saved(path) if plan is not None else False
