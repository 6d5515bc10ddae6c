"""Dead-letter quarantine for tasks that exhausted the retry taxonomy.

When a fused dispatch fails, the executor re-runs every member solo (the
bisect step — ``task.retries > 0`` disables re-fusion); a member that
still fails solo with a permanent class is the poison row. It lands here
as a quarantine record instead of wedging its campaign: the owning
pipeline deactivates (graceful degradation), the rest of the campaign
continues, and the record is surfaced in ``report()["resilience"]
["deadletter"]`` with the pipeline name resolved by the coordinator.

A copy of the JAX package's ``repro.resilience.deadletter`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

import threading
from typing import List, Optional


class DeadLetterQueue:
    """Bounded, thread-safe quarantine log (newest records win)."""

    def __init__(self, cap: int = 256):
        self.cap = int(cap)
        self._records: List[dict] = []
        self._dropped = 0
        self._lock = threading.Lock()

    def record(self, task, *, error_class: str, error: Optional[str],
               fused: bool = False, now: Optional[float] = None) -> dict:
        rec = {
            "uid": task.uid,
            "kind": task.kind,
            "stage": task.stage,
            "pipeline_id": task.pipeline_id,
            "tenant": task.tenant,
            "retries": task.retries,
            "class": error_class,
            "fused": bool(fused),
            "error": (error or "").splitlines()[0][:400] if error else None,
            "t": now,
        }
        with self._lock:
            self._records.append(rec)
            if len(self._records) > self.cap:
                self._dropped += len(self._records) - self.cap
                del self._records[:-self.cap]
        return rec

    def records(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._records]

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)
