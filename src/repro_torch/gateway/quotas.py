"""Per-tenant device quotas for the campaign gateway.

Two mechanisms, riding two existing runtime hooks:

**Weighted share** — each tenant owns a *band stride* of the task queue's
weighted-fair scheduler: the gateway maps a task's stage band into
``tenant_band(tenant_idx, stage_band)`` and pushes combined shares
(tenant share x stage share) via ``TaskQueue.set_band_shares``, so
dispatch *frequency* divides across tenants by their configured weights
even before any hard limit kicks in.

**Hard cap** — ``QuotaManager`` is an executor *allocation policy*
(``AsyncExecutor.set_allocation_policy``): it bounds how many devices a
tenant's dispatches may hold concurrently. Accounting is reserve-at-pick:

  * ``admit(task)`` runs under the queue lock at the moment the task
    would be popped; returning True reserves the task's device floor, so
    two workers can never over-admit a tenant between pick and grant —
    the cap is exact, not best-effort.
  * ``granted(task, sub)`` settles the reservation against the actual
    (possibly row-proportional) grant; ``device_cap(task)`` bounds that
    grant to the tenant's remaining headroom first.
  * ``released(task, sub)`` returns the devices at dispatch end;
    ``denied(task)`` refunds a reservation whose allocation raced out.

A rejected task stays queued and is skipped — never blocking co-tenants'
tasks behind it — and is reconsidered on every subsequent pick, so
admission opens the moment the tenant's devices free up.

Deliberate exemption: tasks *coalesced into another leader's dispatch*
(``pop_matching``) are never admitted through the quota — co-members ride
the leader's grant and hold no devices of their own. Cross-tenant fusion
is the gateway's throughput story; taxing it would only force the same
rows to run in two half-empty batches. The leader's tenant is charged
for the whole grant.

Tenants with no quota (or ``max_devices=None``) pass through untouched;
tasks with no tenant (single-tenant scripts) are never gated.

A copy of the JAX package's ``repro.gateway.quotas`` (free of JAX there
too), reading the port's ``Task`` and ``SubMesh``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.pipeline import Task
from repro_torch.runtime.allocator import SubMesh

# bands 0..TENANT_BAND_STRIDE-1 are a tenant's private stage bands; stage
# tables in the tree use small band ids (0/1), so 16 leaves headroom
TENANT_BAND_STRIDE = 16


def tenant_band(tenant_idx: int, stage_band: int) -> int:
    """Map a (tenant, stage band) pair into the flat band id space the
    weighted-fair queue schedules over."""
    return int(tenant_idx) * TENANT_BAND_STRIDE \
        + int(stage_band) % TENANT_BAND_STRIDE


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's resource envelope: ``share`` weights its bands in the
    fair scheduler (relative to other tenants); ``max_devices`` hard-caps
    the devices its dispatches may hold concurrently (None = uncapped)."""
    share: float = 1.0
    max_devices: Optional[int] = None


class QuotaManager:
    """Executor allocation policy enforcing per-tenant device caps, plus
    per-tenant held/peak accounting for reports and benchmarks."""

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None):
        self._quotas: Dict[str, TenantQuota] = dict(quotas or {})
        self._held: Dict[str, int] = {}      # devices currently held
        self._peak: Dict[str, int] = {}      # high-water mark of held
        self._reserved: Dict[int, int] = {}  # task uid -> reserved floor
        self._rejections: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- configuration ----------------------------------------------------

    def set_quota(self, tenant: str, quota: TenantQuota):
        with self._lock:
            self._quotas[tenant] = quota

    def quota_for(self, tenant: str) -> TenantQuota:
        return self._quotas.get(tenant, TenantQuota())

    # -- the executor policy hooks ----------------------------------------

    def admit(self, task: Task) -> bool:
        t = task.tenant
        if t is None:
            return True
        cap = self.quota_for(t).max_devices
        if cap is None:
            return True
        floor = max(1, int(task.resources.n_devices))
        with self._lock:
            held = self._held.get(t, 0)
            if held + floor > cap:
                self._rejections[t] = self._rejections.get(t, 0) + 1
                return False
            # reserve the floor now, under the queue lock's serialization:
            # admit=True means this task WILL be dispatched (or explicitly
            # denied back), so the cap can never be over-committed
            self._held[t] = held + floor
            self._peak[t] = max(self._peak.get(t, 0), self._held[t])
            self._reserved[task.uid] = floor
        return True

    def device_cap(self, task: Task) -> Optional[int]:
        """Headroom for this task's grant: its own reservation plus
        whatever the tenant has left under the cap. None = unbounded."""
        t = task.tenant
        if t is None:
            return None
        cap = self.quota_for(t).max_devices
        if cap is None:
            return None
        with self._lock:
            floor = self._reserved.get(
                task.uid, max(1, int(task.resources.n_devices)))
            return max(floor, cap - self._held.get(t, 0) + floor)

    def granted(self, task: Task, sub: SubMesh):
        """Settle the pick-time reservation against the actual grant."""
        t = task.tenant
        with self._lock:
            floor = self._reserved.pop(task.uid, 0)
            if t is None:
                return
            self._held[t] = self._held.get(t, 0) - floor + sub.n_devices
            self._peak[t] = max(self._peak.get(t, 0), self._held[t])

    def released(self, task: Task, sub: SubMesh):
        t = task.tenant
        if t is None:
            return
        with self._lock:
            self._held[t] = self._held.get(t, 0) - sub.n_devices

    def denied(self, task: Task):
        """The executor could not allocate after admission (pool raced):
        the task went back to the queue, so refund its reservation."""
        t = task.tenant
        with self._lock:
            floor = self._reserved.pop(task.uid, 0)
            if t is not None and floor:
                self._held[t] = self._held.get(t, 0) - floor

    # -- reporting --------------------------------------------------------

    def stats(self) -> Dict[str, dict]:
        """Per-tenant quota accounting: configured envelope, devices held
        right now, the held high-water mark, and admission rejections —
        the evidence the fake-clock quota tests assert on (peak <= cap)."""
        with self._lock:
            tenants = (set(self._quotas) | set(self._held)
                       | set(self._rejections))
            return {t: {
                "share": self.quota_for(t).share,
                "max_devices": self.quota_for(t).max_devices,
                "held": self._held.get(t, 0),
                "peak_held": self._peak.get(t, 0),
                "rejections": self._rejections.get(t, 0),
            } for t in sorted(tenants)}
