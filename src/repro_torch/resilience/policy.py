"""Retry taxonomy: error classification, deterministic backoff, budgets,
deadlines, and a per-``(kind, stage)`` circuit breaker.

The executor delegates every payload failure to a
:class:`ResilienceManager`, which turns (task, error class, fused?) into
one of two decisions:

- ``("retry", backoff_s)`` — the task requeues with
  ``task.not_before = now + backoff_s``; the :class:`TaskQueue` skips it
  until the backoff elapses, so retries never busy-requeue.
- ``("fail", reason)``    — the task fails fast. ``reason`` is the
  failure class the telemetry layer labels ``tasks.failed{class=}`` with:
  ``permanent`` (non-retryable error type), ``exhausted`` (transient but
  out of retries), ``budget`` (per-kind retry budget spent), ``shed``
  (circuit breaker open), ``canceled``, or ``deadline``.

Classification: explicit :class:`TransientError` / :class:`PermanentError`
always win; otherwise programming-error types (``ValueError``,
``TypeError``, ``KeyError``, ``AssertionError``, ``NotImplementedError``)
are permanent — retrying a deterministic bug just burns devices — and
everything else (I/O hiccups, ``RuntimeError`` from a flaky device) is
transient.

Fused dispatches are special: when a coalesced batch fails, the failure
cannot be attributed to one member, so *every* member is requeued solo
(``task.retries > 0`` disables re-fusion in the executor) regardless of
error class — that solo re-run is the poison-isolation bisect step. Only
solo failures are classified, charged against budgets, and counted by the
circuit breaker.

Backoff is exponential with deterministic jitter: the jitter fraction for
attempt ``a`` of token ``t`` is a pure hash of ``(seed, t, a)``, so a
chaos run replays the exact same schedule. The per-attempt delay is
monotone non-decreasing by construction (a retry never backs off *less*
than the previous attempt) and capped at ``backoff_cap_s``.

A copy of the JAX package's ``repro.resilience.policy`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple


class TransientError(RuntimeError):
    """Explicitly retryable failure (e.g. an injected device hiccup)."""


class PermanentError(RuntimeError):
    """Explicitly non-retryable failure (e.g. an injected poison row)."""


# deterministic bugs: retrying the same payload re-raises the same error
PERMANENT_TYPES: Tuple[type, ...] = (ValueError, TypeError, KeyError,
                                     AssertionError, NotImplementedError)


def classify(exc: BaseException) -> str:
    """``"transient"`` or ``"permanent"`` for an exception instance."""
    if isinstance(exc, PermanentError):
        return "permanent"
    if isinstance(exc, TransientError):
        return "transient"
    if isinstance(exc, PERMANENT_TYPES):
        return "permanent"
    return "transient"


def _jitter_u(seed: int, token: int, attempt: int) -> float:
    """Deterministic uniform in [0, 1) — a pure hash, no RNG state."""
    h = zlib.crc32(f"{seed}:{token}:{attempt}".encode())
    return (h & 0xFFFFFF) / float(0x1000000)


@dataclass(frozen=True)
class RetryPolicy:
    """Knobs for the retry taxonomy. The executor builds a legacy-
    compatible default (no backoff, breaker disabled) from its
    ``max_retries`` when no policy is injected."""
    max_transient_retries: int = 1     # per-task retry ceiling
    backoff_base_s: float = 0.05       # attempt-0 delay
    backoff_mult: float = 2.0          # exponential growth factor
    backoff_cap_s: float = 5.0         # hard ceiling on any delay
    jitter: float = 0.25               # max jitter as a fraction of delay
    seed: int = 0                      # jitter hash seed
    # total retries allowed per kind across all tasks (None = unlimited):
    # a kind-wide outage stops burning devices once the budget is spent
    kind_budgets: Optional[Mapping[str, int]] = None
    # running-task deadline enforced by the executor watchdog (seconds of
    # device time; None = no deadline). Exceeding it fails the task with
    # class "deadline" so the owning pipeline degrades instead of wedging
    deadline_s: Optional[float] = None
    # circuit breaker: consecutive solo failures of one (kind, stage)
    # before retries for it are shed; 0 disables the breaker
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 5.0

    def backoff_s(self, attempt: int, token: int = 0) -> float:
        """Delay before retry ``attempt`` (0-based) of ``token``. Monotone
        in ``attempt``, deterministic in ``(seed, token, attempt)``, and
        bounded by ``backoff_cap_s``."""
        best = 0.0
        for a in range(max(0, int(attempt)) + 1):
            raw = self.backoff_base_s * (self.backoff_mult ** a)
            jit = raw * (1.0 + self.jitter * _jitter_u(self.seed, token, a))
            best = max(best, min(self.backoff_cap_s, jit))
        return best

    def schedule(self, attempts: int, token: int = 0):
        """The first ``attempts`` delays for ``token`` — what a task would
        wait across consecutive transient failures."""
        return [self.backoff_s(a, token) for a in range(int(attempts))]


class CircuitBreaker:
    """Per-key (``(kind, stage)``) consecutive-failure breaker.

    ``closed`` → normal operation. After ``threshold`` consecutive solo
    failures the key opens: retries are shed (fail fast, class ``shed``)
    instead of retry-storming a broken kind. After ``cooldown_s`` the key
    goes ``half_open`` and admits exactly one probe retry; the probe's
    success closes the breaker, its failure re-opens it."""

    STATE_GAUGE = {"closed": 0.0, "half_open": 0.5, "open": 1.0}

    def __init__(self, threshold: int, cooldown_s: float, now_fn,
                 metrics=None):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.now = now_fn
        self.metrics = metrics
        self._lock = threading.Lock()
        # key -> [consecutive failures, state, opened_at]
        self._keys: Dict[Tuple[str, Optional[str]], list] = {}

    def _gauge(self, key, state: str):
        if self.metrics is not None:
            label = f"{key[0]}/{key[1] if key[1] is not None else '-'}"
            self.metrics.gauge("breaker.state", key=label).set(
                self.STATE_GAUGE[state])

    def allow(self, key) -> bool:
        """May a retry of ``key`` proceed right now?"""
        if self.threshold <= 0:
            return True
        with self._lock:
            rec = self._keys.get(key)
            if rec is None or rec[1] == "closed":
                return True
            if rec[1] == "open":
                if self.now() - rec[2] >= self.cooldown_s:
                    rec[1] = "half_open"
                    self._gauge(key, "half_open")
                    return True      # the single probe
                return False
            return False             # half_open: probe already in flight

    def record_failure(self, key):
        if self.threshold <= 0:
            return
        with self._lock:
            rec = self._keys.setdefault(key, [0, "closed", 0.0])
            rec[0] += 1
            if rec[1] == "half_open" or rec[0] >= self.threshold:
                rec[1] = "open"
                rec[2] = self.now()
                self._gauge(key, "open")

    def record_success(self, key):
        if self.threshold <= 0:
            return
        with self._lock:
            rec = self._keys.get(key)
            if rec is not None and (rec[0] or rec[1] != "closed"):
                self._keys[key] = [0, "closed", 0.0]
                self._gauge(key, "closed")

    def states(self) -> Dict[str, dict]:
        with self._lock:
            return {f"{k[0]}/{k[1] if k[1] is not None else '-'}":
                    {"state": rec[1], "consecutive_failures": rec[0]}
                    for k, rec in sorted(self._keys.items(),
                                         key=lambda kv: str(kv[0]))}


class ResilienceManager:
    """Policy + breaker + budgets, owned by the executor. Thread-safe."""

    def __init__(self, policy: Optional[RetryPolicy] = None, *,
                 now_fn=None, metrics=None):
        import time
        self.policy = policy if policy is not None else RetryPolicy()
        self.now = now_fn if now_fn is not None else time.monotonic
        self.metrics = metrics
        self.breaker = CircuitBreaker(self.policy.breaker_threshold,
                                      self.policy.breaker_cooldown_s,
                                      self.now, metrics=metrics)
        self._lock = threading.Lock()
        self._kind_spent: Dict[str, int] = {}
        self._failed_by_class: Dict[str, int] = {}
        self._retries = 0

    # -- classification ---------------------------------------------------

    def classify(self, exc: BaseException) -> str:
        return classify(exc)

    # -- the decision -----------------------------------------------------

    def decide(self, task, error_class: str, *, fused: bool
               ) -> Tuple[str, object]:
        """``("retry", backoff_s)`` or ``("fail", reason)`` for one member
        of a failed dispatch. ``task.retries`` is the attempt counter the
        executor increments after a retry decision."""
        pol = self.policy
        key = (task.kind, task.stage)
        if task.canceled:
            return self._fail("canceled")
        if task.retries >= pol.max_transient_retries:
            if not fused:
                self.breaker.record_failure(key)
            return self._fail("exhausted" if error_class != "permanent"
                              else "permanent")
        if fused:
            # collective failure: cannot attribute blame — every member
            # re-runs solo (the poison-isolation bisect), no backoff
            # charged, no breaker count
            return self._retry(task, backoff=False)
        if error_class == "permanent":
            self.breaker.record_failure(key)
            return self._fail("permanent")
        if pol.kind_budgets is not None:
            budget = pol.kind_budgets.get(task.kind)
            if budget is not None:
                with self._lock:
                    if self._kind_spent.get(task.kind, 0) >= budget:
                        spent = True
                    else:
                        self._kind_spent[task.kind] = \
                            self._kind_spent.get(task.kind, 0) + 1
                        spent = False
                if spent:
                    self.breaker.record_failure(key)
                    return self._fail("budget")
        if not self.breaker.allow(key):
            if self.metrics is not None:
                self.metrics.counter("tasks.shed", kind=task.kind).inc()
            return self._fail("shed")
        return self._retry(task, backoff=True)

    def _retry(self, task, *, backoff: bool) -> Tuple[str, float]:
        delay = (self.policy.backoff_s(task.retries, token=task.uid)
                 if backoff else 0.0)
        with self._lock:
            self._retries += 1
        if self.metrics is not None and delay > 0:
            self.metrics.histogram("retry.backoff_s",
                                   kind=task.kind).observe(delay)
        return ("retry", delay)

    def _fail(self, reason: str) -> Tuple[str, str]:
        with self._lock:
            self._failed_by_class[reason] = \
                self._failed_by_class.get(reason, 0) + 1
        return ("fail", reason)

    def on_success(self, task):
        """A completed task closes its key's breaker window."""
        self.breaker.record_success((task.kind, task.stage))

    # -- reporting --------------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            failed = dict(self._failed_by_class)
            spent = dict(self._kind_spent)
            retries = self._retries
        out = {
            "policy": {
                "max_transient_retries": self.policy.max_transient_retries,
                "backoff_base_s": self.policy.backoff_base_s,
                "backoff_cap_s": self.policy.backoff_cap_s,
                "breaker_threshold": self.policy.breaker_threshold,
            },
            "retries": retries,
            "failed_by_class": failed,
            "breakers": self.breaker.states(),
        }
        if spent:
            out["kind_budget_spent"] = spent
        return out
