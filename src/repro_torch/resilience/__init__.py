"""Resilience substrate: deterministic fault injection, a retry taxonomy
with backoff + circuit breaking, and poison-task quarantine.

- ``faults``     — seed-driven :class:`FaultPlan` injected at the
                   executor / allocator / checkpoint seams, so chaos runs
                   are reproducible.
- ``policy``     — :class:`RetryPolicy` (transient vs permanent error
                   classification, exponential backoff with deterministic
                   jitter, per-kind retry budgets, task deadlines) and a
                   per-``(kind, stage)`` :class:`CircuitBreaker`, wired
                   together by :class:`ResilienceManager`.
- ``deadletter`` — :class:`DeadLetterQueue` quarantine records for tasks
                   that exhausted their retry budget, surfaced in
                   ``report()["resilience"]``.

A copy of the JAX package's ``repro.resilience`` exports.
"""

from repro_torch.resilience.deadletter import DeadLetterQueue
from repro_torch.resilience.faults import FaultPlan, FaultSpec, maybe_corrupt
from repro_torch.resilience.policy import (CircuitBreaker, PermanentError,
                                           ResilienceManager, RetryPolicy,
                                           TransientError, classify)

__all__ = [
    "CircuitBreaker",
    "DeadLetterQueue",
    "FaultPlan",
    "FaultSpec",
    "PermanentError",
    "ResilienceManager",
    "RetryPolicy",
    "TransientError",
    "classify",
    "maybe_corrupt",
]
