"""Bucketing tables and the sub-mesh a task runs on.

``BATCH_BUCKETS``/``bucket_rows`` and ``LENGTH_BUCKETS``/``bucket_len`` are
copies of the reference's (``repro.runtime.allocator``): batched payloads
pad rows and token lengths to these edges. ``SubMesh`` is the minimal
stand-in for the reference's device allocation: the devices a task was
granted, so task functions keep the ``(submesh, payload)`` signature.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

# Batch-dim buckets batched payloads pad to.
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_rows(n: int) -> int:
    """Smallest bucket >= n (next power of two above the largest bucket)."""
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    b = BATCH_BUCKETS[-1]
    while b < n:
        b *= 2
    return b


# Sequence-length buckets masked batched payloads pad their token dim to.
LENGTH_BUCKETS = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def bucket_len(L: int, buckets=None) -> int:
    """Smallest length bucket >= L, from ``buckets`` or ``LENGTH_BUCKETS``;
    past the largest edge, rounds up to the next multiple of it."""
    bs = LENGTH_BUCKETS if buckets is None else tuple(buckets)
    L = max(1, int(L))
    for b in bs:
        if L <= b:
            return int(b)
    top = int(bs[-1])
    return -(-L // top) * top


@dataclass(frozen=True)
class SubMesh:
    """The devices granted to one task."""
    devices: Tuple[torch.device, ...]

    @property
    def n_devices(self) -> int:
        return len(self.devices)
