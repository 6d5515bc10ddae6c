"""Versioned, hot-swappable parameter store.

The generator's params live behind a ``ParamStore`` so model evolution can
swap them without touching in-flight work: every dispatch snapshots
``current()`` once — a (version, params) pair read under the lock — and
finishes on the version it started with, while ``publish`` installs the
evolved weights as a new version atomically. Retired versions (beyond
``keep``) are announced to listeners so per-device weight caches can drop
their copies by version instead of guessing at cache-key layouts.

Versions persist/restore through ``checkpoint.manager.CheckpointManager``
(the checkpoint *step* is the store version), so an evolved generator
survives a restart. A restore announces every version it replaces to the
retire listeners, so per-device copies of them are evicted.

A copy of the JAX package's ``repro.learn.param_store`` (free of JAX there
too).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Tuple


class ParamStore:
    def __init__(self, params: Any, *, version: int = 0, keep: int = 2):
        self._lock = threading.Lock()
        self._params: "OrderedDict[int, Any]" = OrderedDict([(version, params)])
        self._version = version
        self._max_version = version   # highest ever issued: version numbers
        #   are never reused, even after restoring an older checkpoint, so
        #   gen_version provenance stays unambiguous and retired-version
        #   tombstones downstream never match a live version
        self._listeners: List[Callable[[List[int]], None]] = []
        self.keep = max(1, int(keep))

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def current(self) -> Tuple[int, Any]:
        """Atomic (version, params) snapshot — the hot-swap read point. A
        dispatch calls this once and keeps the pair for its whole run."""
        with self._lock:
            return self._version, self._params[self._version]

    def get(self, version: int) -> Optional[Any]:
        with self._lock:
            return self._params.get(version)

    def versions(self) -> List[int]:
        with self._lock:
            return list(self._params)

    def publish(self, params: Any) -> int:
        """Install evolved ``params`` as the new current version; retire the
        oldest versions beyond ``keep`` and notify listeners (outside the
        lock) so they can evict per-device copies of retired versions."""
        with self._lock:
            v = self._max_version + 1
            self._params[v] = params
            self._version = v
            self._max_version = v
            retired = list(self._params)[:-self.keep]
            for r in retired:
                del self._params[r]
        if retired:
            for fn in list(self._listeners):
                fn(retired)
        return v

    def on_retire(self, fn: Callable[[List[int]], None]):
        """Register a callback invoked with the list of retired versions."""
        self._listeners.append(fn)

    # -- checkpoint/restart -------------------------------------------------

    def save(self, manager, *, block: bool = False) -> int:
        """Persist the current version through a ``CheckpointManager`` (the
        checkpoint step *is* the version)."""
        v, params = self.current()
        manager.save(v, params, extra={"param_store_version": v}, block=block)
        return v

    def restore(self, manager, step: Optional[int] = None) -> Optional[int]:
        """Restore the newest (or ``step``) persisted version, replacing the
        store's contents; returns the restored version or None if the
        manager has no checkpoint. Publishing continues past the highest
        version ever handed out (never reusing a number, even when an older
        step was restored)."""
        _, template = self.current()
        state, _, got = manager.restore(template, step)
        if state is None:
            return None
        with self._lock:
            retired = [v for v in self._params if v != got]
            self._params = OrderedDict([(int(got), state)])
            self._version = int(got)
            self._max_version = max(self._max_version, int(got))
        if retired:
            for fn in list(self._listeners):
                fn(retired)
        return int(got)
