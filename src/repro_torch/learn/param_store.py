"""Versioned parameter store.

The generator's params live behind a ``ParamStore``: every dispatch
snapshots ``current()`` once — a (version, params) pair read under the lock
— and tags its result with that version (``gen_version``).

A copy of the read side of the JAX package's ``repro.learn.param_store``
(free of JAX there too), with its imports rewritten to ``repro_torch``.
``publish`` with its retire listeners, and ``save``/``restore`` through a
checkpoint manager, come with ``add_generator`` and model evolution (ROADMAP
Queue 1, item 3): nothing in the port installs a second version yet.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, List, Optional, Tuple


class ParamStore:
    def __init__(self, params: Any, *, version: int = 0):
        self._lock = threading.Lock()
        self._params: "OrderedDict[int, Any]" = OrderedDict([(version, params)])
        self._version = version

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def current(self) -> Tuple[int, Any]:
        """Atomic (version, params) snapshot. A dispatch calls this once and
        keeps the pair for its whole run."""
        with self._lock:
            return self._version, self._params[self._version]

    def get(self, version: int) -> Optional[Any]:
        with self._lock:
            return self._params.get(version)

    def versions(self) -> List[int]:
        with self._lock:
            return list(self._params)
