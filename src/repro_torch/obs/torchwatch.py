"""Build and first-call watcher: first-class metric series for what the
port compiles. The counterpart of the JAX package's ``repro.obs.jaxwatch``,
with the same ``CompileWatcher`` interface.

The port has no tracing compiler; what it pays in its place is

* builds of the kernel library (``kernels._cuda.build`` running ``nvcc``):
  every build logged in ``_cuda.build_log`` while a watcher is open
  increments ``torch.kernel_builds`` and feeds ``torch.kernel_build_s``;
* the payload's first call per shape key (a new engine, a new masked or
  dense shape: the allocator's and the BLAS libraries' warm-up), which the
  payload logs in ``core.payload.compile_log``. ``absorb_compile_log`` folds
  them in under ``torch.payload_first_calls`` / ``torch.payload_first_call_s``
  (the JAX package's ``jax.payload_compiles``);
* ``absorb_counts`` folds a monotonically growing counter dict of a
  long-lived object in under ``torch.probe_counts{probe=..., event=...}``.

Graph captures are not counted yet.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels import _cuda


class CompileWatcher:
    """Context manager streaming kernel builds into a registry::

        with CompileWatcher(registry):
            ...  # kernel launches; a build lands in torch.kernel_builds
    """

    def __init__(self, registry):
        self.registry = registry
        self.supported = False
        self._counts_seen: Dict[tuple, float] = {}

    def absorb_counts(self, probe: str, counts: Dict[str, int]) -> None:
        """Fold a monotonically growing counter dict into the registry
        (delta since this watcher last saw the probe)."""
        for name, n in counts.items():
            key = (probe, name)
            prev = self._counts_seen.get(key, 0)
            if n > prev:
                self.registry.counter("torch.probe_counts", probe=probe,
                                      event=name).inc(n - prev)
                self._counts_seen[key] = n

    def absorb_compile_log(self, log: Dict[str, list],
                           start: Optional[Dict[str, int]] = None) -> None:
        """Fold the payload's per-key first-call walls in
        (``core.payload.compile_log``); ``start`` holds per-key entry counts
        at the start of a run, so long-lived processes count only that
        run's first calls."""
        for kind, walls in log.items():
            new = walls[(start or {}).get(kind, 0):]
            if new:
                self.registry.counter("torch.payload_first_calls",
                                      kind=kind).inc(len(new))
                h = self.registry.histogram("torch.payload_first_call_s",
                                            kind=kind)
                for w in new:
                    h.observe(float(w))

    def __enter__(self) -> "CompileWatcher":
        self.supported = True
        self._builds0 = len(_cuda.build_log)
        return self

    def __exit__(self, *exc) -> None:
        for seconds in _cuda.build_log[self._builds0:]:
            self.registry.counter("torch.kernel_builds", event="build").inc()
            self.registry.histogram("torch.kernel_build_s").observe(
                float(seconds))
