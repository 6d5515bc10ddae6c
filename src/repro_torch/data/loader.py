"""Background-thread prefetcher: overlaps host-side batch generation with
device compute (the data-pipeline half of the paper's "no idle waits").

A copy of the JAX package's ``repro.data.loader`` (stdlib only there
too)."""

from __future__ import annotations

import queue
import threading


class Prefetcher:
    def __init__(self, iterator, depth: int = 2):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except Exception as e:  # surfaced on next __next__
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
