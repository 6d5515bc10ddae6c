"""The traced part of a ``--trace 1`` run, after the measured window.

Two passes over the same work (``fn``, a few steps or one round):

1. the device alone under ``torch.profiler``: the union of the device's
   activity over the pass's wall time (busy and idle) and device time by
   operation name;
2. host and device, with a span (``record_function``) around every call of
   each kernel entry that the cell's metrics read (``perfbench/entries``):
   each call's device time is the time of the kernels whose launches the
   profiler links to the call's span or to an operation inside it, and its
   bound is the entry's frozen work at the call's shapes. The idle gaps of
   this pass are named by the host operation that was running when the
   device fell idle.

The spans are put round the entries by replacing their functions in this
process for the pass; the program's files are not touched.
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
import importlib
import sys
import time
from collections import Counter, defaultdict

import torch

from perfbench.lib import yardstick as ys

SPAN = "bench."
TOP = 10


class _Unpacked:
    """An autograd Function's ctx whose saved tensors are read once, here,
    so that the entry's work and the backward itself can both read them."""

    def __init__(self, ctx):
        self._ctx = ctx
        self.saved_tensors = ctx.saved_tensors

    def __getattr__(self, name):
        return getattr(self._ctx, name)


@contextlib.contextmanager
def spans(entries):
    """Wrap every entry (name -> module with ``TARGET`` and ``work``) in a
    span; yields name -> [(flops, bytes, peak)] a call, in call order."""
    calls = defaultdict(list)
    undo = []
    try:
        for name, e in entries.items():
            mod_name, attr = e.TARGET
            owner = importlib.import_module(mod_name)
            parts = attr.split(".")
            for p in parts[:-1]:
                owner = getattr(owner, p)
            raw = owner.__dict__[parts[-1]]
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw
            undo.append((owner, parts[-1], raw))

            def wrapped(*args, _fn=fn, _name=name, _work=e.work,
                        _bwd=parts[-1] == "backward", **kwargs):
                if _bwd:        # saved tensors unpack once under remat
                    args = (_Unpacked(args[0]),) + args[1:]
                index = len(calls[_name])
                calls[_name].append(_work(*args, **kwargs))
                with torch.profiler.record_function(f"{SPAN}{_name}#{index}"):
                    return _fn(*args, **kwargs)
            setattr(owner, parts[-1], staticmethod(wrapped)
                    if isinstance(raw, staticmethod) else wrapped)
        yield calls
    finally:
        for owner, attr, raw in reversed(undo):
            setattr(owner, attr, raw)


def _profile(fn, cpu):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.events(), wall


def _is_device(e):
    return str(e.device_type).endswith("CUDA")


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_pass(fn):
    """Pass 1: busy and wall seconds, device seconds by op name."""
    events, wall = _profile(fn, cpu=False)
    dev = [e for e in events if _is_device(e)]
    busy = sum(e - s for s, e in _union(_kernels(events))) / 1e6
    ops = Counter()
    for e in dev:
        ops[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    return {"busy_s": busy, "window_s": wall, "ops": dict(ops)}


def _kernels(events):
    """The device's own operations, sorted by start: kernels, copies and
    sets, not the device-side extents of the spans."""
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if _is_device(e) and not e.name.startswith(SPAN))


def entry_pass(fn, entries):
    """Pass 2: each entry call's (device seconds, bound seconds), and the
    idle gaps by the host operation running when they began. The profiler
    marks each span on the device's timeline too, from the first to the
    last operation launched inside it; a call's device time is the time of
    the device's operations within that mark (one stream: none of another
    call's)."""
    with spans(entries) as calls:
        events, _ = _profile(fn, cpu=True)
    ops = _kernels(events)
    starts = [s for s, _ in ops]
    device = defaultdict(float)
    for e in events:
        if not (_is_device(e) and e.name.startswith(SPAN)):
            continue
        lo, hi = e.time_range.start, e.time_range.end
        i = bisect.bisect_left(starts, lo)
        while i < len(ops) and ops[i][0] < hi:
            end = min(ops[i][1], hi)
            device[e.name[len(SPAN):]] += (end - ops[i][0]) / 1e6
            i += 1
    per_entry = {}
    for name, works in calls.items():
        per_entry[name] = [
            (device.get(f"{name}#{i}", 0.0),
             ys.bound_s(flops, nbytes, peak))
            for i, (flops, nbytes, peak) in enumerate(works)]
        print(f"[trace] {name}: {len(works)} calls, "
              f"{sum(d > 0 for d, _ in per_entry[name])} with device time, "
              f"{sum(d for d, _ in per_entry[name])!r} s of it, "
              f"{sum(b for _, b in per_entry[name])!r} s of bound",
              file=sys.stderr)
    return per_entry, idle_gaps(events, ops)


def idle_gaps(events, ops):
    """Device idle gaps summed by the innermost host operation running at
    each gap's start (a kernel launch call names none: its caller does);
    the top ``TOP`` as [name, seconds]."""
    busy = _union(ops)
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if not _is_device(e) and not e.is_async
                  and "LaunchKernel" not in e.name)
    gaps = Counter()
    active, i = [], 0
    for (_, end), (start, _) in zip(busy, busy[1:]):
        while i < len(host) and host[i][0] <= end:
            s, e, n = host[i]
            heapq.heappush(active, (-s, e, n))
            i += 1
        # the latest-started op still running; ended ones are dropped as
        # they surface
        name = "host code outside any traced op"
        while active:
            s, e, n = active[0]
            if e > end:
                name = n
                break
            heapq.heappop(active)
        gaps[name] += (start - end) / 1e6
    return [[n, s] for n, s in gaps.most_common(TOP)]


def top_ops(ops):
    return [[n[:120], s] for n, s in Counter(ops).most_common(TOP)]
