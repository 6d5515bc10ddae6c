"""One run of one cell: load what the cell names, run its loop, read its
metrics and compose the result line. ``run.py`` adds the look for a card
and the check of loaded modules around it; the CPU tests call
``run_cell`` directly."""

from __future__ import annotations

import gc
import math
from dataclasses import dataclass, field

import torch

from perfbench.lib import judge, trace
from perfbench.lib.manifest import Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules):
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Ctx:
    manifest: Manifest
    cell: dict
    config: dict
    mix: dict
    limits: dict
    reference: object
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    entries: dict = field(default_factory=dict)
    control: str | None = None     # a precision for perfbench/control.py

    def free(self):
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def memory_peak(self):
        if torch.device(self.device).type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0


def make_ctx(manifest, cell_name, *, seed, seconds, trace, device, t_start,
             config=None, mix=None, control=None):
    cell = manifest.cell(cell_name)
    mix = mix if mix is not None else manifest.mix(cell["traffic"])
    c = config if config is not None else manifest.config(cell["config"])
    ctx = Ctx(manifest, cell, c, mix, manifest.limits(cell_name),
              manifest.reference(c["reference"]), int(seed), float(seconds),
              bool(trace), device, t_start, control=control)
    if trace:
        for m in manifest.metrics(cell_name, True):
            for e in getattr(manifest.reader(m["name"]), "ENTRIES", ()):
                ctx.entries[e] = manifest.entry(e)
    return ctx


def result_line(ctx, out, chips):
    """The result's JSON object, ``checks`` last."""
    name = ctx.cell["name"]
    metrics = {}
    if not ctx.trace:
        for m in ctx.manifest.metrics(name, False):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    else:
        record = dict(out["record"], trace=out["trace"])
        for m in ctx.manifest.metrics(name, True):
            value = ctx.manifest.reader(m["name"]).read(record)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = torch.device(ctx.device).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if cuda
              else "cpu", "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": judge.passed(out["checks"]) and not out["failed"],
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if ctx.trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = {
            "device_ops": trace.top_ops(out["trace"]["ops"]),
            "idle_gaps": out["trace"]["gaps"]}
    if out.get("control") is not None:
        line["control"] = out["control"]
    line["checks"] = out["checks"]
    return line


def run_cell(manifest, cell_name, *, seed, seconds, trace, device, t_start,
             chips=1, config=None, mix=None, control=None):
    ctx = make_ctx(manifest, cell_name, seed=seed, seconds=seconds,
                   trace=trace, device=device, t_start=t_start,
                   config=config, mix=mix, control=control)
    loop = manifest.loop(ctx.mix["loop"])
    return result_line(ctx, loop.run(ctx), chips)
