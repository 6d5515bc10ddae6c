"""Finds what ``BENCHMARK.json`` names, by name, in files of its own:

  configuration   the file its entry names (sizes, the port's arch, the
                  reference's module)
  traffic mix     ``perfbench/mixes/<traffic>.json`` (the loop it runs and
                  that loop's parameters)
  loop            ``perfbench/loops/<loop>.py`` (``run(ctx)``)
  reference       ``perfbench/ref/<reference>.py``
  limits          ``perfbench/limits/<cell>.json`` (each number compared,
                  its limit and the readings it was set from)
  metric reader   ``perfbench/metrics/<metric>.py`` (``read(record)``;
                  ``ENTRIES``: the kernel entries it reads)
  kernel entry    ``perfbench/entries/<entry>.py`` (``TARGET``, the port's
                  function; ``work``, its frozen work at a call's shapes)

Nothing here names a configuration, a mix or a metric. A later change adds a
cell, a mix or a metric by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HOME = Path(__file__).resolve().parents[1]


def _json(path):
    with open(path) as f:
        return json.load(f)


def _module(path, name):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: "
                   f"{[e['name'] for e in entries]}")


class Manifest:
    """``BENCHMARK.json`` and the files it leads to, under ``root``."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.home = self.root / "perfbench"
        self.data = _json(self.root / "BENCHMARK.json")

    def cell(self, name):
        return _named(self.data["workloads"], name, "workload")

    def config(self, name):
        entry = _named(self.data["configs"], name, "configuration")
        return _json(self.root / entry["file"])

    def mix(self, traffic):
        return _json(self.home / "mixes" / f"{traffic}.json")

    def limits(self, cell):
        return _json(self.home / "limits" / f"{cell}.json")

    def loop(self, name):
        return _module(self.home / "loops" / f"{name}.py",
                       f"perfbench_loop_{name}")

    def reference(self, name):
        return _module(self.home / "ref" / f"{name}.py",
                       f"perfbench_ref_{name}")

    def entry(self, name):
        return _module(self.home / "entries" / f"{name}.py",
                       "perfbench_entry_" + name.replace(".", "_"))

    def reader(self, metric):
        return _module(self.home / "metrics" / f"{metric}.py",
                       "perfbench_metric_" + metric.replace(".", "_")
                       .replace("-", "_"))

    def metrics(self, cell, traced):
        """The cell's end-to-end metrics (``traced`` false: those listing
        the cell under ``workloads``, and those without the key) or
        per-layer metrics (true: those listing the cell under
        ``workloads``, which every per-layer metric has)."""
        if not traced:
            return [m for m in self.data["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]
