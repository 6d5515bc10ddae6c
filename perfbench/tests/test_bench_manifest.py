"""The benchmark finds what BENCHMARK.json names by name, in files of its
own, and a new configuration, mix, metric and cell take only new files and
new entries."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from perfbench.lib.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads_by_name(cell):
    m = Manifest()
    w = m.cell(cell)
    c = m.config(w["config"])
    mix = m.mix(w["traffic"])
    assert hasattr(m.loop(mix["loop"]), "run")
    ref = m.reference(c["reference"])
    assert ref.leaves(c)
    limits = m.limits(cell)
    assert all(limits[k]["limit"] >= 0 for k in limits if k[0] != "_")
    e2e = [x["name"] for x in m.metrics(cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = m.metrics(cell, True)
    assert per_layer
    for metric in per_layer:
        reader = m.reader(metric["name"])
        assert callable(reader.read)
        for e in getattr(reader, "ENTRIES", ()):
            entry = m.entry(e)
            assert callable(entry.work) and len(entry.TARGET) == 2


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    cells = 24   # a full check with as many cells as later PRs may add
    assert (2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 180 + 1200 \
        <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert sum(w["chips"] == 4 for w in b["workloads"]) == 0
    for w in b["workloads"]:
        assert w["config"] in configs and len(w["why"]) <= 200
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def _digest(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_metric_and_cell_are_new_files_only(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path)
    home = tmp_path / "perfbench"
    cfg = json.loads((home / "configs" / "smollm-360m.json").read_text())
    cfg["name"] = "dummy-lm"
    (home / "configs" / "dummy-lm.json").write_text(json.dumps(cfg))
    mix = json.loads((home / "mixes" / "train-32x2048.json").read_text())
    mix.update(rows=2, seq=64)
    (home / "mixes" / "dummy-mix.json").write_text(json.dumps(mix))
    (home / "limits" / "dummy-lm.dummy-mix.json").write_text(
        json.dumps({"loss_gap": {"limit": 1.0}}))
    (home / "metrics" / "dummy_share.train.py").write_text(
        "def read(record):\n    return 42.0\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "dummy-lm", "source": cfg["source"],
                         "file": "perfbench/configs/dummy-lm.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "dummy-lm.dummy-mix", "config": "dummy-lm",
                           "traffic": "dummy-mix", "chips": 1, "why": "test"})
    b["end_to_end"][0]["workloads"].append("dummy-lm.dummy-mix")
    b["per_layer"].append({"name": "dummy_share.train", "unit": "%",
                           "better": "lower", "source": "device_trace",
                           "layer": "a test", "moves": "train_tokens_per_s",
                           "workloads": ["dummy-lm.dummy-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    after = _digest(tmp_path)
    assert all(after[p] == h for p, h in before.items())
    m = Manifest(tmp_path)
    assert m.config("dummy-lm")["name"] == "dummy-lm"
    assert m.mix("dummy-mix")["rows"] == 2
    assert m.limits("dummy-lm.dummy-mix")["loss_gap"]["limit"] == 1.0
    assert [x["name"] for x in m.metrics("dummy-lm.dummy-mix", True)] == [
        "dummy_share.train"]
    assert m.reader("dummy_share.train").read({}) == 42.0
    assert {x["name"] for x in m.metrics("dummy-lm.dummy-mix", False)} == {
        "train_tokens_per_s", "setup_s"}


def test_shared_code_names_no_cell_config_mix_or_metric():
    b = _bench()
    names = {x["name"] for k in ("configs", "workloads", "per_layer")
             for x in b[k]} | {w["traffic"] for w in b["workloads"]}
    shared = [ROOT / "perfbench" / "run.py", ROOT / "perfbench" / "control.py",
              *sorted((ROOT / "perfbench" / "lib").glob("*.py")),
              *sorted((ROOT / "perfbench" / "loops").glob("*.py"))]
    for path in shared:
        text = path.read_text()
        assert not [n for n in names if n in text], path
