"""The check that decides ``correct`` against planted faults and the
control, at tiny sizes on the CPU: a run of the cell with the program in
fp32 comes out correct; with each fault its loop can have
(``perfbench/lib/faults.py``) planted under the timed path, the rest of the
run as it is, it comes out not correct; and the control (the reference in
fp8, put in the program's place) reads over the cell's limits."""

from __future__ import annotations

import time

import pytest

from perfbench.lib import faults, judge
from perfbench.lib.manifest import Manifest
from perfbench.lib.runner import run_cell
from perfbench.tests import tiny

CELLS = [w["name"] for w in Manifest().data["workloads"]]


def _run(cell, control=None, seed=2147483699):
    m = Manifest()
    w = m.cell(cell)
    return run_cell(m, cell, seed=seed, seconds=0.01, trace=False,
                    device="cpu", t_start=time.perf_counter(),
                    config=tiny.config(m.config(w["config"]), "float32"),
                    mix=tiny.mix(m.mix(w["traffic"])), control=control)


def _loop(cell):
    m = Manifest()
    return m.mix(m.cell(cell)["traffic"])["loop"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in sorted(faults.FAULTS[_loop(c)])])
def test_each_planted_fault_is_caught(cell, fault):
    with faults.FAULTS[_loop(cell)][fault]():
        line = _run(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    line = _run(cell, control="fp8")
    limits = Manifest().limits(cell)
    assert not judge.passed(judge.checks(line["control"]["control"],
                                         limits)), line["control"]


@pytest.mark.parametrize("cell", [c for c in CELLS if _loop(c) == "train"])
def test_a_frozen_step_reads_its_true_gradient_norm(cell):
    with faults.FAULTS["train"]["frozen_step"]():
        line = _run(cell, control="none")
    numbers = line["control"]["program"]
    assert numbers["gnorm_gap"] < 1e-4
    assert numbers["grad_gap"] == pytest.approx(1.0)
    assert numbers["change_gap"] == pytest.approx(1.0)
