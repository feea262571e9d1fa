"""On the card, each cell at its own size: a short run is correct, and the
control (the reference in float8 in the program's place) fails one of its
numbers; a planted fault fails too."""
from __future__ import annotations

import time

import pytest

from benchmark import compare
from benchmark.faults import planted
from benchmark.harness import load_cell, run_cell
from benchmark.spec import Spec

CELLS = [w["name"] for w in Spec().doc["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_and_its_control_is_not(cuda, name):
    spec = Spec()
    r = run_cell(spec, load_cell(spec, name, 2147483711, cuda), 1.0, False, time.time(),
                 control=True)
    assert r["correct"] is True, r["checks"]
    control = {k: v["value"] for k, v in r["checks_control"].items()}
    assert not compare.judge(control, spec.limits(name)), r["checks_control"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_fails(cuda, name):
    spec = Spec()
    cell = load_cell(spec, name, 2147483712, cuda)
    fault = "half_batch" if cell.traffic["kind"] == "train" else "answer"
    cell.method = planted(cell.method, fault)
    r = run_cell(spec, cell, 1.0, False, time.time())
    assert r["correct"] is False, r["checks"]
