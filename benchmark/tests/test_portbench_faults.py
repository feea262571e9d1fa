"""The check, driven through a whole run at TINY on the CPU (the card's
look skipped), with the timed path broken underneath: each fault a cell
can have turns ``correct`` false, the control (the reference in float8 in
the program's place) fails one of the cell's numbers, and the sound
program passes, all under the full-size cells' limits."""
from __future__ import annotations

import time

import pytest

from benchmark import compare
from benchmark.faults import planted
from benchmark.harness import load_cell, run_cell


def run(spec, name, fault="", control=False, seed=11):
    cell = load_cell(spec, name, seed, "cpu")
    if fault:
        cell.method = planted(cell.method, fault)
    return run_cell(spec, cell, 0.3, False, time.time(), control=control)


@pytest.mark.parametrize("name", ["rpo_tiny-train", "rpo_tiny-eval", "cocoop_tiny-eval"])
def test_sound_program_passes_and_control_fails(tiny_spec, short_runs, name):
    r = run(tiny_spec, name, control=True)
    assert r["correct"] is True, r["checks"]
    control = {k: v["value"] for k, v in r["checks_control"].items()}
    assert not compare.judge(control, tiny_spec.limits(name)), r["checks_control"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "label"])
def test_train_faults_fail(tiny_spec, short_runs, fault):
    r = run(tiny_spec, "rpo_tiny-train", fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", ["rpo_tiny-eval", "cocoop_tiny-eval"])
def test_an_altered_answer_fails(tiny_spec, short_runs, name):
    r = run(tiny_spec, name, "answer")
    assert r["correct"] is False, r["checks"]


def test_judge():
    assert compare.judge({"a": 1.0}, {"a": 1.0})
    assert not compare.judge({"a": 1.5}, {"a": 1.0})
    assert not compare.judge({"a": float("nan")}, {"a": 1.0})
    assert not compare.judge({"a": 0.1}, {"a": 1.0, "b": 1.0})
    assert compare.judge({"a": 0.1, "b": 9.0}, {"a": 1.0})
    assert not compare.judge({"a": 0.1}, {})
    assert list(compare.checks({"a": 0.1, "b": 9.0}, {"a": 1.0})) == ["a"]
