"""The command without a card, and without the program: it exits non-zero
and prints no result."""
from __future__ import annotations

import os
import subprocess
import sys

from conftest import REPO, copy_benchmark

ARGS = ["-m", "benchmark.run", "--workload", "rpo_vit_b16-train_b4", "--seed", "2147483999",
        "--seconds", "1", "--trace", "0"]


def run(cwd, **env):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, **env))


def no_result(out) -> bool:
    return not any(line.strip().startswith("{") for line in out.stdout.splitlines())


def test_without_a_card():
    out = run(REPO, CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0 and no_result(out)
    assert "CUDA card" in out.stderr


def test_with_only_the_benchmark(tmp_path):
    root = copy_benchmark(tmp_path / "bare")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, *ARGS], cwd=root, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and no_result(out)


def test_an_unknown_workload():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "nope", "--seed",
                          "1", "--seconds", "1"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and no_result(out)
