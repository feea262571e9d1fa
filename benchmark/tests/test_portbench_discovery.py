"""A configuration, a traffic mix, a cell and a per-layer metric added as
files and entries, with no file of the benchmark edited: the harness
finds them and runs the new cell (on the CPU, in a fresh process)."""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

from conftest import REPO, add_tiny_cells, copy_benchmark

READER = '''"""``steps_seen.train``: the window's steps."""


def read(r):
    return float(r.steps) if r.kind == "train" else None
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()}


def test_new_files_and_entries_are_found(tmp_path):
    root = copy_benchmark(tmp_path / "checkout")
    before = digests(root)
    add_tiny_cells(root)
    (root / "benchmark" / "metrics" / "steps_seen.train.py").write_text(READER)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "Engine and staging",
                             "moves": "train_images_per_s", "workloads": ["rpo_tiny-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    after = digests(root)
    assert all(after[p] == d for p, d in before.items()), "a file of the benchmark changed"
    assert len(after) > len(before)

    script = f"""
import json, sys, time
sys.path.append({str(REPO)!r})
from benchmark.kinds import train
train.WARM_STEPS = 1; train.TRACED_STEPS = 2
from benchmark.spec import Spec
from benchmark.harness import load_cell, run_cell
spec = Spec()
print(json.dumps(run_cell(spec, load_cell(spec, "rpo_tiny-train", 5, "cpu"), 0.3, True, time.time())))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, timeout=900, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["steps_seen.train"]["value"] == result["attempted"] >= 1
    assert "host_ms_per_step.train" in result["metrics"]
    assert "eval_images_per_s" not in result["metrics"]
