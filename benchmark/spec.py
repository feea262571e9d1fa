"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` of its ``configs`` entry (under
  ``configs/``), whose ``method`` names ``methods/<method>.py``;
- a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names
  ``kinds/<kind>.py``;
- a cell's limits on the numbers compared: ``limits/<cell>.json``;
- a per-layer metric's reader: ``metrics/<metric>.py``.

A new configuration, traffic mix, cell or metric is a new file and a new
entry: no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


class Spec:
    def __init__(self, root: Path = HERE.parent, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.doc = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in self.doc['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, workload: str) -> Dict[str, float]:
        with open(self.dir / "limits" / f"{workload}.json") as f:
            return {k: float(v) for k, v in json.load(f)["limits"].items()}

    @staticmethod
    def applies(entry: dict, workload: str) -> bool:
        return "workloads" not in entry or workload in entry["workloads"]

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.doc["end_to_end"] if self.applies(m, workload)]

    def per_layer(self, workload: str) -> List[dict]:
        return [m for m in self.doc["per_layer"] if self.applies(m, workload)]

    def reader(self, metric: str) -> ModuleType:
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    @staticmethod
    def method(name: str) -> ModuleType:
        return importlib.import_module(f"benchmark.methods.{name}")

    @staticmethod
    def kind(name: str) -> ModuleType:
        return importlib.import_module(f"benchmark.kinds.{name}")
