"""Fixtures of the benchmark's tests: a copy of the benchmark with TINY
cells added as files, and the card (skips without one)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# CLIP's structure at test size (the port's TINY: 32 px, 2 layers, width 64)
TINY_CLIP = {"embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
             "vision_heads": 1, "vision_patch_size": 16, "context_length": 77,
             "vocab_size": 49408, "text_width": 64, "text_heads": 2, "text_layers": 2}
TINY_CELLS = {  # cell: (full-size cell whose config, traffic and limits it shrinks)
    "rpo_tiny-train": "rpo_vit_b16-train_b4",
    "rpo_tiny-eval": "rpo_vit_b16-eval_b100",
    "cocoop_tiny-eval": "cocoop_vit_b16-eval_b100",
}


def add_tiny_cells(root: Path) -> None:
    """Add the TINY configurations, traffic mixes, cells and limits to the
    benchmark under ``root`` as new files and new entries."""
    doc = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    for cell, full in TINY_CELLS.items():
        w = next(x for x in doc["workloads"] if x["name"] == full)
        config, traffic = cell.split("-")[0], f"{w['traffic']}_tiny"
        if not any(c["name"] == config for c in doc["configs"]):
            entry = next(c for c in doc["configs"] if c["name"] == w["config"])
            data = json.loads((root / entry["file"]).read_text())
            data["clip"] = TINY_CLIP
            (bench / "configs" / f"{config}.json").write_text(json.dumps(data))
            doc["configs"].append(dict(entry, name=config,
                                       file=f"benchmark/configs/{config}.json"))
        data = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        data.update(pool=6, n_cls=7, batch=min(data["batch"], 10))
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(data))
        shutil.copy(bench / "limits" / f"{full}.json", bench / "limits" / f"{cell}.json")
        doc["workloads"].append(dict(w, name=cell, config=config, traffic=traffic))
        for m in doc["end_to_end"] + doc["per_layer"]:
            if full in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))


def copy_benchmark(dst: Path) -> Path:
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_benchmark(tmp_path / "checkout")
    add_tiny_cells(root)
    return root


@pytest.fixture
def tiny_spec(tiny_root):
    from benchmark.spec import Spec

    return Spec(tiny_root, tiny_root / "benchmark")


@pytest.fixture
def short_runs(monkeypatch):
    """Fewer warm and traced steps, for the CPU."""
    from benchmark.kinds import eval as eval_kind
    from benchmark.kinds import train

    monkeypatch.setattr(train, "WARM_STEPS", 1)
    monkeypatch.setattr(train, "TRACED_STEPS", 2)
    monkeypatch.setattr(eval_kind, "TRACED_BATCHES", 2)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
