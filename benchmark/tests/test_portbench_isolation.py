"""What a run loads: never JAX nor the JAX package, compared by whole
top-level name; the reference loads nothing of the program either."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "rpo_tpu"}


def loaded_after(code: str, cwd=REPO) -> set:
    script = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_the_program_nor_jax():
    names = loaded_after("""
import torch
from benchmark import inputs
from benchmark.reference import clip, cocoop, precision, rpo, sgd, tokenizer
clip_cfg = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64, vision_heads=1,
                vision_patch_size=16, context_length=77, vocab_size=49408, text_width=64,
                text_heads=2, text_layers=2)
sd = inputs.state_dict(clip_cfg, 1, "cpu", dtype=torch.float32)
ref = rpo.RPOReference(sd, clip_cfg, ["red fox", "oak"], "a photo of a _.", 3)
state = {"text_prompt": torch.zeros(3, 64), "img_prompt": torch.zeros(3, 64)}
images = torch.zeros(2, 32, 32, 3, dtype=torch.uint8)
ref.logits(state, images, precision.EXACT)
""")
    assert not names & (FORBIDDEN | {"rpo_tpu_torch"})


def test_a_run_loads_no_jax(tiny_root):
    names = loaded_after(f"""
import sys, time
sys.path.insert(0, {str(REPO)!r})
from benchmark.kinds import train, eval as ev
train.WARM_STEPS = 1; train.TRACED_STEPS = 1; ev.TRACED_BATCHES = 1
from benchmark.spec import Spec
from benchmark.harness import load_cell, run_cell
spec = Spec({str(tiny_root)!r}, {str(tiny_root / 'benchmark')!r})
for name in ("rpo_tiny-train", "cocoop_tiny-eval"):
    run_cell(spec, load_cell(spec, name, 1, "cpu"), 0.2, True, time.time())
import benchmark.run, benchmark.calibrate, benchmark.faults
for m in spec.doc["per_layer"]:
    spec.reader(m["name"])
""")
    assert "rpo_tpu_torch" in names and "benchmark" in names
    assert not names & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "rpo_tpu_torch_extra", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rpo_tpu.engine", types.ModuleType("rpo_tpu.engine"))
    assert forbidden_modules() == ["rpo_tpu"]
