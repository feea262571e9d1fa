"""The port stands alone: no jax and no rpo_tpu import, and entry points
that need a CUDA card unless the caller names another device."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "rpo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    """Top-level module names a file imports (absolute imports only)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_rpo_tpu_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "rpo_tpu"}, roots


def test_importing_the_port_loads_neither_jax_nor_rpo_tpu():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "rpo_tpu_torch").rglob("*.py")
    )
    assert {
        "rpo_tpu_torch.ops.masked_attention",
        "rpo_tpu_torch.ops.fused_text_layer",
        "rpo_tpu_torch.ops.fused_rect_layer",
        "rpo_tpu_torch.methods.cocoop",
        "rpo_tpu_torch.methods.coop",  # the CoOp trainer lives beside its functions
        "rpo_tpu_torch.methods.zsclip",
        "rpo_tpu_torch.methods.templates",
        "rpo_tpu_torch.engine.optim",  # SGD and lr_at_epoch, a copy of rpo_tpu's
    } <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rpo_tpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from rpo_tpu_torch.device import resolve_device
    from rpo_tpu_torch.methods.cocoop import CoCoOp
    from rpo_tpu_torch.methods.coop import CoOp
    from rpo_tpu_torch.methods.rpo_trainer import RPO
    from rpo_tpu_torch.methods.zsclip import ZeroshotCLIP, ZeroshotCLIP2

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RPO(["cat", "dog"], K=2, backbone="TINY")
    from rpo_tpu_torch.ops.fused_rect_layer import fused_rect_residual_block
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RPO(["cat", "dog"], K=2, backbone="TINY", vision_layer=fused_rect_residual_block)
    for cls in (CoOp, CoCoOp, ZeroshotCLIP, ZeroshotCLIP2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(["cat", "dog"], backbone="TINY")
    assert resolve_device("cpu") == torch.device("cpu")
    CoCoOp(["cat", "dog"], backbone="TINY", device="cpu")


def test_no_fallback_around_the_kernels():
    """On a CUDA tensor a wrapper launches its kernel or raises: no
    ``try`` in the kernel modules that could fall back to the plain
    version.  The selftest (``ops/selftest.py``) catches a check's
    exception to report it, which is its job: its handlers call nothing
    but what records the failure, so none can route around a kernel."""
    for path in (ROOT / "rpo_tpu_torch" / "ops").glob("*.py"):
        tree = ast.parse(path.read_text())
        if path.name == "selftest.py":
            handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
            assert handlers
            called = {getattr(c.func, "id", getattr(c.func, "attr", None))
                      for h in handlers for c in ast.walk(h) if isinstance(c, ast.Call)}
            assert called <= {"Reading", "type", "print_exc", "is_cuda_error"}, called
            continue
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path.name
