"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/rpo_tpu_torch/lib<name>-<hash>.so`` at the repository root
(``.gitignore`` lists ``build/``), where the hash covers the source, every
header under ``csrc/`` and the flags, so an edited source or header is
rebuilt.  No PyTorch header is included: nvcc takes seconds per source
instead of minutes.

A build happens at the first launch of a kernel, never at import.  A
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rpo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")


def _target(name: str) -> Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    """Start nvcc on one source; it writes to a temporary file first."""
    target = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build the named sources that are not built yet, one nvcc each, all
    started together.  Returns each name's build log ("" if it was
    already built).  Raises if any build fails."""
    jobs = {}
    logs = {}
    for name in names:
        if _target(name).exists():
            logs[name] = ""
        else:
            jobs[name] = _start(name)
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def build_all() -> Tuple[float, Dict[str, str]]:
    """Build every CUDA source of the package in parallel; returns
    (seconds, logs)."""
    t0 = time.perf_counter()
    logs = build(sorted(p.stem for p in CSRC.glob("*.cu")))
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib
