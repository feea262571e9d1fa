"""One run of one cell: set-up, the measured window, the traced window,
the check, and the result line.

``run_cell`` takes the device it is given: the command (``run.py``)
gives it the card after its own checks; the tests give it the CPU.
"""
from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time
from types import ModuleType
from typing import Dict

import torch

from . import compare
from .readers import Reading
from .reference import precision
from .spec import Spec
from .trace import TracedWindow
from .yardstick import peaks

FORBIDDEN = ("jax", "jaxlib", "flax", "rpo_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    device: torch.device
    method: ModuleType
    kind: ModuleType

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def load_cell(spec: Spec, name: str, seed: int, device) -> Cell:
    w = spec.workload(name)
    config = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    return Cell(name, config, traffic, spec.limits(name), int(seed), torch.device(device),
                spec.method(config["method"]), spec.kind(traffic["kind"]))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> Dict[str, object]:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    out = {"kind": torch.cuda.get_device_name(0)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        out["nvidia_smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"not read: {e}"
    return out


def run_cell(spec: Spec, cell: Cell, seconds: float, trace: bool, t_start: float,
             control: bool = False) -> dict:
    """The result line's object.  ``t_start``: the process's start on
    ``time.time()``'s clock.  ``control`` adds the numbers of the
    reference in the control's precision (``checks_control``)."""
    session = cell.kind.Session(cell)
    setup_s = time.time() - t_start
    print("set-up: " + ", ".join(f"{name} {sec:.3f} s" for name, sec in session.phases.seen)
          + f"; {setup_s:.3f} s from the process's start", file=sys.stderr)
    win = session.window(seconds)
    traced, traced_steps = None, 0
    if trace:
        with TracedWindow(cell.cuda) as tw:
            traced_steps = session.traced(tw)
        traced = tw.trace
    device: Dict[str, object] = {"platform": "gpu" if cell.cuda else "cpu", "count": 1}
    if cell.cuda:
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(cell.device))
        device.update(card())
        bw_peak = peaks(str(device["kind"]))
    else:
        device.update(kind="cpu", memory_peak_bytes=0)
        bw_peak = peaks("")
    work = cell.method.work(cell.config, cell.traffic, session.classnames)
    reading = Reading(cell.traffic["kind"], work, bw_peak, win["steps"], win["wall_s"],
                      win["host_s"], traced, traced_steps)
    session.release()
    numbers = session.check(precision.EXACT)
    result = {"correct": compare.judge(numbers, cell.limits) and win["failed"] == 0,
              "attempted": win["steps"], "failed": win["failed"]}
    metrics = {}
    if trace:
        for m in spec.per_layer(cell.name):
            value = spec.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if traced is not None and cell.cuda:
            device["busy_s"] = traced.busy_s()
            device["window_s"] = traced.window_s
    else:
        measured = dict(win["metrics"], setup_s=setup_s)
        for m in spec.end_to_end(cell.name):
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device
    if trace and traced is not None:
        result["breakdown"] = traced.breakdown()
    if control:
        result["checks_control"] = compare.checks(session.check(precision.E4M3), cell.limits)
    result["checks"] = compare.checks(numbers, cell.limits)
    return result
