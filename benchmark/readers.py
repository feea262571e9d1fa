"""What the per-layer metric readers share.

A reader (``metrics/<name>.py``) has ``read(r: Reading) -> float | None``.
It returns None where its run has nothing for it to read: another kind of
traffic, no traced window, or no device operation in it.  A kernel's
roofline share is the sum of its calls' bounds over the sum of their
device time; where the trace does not hold the calls the step's shapes
say it should, there is nothing sound to read, and it returns None.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Tuple

from . import yardstick
from .methods.common import Work
from .trace import Trace


@dataclasses.dataclass
class Reading:
    kind: str  # the traffic's kind: "train" or "eval"
    work: Work  # a step's (an eval batch's) operations and kernel calls
    peaks: Tuple[float, float]  # (bytes/s, FLOP/s) of the card
    steps: int  # steps (batches) of the measured window
    wall_s: float  # its length
    host_s: float  # the host's time inside the benchmark's calls into the program
    trace: Optional[Trace] = None  # the traced window, with ``--trace 1``
    traced_steps: int = 0


def traced(r: Reading, kind: str) -> Optional[Trace]:
    """The traced window of a run of ``kind`` that saw the device work."""
    if r.kind != kind or r.trace is None or not r.trace.ops() or r.traced_steps < 1:
        return None
    return r.trace


def roofline(r: Reading, kind: str, group: str) -> Optional[float]:
    """Percent of the least time the card could take for ``group``'s calls."""
    trace = traced(r, kind)
    calls = r.work.kernels.get(group)
    if trace is None or not calls:
        return None
    expected = len(calls) * r.traced_steps
    seen = trace.count(group)
    if seen != expected:
        print(f"{group}: {seen} calls in the traced window, the shapes say {expected}; "
              "its roofline is not read", file=sys.stderr)
        return None
    bw, peak = r.peaks
    bound_s = sum(yardstick.bound(b, f, bw, peak)[0] for b, f in calls) / 1e3 * r.traced_steps
    return 100.0 * bound_s / trace.op_seconds(group)


def idle_share(r: Reading, kind: str) -> Optional[float]:
    trace = traced(r, kind)
    if trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def device_ms(r: Reading, kind: str) -> Optional[float]:
    trace = traced(r, kind)
    return None if trace is None else trace.op_seconds() / r.traced_steps * 1e3


def host_ms(r: Reading, kind: str) -> Optional[float]:
    return None if r.kind != kind or r.steps < 1 else r.host_s / r.steps * 1e3


def mfu(r: Reading, kind: str) -> Optional[float]:
    if r.kind != kind or r.steps < 1 or r.wall_s <= 0:
        return None
    return 100.0 * r.work.flops * r.steps / r.wall_s / r.peaks[1]
