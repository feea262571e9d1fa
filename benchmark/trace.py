"""The traced window: ``torch.profiler`` over a few steps, with the
benchmark's own spans, read back from its Chrome trace.

Spans are ``record_function`` ranges named ``bench:<what>`` around the
calls the benchmark makes into the program; the trace puts them and the
device's operations (kernels, copies, sets) on one clock.  The trace is
written under the temporary directory (``tempfile``), read and deleted.

From it: the device's busy time (the union of its operations' intervals
inside the window), each operation's time, the kernel groups, and the
idle gaps, each labelled by the innermost span that was open when it
began ("harness" where none was).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .yardstick import kernel_group

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench:"
Interval = Tuple[str, float, float]  # (name, start us, end us)


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]  # us
    device: List[Interval]
    spans: List[Interval]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def ops(self) -> List[Interval]:
        """Device operations inside the window, clipped to it."""
        w0, w1 = self.window
        return [(n, max(a, w0), min(b, w1)) for n, a, b in self.device if b > w0 and a < w1]

    def busy_s(self) -> float:
        total, end = 0.0, None
        for _, a, b in sorted(self.ops(), key=lambda e: e[1]):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e6

    def op_seconds(self, group: Optional[str] = None) -> float:
        """The summed time of the operations (of one kernel group)."""
        return sum(b - a for n, a, b in self.ops()
                   if group is None or kernel_group(n) == group) / 1e6

    def count(self, group: str) -> int:
        return sum(1 for n, _, _ in self.ops() if kernel_group(n) == group)

    def groups(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, a, b in self.ops():
            out[kernel_group(n)] += (b - a) / 1e6
        return dict(out)

    def gaps(self) -> List[Tuple[str, float]]:
        """The idle gaps inside the window, longest first, each labelled by
        the innermost span open at its start."""
        w0, w1 = self.window
        cursor, out = w0, []
        for _, a, b in sorted(self.ops(), key=lambda e: e[1]) + [("", w1, w1)]:
            if a > cursor:
                out.append((self.label_at(cursor), (a - cursor) / 1e6))
            cursor = max(cursor, b)
        return sorted(out, key=lambda g: -g[1])

    def label_at(self, t: float) -> str:
        best = None
        for name, a, b in self.spans:
            if a <= t < b and (best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        return "harness" if best is None else best[0]

    def breakdown(self, top: int = 10) -> dict:
        groups = sorted(self.groups().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[g, s] for g, s in groups],
                "idle_gaps": [[n, s] for n, s in self.gaps()[:top]]}


def parse(events: List[dict]) -> Optional[Trace]:
    """A Trace of Chrome trace events, or None without the window span."""
    device, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        name, cat = e.get("name", ""), e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((name, start, end))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            if name == PREFIX + "window":
                window = (start, end)
            else:
                spans.append((name[len(PREFIX):], start, end))
    return None if window is None else Trace(window, device, spans)


class TracedWindow:
    """``with TracedWindow(cuda) as tw:`` profile the body; ``tw.span(name)``
    labels a call; ``tw.trace`` holds the parsed trace afterwards."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity

        self.activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.trace: Optional[Trace] = None
        self._stack = contextlib.ExitStack()

    @staticmethod
    def span(name: str):
        from torch.profiler import record_function

        return record_function(PREFIX + name)

    def __enter__(self) -> "TracedWindow":
        from torch.profiler import profile

        self.prof = self._stack.enter_context(profile(activities=self.activities))
        self._stack.enter_context(self.span("window"))
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()
        if exc[0] is not None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = parse(json.load(f).get("traceEvents", []))
        finally:
            os.unlink(path)
