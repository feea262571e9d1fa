"""Three timers of a call ``fn()`` on the card.

- ``call_ms``: the median over calls, each between its own CUDA events and
  synchronised, so every time holds the host's launch of the call;
- ``stream_ms``: CUDA events around calls made back to back, over their
  number: the host launches the next call while the card runs this one,
  so a kernel longer than its launch is timed alone, a shorter one shows
  the launch's cost;
- ``device_ms``: the device time of the kernels the calls launch, under
  ``torch.profiler``: no host time at all.

A kernel of a few microseconds reads several times apart on the three, so
two versions are compared on one timer only, and within one process.
"""
from __future__ import annotations

import statistics
from typing import Callable, Optional

import torch


def call_ms(fn: Callable[[], object], n: int, warmup: int = 3) -> float:
    """Median ms of ``fn()`` over ``n`` calls, CUDA events around each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_ms(fn: Callable[[], object], n: int, warmup: int = 3) -> float:
    """ms a call of ``fn()``: CUDA events around ``n`` calls made back to
    back, over n."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn: Callable[[], object], n: int) -> Optional[float]:
    """Mean device time a call of the kernels ``fn()`` launches, over ``n``
    calls under torch.profiler.  A profiler window can come back without
    its kernels: such a window is taken again, up to three times, and
    after that the time is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / n / 1e3
    return None


def fmt_ms(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"
