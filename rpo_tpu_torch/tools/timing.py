"""Three timers of a call ``fn()`` on the card.

- ``call_ms``: the median over calls, each between its own CUDA events and
  synchronised, so every time holds the host's launch of the call;
- ``stream_ms``: CUDA events around calls made back to back, over their
  number: the host launches the next call while the card runs this one,
  so a kernel longer than its launch is timed alone, a shorter one shows
  the launch's cost;
- ``device_ms``: the device time of the kernels the calls launch, under
  ``torch.profiler``: no host time at all (``device_ms_by_kernel``: the
  same by kernel name).

``kernel_group`` names the group of a device operation by its kernel's
name, as ``chip_smoke.py``'s profiles and ``tools/profile_step.py`` rank
them.

A kernel of a few microseconds reads several times apart on the three, so
two versions are compared on one timer only, and within one process.
"""
from __future__ import annotations

import statistics
from typing import Callable, Dict, Optional

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
    calls under torch.profiler, or None (not measured): the sum of
    ``device_ms_by_kernel``."""
    by_kernel = device_ms_by_kernel(fn, n)
    return None if by_kernel is None else sum(by_kernel.values())


def device_ms_by_kernel(fn: Callable[[], object], n: int) -> Optional[Dict[str, float]]:
    """The mean device ms a call of each kernel ``fn()`` launches, by kernel
    name, over ``n`` calls under torch.profiler.  A profiler window can come
    back without its kernels: such a window is taken again, up to three
    times, and after that the result is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by_name = {e.key: e.self_device_time_total / n / 1e3 for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0}
        if by_name:
            return by_name
    return None


def fmt_ms(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def kernel_group(name: str) -> str:
    """The group of a device operation, by its kernel's name."""
    n = name.lower()
    return ("fused_text_layer kernel" if "fused_text_layer" in n
            else "fused_rect_attn_half kernel" if "fused_rect_attn_half" in n
            else "fused_mlp_half kernel" if "fused_mlp_half" in n
            else "masked_attention kernel" if "attention_kernel" in n and "true" in n
            else "rect_attention kernel" if "attention_kernel" in n
            else "conv (cuDNN)" if any(w in n for w in ("fprop", "implicit_gemm", "cudnn",
                                                        "winograd", "conv2d", "convolve"))
            else "batch_norm" if "batch_norm" in n or "bn_fw" in n
            else "pooling" if "pool" in n
            else "matmul" if any(w in n for w in ("gemm", "cutlass", "xmma", "nvjet", "sm90"))
            else "layer_norm" if "layer_norm" in n
            else "softmax/reduce" if any(w in n for w in ("softmax", "reduce"))
            else "copy/cast" if any(w in n for w in ("copy", "memcpy", "cat", "nchwtonhwc",
                                                     "nhwctonchw"))
            else "elementwise" if "elementwise" in n
            else "other")
