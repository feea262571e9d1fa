"""The trace's arithmetic and the readers, on hand-made events."""
from __future__ import annotations

import pytest

from benchmark import readers, yardstick
from benchmark.methods.common import Work
from benchmark.trace import parse

RECT = "void attention_kernel_tc<64, false, 13>(attention_tc::Params, int, long long, int)"


def event(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def make_trace():
    return parse([
        event("bench:window", 0, 100, "user_annotation"),
        event("bench:launch", 0, 10, "user_annotation"),
        event("bench:drain", 40, 30, "user_annotation"),
        event("aten::mm", 0, 5, "cpu_op"),
        event(RECT, 10, 20, "kernel"),  # 10-30
        event("gemm_kernel", 25, 10, "kernel"),  # overlaps: 25-35
        event("Memcpy HtoD", 50, 10, "gpu_memcpy"),  # 50-60
        event("late_gemm", 95, 20, "kernel"),  # clipped to 95-100
    ])


def test_busy_is_the_union_inside_the_window():
    t = make_trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx((25 + 10 + 5) * 1e-6)
    assert t.op_seconds() == pytest.approx((20 + 10 + 10 + 5) * 1e-6)
    assert t.count("rect_attention kernel") == 1


def test_gaps_are_labelled_by_the_open_span():
    gaps = make_trace().gaps()
    assert gaps[0] == ("drain", pytest.approx(35e-6))  # 60-95: the drain span is open at 60
    labels = dict((round(s * 1e6), n) for n, s in gaps)
    assert labels[10] == "launch"  # 0-10
    assert labels[15] == "harness"  # 35-50
    assert make_trace().label_at(45) == "drain"


def test_breakdown_lists_groups_and_gaps():
    b = make_trace().breakdown()
    assert b["device_ops"][0] == ["rect_attention kernel", pytest.approx(20e-6)]
    assert b["device_ops"][1] == ["matmul", pytest.approx(15e-6)]
    assert len(b["idle_gaps"]) == 3


def reading(trace, steps=1, kind="eval"):
    work = Work(1e9, {"rect_attention kernel": [yardstick.rect_attention_work(2, 2, 8, 8, 64)]})
    return readers.Reading(kind, work, (3.35e12, 989e12), 10, 2.0, 0.5, trace, steps)


def test_roofline_reads_bound_over_time():
    r = reading(make_trace())
    n_bytes, n_flops = yardstick.rect_attention_work(2, 2, 8, 8, 64)
    want = 100 * yardstick.bound(n_bytes, n_flops, 3.35e12, 989e12)[0] / 1e3 / 20e-6
    assert readers.roofline(r, "eval", "rect_attention kernel") == pytest.approx(want)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    t = make_trace()
    assert readers.roofline(reading(t, steps=2), "eval", "rect_attention kernel") is None
    assert readers.roofline(reading(t), "train", "rect_attention kernel") is None
    assert readers.roofline(reading(t), "eval", "fused_text_layer kernel") is None
    assert readers.idle_share(reading(None), "eval") is None
    assert readers.device_ms(reading(t, kind="train"), "eval") is None
    assert readers.host_ms(reading(t, kind="train"), "eval") is None


def test_idle_share_mfu_and_host_ms():
    r = reading(make_trace())
    assert readers.idle_share(r, "eval") == pytest.approx(60.0)
    assert readers.mfu(r, "eval") == pytest.approx(100 * 1e9 * 10 / 2.0 / 989e12)
    assert readers.host_ms(r, "eval") == pytest.approx(50.0)
    assert readers.device_ms(r, "eval") == pytest.approx(0.045)
