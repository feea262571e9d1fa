"""The port's spans (``rpo_tpu_torch.tracing``) and the benchmark's readers
of the host's split (``benchmark/host_split.py``), on the CPU at TINY.

Every span is stamped into a bounded record; under ``torch.profiler`` it
also enters an ``rpo:`` range, on the clock of the exported Chrome trace,
and its row is marked profiled.  The ``gpu`` case needs a card and skips
here: a replay of the captured step records its staging and launch under
its dispatch.  This file imports no JAX, so on the card's machine:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_tracing.py
"""
import contextlib
import importlib.util
import json
import os
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import host_split
from rpo_tpu_torch import tracing
from rpo_tpu_torch.engine.trainer import device_prefetch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSNAMES = ["a", "b", "c"]
K = 4
CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_record():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def rpo():
    from rpo_tpu_torch.methods.rpo_trainer import RPO
    from rpo_tpu_torch.models.clip.model import ARCHS, init_clip

    clip = init_clip(torch.Generator().manual_seed(0), ARCHS["TINY"])
    model = RPO(CLASSNAMES, K=K, backbone="TINY", prec="fp32", device="cpu", clip_params=clip)
    model.current_lr = 0.01
    return model


def batches(n, rows=2, side=32, classes=3):
    rng = np.random.RandomState(3)
    return [{"img": rng.randint(0, 256, (rows, side, side, 3)).astype(np.uint8),
             "label": rng.randint(0, classes, rows), "mask": np.ones(rows, np.float32)}
            for _ in range(n)]


def evaluate(model, host_batches, device):
    """``TrainerBase.test``'s loop: the prefetch's puts, then the logits."""
    return [model.model_inference_async(b["img"]).float().cpu()
            for b in device_prefetch(host_batches, device, keys=("img",))]


def test_no_profiler_stamps_and_enters_no_record_function(rpo, monkeypatch):
    """With no profiler a dispatch is stamped, unprofiled, and no
    ``record_function`` is entered; the eval path records nothing."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(tracing, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    data = batches(2)
    rpo.forward_backward(data[0])
    rpo.forward_backward_multi(data)
    evaluate(rpo, data, "cpu")
    rpo.model_inference(data[0]["img"])
    rows = tracing.spans()
    assert [(s.name, s.parent, s.profiled) for s in rows] == [("train_dispatch", -1, False)] * 2
    assert all(s.start_ns < s.end_ns for s in rows)
    assert tracing.summary()["train_dispatch"]["count"] == 2


def test_spans_under_a_profiler(rpo):
    """Three train dispatches under a profiler: one profiled span a call,
    in order; on the CPU the steps run eagerly and nothing nests."""
    data = batches(3)
    with profile(activities=CPU):
        for b in data:
            rpo.forward_backward(b)
        evaluate(rpo, data[:2], "cpu")
    rows = tracing.spans()
    assert [(s.name, s.parent, s.profiled) for s in rows] == [("train_dispatch", -1, True)] * 3
    assert all(s.start_ns < s.end_ns for s in rows)
    assert all(a.end_ns <= b.start_ns for a, b in zip(rows, rows[1:]))
    summary = tracing.summary()["train_dispatch"]
    assert summary["count"] == 3 and summary["total_ms"] > 0
    assert summary["self_ms"] == pytest.approx(summary["total_ms"])
    assert host_split.record() == [tuple(s) for s in rows]  # the benchmark reads the same rows


@pytest.mark.parametrize("profiled", [False, True])
def test_nesting_parents_and_self_time(profiled, monkeypatch):
    """Parents are the innermost open span; a span's self time is its
    duration less its children's; an open span has no end and stays out
    of the summary."""
    clock = iter(range(0, 100_000_000, 1_000_000))  # 1 ms a stamp
    monkeypatch.setattr(tracing, "time_ns", lambda: next(clock))
    with profile(activities=CPU) if profiled else contextlib.nullcontext():
        with tracing.span("outer"):  # 0 .. 7 ms
            with tracing.span("a"):  # 1 .. 2
                pass
            with tracing.span("b"):  # 3 .. 6
                with tracing.span("c"):  # 4 .. 5
                    assert tracing.spans()[-1].end_ns is None
                    assert "c" not in tracing.summary()
    rows = tracing.spans()
    assert [(s.name, s.parent, s.profiled) for s in rows] == [
        ("outer", -1, profiled), ("a", 0, profiled), ("b", 0, profiled), ("c", 2, profiled)]
    assert [(s.start_ns, s.end_ns) for s in rows] == [
        (0, 7_000_000), (1_000_000, 2_000_000), (3_000_000, 6_000_000), (4_000_000, 5_000_000)]
    assert tracing.summary() == {
        "outer": {"count": 1, "total_ms": 7.0, "self_ms": 3.0},
        "a": {"count": 1, "total_ms": 1.0, "self_ms": 1.0},
        "b": {"count": 1, "total_ms": 3.0, "self_ms": 2.0},
        "c": {"count": 1, "total_ms": 1.0, "self_ms": 1.0}}


def test_the_record_keeps_the_last_spans(monkeypatch):
    """The record holds the last ``LIMIT`` spans; a span whose parent was
    dropped has no parent row; ``reset`` empties it."""
    assert tracing._record.maxlen == tracing.LIMIT
    monkeypatch.setattr(tracing, "_record", deque(maxlen=4))
    with tracing.span("outer"):
        for name in "abcde":
            with tracing.span(name):
                pass
    with tracing.span("next"):
        with tracing.span("f"):
            pass
    rows = tracing.spans()
    assert [(s.name, s.parent) for s in rows] == [("d", -1), ("e", -1), ("next", -1), ("f", 2)]
    assert all(s.end_ns is not None for s in rows)
    tracing.reset()
    assert tracing.spans() == [] and tracing.summary() == {}


def test_spans_share_the_chrome_traces_clock(rpo, tmp_path):
    """Each profiled span lies within 1 ms of its ``rpo:`` event in the
    exported trace (``ts`` in microseconds plus ``baseTimeNanoseconds``)."""
    with profile(activities=CPU):  # the profiler's first range pays its set-up
        with tracing.span("warm"):
            pass
    tracing.reset()
    data = batches(2)
    with profile(activities=CPU) as prof:
        for b in data:
            rpo.forward_backward(b)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])
    events = sorted((float(e["ts"]) * 1e3 + base, (float(e["ts"]) + float(e["dur"])) * 1e3 + base)
                    for e in doc["traceEvents"]
                    if e.get("ph") == "X" and e.get("name") == tracing.PREFIX + "train_dispatch")
    rows = tracing.spans()
    assert len(events) == len(rows) == 2
    for s, (start, end) in zip(rows, events):
        assert abs(s.start_ns - start) < 1e6 and abs(s.end_ns - end) < 1e6, (s, start, end)


def test_the_engines_profiled_epoch_prints_its_spans(tmp_path):
    """TRAIN.PROFILE_DIR at the second of two epochs: the epoch's trace
    holds its dispatches, the log their summary (that epoch's alone), and
    the record is empty afterwards."""
    from tests.test_torch_port_cli import fixture_args, run_main

    out, prof_dir = str(tmp_path / "run"), tmp_path / "prof"
    trainer, log = run_main(fixture_args(out, opts=[
        "DATASET.SUBSAMPLE_CLASSES", "base", "TRAIN.PROFILE_DIR", str(prof_dir),
        "TRAIN.PROFILE_EPOCH", "2"]))
    assert trainer.epoch + 1 == 2
    assert f"span rpo:train_dispatch: {trainer.num_batches} calls, " in log
    assert "ms a call" in log and "Finish training" in log
    assert tracing.spans() == []
    names = [e.get("name") for e in json.loads(
        (prof_dir / "trace_epoch2.json").read_text())["traceEvents"]]
    assert names.count("rpo:train_dispatch") == trainer.num_batches


# -- the benchmark's readers, on hand-made records ------------------------------

TRAIN_CELLS = ["rpo_vit_b16-train_b4", "rpo_vit_b16-train_b4_n500"]
EVAL_CELLS = ["cocoop_vit_b16-eval_b100", "rpo_vit_b16-eval_b100", "rpo_vit_l14_336-eval_b100"]
# metric: (kind, ms of the window's first step, cells, layer)
READERS = {
    "stage_wait_ms.train": ("train", 1.0, TRAIN_CELLS, "Engine and staging"),
    "stage_copy_ms.train": ("train", 0.5, TRAIN_CELLS, "Engine and staging"),
    "replay_launch_ms.train": ("train", 0.25, TRAIN_CELLS, "Engine and staging"),
    "dispatch_self_ms.train": ("train", 4.0 - 1.75, TRAIN_CELLS, "Engine and staging"),
    "prefetch_put_ms.eval": ("eval", 0.3, EVAL_CELLS, "Engine and staging"),
    "eval_enqueue_ms.eval": ("eval", 2.0, EVAL_CELLS, "Method cores and CLIP model"),
}
MS = 1_000_000
SET_UP, WINDOW, TRACED = 2, 4, 3


def train_record():
    """Set-up's 2 steps (100 times as long), the window's 4 (step k k + 1
    times as long as the first) and the traced window's 3, profiled (1000
    times): a dispatch of 4 ms holding a wait of 1, a copy of 0.5 and a
    replay of 0.25."""
    rows = []
    scales = [(100, False)] * SET_UP + [(k + 1, False) for k in range(WINDOW)] + [
        (1000, True)] * TRACED
    for k, (f, profiled) in enumerate(scales):
        t, top = 10_000 * MS * k, len(rows)
        for name, a, b in (("train_dispatch", 0, 4), ("stage_wait", 0.1, 1.1),
                           ("stage_copy", 1.1, 1.6), ("replay", 2.0, 2.25)):
            rows.append((name, t + int(a * f * MS), t + int(b * f * MS),
                         -1 if name == "train_dispatch" else top, profiled))
    return rows


def eval_trace():
    """The benchmark's spans of a traced eval window, in microseconds:
    batch k's put 0.3 ms and launch 2 ms, k + 1 times; one more put that
    finds the end; the drains."""
    spans = []
    for k in range(TRACED):
        t, f = 100_000.0 * k, k + 1
        spans += [("prefetch put", t, t + 300.0 * f), ("launch", t + 500, t + 500 + 2000.0 * f),
                  ("drain", t + 3000, t + 9000)]
    return SimpleNamespace(window=(0.0, 1e6), spans=spans + [("prefetch put", 9e5, 9e5 + 1.0)])


def reading(kind, steps=WINDOW, traced_steps=TRACED, trace=True):
    """What the readers take of a run's reading."""
    if trace:
        trace = eval_trace() if kind == "eval" else SimpleNamespace(window=(0.0, 1e6), spans=[])
    return SimpleNamespace(kind=kind, steps=steps, traced_steps=traced_steps,
                           trace=trace or None)


def reader(metric):
    path = os.path.join(REPO, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("metric", sorted(READERS))
def test_host_split_readers(metric, monkeypatch):
    kind, ms, cells, layer = READERS[metric]
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        entry = next(m for m in json.load(f)["per_layer"] if m["name"] == metric)
    assert entry == {"name": metric, "unit": "ms", "better": "lower", "source": "host_clock",
                     "layer": layer, "moves": f"{kind}_images_per_s", "workloads": cells}
    read = reader(metric)
    other = "eval" if kind == "train" else "train"
    rows = train_record()
    monkeypatch.setattr(host_split, "record", lambda: rows)
    assert read(reading(other)) is None
    assert read(reading(kind, trace=False)) is None
    if kind == "eval":
        end = 0.001 if metric == "prefetch_put_ms.eval" else 0.0  # the put that finds the end
        assert read(reading(kind)) == pytest.approx((ms * (1 + 2 + 3) + end) / TRACED)
        assert read(reading(kind, traced_steps=TRACED - 1)) is None  # a span more than batches
        return
    # the measured window's steps alone, neither set-up's nor the traced ones
    assert read(reading(kind)) == pytest.approx(ms * (1 + 2 + 3 + 4) / WINDOW)
    # more steps than the record keeps unprofiled: every one it kept
    assert read(reading(kind, steps=WINDOW + SET_UP + 5)) == pytest.approx(
        (100 * 2 * ms + ms * 10) / (WINDOW + SET_UP))
    assert read(reading(kind, steps=2)) == pytest.approx(ms * (3 + 4) / 2)
    assert read(reading(kind, traced_steps=TRACED + 1)) is None  # an unprofiled one among them
    assert read(reading(kind, traced_steps=TRACED - 1)) is None  # a profiled one before them
    rows[-13] = rows[-13][:2] + (None,) + rows[-13][3:]  # the window's last replay, open
    assert read(reading(kind)) is None
    monkeypatch.setattr(host_split, "record", lambda: None)  # a program without the record
    assert read(reading(kind)) is None


# -- on the card ------------------------------------------------------------------

@pytest.mark.gpu
def test_a_replay_is_staged_and_launched_under_its_dispatch_on_gpu():
    """A replay of the captured step, with no profiler and under one: its
    wait, its copies and its launch, once each, under the dispatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.methods.rpo_trainer import RPO

    model = RPO([f"object category {i}" for i in range(6)], K=4, backbone="TINY_W128",
                prec="fp16", seed=1)
    model.current_lr = 0.01
    data = batches(3, rows=4, classes=6)
    model.forward_backward(data[0])  # the capture
    torch.cuda.synchronize()
    for profiled, batch in ((False, data[1]), (True, data[2])):
        tracing.reset()
        with (profile(activities=CPU + [ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()):
            model.forward_backward(batch)
            torch.cuda.synchronize()
        rows = tracing.spans()
        assert [(s.name, s.parent, s.profiled) for s in rows] == [
            ("train_dispatch", -1, profiled), ("stage_wait", 0, profiled),
            ("stage_copy", 0, profiled), ("replay", 0, profiled)]
        summary = tracing.summary()
        dispatch = summary["train_dispatch"]
        assert 0 < dispatch["self_ms"] <= dispatch["total_ms"]
        assert dispatch["total_ms"] - dispatch["self_ms"] == pytest.approx(
            sum(summary[n]["total_ms"] for n in ("stage_wait", "stage_copy", "replay")))
