"""The host's split of a train step or an eval batch, per-layer metrics.

Train, from the program's own spans (``rpo_tpu_torch.tracing``): the port
stamps every span into a bounded record, and marks those that opened
while a ``torch.profiler`` recorded.  The readers take the record in the
same process after the run, and read the measured window: the record
ends in the traced window's ``r.traced_steps`` top ``train_dispatch``
spans, all profiled, and the window's are the ``r.steps`` unprofiled ones
before them (where the record has dropped the window's first steps, the
ones it kept).  The profiler's cost lands inside the spans it
watches, so the traced window's spans are only checked, never read.  The
arithmetic (sums, self time, the counts) is the benchmark's own.

Eval, from the benchmark's own ``prefetch put`` and ``launch`` spans in
the traced window (``benchmark/kinds/eval.py``): the host's time in the
prefetch's next batch and in the trainer's eval step, under the profiler.

A reader gives None where there is nothing sound to read: a run of
another kind, no traced window, a program without the record, or counts
that do not match the run's steps.
"""
from __future__ import annotations

import sys
from typing import List, Optional, Tuple

TOP = "train_dispatch"
Row = Tuple[str, int, Optional[int], int, bool]  # name, start ns, end ns, parent row, profiled


def record() -> Optional[List[Row]]:
    """The program's record, or None where the program keeps none."""
    try:
        from rpo_tpu_torch import tracing
    except ImportError:
        return None
    return [tuple(s) for s in tracing.spans()]


def _skip(name: str, why: str) -> None:
    print(f"host split: {why}; {name} is not read", file=sys.stderr)


def train_ms(r, name: str, self_time: bool = False) -> Optional[float]:
    """The milliseconds a measured step of the spans ``name`` (their self
    time: each one's duration less its children's) inside the window's
    ``train_dispatch`` spans."""
    if r.kind != "train" or r.trace is None or r.traced_steps < 1 or r.steps < 1:
        return None
    rows = record()
    if rows is None:
        return None
    tops = [i for i, (n, _, _, parent, _) in enumerate(rows) if n == TOP and parent < 0]
    traced = [rows[i][4] for i in tops[-r.traced_steps:]]
    window = []  # the unprofiled tops just before the traced ones, the last first
    for i in reversed(tops[:-r.traced_steps]):
        if rows[i][4] or len(window) == r.steps:
            break
        window.append(i)
    if len(traced) != r.traced_steps or not all(traced) or not window:
        _skip(name, f"the record ends in {sum(traced)} profiled {TOP} for "
                    f"{r.traced_steps} traced steps, after {len(window)} unprofiled")
        return None
    top = list(range(len(rows)))  # each row's outermost span
    for i, (_, _, _, parent, _) in enumerate(rows):
        if parent >= 0:
            top[i] = top[parent]
    chosen = set(window)
    total = 0
    for i, (n, start, end, parent, _) in enumerate(rows):
        if top[i] not in chosen:
            continue
        if end is None:
            _skip(name, f"a {n} span of the window is still open")
            return None
        if n == name:
            total += end - start
        if self_time and parent >= 0 and rows[parent][0] == name:
            total -= end - start
    return total / len(window) / 1e6


def eval_ms(r, bench_span: str, extra: int = 0) -> Optional[float]:
    """The milliseconds a traced batch in the benchmark's ``bench_span``
    spans, of which the window holds one a batch and ``extra`` more."""
    if r.kind != "eval" or r.trace is None or r.traced_steps < 1:
        return None
    durations = [b - a for n, a, b in r.trace.spans if n == bench_span]
    if len(durations) != r.traced_steps + extra:
        _skip(bench_span, f"{len(durations)} spans for {r.traced_steps} traced batches")
        return None
    return sum(durations) / r.traced_steps / 1e3  # the trace's microseconds
