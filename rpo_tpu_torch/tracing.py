"""Spans of the port's train loop and dispatch, and counters, on the profiler's clock.

``span(name)`` marks one stretch of the host's work.  There is no switch:

- every span is stamped into a bounded record in memory (the last
  ``LIMIT`` spans), about two microseconds a span, so that the host's split
  of an ordinary run, with no profiler, can be read;
- while a ``torch.profiler`` records in the process, a span also enters
  ``record_function("rpo:" + name)``, so that it appears in every exported
  trace beside the kernels and copies, and its row is marked ``profiled``.
  The profiler's own cost lands inside the spans it watches (a graph
  launch runs many times slower under it), so a profiled span's length is
  not an ordinary run's.

The stamps are ``time.time_ns()``, the clock of an exported Chrome trace
(an event's ``ts`` in microseconds plus the trace's
``baseTimeNanoseconds``), taken outside the ``record_function`` so that a
span covers its event.  The engine's profiled epoch (TRAIN.PROFILE_DIR)
prints its spans' ``summary()``.

The spans, one a call each:

  train_dispatch  ``CLIPMethodTrainer._dispatch``: a ``forward_backward``
                  or ``forward_backward_multi`` on the host, either path
  stage_wait      ``StepGraph._load``: the wait on the last copy out of
                  the pinned staging buffers
  stage_copy      the rest of ``_load``: the staging copies, the
                  non-blocking copies to the device, the event
  replay          ``StepGraph.run``: ``graph.replay()``
  loader_wait     ``engine/trainer.py`` ``_waited``: the epoch loop's wait
                  for the loader's next batch (and the one that finds the
                  epoch's end), outside ``train_dispatch``

``count(name)`` stamps an instant row into the same record (start equal
to end, the innermost open span as its parent, marked ``profiled`` as a
span is), entering no ``record_function``.  The counters, one a launch
made from Python:

  rect_split_row  ``ops/rect_attention.py``: a bf16 launch whose score row
                  is split across the warps of a group (the kernel's
                  split-row route: head dim 64, 257 to 624 keys)
  rect_two_pass   ``ops/rect_attention.py``: a bf16 launch whose padded key
                  width exceeds the widest score row a warp holds in
                  registers, and which the split-row route does not take
                  (the kernel's two-pass route)
  rect_registers  every other bf16 launch of the rect kernel

A replay of a captured CUDA graph runs its launches without passing
through Python and counts none of them.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from time import time_ns
from typing import Deque, Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

PREFIX = "rpo:"
LIMIT = 1 << 16  # spans kept: over 16,000 train steps


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    parent: int  # the row of the innermost span open at the start; -1: none, or not kept
    profiled: bool  # a profiler recorded while it opened


# rows [name, start, end, parent's id, profiled, id]; a deque's append and
# copy are atomic, so threads share the record without a lock
_record: Deque[list] = deque(maxlen=LIMIT)
_ids = itertools.count()
_local = threading.local()  # each thread's stack of open spans' ids


class span:
    """``with span(name):`` stamps ``name`` into the record (and the trace,
    under a profiler)."""

    __slots__ = ("name", "row", "event")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        stack = _local.__dict__.setdefault("stack", [])
        profiled = torch.autograd._profiler_enabled()
        ident = next(_ids)
        self.row = row = [self.name, 0, None, stack[-1] if stack else -1, profiled, ident]
        stack.append(ident)
        _record.append(row)
        row[1] = time_ns()
        self.event = record_function(PREFIX + self.name) if profiled else None
        if self.event is not None:
            self.event.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.event is not None:
            self.event.__exit__(*exc)
        self.row[2] = time_ns()
        _local.stack.pop()


def count(name: str) -> None:
    """Stamp one ``name`` event into the record: an instant row."""
    stack = _local.__dict__.get("stack")
    now = time_ns()
    _record.append([name, now, now, stack[-1] if stack else -1,
                    torch.autograd._profiler_enabled(), next(_ids)])


def spans() -> List[Span]:
    """The record, in the order the spans opened; a parent is a row of it."""
    rows = _record.copy()
    at = {row[5]: i for i, row in enumerate(rows)}
    return [Span(name, start, end, at.get(parent, -1), profiled)
            for name, start, end, parent, profiled, _ in rows]


def summary() -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "total_ms", "self_ms"}}`` over the closed spans;
    a span's self time is its duration less its children's."""
    record = spans()
    children = [0] * len(record)
    for s in record:
        if s.end_ns is not None and s.parent >= 0:
            children[s.parent] += s.end_ns - s.start_ns
    out: Dict[str, Dict[str, float]] = {}
    for i, s in enumerate(record):
        if s.end_ns is None:
            continue
        entry = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        entry["count"] += 1
        entry["total_ms"] += (s.end_ns - s.start_ns) / 1e6
        entry["self_ms"] += (s.end_ns - s.start_ns - children[i]) / 1e6
    return out


def reset() -> None:
    """Empty the record; call it with no span open."""
    _record.clear()
