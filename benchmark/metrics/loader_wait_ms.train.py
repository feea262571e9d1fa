"""``loader_wait_ms.train``: the host's milliseconds a measured step that
the engine's epoch loop waits for the loader's next batch: the program's
``loader_wait`` spans (``rpo_tpu_torch/engine/trainer.py``; the wait that
finds each epoch's end included) over the window's steps.  The engine
cell's window empties the program's record as it starts, so its
unprofiled rows are the window's.  None for another kind of traffic,
where the program has no such span, or where the record no longer holds
one ``train_dispatch`` span a step of the window."""
from __future__ import annotations

from typing import Optional


def read(r) -> Optional[float]:
    if r.kind != "engine_epoch" or r.steps < 1:
        return None
    try:
        from rpo_tpu_torch import tracing
    except ImportError:
        return None
    rows = [s for s in tracing.spans() if not s[4]]
    waits = [s for s in rows if s[0] == "loader_wait"]
    steps = sum(1 for s in rows if s[0] == "train_dispatch" and s[3] < 0)
    if not waits or steps != r.steps or any(s[2] is None for s in waits):
        return None
    return sum(s[2] - s[1] for s in waits) / r.steps / 1e6
