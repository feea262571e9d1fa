"""``rect_split_row_calls.eval``: the rect_attention launches a traced eval
batch that took the kernel's split-row route: the program's
``rect_split_row`` counter rows (``rpo_tpu_torch.tracing.count``) marked
profiled, which the traced window alone stamps, over its batches.  None
where the program has no split-row route (its wrapper has no
``split_row``) or keeps no counters, or where the count is not a whole
number a batch."""
from __future__ import annotations

from typing import Optional

NAME = "rect_split_row"


def read(r) -> Optional[float]:
    if r.kind != "eval" or r.trace is None or r.traced_steps < 1:
        return None
    try:
        from rpo_tpu_torch import tracing
        from rpo_tpu_torch.ops import rect_attention
    except ImportError:
        return None
    if not hasattr(tracing, "count") or not hasattr(rect_attention, "split_row"):
        return None
    n = sum(1 for s in tracing.spans() if s[0] == NAME and s[4])
    if n % r.traced_steps:
        return None
    return float(n // r.traced_steps)
