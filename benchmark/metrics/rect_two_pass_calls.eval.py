"""``rect_two_pass_calls.eval``: the rect_attention launches a traced eval
batch that took the kernel's two-pass route: the program's
``rect_two_pass`` counter rows (``rpo_tpu_torch.tracing.count``) marked
profiled, which the traced window alone stamps, over its batches.  None
where the program keeps no such counter, or where the count is not a
whole number a batch."""
from __future__ import annotations

from typing import Optional

NAME = "rect_two_pass"


def read(r) -> Optional[float]:
    if r.kind != "eval" or r.trace is None or r.traced_steps < 1:
        return None
    try:
        from rpo_tpu_torch import tracing
    except ImportError:
        return None
    if not hasattr(tracing, "count"):  # a program without counters
        return None
    n = sum(1 for s in tracing.spans() if s[0] == NAME and s[4])
    if n % r.traced_steps:
        return None
    return float(n // r.traced_steps)
