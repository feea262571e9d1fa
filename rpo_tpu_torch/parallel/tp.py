"""TRAIN.TENSOR_PARALLEL against the visible CUDA cards.

The port's copy of ``resolve_tp`` of ``rpo_tpu/parallel/tp.py``: the
check, its warn-once for each requested value and its messages, over
``torch.cuda.device_count()`` (1 on a host without a card, where the
port runs on the CPU).  The rest of the JAX package's ``parallel/`` (the
data-parallel step, the tensor-parallel mesh and its sharded steps, the
loader's padding to a multiple of the cards) waits for the multi-GPU
port (ROADMAP queue 1, item 7), so a value that would turn tensor
parallelism on still runs on one card here, and says so.
"""
from __future__ import annotations

import torch

_WARNED_SINGLE_DEVICE: set = set()


def device_count() -> int:
    """The cards a run could split over: at least 1 (the CPU, or one card)."""
    return max(1, torch.cuda.device_count())


def resolve_tp(cfg) -> int:
    """The model-axis size from ``cfg.TRAIN.TENSOR_PARALLEL``, validated
    against the visible cards.  0 = tensor parallelism off (tp 0 or 1).
    A request that cannot be met is never silent: a count the cards do not
    divide by raises; with one visible card it warns once for each
    requested value (a long-lived sweep warns for each distinct config)
    and the run goes on on one card."""
    tp = int(getattr(cfg.TRAIN, "TENSOR_PARALLEL", 0) or 0)
    n = device_count()
    if tp < 2:
        return 0
    if n < 2:
        if tp not in _WARNED_SINGLE_DEVICE:
            _WARNED_SINGLE_DEVICE.add(tp)
            print(
                f"(!) TRAIN.TENSOR_PARALLEL={tp} requested but only {n} "
                "device is visible — tensor parallelism disabled, running "
                "single-device"
            )
        return 0
    if n % tp != 0:
        raise ValueError(
            f"TRAIN.TENSOR_PARALLEL={tp} does not divide the "
            f"{n} visible devices"
        )
    return tp
