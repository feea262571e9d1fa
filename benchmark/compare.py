"""The numbers that decide ``correct``, and their judgement against the
cell's limits (``limits/<cell>.json``: each number's name and limit).

Training, over the first steps that the program and the reference take
from the same state on the same batches:

- ``loss_gap``: the largest gap between the program's and the
  reference's loss, over the steps;
- ``grad1_gap``: the first gradient as the optimizer got it (the
  momentum buffer after one step, less the weight decay's share), by the
  worst leaf: the gap between the norms of the program's and the
  reference's gradient, over the larger of that leaf's reference norm
  and the median leaf's;
- ``update_gap``: the same for the change of each leaf over the steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by rounding alone and are left out of both.

Evaluation, over a sample of the window's batches:

- ``logit_gap``: the largest gap between a program logit and the
  reference's;
- ``top1_gap``: by how much the class that the program ranks first lies
  below the reference's first, in the reference's logits, at worst.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import numpy as np
import torch

FLAT_SHARE = 1e-3


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Sequence[str]) -> float:
    p, r = _norms(prog), _norms(ref)
    floor = statistics.median(r[k] for k in keep)
    return max(abs(p[k] - r[k]) / max(r[k], floor, 1e-30) for k in keep)


def kept_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(ref_grad)
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= FLAT_SHARE * median]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses``, ``grad1`` and ``update`` (flat
    dicts of leaves); ``ref`` from ``reference.sgd.train_steps``."""
    keep = kept_leaves(ref["grad1"])
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad1_gap": leaf_gap(prog["grad1"], ref["grad1"], keep),
        "update_gap": leaf_gap(prog["update"], ref["update"], keep),
    }


def eval_numbers(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """``prog`` and ``ref``: (rows, n_cls) logits of the same images."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    rows = np.arange(len(ref))
    chosen = prog.argmax(axis=1)
    return {"logit_gap": float(np.abs(prog - ref).max()),
            "top1_gap": float((ref.max(axis=1) - ref[rows, chosen]).max())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct where each number the cell's limits name is there, finite
    and within its limit.  A number without a limit is not compared."""
    return bool(limits) and all(
        k in numbers and np.isfinite(numbers[k]) and numbers[k] <= v for k, v in limits.items())


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number compared beside its limit."""
    return {k: {"value": numbers.get(k), "limit": v} for k, v in sorted(limits.items())}
