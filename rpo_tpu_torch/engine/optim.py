"""SGD and the per-epoch LR schedule, with Dassl's semantics.

Port of ``rpo_tpu/engine/optim.py``.  The prompts train with
``torch.optim.SGD`` (momentum 0.9, weight decay 5e-4 by default), whose
rules are the JAX package's ``sgd_update``:

    g = grad + wd * p
    buf = g on the first update, else momentum * buf + (1 - dampening) * g
    p = p - lr * (momentum * buf + g if nesterov else buf)

The learning rate of the epoch comes from ``lr_at_epoch`` on the host and
is set on the optimizer before each step.  ``sgd_state_from_numpy``
carries the JAX package's ``SGDState`` (a momentum pytree and an update
count) into the optimizer; ``sgd_momentum`` reads it back.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Mapping

import numpy as np
import torch


def tree_leaves(tree: Mapping[str, Any]) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in its key order."""
    for leaf in tree.values():
        if isinstance(leaf, Mapping):
            yield from tree_leaves(leaf)
        else:
            yield leaf


def tree_map(fn, tree: Mapping[str, Any], *rest: Mapping[str, Any]) -> Dict[str, Any]:
    """``fn`` on the leaves of ``tree`` and of trees of its structure,
    matched by key (a JAX pytree's dicts come back with sorted keys)."""
    return {
        key: tree_map(fn, leaf, *(r[key] for r in rest)) if isinstance(leaf, Mapping)
        else fn(leaf, *(r[key] for r in rest))
        for key, leaf in tree.items()
    }


def sgd(params: Mapping[str, Any], momentum: float = 0.9, weight_decay: float = 5e-4,
        nesterov: bool = False, dampening: float = 0.0) -> torch.optim.SGD:
    """``torch.optim.SGD`` over the tensors of ``params`` (``sgd_init``),
    one tensor at a time (``foreach=False``); the LR is set at each step.

    Nesterov momentum with dampening raises, as in the JAX trainer and in
    torch.  At momentum 0 nesterov is plain SGD in both (the JAX buffer
    is the gradient itself), so it is passed on only with a momentum."""
    if nesterov and dampening:
        raise ValueError("Nesterov momentum requires zero dampening")
    return torch.optim.SGD(list(tree_leaves(params)), lr=0.0, momentum=momentum,
                           dampening=dampening, weight_decay=weight_decay,
                           nesterov=bool(nesterov and momentum > 0), foreach=False)


def sgd_step(optimizer: torch.optim.SGD, params: Mapping[str, Any],
             grads: Mapping[str, Any], lr: float) -> None:
    """One ``sgd_update`` at ``lr``: the gradients of ``params`` (a tree
    of its structure) in place of ``.grad`` for the step."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    tree_map(lambda p, g: setattr(p, "grad", g), params, grads)
    optimizer.step()
    for p in tree_leaves(params):
        p.grad = None


def sgd_momentum(optimizer: torch.optim.SGD, params: Mapping[str, Any]) -> Dict[str, Any]:
    """The momentum tree of ``SGDState``: zeros before the first update."""
    def buf(p):
        b = optimizer.state.get(p, {}).get("momentum_buffer")
        return torch.zeros_like(p) if b is None else b
    return tree_map(buf, params)


def sgd_state_from_numpy(optimizer: torch.optim.SGD, params: Mapping[str, Any],
                         momentum: Mapping[str, Any], step: int) -> None:
    """Install the JAX package's ``SGDState(momentum, step)`` (arrays or
    tensors in ``params``' structure, an update count) in ``optimizer``:
    at step 0 no buffer (the next update writes the gradient itself,
    torch's and ``sgd_update``'s first-buffer rule), past it a float32
    copy of each momentum array on its parameter's device."""
    def install(p, m):
        state = optimizer.state[p]
        if int(step) == 0:
            state.pop("momentum_buffer", None)
        else:
            if isinstance(m, torch.Tensor):
                a = m.detach().to(p.device, torch.float32, copy=True)
            else:
                a = torch.from_numpy(np.array(m, dtype=np.float32)).to(p.device)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"momentum of shape {tuple(a.shape)} for a parameter of "
                                 f"shape {tuple(p.shape)}")
            state["momentum_buffer"] = a
    tree_map(install, params, momentum)


def lr_at_epoch(cfg_optim, epoch: int) -> float:
    """Per-epoch LR with warmup, matching Dassl's scheduler composition.

    ``cfg_optim`` is any object with the config's ``OPTIM`` attribute
    names (LR, MAX_EPOCH, WARMUP_EPOCH, WARMUP_TYPE, WARMUP_CONS_LR,
    WARMUP_MIN_LR, LR_SCHEDULER, STEPSIZE, GAMMA and, optionally,
    WARMUP_RECOUNT).  Epochs < WARMUP_EPOCH take the warmup LR (constant,
    or a linear ramp); after it the main schedule runs on
    (epoch - WARMUP_EPOCH), so a cosine restarts at the full LR on the
    first epoch after warmup, unless WARMUP_RECOUNT is False, where it
    runs on the absolute epoch.
    """
    lr = float(cfg_optim.LR)
    max_epoch = int(cfg_optim.MAX_EPOCH)
    warmup = int(cfg_optim.WARMUP_EPOCH)
    if warmup > 0:
        if epoch < warmup:
            if cfg_optim.WARMUP_TYPE == "constant":
                return float(cfg_optim.WARMUP_CONS_LR)
            if cfg_optim.WARMUP_TYPE == "linear":
                # WARMUP_MIN_LR at epoch 0, then LR * epoch / warmup
                if epoch == 0:
                    return float(cfg_optim.WARMUP_MIN_LR)
                return lr * epoch / warmup
            raise ValueError(f"Unknown WARMUP_TYPE {cfg_optim.WARMUP_TYPE}")
        if getattr(cfg_optim, "WARMUP_RECOUNT", True):
            epoch = epoch - warmup

    sched = cfg_optim.LR_SCHEDULER
    if sched == "cosine":
        return lr * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epoch))
    if sched == "single_step":
        step = cfg_optim.STEPSIZE[0] if cfg_optim.STEPSIZE else -1
        if step <= 0:
            return lr
        return lr * (float(cfg_optim.GAMMA) ** (epoch // step))
    if sched == "multi_step":
        passed = sum(1 for s in cfg_optim.STEPSIZE if epoch >= s)
        return lr * (float(cfg_optim.GAMMA) ** passed)
    if sched == "constant":
        return lr
    raise ValueError(f"Unknown LR_SCHEDULER {sched}")
