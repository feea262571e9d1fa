"""SGD and the per-epoch LR schedule, with Dassl's semantics.

Port of ``rpo_tpu/engine/optim.py``.  The prompts train with momentum 0.9
and weight decay 5e-4 by default, under the JAX package's ``sgd_update``
rules (which are ``torch.optim.SGD``'s):

    g = grad + wd * p
    buf = g on the first update, else momentum * buf + (1 - dampening) * g
    p = p - lr * (momentum * buf + g if nesterov else buf)

``SGD`` keeps that state in tensors on the parameters' device and updates
them and the parameters in place with tensor operations only: the
learning rate is a device scalar filled before a step, and the
first-buffer rule is a device scalar too (the gradient's weight in the
buffer: 1 before the first update, 1 - dampening after it).  Nothing in
an update reads a value back to the host, so a CUDA graph can capture it
(``methods/step_graph.py``), and the buffers keep their storage for the
life of the optimizer.  The learning rate of the epoch comes from
``lr_at_epoch`` on the host.  ``sgd_state_from_numpy`` carries the JAX
package's ``SGDState`` (a momentum pytree and an update count) into it;
``sgd_momentum`` reads it back.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Mapping

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


class SGD:
    """The port's ``SGDState`` and ``sgd_update`` over the tensors of a
    params tree, all on their device.  ``lr`` is a 0-d float32 tensor;
    ``update`` reads it, never a Python number."""

    def __init__(self, params: Mapping[str, Any], momentum: float = 0.9,
                 weight_decay: float = 5e-4, nesterov: bool = False, dampening: float = 0.0):
        if nesterov and dampening:
            raise ValueError("Nesterov momentum requires zero dampening")
        self.params = list(tree_leaves(params))
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        # at momentum 0 nesterov is plain SGD (the JAX buffer is the
        # gradient itself), and no buffer is kept
        self.nesterov = bool(nesterov and momentum > 0)
        self.dampening = float(dampening)
        device = self.params[0].device
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.buffers = [torch.zeros_like(p) for p in self.params] if self.momentum else []
        # the gradient's weight in the buffer: 1 at the first update (the
        # buffer is the gradient itself), 1 - dampening after it
        self.grad_weight = torch.ones((), dtype=torch.float32, device=device)

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor an update reads or writes besides the gradients."""
        return self.params + self.buffers + [self.lr, self.grad_weight]

    def reset(self) -> None:
        """Back to ``sgd_init``: zero buffers, no update yet (in place)."""
        for b in self.buffers:
            b.zero_()
        self.grad_weight.fill_(1.0)

    def set_lr(self, lr: float) -> None:
        self.lr.fill_(float(lr))

    def update(self, params: Mapping[str, Any], grads: Mapping[str, Any]) -> None:
        """One ``sgd_update`` at ``self.lr``, in place: ``grads`` is a
        tree of ``params``' structure, whose tensors must be the ones the
        optimizer was built over."""
        pairs = []  # (param, grad) in params' order, matched by key
        tree_map(lambda p, g: pairs.append((p, g)), params, grads)
        if len(pairs) != len(self.params) or any(
                p is not q for (p, _), q in zip(pairs, self.params)):
            raise ValueError("the optimizer was built over other parameter tensors")
        for i, (p, g) in enumerate(pairs):
            if self.weight_decay:
                g = g.add(p, alpha=self.weight_decay)
            if self.momentum:
                buf = self.buffers[i]
                buf.mul_(self.momentum).add_(g * self.grad_weight if self.dampening else g)
                g = g.add(buf, alpha=self.momentum) if self.nesterov else buf
            p.addcmul_(g, self.lr, value=-1.0)
        if self.momentum and self.dampening:
            self.grad_weight.fill_(1.0 - self.dampening)


def sgd(params: Mapping[str, Any], momentum: float = 0.9, weight_decay: float = 5e-4,
        nesterov: bool = False, dampening: float = 0.0) -> SGD:
    """A fresh ``SGD`` over the tensors of ``params`` (``sgd_init``).
    Nesterov momentum with dampening raises, as in the JAX trainer and in
    torch."""
    return SGD(params, momentum, weight_decay, nesterov, dampening)


def sgd_step(optimizer: SGD, params: Mapping[str, Any], grads: Mapping[str, Any],
             lr: float) -> None:
    """One ``sgd_update`` at ``lr`` (a host number, written into the
    optimizer's device scalar first)."""
    optimizer.set_lr(lr)
    optimizer.update(params, grads)


def sgd_momentum(optimizer: SGD, params: Mapping[str, Any]) -> Dict[str, Any]:
    """The momentum tree of ``SGDState``: zeros before the first update
    (and always at momentum 0)."""
    if not optimizer.buffers:
        return tree_map(torch.zeros_like, params)
    it = iter(optimizer.buffers)
    return tree_map(lambda _: next(it), params)


def sgd_state_from_numpy(optimizer: SGD, params: Mapping[str, Any],
                         momentum: Mapping[str, Any], step: int) -> None:
    """Install the JAX package's ``SGDState(momentum, step)`` (arrays or
    tensors in ``params``' structure, an update count) in ``optimizer``,
    copied into its buffers: at step 0 zero buffers and the first-buffer
    rule ahead (the next update writes the gradient itself, torch's and
    ``sgd_update``'s rule), past it a float32 copy of each momentum
    array."""
    def install(p, m, buf):
        a = m.detach() if isinstance(m, torch.Tensor) else torch.from_numpy(
            np.array(m, dtype=np.float32))
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"momentum of shape {tuple(a.shape)} for a parameter of "
                             f"shape {tuple(p.shape)}")
        if buf is not None and int(step) != 0:
            buf.copy_(a.to(buf.device, torch.float32))

    bufs = iter(optimizer.buffers)
    tree_map(lambda p, m: install(p, m, next(bufs, None)), params, momentum)
    if int(step) == 0:
        optimizer.reset()
    else:
        optimizer.grad_weight.fill_(1.0 - optimizer.dampening)


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
