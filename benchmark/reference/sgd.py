"""The training steps of the reference: mean cross-entropy, autograd over
the trainable state, and SGD as ``torch.optim.SGD`` has it (weight decay
added to the gradient, the momentum buffer equal to that sum at the
first step, no dampening, no Nesterov)."""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F


def leaves(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors, flat, by dotted key."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def train_steps(logits_fn: Callable, state: Dict, batches: Sequence[Tuple[torch.Tensor,
                                                                            torch.Tensor]],
                lr: float, momentum: float, weight_decay: float) -> Dict:
    """Run ``len(batches)`` steps from ``state`` (not modified).
    ``logits_fn(state, images_u8) -> (B, n_cls)``.  Returns the losses,
    the first step's gradient by leaf and the state after the steps."""
    params = {k: v.detach().clone() for k, v in leaves(state).items()}
    bufs: Dict[str, torch.Tensor] = {}
    losses: List[float] = []
    grad1 = None
    for images, labels in batches:
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss = F.cross_entropy(logits_fn(nest(live), images), labels)
            grads = torch.autograd.grad(loss, list(live.values()))
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {k: g.detach() for k, g in zip(live, grads)}
        with torch.no_grad():
            new = {}
            for (k, p), g in zip(live.items(), grads):
                d = g + weight_decay * p
                bufs[k] = d if k not in bufs else momentum * bufs[k] + d
                new[k] = (p - lr * bufs[k]).detach()
        params = new
    return {"losses": losses, "grad1": grad1, "params": params}
