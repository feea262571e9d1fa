"""Carry the JAX package's parameters into the port.

``params_from_numpy`` turns a nested dict of numpy arrays (``np.asarray``
of each JAX leaf) into the port's nested dict of tensors under the same
keys.  It copies: no tensor aliases the caller's buffers.  bf16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy``
rejects; they go through float32, which holds every bf16 value exactly,
and back to bfloat16.  The method pytrees go through the same function:
RPO's (``text_prompt``, ``img_prompt``), CoOp's (``ctx``) and CoCoOp's
nested one (``ctx``, ``meta_net``: ``w1``, ``b1``, ``w2``, ``b2``), all
float32.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .model import cast_params


def _leaf(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _node(node: Any, device):
    if isinstance(node, Mapping):
        return {key: _node(leaf, device) for key, leaf in node.items()}
    if isinstance(node, list):
        return [_node(leaf, device) for leaf in node]
    return _leaf(node, device)


def params_from_numpy(tree: Mapping[str, Any], device, dtype: Optional[torch.dtype] = None):
    """Nested dict of arrays -> nested dict of tensors on ``device``; a list
    node (a ResNet tower's ``layers``, lists of block dicts) stays a list.

    ``dtype`` casts the floating leaves as ``cast_params`` does (logit_scale
    stays float32); ``None`` keeps each leaf's dtype."""
    out = _node(tree, device)
    return out if dtype is None else cast_params(out, dtype)
