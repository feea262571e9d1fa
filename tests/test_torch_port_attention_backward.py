"""The attention wrappers' backward computes only the gradients autograd
asks for.

``_RectAttention`` and ``_MaskedAttention`` pass their Function's
``needs_input_grad`` to ``_attention_bwd_math``: the split vision tower's
prompt rows read k and v made without grad and ask for dq alone.  The
gradients returned are the ones the full backward gives, bit for bit
(the same operations), and None where none was asked.
"""
import itertools

import pytest
import torch

from rpo_tpu_torch.models.clip.model import causal_mask
from rpo_tpu_torch.ops import masked_attention as ma
from rpo_tpu_torch.ops import rect_attention as ra

NEEDS = [n for n in itertools.product((True, False), repeat=3) if any(n)]


def _qkv(dtype, Lq=7, Lk=7):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(2, 3, n, 32, generator=gen).to(dtype) for n in (Lq, Lk, Lk)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("needs", NEEDS, ids=lambda n: "d" + "".join(
    w for w, on in zip("qkv", n) if on))
@pytest.mark.parametrize("which", ["rect", "masked"])
def test_backward_returns_what_is_asked_and_nothing_else(which, needs, dtype):
    q, k, v = _qkv(dtype, 5 if which == "rect" else 7)
    bias = causal_mask(7)[None, None] if which == "masked" else None
    g = torch.randn(2, 3, q.shape[2], 32, generator=torch.Generator().manual_seed(1)).to(dtype)
    full = ra._attention_bwd_math(q, k, v, bias, g)
    part = ra._attention_bwd_math(q, k, v, bias, g, needs)
    for want, got, on in zip(full, part, needs):
        assert (got is None) != on
        if on:
            assert torch.equal(got, want)

    # through autograd: only the leaves that require grad get one
    leaves = [t.clone().requires_grad_(on) for t, on in zip((q, k, v), needs)]
    out = (ra.rect_attention(*leaves) if bias is None
           else ma.masked_attention(*leaves, bias))
    (out.float() * g.float()).sum().backward()
    for leaf, want, on in zip(leaves, full, needs):
        if on:
            assert torch.equal(leaf.grad, want)
        else:
            assert leaf.grad is None
