"""Square attention with an additive f32 bias: the CUDA kernel and its
plain version.

Port of ``pallas_attention`` (``rpo_tpu/ops/pallas_attention.py``).
``masked_attention(q, k, v, bias)`` takes q, k, v (B, H, L, D) and a bias
of shape (1 | B, 1, L, L):

- on a CUDA tensor it launches the ``HAS_BIAS`` instantiation of
  ``csrc/rect_attention.cu`` (``masked_attention_forward``) or raises;
- on a CPU tensor it runs ``masked_attention_reference``, the same math in
  plain PyTorch.

In bf16 the kernel runs on the tensor cores and takes L up to 768 at
head dim 64 (1408 at 32, 384 at 128); the f32 instantiation is the SIMT
kernel (``rect_attention``'s limits).  A shared (1, 1, L, L) bias is read
in place (batch stride 0), never expanded into a per-batch copy.  There
is no fallback from the kernel to the plain version.  ``launches`` counts
the kernel launches.  The backward is the plain recompute with the bias,
as in the JAX package; the bias is a static mask in every caller and gets
no gradient.
"""
from __future__ import annotations

import torch

from . import rect_attention as ra

launches = 0  # kernel launches since the count was last set to 0


def masked_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """The kernel's math in plain PyTorch (``_softmax_attend`` with the
    bias): f32 scores times D^-1/2 plus the f32 bias, f32 softmax
    normalised before the cast, probabilities rounded to v's dtype,
    f32-accumulated product with v, output in q's dtype."""
    return ra._softmax_attend(q, k, v, bias)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise on anything the kernel does not take (``bias`` as the wrapper
    hands it over, after its cast to float32)."""
    ra._check(q, k, v)
    B, H, L, D = q.shape
    if k.shape[2] != L:
        raise ValueError(f"masked_attention is square: q has {L} rows, k {k.shape[2]}")
    if bias.device != q.device:
        raise ValueError(f"bias is on {bias.device}, q on {q.device}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    bs = bias.shape
    if len(bs) != 4 or bs[1] != 1 or bs[0] not in (1, B):
        raise ValueError(f"bias must be (1 | {B}, 1, {L}, {L}), got {tuple(bs)}")
    if bs[2] != L or bs[3] != L:
        raise ValueError(f"bias's last two dims must be ({L}, {L}), got {tuple(bs)}")
    if L > 1 and bias.stride(3) != 1:
        raise ValueError("bias must be contiguous in its last dim")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    global launches
    _check(q, k, v, bias)
    B, H, L, D = q.shape
    lib = ra._lib()
    out = ra._out_like(q)
    bias_sb = 0 if bias.shape[0] == 1 else bias.stride(0)
    stream = ra._stream(q.device)
    rc = lib.masked_attention_forward(
        ra._DTYPES[q.dtype], q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), out.data_ptr(), B, H, L, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        bias_sb, bias.stride(2), D ** -0.5, stream,
    )
    if rc != 0:
        raise ra._launch_error(lib, "masked_attention", rc, L, q)
    launches += 1
    return out


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    if q.is_cuda:
        return _launch(q, k, v, bias)
    if q.device.type != "cpu":
        raise ValueError(f"masked_attention runs on CUDA or the CPU, not {q.device}")
    return masked_attention_reference(q, k, v, bias)


class _MaskedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return _forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        return (*ra._attention_bwd_math(q, k, v, bias, g, ctx.needs_input_grad), None)


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Attention of q over k, v (B, H, L, D) plus the additive ``bias``
    (1 | B, 1, L, L), taken as float32: the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if ra._needs_grad(q, k, v):
        return _MaskedAttention.apply(q, k, v, bias.float())
    return _forward(q, k, v, bias.float())
