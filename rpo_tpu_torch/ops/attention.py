"""Multi-head attention with an additive bias.

Port of ``rpo_tpu/ops/attention.py``.  Layout is (batch, seq, dim); a
projection's head split is a view of its matmul output, so q, k and v
reach the kernel as strided (B, H, L, Dh) views without a copy.
Attention logits and softmax run in float32 whatever the activation
dtype; the probabilities are cast to v's dtype before the product with v.

Bias-free attention goes to ``rect_attention``; square attention with a
row-aligned (1 | B, 1, L, L) bias — the text towers' masks — goes to
``masked_attention`` (each the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor).  Every other bias — column-broadcast, per-head,
the cached text cross-attention (Lq != Lk) — runs the plain f32-softmax
math here, as the JAX package sends it to XLA.  The dispatch looks at
shapes only: the JAX package's thread-local Pallas scope, its environment
switches and its tensor-parallel hooks have no counterpart here.

The attention functions are arguments (``rect_attn``, ``masked_attn``)
with the kernels as defaults, threaded down from the towers, so that a
caller can run the same path on the plain versions.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .masked_attention import masked_attention
from .rect_attention import rect_attention

NEG_INF = -1e9  # finite -inf stand-in: keeps softmax NaN-free for fully masked rows

Attention = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
MaskedAttention = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def takes_masked_kernel(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> bool:
    """The guard of ``rpo_tpu/ops/attention.py:128-143``: square attention
    with a full (1 | B, 1, L, L) bias.  A column-broadcast bias (its last
    two dims not (Lq, Lk)), a per-head bias (the kernel reads head 0's
    only) and a batch dim other than 1 or B take the plain math.  The JAX
    guard assumes a 4-D bias, as every caller passes one; so does this."""
    return (
        bias.dim() == 4
        and q.shape[-2] == k.shape[-2]
        and bias.shape[-2] == q.shape[-2]
        and bias.shape[-1] == k.shape[-2]
        and bias.shape[1] == 1
        and bias.shape[0] in (1, q.shape[0])
    )


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    rect_attn: Attention = rect_attention,
    masked_attn: MaskedAttention = masked_attention,
) -> torch.Tensor:
    """Scaled dot-product attention.

    q, k, v: (B, H, L, Dh).  bias: broadcastable to (B, H, Lq, Lk), float32
    additive.  Returns (B, H, Lq, Dh) in v.dtype.
    """
    if bias is None:
        return rect_attn(q, k, v)
    if takes_masked_kernel(q, k, bias):
        return masked_attn(q, k, v, bias)
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def _head_proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, L, D) @ (D, H*Dh) + b -> (B, H, L, Dh), a view of the matmul
    output.  The product accumulates in f32 and rounds once to x's dtype;
    the bias is added after, in x's dtype (the JAX einsum with
    preferred_element_type=f32, astype, then + b)."""
    B, L, _ = x.shape
    out = torch.matmul(x, w) + b.to(x.dtype)
    return out.view(B, L, n_heads, -1).permute(0, 2, 1, 3)


def _split_qkv(x: torch.Tensor, params: dict, n_heads: int):
    """The fused (D, 3D) QKV projection as one matmul, split into the
    per-head (B, H, L, Dh) q, k, v views."""
    B, L, D = x.shape
    qkv = torch.matmul(x, params["qkv_w"]) + params["qkv_b"].to(x.dtype)
    qkv = qkv.view(B, L, 3, n_heads, D // n_heads).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _out_proj(out: torch.Tensor, params: dict, dtype) -> torch.Tensor:
    """(B, H, L, Dh) attention output -> merged (B, L, D) projection."""
    B, H, L, Dh = out.shape
    merged = out.permute(0, 2, 1, 3).reshape(B, L, H * Dh)
    return torch.matmul(merged, params["out_w"]).to(dtype) + params["out_b"].to(dtype)


def multihead_attention(
    x: torch.Tensor,
    params: dict,
    n_heads: int,
    bias: Optional[torch.Tensor] = None,
    rect_attn: Attention = rect_attention,
    masked_attn: MaskedAttention = masked_attention,
) -> torch.Tensor:
    """Self-attention over x: (B, L, D) with the fused QKV projection.

    params: {qkv_w: (D, 3D), qkv_b: (3D,), out_w: (D, D), out_b: (D,)},
    weights in the (in, out) layout.
    """
    q, k, v = _split_qkv(x, params, n_heads)
    out = dot_product_attention(q, k, v, bias, rect_attn, masked_attn)
    return _out_proj(out, params, x.dtype)


def multihead_attention_kv(
    x: torch.Tensor,
    params: dict,
    n_heads: int,
    bias: Optional[torch.Tensor] = None,
    rect_attn: Attention = rect_attention,
    masked_attn: MaskedAttention = masked_attention,
):
    """Like multihead_attention, but also returns the (k, v) heads
    ((B, H, L, Dh) each) for a later cross-attention (the RPO frozen-text
    K/V cache)."""
    q, k, v = _split_qkv(x, params, n_heads)
    out = dot_product_attention(q, k, v, bias, rect_attn, masked_attn)
    return _out_proj(out, params, x.dtype), k, v


def multihead_attention_rect(
    x: torch.Tensor,
    params: dict,
    n_heads: int,
    n_kv: int,
    rect_attn: Attention = rect_attention,
) -> torch.Tensor:
    """Self-attention where only the first ``n_kv`` rows contribute keys
    and values: queries for all L rows, k/v for x[:, :n_kv].  Equal to
    full self-attention under a mask blocking columns >= n_kv, without
    computing the masked K/V or any bias.

    ``rect_attn`` is the attention function; a caller may pass
    ``rect_attention_reference`` to run the same path on the plain
    version."""
    D = x.shape[-1]
    w, b = params["qkv_w"], params["qkv_b"]
    q = _head_proj(x, w[:, :D], b[:D], n_heads)
    kv = _head_proj(x[:, :n_kv], w[:, D:], b[D:], 2 * n_heads)
    k, v = kv[:, :n_heads], kv[:, n_heads:]
    out = rect_attn(q, k, v)
    return _out_proj(out, params, x.dtype)


def multihead_attention_cached(
    x_q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    params: dict,
    n_heads: int,
    bias: Optional[torch.Tensor] = None,
    rect_attn: Attention = rect_attention,
    masked_attn: MaskedAttention = masked_attention,
) -> torch.Tensor:
    """Cross-attention of query rows x_q (B, Lq, D) against precomputed
    key/value heads k, v (B, H, Lk, Dh): only the q slice of the fused QKV
    projection is computed.  Without a bias (the split vision tower's
    prompt rows) it goes to ``rect_attn``; the cached text path's
    column-broadcast bias takes the plain math."""
    D = x_q.shape[-1]
    q = _head_proj(x_q, params["qkv_w"][:, :D], params["qkv_b"][:D], n_heads)
    out = dot_product_attention(q, k.to(x_q.dtype), v.to(x_q.dtype), bias, rect_attn, masked_attn)
    return _out_proj(out, params, x_q.dtype)
