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
shapes only: the JAX package's environment switches have no counterpart
here.

Tensor parallelism (``parallel/tp.py``, JAX's ``shard_heads``): a block
whose q/k/v weight holds a slice of the heads (narrower than 3D) runs
those heads only, the kernels on them, and its out-projection sums the
float32 partial products over the model group (``tp.row_parallel``)
before the cast and the bias.

The two attention functions are read here at call time, from one
module-level pair: the kernels, unless a comparison runs the same path on
other functions (their plain versions, a recording wrapper) inside
``attention_functions``, the counterpart of the JAX package's
``pallas_attention_scope``.  Nothing in the program enters it, so the
layers, towers, methods and trainers above take no attention function.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..parallel import tp
from .masked_attention import masked_attention
from .rect_attention import rect_attention

NEG_INF = -1e9  # finite -inf stand-in: keeps softmax NaN-free for fully masked rows

Attention = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
MaskedAttention = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

# (rect, masked): the functions every attention call above reads
_current: Tuple[Attention, MaskedAttention] = (rect_attention, masked_attention)


def current_attention() -> Tuple[Attention, MaskedAttention]:
    """The (rect, masked) attention functions in force."""
    return _current


class attention_functions:
    """``with attention_functions(rect=..., masked=...):`` runs the block on
    ``rect`` and/or ``masked`` in place of the functions in force (None
    keeps one); the previous pair comes back on exit, an exception's too.
    For comparisons only: tests, the selftest and the chip smoke run a
    path on the plain versions this way."""

    def __init__(self, rect: Optional[Attention] = None,
                 masked: Optional[MaskedAttention] = None) -> None:
        self._swap = (rect, masked)

    def __enter__(self) -> None:
        global _current
        self._prev = _current
        _current = tuple(new or old for new, old in zip(self._swap, _current))

    def __exit__(self, *exc) -> None:
        global _current
        _current = self._prev


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
) -> torch.Tensor:
    """Scaled dot-product attention.

    q, k, v: (B, H, L, Dh).  bias: broadcastable to (B, H, Lq, Lk), float32
    additive.  Returns (B, H, Lq, Dh) in v.dtype.
    """
    rect_attn, masked_attn = _current
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


def _heads_here(params: dict, D: int, n_heads: int) -> int:
    """The heads this block holds: all ``n_heads``, or a tensor-parallel
    rank's slice of them (its q/k/v weight narrower than 3D)."""
    return n_heads * (params["qkv_w"].shape[-1] // 3) // D


def _qkv_input(x: torch.Tensor, params: dict) -> torch.Tensor:
    """The projections' input: under a sliced block, the gradient of x is
    summed over the model group on the way back."""
    return tp.column_input(x) if tp.attention_sliced(params["qkv_w"]) else x


def _split_qkv(x: torch.Tensor, params: dict, n_heads: int):
    """The fused (D, 3D) QKV projection as one matmul, split into the
    per-head (B, H, L, Dh) q, k, v views (the block's heads: a slice of
    them under tensor parallelism)."""
    B, L, D = x.shape
    heads = _heads_here(params, D, n_heads)
    qkv = torch.matmul(_qkv_input(x, params), params["qkv_w"]) + params["qkv_b"].to(x.dtype)
    qkv = qkv.view(B, L, 3, heads, D // n_heads).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _out_proj(out: torch.Tensor, params: dict, dtype) -> torch.Tensor:
    """(B, H, L, Dh) attention output -> merged (B, L, D) projection; a
    tensor-parallel rank's heads (fewer rows of out_w than columns) sum
    their partial products over the model group."""
    B, H, L, Dh = out.shape
    merged = out.permute(0, 2, 1, 3).reshape(B, L, H * Dh)
    w = params["out_w"]
    if tp.out_proj_sliced(w):
        return tp.row_parallel(merged, w, params["out_b"], dtype)
    return torch.matmul(merged, w).to(dtype) + params["out_b"].to(dtype)


def multihead_attention(
    x: torch.Tensor,
    params: dict,
    n_heads: int,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention over x: (B, L, D) with the fused QKV projection.

    params: {qkv_w: (D, 3D), qkv_b: (3D,), out_w: (D, D), out_b: (D,)},
    weights in the (in, out) layout.
    """
    q, k, v = _split_qkv(x, params, n_heads)
    out = dot_product_attention(q, k, v, bias)
    return _out_proj(out, params, x.dtype)


def multihead_attention_kv(
    x: torch.Tensor,
    params: dict,
    n_heads: int,
    bias: Optional[torch.Tensor] = None,
):
    """Like multihead_attention, but also returns the (k, v) heads
    ((B, H, L, Dh) each) for a later cross-attention (the RPO frozen-text
    K/V cache)."""
    q, k, v = _split_qkv(x, params, n_heads)
    out = dot_product_attention(q, k, v, bias)
    return _out_proj(out, params, x.dtype), k, v


def multihead_attention_rect(
    x: torch.Tensor,
    params: dict,
    n_heads: int,
    n_kv: int,
) -> torch.Tensor:
    """Self-attention where only the first ``n_kv`` rows contribute keys
    and values: queries for all L rows, k/v for x[:, :n_kv].  Equal to
    full self-attention under a mask blocking columns >= n_kv, without
    computing the masked K/V or any bias."""
    D = x.shape[-1]
    w, b = params["qkv_w"], params["qkv_b"]
    heads = _heads_here(params, D, n_heads)
    qw = w.shape[-1] // 3
    x = _qkv_input(x, params)
    q = _head_proj(x, w[:, :qw], b[:qw], heads)
    kv = _head_proj(x[:, :n_kv], w[:, qw:], b[qw:], 2 * heads)
    k, v = kv[:, :heads], kv[:, heads:]
    out = _current[0](q, k, v)
    return _out_proj(out, params, x.dtype)


def multihead_attention_cached(
    x_q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    params: dict,
    n_heads: int,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cross-attention of query rows x_q (B, Lq, D) against precomputed
    key/value heads k, v (B, H, Lk, Dh): only the q slice of the fused QKV
    projection is computed.  Without a bias (the split vision tower's
    prompt rows) it goes to the rect function; the cached text path's
    column-broadcast bias takes the plain math."""
    D = x_q.shape[-1]
    qw = params["qkv_w"].shape[-1] // 3
    q = _head_proj(_qkv_input(x_q, params), params["qkv_w"][:, :qw], params["qkv_b"][:qw],
                   _heads_here(params, D, n_heads))
    out = dot_product_attention(q, k.to(x_q.dtype), v.to(x_q.dtype), bias)
    return _out_proj(out, params, x_q.dtype)
