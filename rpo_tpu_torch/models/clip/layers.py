"""Transformer building blocks for CLIP, functional style.

Port of ``rpo_tpu/models/clip/layers.py``, with the same numerics:
  - LayerNorm computes in float32 and casts back.
  - QuickGELU is ``x * sigmoid(1.702 x)`` in the activation dtype.
  - Matmuls accumulate in f32 and round once to the activation dtype; the
    bias is added after, in that dtype.  PyTorch's bf16 matmul does this
    on the card (cuBLAS, f32 accumulation) and on the CPU
    (tests/test_torch_port_layers.py checks the CPU one).
  - Blocks are pre-LN residual: attention, then the 4x MLP.
  - Under tensor parallelism (``parallel/tp.py``, JAX's ``shard_hidden``)
    a block's fc holds a rank's slice of the 4W hidden columns and proj
    the matching rows; proj's float32 partial products are summed over
    the model group before the cast and the bias.

A transformer's blocks are stacked along a leading layer axis, as in the
JAX pytree; the ``lax.scan`` over them is a Python loop over the index.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ...ops.attention import (
    multihead_attention,
    multihead_attention_cached,
    multihead_attention_kv,
    multihead_attention_rect,
)
from ...ops.fused_text_layer import fused_text_tower
from ...parallel import tp

# (x, one layer's params, n_heads, (L, L) mask) -> x, a whole residual block
TextLayer = Callable[[torch.Tensor, dict, int, torch.Tensor], torch.Tensor]
# (x, one layer's params, n_heads, n_kv) -> x, a whole rect residual block
VisionLayer = Callable[[torch.Tensor, dict, int, int], torch.Tensor]


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked block pytree."""
    return {
        key: layer_params(leaf, i) if isinstance(leaf, dict) else leaf[i]
        for key, leaf in stacked.items()
    }


def n_layers(stacked: dict) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def layer_norm(x: torch.Tensor, params: dict, eps: float = 1e-5) -> torch.Tensor:
    out = F.layer_norm(
        x.float(), x.shape[-1:], params["scale"].float(), params["bias"].float(), eps
    )
    return out.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def mlp(x: torch.Tensor, params: dict) -> torch.Tensor:
    """4x expansion MLP with QuickGELU (a tensor-parallel rank's slice of
    the hidden when fc is narrower than 4D)."""
    if tp.mlp_sliced(params["fc_w"]):
        h = torch.matmul(tp.column_input(x), params["fc_w"]) + params["fc_b"].to(x.dtype)
        return tp.row_parallel(quick_gelu(h), params["proj_w"], params["proj_b"], x.dtype)
    h = torch.matmul(x, params["fc_w"]) + params["fc_b"].to(x.dtype)
    h = quick_gelu(h)
    return torch.matmul(h, params["proj_w"]) + params["proj_b"].to(x.dtype)


def residual_block(
    x: torch.Tensor,
    params: dict,
    n_heads: int,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    x = x + multihead_attention(layer_norm(x, params["ln_1"]), params["attn"], n_heads, bias)
    x = x + mlp(layer_norm(x, params["ln_2"]), params["mlp"])
    return x


def residual_block_kv(
    x: torch.Tensor,
    params: dict,
    n_heads: int,
    bias: Optional[torch.Tensor] = None,
):
    """residual_block that also returns this layer's (k, v) heads
    ((B, H, L, Dh)), the per-layer state of the RPO frozen-text cache."""
    attn_out, k, v = multihead_attention_kv(layer_norm(x, params["ln_1"]), params["attn"],
                                            n_heads, bias)
    x = x + attn_out
    x = x + mlp(layer_norm(x, params["ln_2"]), params["mlp"])
    return x, k, v


def rect_residual_block(
    x: torch.Tensor,
    params: dict,
    n_heads: int,
    n_kv: int,
) -> torch.Tensor:
    """Residual block whose attention lets every row read only the first
    ``n_kv`` rows (the RPO eval-path vision tower)."""
    x = x + multihead_attention_rect(layer_norm(x, params["ln_1"]), params["attn"], n_heads, n_kv)
    x = x + mlp(layer_norm(x, params["ln_2"]), params["mlp"])
    return x


def cross_residual_block(
    x: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    params: dict,
    n_heads: int,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Residual block whose attention reads precomputed (k, v) heads
    instead of self-attending: the query rows never contribute keys or
    values (the RPO read-only prompt rows)."""
    x = x + multihead_attention_cached(layer_norm(x, params["ln_1"]), k, v, params["attn"],
                                       n_heads, bias)
    x = x + mlp(layer_norm(x, params["ln_2"]), params["mlp"])
    return x


def transformer(
    x: torch.Tensor,
    stacked_blocks: dict,
    n_heads: int,
    bias: Optional[torch.Tensor] = None,
    text_layer: Optional[TextLayer] = None,
) -> torch.Tensor:
    """Run a stack of residual blocks over params with a leading
    [n_layers] axis.

    ``text_layer`` (``fused_text_layer`` or its plain version) runs each
    whole block instead, through ``fused_text_tower``, where the guard of
    ``rpo_tpu/models/clip/layers.py:150-168`` holds: bf16 (N, L, d)
    activations, a shared (1, 1, L, L) bias and d divisible by the head
    count.  Otherwise, and with the default None, the per-block loop runs."""
    if (
        text_layer is not None
        and bias is not None
        and x.dim() == 3
        and x.dtype == torch.bfloat16
        and bias.dim() == 4
        and tuple(bias.shape[:2]) == (1, 1)
        and bias.shape[2] == bias.shape[3] == x.shape[1]
        and x.shape[2] % n_heads == 0
    ):
        return fused_text_tower(x, stacked_blocks, n_heads, bias[0, 0], text_layer)
    for i in range(n_layers(stacked_blocks)):
        x = residual_block(
            x, layer_params(stacked_blocks, i), n_heads, bias
        )
    return x
