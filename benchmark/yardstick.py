"""The yardstick: the card's peaks, a kernel's least time, and the
operations and bytes of the port's kernels and of whole steps, all worked
out from shapes.

The peaks are NVIDIA's data-sheet figures (dense bfloat16, no sparsity);
the first name fragment that matches the card's name wins and the H100
SXM's are the default.  A kernel's bound is the larger of its bytes over
the bandwidth and its operations over the peak: each input byte read once,
each output byte written once.  ``kernel_group`` names the group of a
device operation by its kernel's name; it is frozen here so that the
groups stay what they were when the benchmark was defined.

A step's operations are the products of matrices that the method needs,
at 2 operations a multiply-add; element-wise work, norms and softmax are
not counted.  A train step counts the forward and the backward that the
trainable tensors' gradients need: gradients of the activations only, the
weights being frozen; nothing recomputed is counted.  Rows that a method
does not need (padding past a text's EOT, keys and values of rows that no
row may read) are not counted either.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

# (name fragment, bytes/s, dense bf16 FLOP/s)
PEAKS = [
    ("H100 PCIe", 2.0e12, 756e12),
    ("H100 NVL", 3.9e12, 835e12),
    ("H200", 4.8e12, 989e12),
    ("H100", 3.35e12, 989e12),
]

BF16 = 2  # bytes an element


def peaks(device_name: str) -> Tuple[float, float]:
    """(bytes/s, FLOP/s) of the card called ``device_name``."""
    for fragment, bw, flops in PEAKS:
        if fragment in device_name:
            return bw, flops
    return PEAKS[-1][1], PEAKS[-1][2]


def bound(n_bytes: float, n_flops: float, bw: float, peak: float) -> Tuple[float, str]:
    """(the least ms, "bytes" or "operations"), for the card's peaks."""
    bytes_ms, flops_ms = n_bytes / bw * 1e3, n_flops / peak * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def rect_attention_work(B: int, H: int, Lq: int, Lk: int, D: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one rect attention call in bfloat16: q and the
    output (Lq rows), k and v (Lk rows) once each; QK^T and PV."""
    return BF16 * B * H * (Lq + Lk + Lk + Lq) * D, 4.0 * B * H * Lq * Lk * D


def fused_text_layer_work(N: int, L: int, d: int, heads: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one fused text layer call in bfloat16: x in and
    out, the layer's weights and biases once, the float32 (L, L) mask;
    the four projections (12 d^2 multiply-adds a row) and the two
    attention products."""
    n_weights = 12 * d * d + 13 * d
    n_bytes = BF16 * (2 * N * L * d + n_weights) + 4 * L * L
    n_flops = 2.0 * N * L * 12 * d * d + 4.0 * N * heads * L * L * (d // heads)
    return n_bytes, n_flops


def layer_flops(d: int, q_rows: float, kv_rows: float, attn_pairs: float) -> float:
    """One transformer layer of width ``d``: ``q_rows`` rows take the q
    and output projections and the 4d MLP (20 d^2 multiply-adds each),
    ``kv_rows`` rows give keys and values (4 d^2), and ``attn_pairs``
    (the sum over sequences of query rows x key rows) take QK^T and PV."""
    return 2.0 * d * d * (10 * q_rows + 2 * kv_rows) + 4.0 * d * attn_pairs


def vision_frozen_flops(clip: dict, B: int) -> float:
    """A ViT's patch embedding and tower over B images' class and patch
    rows, self-attending (no grad)."""
    dv, P = clip["vision_width"], clip["vision_patch_size"]
    S = (clip["image_resolution"] // P) ** 2 + 1
    patch = 2.0 * B * (S - 1) * 3 * P * P * dv
    return patch + clip["vision_layers"] * layer_flops(dv, B * S, B * S, B * S * S)


def rpo_eval_batch_flops(clip: dict, K: int, n_cls: int, B: int) -> float:
    """An RPO eval batch: the tower over B x (S + K) rows whose keys and
    values come from the S frozen rows, the prompt rows' head, the logits.
    The text features are the task's, made once."""
    dv, E, P = clip["vision_width"], clip["embed_dim"], clip["vision_patch_size"]
    S = (clip["image_resolution"] // P) ** 2 + 1
    patch = 2.0 * B * (S - 1) * 3 * P * P * dv
    tower = clip["vision_layers"] * layer_flops(dv, B * (S + K), B * S, B * (S + K) * S)
    return patch + tower + 2.0 * B * K * dv * E + 2.0 * B * n_cls * K * E


def rpo_train_step_flops(clip: dict, K: int, lens: Sequence[int], B: int) -> float:
    """An RPO train step: the frozen rows' tower forward (no grad); then,
    forward and backward, the B x K image prompt rows reading each layer's
    frozen keys and values, the n_cls x K text prompt rows reading class
    c's first ``lens[c]`` frozen rows (the task's cached keys and values),
    both heads and the logits."""
    dv, dt, E = clip["vision_width"], clip["text_width"], clip["embed_dim"]
    S = (clip["image_resolution"] // clip["vision_patch_size"]) ** 2 + 1
    n_cls = len(lens)
    frozen = vision_frozen_flops(clip, B)
    vision_prompts = (clip["vision_layers"] * layer_flops(dv, B * K, 0, B * K * S)
                      + 2.0 * B * K * dv * E)
    text_prompts = (clip["text_layers"] * layer_flops(dt, n_cls * K, 0, K * float(sum(lens)))
                    + 2.0 * n_cls * K * dt * E)
    logits = 2.0 * B * n_cls * K * E
    return frozen + 2 * (vision_prompts + text_prompts + logits)


def cocoop_eval_batch_flops(clip: dict, rows: Iterable[int], B: int, n_ctx: int) -> float:
    """A CoCoOp eval batch: the image tower and head, the meta-net, and
    per image every class's causal text tower over its ``rows[c]`` rows
    (up to its EOT), its head and the logits."""
    dv, dt, E = clip["vision_width"], clip["text_width"], clip["embed_dim"]
    rows = [int(r) for r in rows]
    n_cls = len(rows)
    vision = vision_frozen_flops(clip, B) + 2.0 * B * dv * E
    meta = 2.0 * B * (E * (E // 16) + (E // 16) * dt)
    text = B * (clip["text_layers"] * layer_flops(dt, sum(rows), sum(rows),
                                                  float(sum(r * r for r in rows)))
                + 2.0 * n_cls * dt * E)
    return vision + meta + text + 2.0 * B * n_cls * E


def kernel_group(name: str) -> str:
    """The group of a device operation, by its kernel's name."""
    n = name.lower()
    return ("fused_text_layer kernel" if "fused_text_layer" in n
            else "fused_rect_attn_half kernel" if "fused_rect_attn_half" in n
            else "fused_mlp_half kernel" if "fused_mlp_half" in n
            else "masked_attention kernel" if "attention_kernel" in n and "true" in n
            else "rect_attention kernel" if "attention_kernel" in n
            else "conv (cuDNN)" if any(w in n for w in ("fprop", "implicit_gemm", "cudnn",
                                                        "winograd", "conv2d", "convolve"))
            else "batch_norm" if "batch_norm" in n or "bn_fw" in n
            else "pooling" if "pool" in n
            else "matmul" if any(w in n for w in ("gemm", "cutlass", "xmma", "nvjet", "sm90"))
            else "layer_norm" if "layer_norm" in n
            else "softmax/reduce" if any(w in n for w in ("softmax", "reduce"))
            else "copy/cast" if any(w in n for w in ("copy", "memcpy", "cat", "nchwtonhwc",
                                                     "nhwctonchw"))
            else "elementwise" if "elementwise" in n
            else "other")
