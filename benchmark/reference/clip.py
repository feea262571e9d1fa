"""Plain CLIP towers on an OpenAI-layout state dict, after ``clip/model.py``.

Weights are the state dict's own: ``nn.Linear`` weights (out, in), the
attention's packed ``in_proj`` (q; k; v), the ViT's patch convolution
(width, 3, P, P).  Activations are float32; every product goes through
``p`` (``precision.Precision``): ``p.mm`` for a product, ``p.cast``
where the program rounds an activation to its compute type.  Masks are additive float tensors with
-inf where a row may not read a column.  ``clip`` is the configuration
file's ``clip`` group.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .precision import Precision

StateDict = Dict[str, torch.Tensor]

PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def linear(x, w, b, p: Precision):
    return p.cast(p.cast(p.mm(x, w.t())) + b)


def layer_norm(x, sd: StateDict, prefix: str, p: Precision):
    return p.cast(F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.weight"], sd[f"{prefix}.bias"],
                               1e-5))


def quick_gelu(x, p: Precision):
    return p.cast(x * torch.sigmoid(1.702 * x))


def attention(x, sd: StateDict, prefix: str, heads: int, mask: Optional[torch.Tensor],
              p: Precision):
    N, L, d = x.shape
    q, k, v = linear(x, sd[f"{prefix}.in_proj_weight"], sd[f"{prefix}.in_proj_bias"],
                     p).split(d, dim=-1)

    def split(t):
        return t.reshape(N, L, heads, d // heads).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    s = p.mm(q, k.transpose(-1, -2)) * (d // heads) ** -0.5
    if mask is not None:
        s = s + mask
    o = p.cast(p.mm(p.cast(torch.softmax(s, dim=-1)), v)).transpose(1, 2).reshape(N, L, d)
    return linear(o, sd[f"{prefix}.out_proj.weight"], sd[f"{prefix}.out_proj.bias"], p)


def block(x, sd: StateDict, prefix: str, heads: int, mask, p: Precision):
    x = p.cast(x + attention(layer_norm(x, sd, f"{prefix}.ln_1", p), sd, f"{prefix}.attn", heads,
                             mask, p))
    h = quick_gelu(linear(layer_norm(x, sd, f"{prefix}.ln_2", p), sd[f"{prefix}.mlp.c_fc.weight"],
                          sd[f"{prefix}.mlp.c_fc.bias"], p), p)
    return p.cast(x + linear(h, sd[f"{prefix}.mlp.c_proj.weight"], sd[f"{prefix}.mlp.c_proj.bias"],
                             p))


def transformer(x, sd: StateDict, prefix: str, layers: int, heads: int, mask, p: Precision):
    for i in range(layers):
        x = block(x, sd, f"{prefix}.{i}", heads, mask, p)
    return x


def pixels(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32, CLIP's normalisation."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(PIXEL_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(PIXEL_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def vision_tokens(sd: StateDict, clip: dict, images_u8: torch.Tensor, p: Precision):
    """The stride-P patch convolution as a product over (c, py, px)
    patches, the class token prepended, the positions added:
    (B, 1 + grid^2, width)."""
    x = pixels(images_u8)
    B, C, H, W = x.shape
    P = clip["vision_patch_size"]
    g = H // P
    patches = x.reshape(B, C, g, P, g, P).permute(0, 2, 4, 1, 3, 5).reshape(B, g * g, C * P * P)
    conv = sd["visual.conv1.weight"]
    x = p.cast(p.mm(patches, conv.reshape(conv.shape[0], -1).t()))
    cls = sd["visual.class_embedding"].expand(B, 1, -1)
    return p.cast(torch.cat([cls, x], dim=1) + sd["visual.positional_embedding"])


def vision_transformer(sd: StateDict, clip: dict, x, mask, p: Precision):
    x = layer_norm(x, sd, "visual.ln_pre", p)
    return transformer(x, sd, "visual.transformer.resblocks", clip["vision_layers"],
                       clip["vision_heads"], mask, p)


def encode_image(sd: StateDict, clip: dict, images_u8: torch.Tensor, p: Precision):
    """CLIP's image features (B, embed): the class token's row."""
    x = vision_transformer(sd, clip, vision_tokens(sd, clip, images_u8, p), None, p)
    return p.mm(layer_norm(x[:, 0], sd, "visual.ln_post", p), sd["visual.proj"])


def text_transformer(sd: StateDict, clip: dict, x, mask, p: Precision):
    return transformer(x, sd, "transformer.resblocks", clip["text_layers"], clip["text_heads"],
                       mask, p)


def causal_mask(L: int, device) -> torch.Tensor:
    return torch.full((L, L), float("-inf"), device=device).triu(1)


def normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
