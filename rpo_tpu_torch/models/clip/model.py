"""CLIP in functional PyTorch: config, random init, and stage functions.

Port of ``rpo_tpu/models/clip/model.py``.  Parameters are nested dicts of
tensors under the JAX pytree's key names, and every layer stack keeps its
leading ``[n_layers]`` axis, so ``bridge.params_from_numpy`` is a 1:1
tree map.  Weights use the (in, out) layout: a projection is ``x @ w``.
Images are HWC, and a patch is flattened in (py, px, c) order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ...ops.attention import NEG_INF, Attention, MaskedAttention
from ...ops.masked_attention import masked_attention
from ...ops.rect_attention import rect_attention
from .layers import TextLayer, layer_norm, transformer
from .resnet import init_resnet_visual, resnet_encode_image

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision
    image_resolution: int = 224
    vision_layers: Union[int, Tuple[int, int, int, int]] = 12
    vision_width: int = 768
    vision_patch_size: int = 16
    # text
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12

    @property
    def vision_heads(self) -> int:
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def vision_seq_len(self) -> int:
        return self.grid_size ** 2 + 1

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)


VIT_B16 = CLIPConfig()
VIT_B32 = dataclasses.replace(VIT_B16, vision_patch_size=32)
RN50 = CLIPConfig(
    embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64,
    vision_patch_size=0,
)
RN101 = CLIPConfig(
    embed_dim=512, vision_layers=(3, 4, 23, 3), vision_width=64,
    vision_patch_size=0,
)
RN50x4 = CLIPConfig(
    embed_dim=640, image_resolution=288, vision_layers=(4, 6, 10, 6),
    vision_width=80, vision_patch_size=0,
    text_width=640, text_heads=10, text_layers=12,
)
RN50x16 = CLIPConfig(
    embed_dim=768, image_resolution=384, vision_layers=(6, 8, 18, 8),
    vision_width=96, vision_patch_size=0,
    text_width=768, text_heads=12, text_layers=12,
)
# Test-size model: full structure, tiny dims (vision_width must be a
# multiple of 64 because vision_heads = width // 64).
TINY = CLIPConfig(
    embed_dim=64,
    image_resolution=32,
    vision_layers=2,
    vision_width=64,
    vision_patch_size=16,
    context_length=77,
    vocab_size=49408,
    text_width=64,
    text_heads=2,
    text_layers=2,
)

# TINY with a 128-wide vision tower: 2 heads of 64, the smallest vision
# tower whose head count is even.
TINY_W128 = dataclasses.replace(TINY, vision_width=128)

# Test-size ModifiedResNet: one bottleneck per stage, width 16 (8
# attention-pool heads, a 512-wide feature, embed 64).
TINY_RN = CLIPConfig(
    embed_dim=64,
    image_resolution=32,
    vision_layers=(1, 1, 1, 1),
    vision_width=16,
    vision_patch_size=0,
    context_length=77,
    vocab_size=49408,
    text_width=64,
    text_heads=2,
    text_layers=2,
)

ARCHS = {
    "ViT-B/16": VIT_B16,
    "ViT-B/32": VIT_B32,
    "RN50": RN50,
    "RN101": RN101,
    "RN50x4": RN50x4,
    "RN50x16": RN50x16,
    "TINY": TINY,
    "TINY_W128": TINY_W128,
    "TINY_RN": TINY_RN,
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * std).to(dtype)


def _init_block_stack(gen: torch.Generator, n_layers: int, width: int, dtype) -> Params:
    """CLIP's transformer init scheme (the same distributions as the JAX
    package's ``_init_block_stack``)."""
    proj_std = (width ** -0.5) * ((2 * n_layers) ** -0.5)
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5
    L = n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=gen.device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=gen.device)

    return {
        "ln_1": {"scale": ones(L, width), "bias": zeros(L, width)},
        "attn": {
            "qkv_w": _normal(gen, (L, width, 3 * width), attn_std, dtype),
            "qkv_b": zeros(L, 3 * width),
            "out_w": _normal(gen, (L, width, width), proj_std, dtype),
            "out_b": zeros(L, width),
        },
        "ln_2": {"scale": ones(L, width), "bias": zeros(L, width)},
        "mlp": {
            "fc_w": _normal(gen, (L, width, 4 * width), fc_std, dtype),
            "fc_b": zeros(L, 4 * width),
            "proj_w": _normal(gen, (L, 4 * width, width), proj_std, dtype),
            "proj_b": zeros(L, width),
        },
    }


def init_clip(gen: torch.Generator, cfg: CLIPConfig, dtype=torch.float32) -> Params:
    """Random CLIP params with the CLIP init distributions, drawn from
    ``gen`` on ``gen.device``: a ViT or, for a tuple of ``vision_layers``,
    a ModifiedResNet visual tower (``resnet.init_resnet_visual``).  The
    numbers differ from the JAX package's for the same seed; tests carry
    the JAX weights across with ``bridge.params_from_numpy`` instead."""
    vw, tw = cfg.vision_width, cfg.text_width
    scale = vw ** -0.5
    dev = gen.device

    def ln(width):
        return {
            "scale": torch.ones(width, dtype=dtype, device=dev),
            "bias": torch.zeros(width, dtype=dtype, device=dev),
        }

    if cfg.is_vit:
        visual = {
            # patch embedding stored matmul-ready: (P*P*3, width)
            "patch_embed": _normal(gen, (cfg.vision_patch_size ** 2 * 3, vw), scale, dtype),
            "class_embedding": _normal(gen, (vw,), scale, dtype),
            "positional_embedding": _normal(gen, (cfg.vision_seq_len, vw), scale, dtype),
            "ln_pre": ln(vw),
            "blocks": _init_block_stack(gen, cfg.vision_layers, vw, dtype),
            "ln_post": ln(vw),
            "proj": _normal(gen, (vw, cfg.embed_dim), scale, dtype),
        }
    else:
        visual = init_resnet_visual(gen, cfg, dtype)
    text = {
        "token_embedding": _normal(gen, (cfg.vocab_size, tw), 0.02, dtype),
        "positional_embedding": _normal(gen, (cfg.context_length, tw), 0.01, dtype),
        "blocks": _init_block_stack(gen, cfg.text_layers, tw, dtype),
        "ln_final": ln(tw),
        "text_projection": _normal(gen, (tw, cfg.embed_dim), tw ** -0.5, dtype),
    }
    return {
        "visual": visual,
        "text": text,
        "logit_scale": torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=dev),
    }


def cast_params(params: Params, dtype) -> Params:
    """Cast floating leaves to ``dtype``; logit_scale stays float32
    (it is the only trained backbone scalar and exp() of bf16 drifts).
    Walks dicts and lists (a ResNet tower's ``layers``)."""
    def cast(key, leaf):
        if isinstance(leaf, dict):
            return {k: cast(k, v) for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [cast(key, v) for v in leaf]
        if key == "logit_scale" or not leaf.is_floating_point():
            return leaf
        return leaf.to(dtype)

    return cast(None, params)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def causal_mask(length: int, device=None) -> torch.Tensor:
    """(L, L) float32 additive causal mask."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(j > i, zero + NEG_INF, zero)


# ---------------------------------------------------------------------------
# vision tower stages
# ---------------------------------------------------------------------------

def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, n_patches, P*P*3), patch order (py, px, c) —
    the stride-P conv of CLIP phrased as a reshape and one matmul."""
    B, H, W, C = images.shape
    P = patch_size
    x = images.reshape(B, H // P, P, W // P, P, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # B, gh, gw, P, P, C
    return x.reshape(B, (H // P) * (W // P), P * P * C)


def vision_embed(params: Params, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """Images (B, H, W, 3) -> token sequence (B, 1+grid^2, width): class
    embedding prepended, positional embedding added, ln_pre NOT applied
    (RPO appends its prompt tokens first)."""
    dtype = params["patch_embed"].dtype
    patches = patchify(images.to(dtype), cfg.vision_patch_size)
    # a bf16 matmul accumulates in f32 and rounds once (the JAX einsum's
    # preferred_element_type=f32 followed by astype)
    x = torch.matmul(patches, params["patch_embed"])
    cls = params["class_embedding"].to(dtype).expand(x.shape[0], 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1)
    return x + params["positional_embedding"].to(dtype)


def vision_transformer_run(
    params: Params,
    cfg: CLIPConfig,
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    rect_attn: Attention = rect_attention,
    masked_attn: MaskedAttention = masked_attention,
) -> torch.Tensor:
    """ln_pre, then the transformer over already-embedded vision tokens."""
    x = layer_norm(x, params["ln_pre"])
    return transformer(x, params["blocks"], cfg.vision_heads, bias, rect_attn, masked_attn)


def encode_image(
    params: Params,
    cfg: CLIPConfig,
    images: torch.Tensor,
    rect_attn: Attention = rect_attention,
    masked_attn: MaskedAttention = masked_attention,
) -> torch.Tensor:
    """Standard CLIP image features (B, embed_dim): the ViT CLS head, or
    the ModifiedResNet's attention pool, which calls no attention kernel.
    The unmasked ViT tower's attention is the rect kernel with Lq = Lk."""
    if not cfg.is_vit:
        return resnet_encode_image(params, cfg, images)
    v = params["visual"]
    x = vision_embed(v, cfg, images)
    x = vision_transformer_run(v, cfg, x, None, rect_attn, masked_attn)
    x = layer_norm(x[:, 0, :], v["ln_post"])
    return torch.matmul(x, v["proj"])


# ---------------------------------------------------------------------------
# text tower stages
# ---------------------------------------------------------------------------

def text_embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, L) -> embedded sequence + positional (B, L, width)."""
    emb = params["token_embedding"][tokens]
    pos = params["positional_embedding"][: tokens.shape[1]]
    return emb + pos.to(emb.dtype)


def text_transformer_run(
    params: Params,
    cfg: CLIPConfig,
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    rect_attn: Attention = rect_attention,
    masked_attn: MaskedAttention = masked_attention,
    text_layer: Optional[TextLayer] = None,
) -> torch.Tensor:
    """The text transformer; ``text_layer`` as in ``layers.transformer``."""
    return transformer(x, params["blocks"], cfg.text_heads, bias, rect_attn, masked_attn,
                       text_layer)


def encode_text(
    params: Params,
    cfg: CLIPConfig,
    tokens: torch.Tensor,
    masked_attn: MaskedAttention = masked_attention,
) -> torch.Tensor:
    """Standard CLIP text features: the EOT-position head.  Runs at
    ``tokens.shape[1]``; tokens truncated anywhere past the longest EOT
    give the same features under the causal mask, which is shared by the
    whole batch and goes to ``masked_attn``."""
    t = params["text"]
    x = text_embed(t, tokens)
    bias = causal_mask(tokens.shape[1], x.device)[None, None]
    x = text_transformer_run(t, cfg, x, bias, masked_attn=masked_attn)
    x = layer_norm(x, t["ln_final"])
    eot_pos = tokens.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot_pos]
    return torch.matmul(x, t["text_projection"])


def clip_forward(
    params: Params,
    cfg: CLIPConfig,
    images: torch.Tensor,
    tokens: torch.Tensor,
    rect_attn: Attention = rect_attention,
    masked_attn: MaskedAttention = masked_attention,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contrastive logits (logits_per_image, logits_per_text).  As in the
    JAX package, the features are normalised in the activation dtype and
    exp(logit_scale) is cast to it too (unlike ``coop_logits``, which
    works in float32)."""
    img = encode_image(params, cfg, images, rect_attn, masked_attn)
    txt = encode_text(params, cfg, tokens, masked_attn)
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    scale = torch.exp(params["logit_scale"]).to(img.dtype)
    logits_per_image = scale * img @ txt.T
    return logits_per_image, logits_per_image.T
