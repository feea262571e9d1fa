"""The user-level CLIP API on the card: ``available_models``, ``load`` and
``tokenize``.

Port of ``rpo_tpu/clip.py``, the vendored ``clip`` package's public
surface:

    from rpo_tpu_torch import clip
    model, preprocess = clip.load("RN50")
    tokens = clip.tokenize(["a photo of a cat", "a photo of a dog"])
    image = preprocess(uint8_hwc_array)[None]        # (1, H, W, 3)
    logits_per_image, logits_per_text = model(image, tokens)

As in the JAX package: ``load`` takes no ``jit=`` flag and its arguments
after ``name`` are keywords (a ported ``clip.load(name, device)`` fails
at the call); images are **HWC** float, not CHW; weights resolve offline
(``$CLIP_CHECKPOINT``, ``$CLIP_CACHE_DIR`` or ``~/.cache/clip``, else
random ones from ``seed``; ``require_weights=True`` refuses the random
ones).  The model lives on ``device`` (None: the CUDA card, where TF32
is turned off, so a float32 model computes in float32).  The preprocess
takes an HWC uint8 array and resizes it with the port's numpy resample
(Pillow's bicubic, byte for byte); a path or a PIL image needs Pillow,
imported only for them.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, center_crop, load_image, \
    resize_shorter
from .device import DeviceLike
from .models.clip import model as _m
from .models.clip.pretrained import _SHA256, find_checkpoint, load_backbone
from .models.clip.resnet import conv_layout
from .tokenizer import tokenize  # re-exported: the clip package's tokenize

__all__ = ["available_models", "load", "tokenize", "CLIPModel"]

PIXEL_MEAN = np.array(CLIP_PIXEL_MEAN, np.float32)
PIXEL_STD = np.array(CLIP_PIXEL_STD, np.float32)


def available_models() -> List[str]:
    """The names :func:`load` takes."""
    return list(_SHA256)


class CLIPModel:
    """A loaded CLIP backbone with the reference module's call surface:
    ``encode_image``, ``encode_text`` and ``__call__`` -> (logits_per_image,
    logits_per_text), tensors on the model's device, without grad.  The
    weights are ``self.params`` (a ResNet's conv kernels laid out for the
    convolution once, here), the architecture ``self.cfg``."""

    def __init__(self, params: _m.Params, cfg: _m.CLIPConfig):
        if not cfg.is_vit:
            params = {**params, "visual": conv_layout(params["visual"])}
        self.params = params
        self.cfg = cfg
        self.device = params["logit_scale"].device

    @property
    def visual_input_resolution(self) -> int:
        return self.cfg.image_resolution

    @property
    def logit_scale(self) -> torch.Tensor:
        return self.params["logit_scale"]

    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor)
                            else images).to(self.device, torch.float32)
        return x[None] if x.ndim == 3 else x

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens) if not isinstance(tokens, torch.Tensor)
                               else tokens).to(self.device, torch.int64)

    @torch.no_grad()
    def encode_image(self, images) -> torch.Tensor:
        """(B, H, W, 3) normalised float -> (B, embed_dim) features."""
        return _m.encode_image(self.params, self.cfg, self._images(images))

    @torch.no_grad()
    def encode_text(self, tokens) -> torch.Tensor:
        """(B, L) token ids (from :func:`tokenize`) -> (B, embed_dim)."""
        return _m.encode_text(self.params, self.cfg, self._tokens(tokens))

    @torch.no_grad()
    def __call__(self, images, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        return _m.clip_forward(self.params, self.cfg, self._images(images),
                               self._tokens(tokens))


def _make_preprocess(n_px: int) -> Callable:
    """The reference's ``_transform``: the shorter side resized to ``n_px``
    (bicubic), a centre crop, RGB, [0, 1], normalised.  Takes an HWC uint8
    array, a path (or ``synthetic://`` URI) or a PIL image; returns a
    float32 (n_px, n_px, 3) array."""
    def preprocess(img) -> np.ndarray:
        if isinstance(img, str):
            img = load_image(img)
        elif not isinstance(img, np.ndarray):  # a PIL image
            img = np.asarray(img.convert("RGB"), dtype=np.uint8)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected an HWC uint8 RGB array, got {img.dtype} "
                             f"{tuple(img.shape)}")
        img = center_crop(resize_shorter(img, n_px, "bicubic"), n_px)
        x = np.asarray(img, np.float32) / 255.0
        return (x - PIXEL_MEAN) / PIXEL_STD

    return preprocess


def load(name: str, *, dtype: Optional[torch.dtype] = None, require_weights: bool = False,
         seed: int = 0, device: DeviceLike = None) -> Tuple[CLIPModel, Callable]:
    """A CLIP backbone by name -> (model, preprocess).  ``dtype`` casts the
    weights (``torch.bfloat16``, say); None keeps float32."""
    path = find_checkpoint(name)  # once: a cache hit hashes the whole file
    if require_weights and path is None:
        raise FileNotFoundError(
            f"No checkpoint for {name!r}: set $CLIP_CHECKPOINT or place it in "
            "$CLIP_CACHE_DIR (default ~/.cache/clip); nothing is downloaded")
    params, cfg = load_backbone(name, dtype=dtype, seed=seed, path=path, device=device)
    return CLIPModel(params, cfg), _make_preprocess(cfg.image_resolution)
