"""Shared trainer plumbing for the CLIP prompt methods: the eval half.

Port of the evaluation side of ``rpo_tpu/methods/base_trainer.py``: the
precision map, the per-task text-feature cache, ``model_inference`` and
the checkpoint-state install with its shape validation.  A subclass's
``build_method()`` sets ``self.task``, ``self.params`` and
``self._frozen`` and calls ``_install_steps`` with two functions:

  text_features(params, frozen) -> per-task tensors for eval (or None)
  eval_step(params, frozen, text_f, images_u8, rect_attn, masked_attn) -> logits

The engine around it (config, data, epoch loop, training) is not ported
yet; the trainer takes its settings as arguments.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, device_normalize_fn
from ..device import DeviceLike, resolve_device
from ..models.clip.model import ARCHS, cast_params, init_clip
from ..ops.attention import Attention, MaskedAttention
from ..ops.masked_attention import masked_attention
from ..ops.rect_attention import rect_attention


def prec_dtype(prec: str) -> torch.dtype:
    """Map a reference PREC name to the compute dtype.

    ``fp16`` and ``amp`` both map to bfloat16, as in the JAX package: the
    reference's amp path pairs fp16 compute with a GradScaler because
    fp16's 5-bit exponent underflows gradients, and bf16 keeps fp32's
    8-bit exponent, so the distinction collapses.
    """
    return {"fp16": torch.bfloat16, "amp": torch.bfloat16, "fp32": torch.float32}[prec]


class CLIPMethodTrainer:
    model_name = "model"

    def __init__(
        self,
        backbone: str = "ViT-B/16",
        prec: str = "fp16",
        seed: int = 1,
        device: DeviceLike = None,
        clip_params: Optional[dict] = None,
    ):
        """``clip_params`` (a nested dict of tensors on ``device``) replaces
        the random backbone, which is drawn from ``seed`` otherwise: no CLIP
        checkpoint ships with the repository.  Images are normalised with
        CLIP's pixel statistics (every RPO config's INPUT.PIXEL_MEAN/STD)."""
        if prec not in ("fp16", "fp32", "amp"):
            raise ValueError(f"PREC must be fp16, fp32 or amp, got {prec!r}")
        self.device = resolve_device(device)
        self.seed = max(int(seed), 0)
        self.clip_cfg = ARCHS[backbone]
        dtype = prec_dtype(prec)
        if clip_params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            clip_params = init_clip(gen, self.clip_cfg)
        self.clip_params = cast_params(clip_params, dtype)
        self._normalize = device_normalize_fn(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=dtype)
        self.params = None
        self.build_method()

    def build_method(self) -> None:
        raise NotImplementedError

    def _install_steps(self, text_features, eval_step) -> None:
        self._text_features = text_features
        self._eval_step = eval_step
        self._text_f_cache = None
        if not hasattr(self, "_frozen"):
            raise RuntimeError("build_method must set self._frozen")

    @torch.no_grad()
    def text_features(self):
        """The per-task text features, computed once and cached until the
        trainable state changes."""
        if self._text_features is not None and self._text_f_cache is None:
            self._text_f_cache = self._text_features(self.params, self._frozen)
        return self._text_f_cache

    @torch.no_grad()
    def eval_step(
        self,
        images_u8,
        rect_attn: Attention = rect_attention,
        masked_attn: MaskedAttention = masked_attention,
    ) -> torch.Tensor:
        """(B, n_cls) logits for a uint8 (B, H, W, 3) batch, on the device.
        ``rect_attn`` and ``masked_attn`` replace the attention kernels
        (for a comparison with their plain versions); the cached text
        features are computed with the kernels."""
        images = torch.as_tensor(images_u8).to(self.device)
        return self._eval_step(
            self.params, self._frozen, self.text_features(), images, rect_attn, masked_attn
        )

    def model_inference(self, images: np.ndarray) -> np.ndarray:
        return self.eval_step(images).float().cpu().numpy()

    # -- checkpoint state ---------------------------------------------------
    def set_ckpt_state(self, name: str, state) -> None:
        """Install checkpointed trainable state (a dict of arrays or tensors,
        or of such dicts, as CoCoOp's ``meta_net``; each leaf copied to
        float32 on the device), validated against the method's own:
        Dassl's strict=False semantics — stale / unexpected top-level keys
        are dropped with a warning, missing ones keep their current init,
        but a SHAPE mismatch of any leaf fails here at the load site."""
        state = dict(state)  # never mutate the caller's dict
        for stale in ("token_prefix", "token_suffix"):
            state.pop(stale, None)

        def as_f32(a):
            if isinstance(a, dict):
                return {k: as_f32(v) for k, v in a.items()}
            if isinstance(a, torch.Tensor):
                return a.detach().to(self.device, torch.float32, copy=True)
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(self.device)

        if self.params is None:
            self.params = as_f32(state)
            self._text_f_cache = None
            return
        unexpected = sorted(k for k in state if k not in self.params)
        missing = sorted(k for k in self.params if k not in state)
        if unexpected:
            print(f"WARNING: ignoring unexpected checkpoint keys for {name}: {unexpected}")
        if missing:
            print(f"WARNING: checkpoint for {name} missing keys {missing}; "
                  "keeping their current values")

        def install(key, old, new):
            """``new`` in float32 on the device, in ``old``'s structure and
            shapes (``key`` is the top-level key, for the message)."""
            if isinstance(old, dict):
                if not isinstance(new, dict) or set(new) != set(old):
                    got = sorted(new) if isinstance(new, dict) else type(new).__name__
                    raise ValueError(f"checkpoint structure mismatch for {name}.{key}: got "
                                     f"{got}, expected {sorted(old)}")
                return {k: install(key, old[k], new[k]) for k in old}
            arr = as_f32(new)
            if tuple(arr.shape) != tuple(old.shape):
                raise ValueError(
                    f"checkpoint shape mismatch for {name}.{key}: got "
                    f"{tuple(arr.shape)}, expected {tuple(old.shape)} — "
                    "is this a checkpoint from a different method/backbone?"
                )
            return arr

        self.params = {k: install(k, old, state[k]) if k in state else old
                       for k, old in self.params.items()}
        self._text_f_cache = None
