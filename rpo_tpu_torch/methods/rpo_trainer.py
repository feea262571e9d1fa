"""RPO trainer.

Port of ``rpo_tpu/methods/rpo_trainer.py``: the build (task, prompts,
frozen bundle with the text K/V cache), the per-task text features, the
eval step on uint8 images, and the train step: each step's text features
come from the live prompts through the cached text path, the logits from
the split vision tower, under the base trainer's masked cross-entropy
and SGD.  Registered as ``"RPO"`` for the engine, which builds it from a
config (TRAINER.RPO.K and PREC, DATASET.PROMPT, the dataset's classnames).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..engine.registry import TRAINER_REGISTRY
from ..models.clip.layers import VisionLayer
from ..models.clip.model import ARCHS
from ..ops.fused_text_layer import with_kernel_layout
from . import rpo as core
from .base_trainer import CLIPMethodTrainer


@TRAINER_REGISTRY.register()
class RPO(CLIPMethodTrainer):
    prec_key = "RPO"
    model_name = "prompt_learner"
    log_acc = False  # the reference RPO logs only the loss

    def __init__(
        self,
        classnames: Sequence[str],
        prompt_template: str = "a photo of a _.",
        K: int = 24,
        vision_layer: Optional[VisionLayer] = None,
        **kwargs,
    ):
        """``classnames`` and ``prompt_template`` ('_' is the classname
        slot) make the task; ``vision_layer`` (``fused_rect_residual_block``
        or its plain version) runs each block of the eval vision tower,
        None keeps ``rect_residual_block`` (training always runs the split
        tower); ``kwargs`` go to ``CLIPMethodTrainer`` (backbone, prec,
        seed, device, clip_params, the SGD settings, microbatch)."""
        self.classnames = list(classnames)
        self.prompt_template = prompt_template
        self.K = int(K)
        self.vision_layer = vision_layer
        super().__init__(**kwargs)

    def check_cfg(self, cfg) -> None:
        super().check_cfg(cfg)
        arch = ARCHS.get(cfg.MODEL.BACKBONE.NAME)
        if arch is not None and not arch.is_vit:
            # the reference RPO hardcodes the ViT patch grid and d_v = 768;
            # a ResNet visual tower has no prompt insertion points
            raise ValueError(
                f"RPO requires a ViT backbone, got {cfg.MODEL.BACKBONE.NAME} (ModifiedResNet). "
                "Use CoOp/CoCoOp/LP/ZeroshotCLIP for RN backbones.")

    def method_kwargs(self, cfg) -> dict:
        return {"classnames": self.dm.classnames, "prompt_template": cfg.DATASET.PROMPT,
                "K": int(cfg.TRAINER.RPO.K)}

    def build_method(self) -> None:
        if not self.clip_cfg.is_vit:
            raise ValueError("RPO requires a ViT backbone")
        self.task = core.make_task(
            self.clip_cfg, self.classnames, self.prompt_template, self.K
        )
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = core.init_prompts(gen, self.clip_params, self.clip_cfg, self.K)
        self._frozen = core.make_frozen(self.clip_params, self.task)
        if self.vision_layer is not None:
            # the vision tower's weight matrices also in the fused kernels'
            # layout, laid out once here for every eval launch
            visual = self.clip_params["visual"]
            self._frozen["clip"] = {**self.clip_params, "visual": {
                **visual, "blocks": with_kernel_layout(visual["blocks"])}}

        task = self.task
        normalize = self._normalize
        vision_layer = self.vision_layer

        def text_features(params, frozen):
            return core.encode_text_with_prompts(params, frozen, task)

        def eval_step(params, frozen, text_f, images_u8, rect_attn, masked_attn):
            # the rect tower reads no bias: masked_attn has nothing to replace
            return core.rpo_logits(
                params, frozen, task, normalize(images_u8), text_f=text_f, rect_attn=rect_attn,
                vision_layer=vision_layer,
            )

        # the text tower is the per-step work shared by microbatch chunks:
        # once a step, on the live prompts, under grad; the cached text
        # path reads no square bias, so masked_attn has nothing to replace
        def precompute(params, frozen, masked_attn):
            return core.encode_text_with_prompts(params, frozen, task)

        def logits_fn(params, frozen, images_u8, text_f, rect_attn, masked_attn):
            return core.rpo_logits(params, frozen, task, normalize(images_u8), text_f=text_f,
                                   rect_attn=rect_attn, split_vision=True)

        self._install_steps(text_features, eval_step,
                            self._make_train_step(logits_fn, precompute))
