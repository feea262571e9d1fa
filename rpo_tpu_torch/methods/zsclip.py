"""Zero-shot CLIP baselines, evaluation only.

Port of ``rpo_tpu/methods/zsclip.py``.  ``ZeroshotCLIP`` classifies with
the normalised text features of one hand template per dataset;
``ZeroshotCLIP2`` ensembles IMAGENET_TEMPLATES_SELECT (plus the dataset's
template, except for ImageNet): per-template features normalised, the
mean over templates normalised again.  The backbone runs in bfloat16
whatever the config says, as in the JAX package.  Both are evaluation
only (``--eval-only``): their train hook raises, nothing is saved, and a
model directory is not read.  The trainer plumbing (device, backbone,
cached text features, eval step) is ``CLIPMethodTrainer``'s.  Registered
as ``"ZeroshotCLIP"`` and ``"ZeroshotCLIP2"`` for the engine, which
picks the templates by DATASET.NAME.

The causal text towers send their shared (1, 1, L, L) bias to
``masked_attention`` and the image tower goes to ``rect_attention``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.registry import TRAINER_REGISTRY
from ..models.clip.model import CLIPConfig, encode_image, encode_text
from ..ops.attention import Attention, MaskedAttention
from ..ops.masked_attention import masked_attention
from ..ops.rect_attention import rect_attention
from ..tokenizer import eot_trim, tokenize
from .base_trainer import CLIPMethodTrainer
from .templates import CUSTOM_TEMPLATES, IMAGENET_TEMPLATES_SELECT


def template_tokens(classnames: Sequence[str], templates: Sequence[str]) -> np.ndarray:
    """(n_templates, n_cls, L) prompt tokens, trimmed past the longest EOT
    over all templates (exact under the causal mask)."""
    n_t, n_cls = len(templates), len(classnames)
    tokens = np.stack([
        tokenize([temp.format(c.replace("_", " ")) for c in classnames]) for temp in templates
    ])
    return eot_trim(tokens.reshape(n_t * n_cls, -1)).reshape(n_t, n_cls, -1)


def zeroshot_text_features(
    clip_params: dict,
    cfg: CLIPConfig,
    tokens: torch.Tensor,
    masked_attn: MaskedAttention = masked_attention,
) -> torch.Tensor:
    """Normalised ensemble text features (n_cls, embed_dim) in float32 from
    (n_templates, n_cls, L) tokens: each template's features in float32,
    normalised; the mean over templates, normalised again.  One text tower
    per template (the JAX ``lax.map``)."""
    feats = []
    for toks in tokens:
        tf = encode_text(clip_params, cfg, toks, masked_attn).float()
        feats.append(tf / torch.linalg.vector_norm(tf, dim=-1, keepdim=True))
    mean = torch.stack(feats).mean(dim=0)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True)


def zeroshot_logits(
    clip_params: dict,
    cfg: CLIPConfig,
    images: torch.Tensor,
    text_f: torch.Tensor,
    rect_attn: Attention = rect_attention,
    masked_attn: MaskedAttention = masked_attention,
) -> torch.Tensor:
    """(B, n_cls): exp(logit_scale) times the float32 normalised image
    features against the normalised text features."""
    imf = encode_image(clip_params, cfg, images, rect_attn, masked_attn).float()
    imf = imf / torch.linalg.vector_norm(imf, dim=-1, keepdim=True)
    scale = torch.exp(clip_params["logit_scale"].float())
    return scale * imf @ text_f.T


@TRAINER_REGISTRY.register()
class ZeroshotCLIP(CLIPMethodTrainer):
    """Zero-shot CLIP with the dataset's hand template: nothing trained,
    the text features computed once, the backbone in bfloat16."""

    def __init__(self, classnames: Sequence[str], dataset_name: str = "Caltech101", **kwargs):
        """``kwargs`` go to ``CLIPMethodTrainer`` (backbone, seed, device,
        clip_params: a nested dict of tensors on the device that replaces
        the random backbone, drawn from ``seed`` otherwise, since no CLIP
        checkpoint ships with the repository), with PREC fp16 whatever it
        says."""
        self.classnames = list(classnames)
        self.dataset_name = dataset_name
        super().__init__(**{**kwargs, "prec": "fp16"})

    def cfg_prec(self, cfg) -> str:
        return "fp16"  # no TRAINER.<name>.PREC: always bfloat16

    def method_kwargs(self, cfg) -> dict:
        return {"classnames": self.dm.classnames, "dataset_name": cfg.DATASET.NAME}

    def _select_templates(self):
        temp = CUSTOM_TEMPLATES[self.dataset_name]
        print(f"Prompts template: {temp!r}")
        return [temp]

    def text_tokens(self) -> torch.Tensor:
        """(n_templates, n_cls, L) tokens of this method's templates."""
        tokens = template_tokens(self.classnames, self.templates)
        return torch.from_numpy(tokens.astype(np.int64)).to(self.device)

    def build_method(self) -> None:
        self.templates = self._select_templates()
        self._frozen = {"clip": self.clip_params}
        cfg, normalize = self.clip_cfg, self._normalize

        def text_features(_params, frozen):
            return zeroshot_text_features(frozen["clip"], cfg, self.text_tokens())

        def eval_step(_params, frozen, text_f, images_u8, rect_attn, masked_attn):
            return zeroshot_logits(frozen["clip"], cfg, normalize(images_u8), text_f, rect_attn,
                                   masked_attn)

        self._install_steps(text_features, eval_step)

    def forward_backward(self, batch):
        raise RuntimeError(f"{type(self).__name__} is evaluation-only (use --eval-only)")

    def save_model(self, epoch: int, is_best: bool = False) -> None:
        pass  # nothing trained, nothing to save

    def load_model(self, directory: str, epoch: Optional[int] = None) -> None:
        if not directory:
            print("Note that load_model() is skipped as no pretrained model is given")


@TRAINER_REGISTRY.register()
class ZeroshotCLIP2(ZeroshotCLIP):
    """Prompt ensembling over IMAGENET_TEMPLATES_SELECT."""

    def _select_templates(self):
        templates = list(IMAGENET_TEMPLATES_SELECT)
        if self.dataset_name != "ImageNet":
            templates.append(CUSTOM_TEMPLATES[self.dataset_name])
        print(f"Prompt ensembling (n={len(templates)})")
        return templates
