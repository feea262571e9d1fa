"""Linear-probe baseline.

Port of ``rpo_tpu/methods/linear_probe.py``.  One trainable Linear
(embed_dim -> embed_dim), initialised to the identity with a zero bias,
is applied to the *unnormalised* frozen image features; the logits are
scaled products with frozen, normalised text features of
TRAINER.LP.PROMPT (the raw classnames, no underscore replacement).  The
text features are computed once, at the build, on ``masked_attention``;
the image tower runs on ``rect_attention``, without grad in a train
step.  Registered as ``"LP"`` for the engine, whose checkpoints name the
model ``lp_layer``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..engine.registry import TRAINER_REGISTRY
from ..models.clip.model import CLIPConfig, encode_image, encode_text
from ..ops.attention import Attention, MaskedAttention
from ..ops.masked_attention import masked_attention
from ..ops.rect_attention import rect_attention
from ..tokenizer import eot_trim, tokenize
from .base_trainer import CLIPMethodTrainer

Params = Dict[str, torch.Tensor]


def lp_text_features(
    clip_params: dict,
    cfg: CLIPConfig,
    classnames: Sequence[str],
    prompt: str,
    masked_attn: MaskedAttention = masked_attention,
) -> torch.Tensor:
    """(n_cls, embed_dim) normalised float32 text features of
    ``prompt.format(cls_name=c)`` for each raw classname ``c``, tokens
    trimmed past the longest EOT."""
    tokens = eot_trim(tokenize([prompt.format(cls_name=c) for c in classnames]))
    device = clip_params["text"]["token_embedding"].device
    tf = encode_text(clip_params, cfg, torch.from_numpy(tokens.astype(np.int64)).to(device),
                     masked_attn).float()
    return tf / torch.linalg.vector_norm(tf, dim=-1, keepdim=True)


def lp_logits(
    params: Params,
    clip_params: dict,
    cfg: CLIPConfig,
    text_f: torch.Tensor,
    images: torch.Tensor,
    rect_attn: Attention = rect_attention,
) -> torch.Tensor:
    """(B, n_cls): exp(logit_scale) times the probe's float32 output on the
    unnormalised image features, against ``text_f``."""
    imf = encode_image(clip_params, cfg, images, rect_attn).float()
    imf = imf @ params["w"] + params["b"]
    scale = torch.exp(clip_params["logit_scale"].float())
    return scale * imf @ text_f.T


@TRAINER_REGISTRY.register()
class LP(CLIPMethodTrainer):
    """The JAX package's ``LP`` trainer: the probe, the frozen text
    features, the eval and train steps and the torch-layout checkpoint
    remap."""

    prec_key = "LP"
    model_name = "lp_layer"

    def __init__(self, classnames: Sequence[str], prompt: str = "A photo of a {cls_name}",
                 **kwargs):
        """``prompt`` (TRAINER.LP.PROMPT, whose ``{cls_name}`` takes each
        classname as it is); ``kwargs`` go to ``CLIPMethodTrainer``."""
        self.classnames = list(classnames)
        self.prompt = prompt
        super().__init__(**kwargs)

    def method_kwargs(self, cfg) -> dict:
        return {"classnames": self.dm.classnames, "prompt": cfg.TRAINER.LP.PROMPT}

    def build_method(self) -> None:
        cfg = self.clip_cfg
        # applied to the image features: embed_dim wide (the reference sizes
        # it by ln_final's width, the same 512 for ViT-B/16)
        d = cfg.embed_dim
        self.params = {"w": torch.eye(d, dtype=torch.float32, device=self.device),
                       "b": torch.zeros(d, dtype=torch.float32, device=self.device)}
        self.task = None
        with torch.no_grad():
            text_f = lp_text_features(self.clip_params, cfg, self.classnames, self.prompt)
        self._frozen = {"clip": self.clip_params, "text_f": text_f}
        normalize = self._normalize

        def eval_step(params, frozen, _text_f, images_u8, rect_attn, _masked_attn):
            return lp_logits(params, frozen["clip"], cfg, frozen["text_f"], normalize(images_u8),
                             rect_attn)

        def logits_fn(params, frozen, images_u8, _ctx, rect_attn, masked_attn):
            return eval_step(params, frozen, None, images_u8, rect_attn, masked_attn)

        self._install_steps(None, eval_step, self._make_train_step(logits_fn))

    def set_ckpt_state(self, name: str, state) -> None:
        """Reference torch checkpoints too: their lp_layer state is torch's
        ``{weight: (out, in), bias}``, applied as x @ weight.T + bias,
        remapped here to ``{w: (in, out), b}``, applied as x @ w + b."""
        if "weight" in state:
            weight = state["weight"]
            state = {"w": weight.T if isinstance(weight, torch.Tensor) else np.asarray(weight).T,
                     "b": state["bias"]}
        super().set_ckpt_state(name, state)
