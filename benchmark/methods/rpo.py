"""RPO: the port's ``methods/rpo_trainer.py`` ``RPO`` and the reference's
``RPOReference``.  Configuration keys: ``clip``, ``prec``, ``K``,
``prompt_template``, ``momentum``, ``weight_decay``."""
from __future__ import annotations

from typing import Sequence

import torch

from .. import inputs, yardstick
from ..reference.rpo import RPOReference
from ..reference.tokenizer import EOT_TOKEN, tokenize
from .common import Work, rect_calls, vision_shape

MODEL = "prompt_learner"


def make_state(config: dict, sd: dict, seed: int, device) -> dict:
    """K text prompts at the EOT embedding and K image prompts at the class
    embedding, each moved by 0.1 times a random unit vector (the method's
    initialisation), float32 on ``device``."""
    K, clip = config["K"], config["clip"]
    gen = torch.Generator(device=device).manual_seed(seed)
    eot = sd["token_embedding.weight"][EOT_TOKEN].to(device, torch.float32)
    cls = sd["visual.class_embedding"].to(device, torch.float32)
    return {"text_prompt": eot[None] + 0.1 * inputs.unit_rows(gen, K, clip["text_width"]),
            "img_prompt": cls[None] + 0.1 * inputs.unit_rows(gen, K, clip["vision_width"])}


def build_trainer(config: dict, classnames: Sequence[str], clip_params, clip_cfg, device):
    from rpo_tpu_torch.methods.rpo_trainer import RPO

    return RPO(list(classnames), prompt_template=config["prompt_template"], K=config["K"],
               prec=config["prec"], device=device, clip_params=clip_params, clip_cfg=clip_cfg,
               momentum=config["momentum"], weight_decay=config["weight_decay"])


def reference(config: dict, sd32: dict, classnames: Sequence[str]) -> RPOReference:
    return RPOReference(sd32, config["clip"], classnames, config["prompt_template"], config["K"])


def prompt_lens(config: dict, classnames: Sequence[str]):
    """Each class prompt's real tokens, EOT included."""
    tokens = tokenize([config["prompt_template"].replace("_", c) for c in classnames],
                      config["clip"]["context_length"])
    return [int(n) + 1 for n in tokens.argmax(axis=-1)]


def work(config: dict, traffic: dict, classnames: Sequence[str]) -> Work:
    clip, K, B = config["clip"], config["K"], traffic["batch"]
    _, S, _ = vision_shape(clip)
    if traffic["kind"] == "train":
        flops = yardstick.rpo_train_step_flops(clip, K, prompt_lens(config, classnames), B)
        # the frozen rows' self-attention and the prompt rows' reads of them
        return Work(flops, {"rect_attention kernel": rect_calls(clip, [(B, S, S), (B, K, S)])})
    flops = yardstick.rpo_eval_batch_flops(clip, K, len(classnames), B)
    return Work(flops, {"rect_attention kernel": rect_calls(clip, [(B, S + K, S)])})
