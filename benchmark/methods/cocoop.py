"""CoCoOp: the port's ``methods/cocoop.py`` ``CoCoOp`` and the reference's
``CoCoOpReference``.  Configuration keys: ``clip``, ``prec``, ``n_ctx``,
``ctx_init``, ``momentum``, ``weight_decay``, ``eval_chunk`` (images a
chunk of text towers at eval, the method's)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import yardstick
from ..reference.cocoop import CoCoOpReference
from ..reference.tokenizer import tokenize
from .common import Work, rect_calls, vision_shape

MODEL = "prompt_learner"


def make_state(config: dict, sd: dict, seed: int, device) -> dict:
    """The context at the embeddings of ``ctx_init``'s words plus N(0, 0.02)
    noise, and the meta-net at ``nn.Linear``'s default init, (in, out)
    layout, float32 on ``device``."""
    clip, n_ctx = config["clip"], config["n_ctx"]
    E, dt = clip["embed_dim"], clip["text_width"]
    hidden = E // 16
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.from_numpy(tokenize(config["ctx_init"])[0, 1:1 + n_ctx].astype(np.int64))
    ctx = sd["token_embedding.weight"][ids].to(device, torch.float32)
    ctx = ctx + 0.02 * torch.randn(ctx.shape, generator=gen, device=device)

    def uniform(shape, fan_in):
        u = torch.rand(shape, generator=gen, device=device)
        return (2 * u - 1) / fan_in ** 0.5

    return {"ctx": ctx, "meta_net": {"w1": uniform((E, hidden), E), "b1": uniform((hidden,), E),
                                     "w2": uniform((hidden, dt), hidden),
                                     "b2": uniform((dt,), hidden)}}


def build_trainer(config: dict, classnames: Sequence[str], clip_params, clip_cfg, device):
    from rpo_tpu_torch.methods.cocoop import CoCoOp

    return CoCoOp(list(classnames), n_ctx=config["n_ctx"], ctx_init=config["ctx_init"],
                  prec=config["prec"], device=device, clip_params=clip_params, clip_cfg=clip_cfg,
                  momentum=config["momentum"], weight_decay=config["weight_decay"])


def reference(config: dict, sd32: dict, classnames: Sequence[str]) -> CoCoOpReference:
    return CoCoOpReference(sd32, config["clip"], classnames, config["n_ctx"],
                           config["eval_chunk"])


def eot_rows(config: dict, classnames: Sequence[str]):
    """Each class prompt's rows up to its EOT, and the padded length the
    text towers run at (the longest, rounded up to 8)."""
    tokens = tokenize([f"{config['ctx_init']} {c.replace('_', ' ')}." for c in classnames],
                      config["clip"]["context_length"])
    rows = [int(e) + 1 for e in tokens.argmax(axis=-1)]
    return rows, min(tokens.shape[1], -(-max(rows) // 8) * 8)


def work(config: dict, traffic: dict, classnames: Sequence[str]) -> Work:
    if traffic["kind"] != "eval":
        raise ValueError("the CoCoOp configuration has eval cells only")
    clip, B, n_cls = config["clip"], traffic["batch"], len(classnames)
    _, S, _ = vision_shape(clip)
    rows, L = eot_rows(config, classnames)
    chunk = max(c for c in range(1, min(config["eval_chunk"], B) + 1) if B % c == 0)
    fused = [yardstick.fused_text_layer_work(chunk * n_cls, L, clip["text_width"],
                                             clip["text_heads"])
             for _ in range(B // chunk) for _ in range(clip["text_layers"])]
    return Work(yardstick.cocoop_eval_batch_flops(clip, rows, B, config["n_ctx"]),
                {"rect_attention kernel": rect_calls(clip, [(B, S, S)]),
                 "fused_text_layer kernel": fused})
