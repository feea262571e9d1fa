"""RPO (Lee et al., ICCV 2023) as the paper states it, in plain PyTorch.

K text prompts replace the K tokens after each class prompt's EOT, and K
image prompts are appended after the class and patch tokens.  Read-only
masks: a frozen token never reads a prompt, and a prompt reads only the
frozen tokens (not itself, not another prompt); the text side keeps the
causal mask besides.  Both towers run whole, every row of every layer,
with these masks.  The prompt rows' outputs are projected; the logit of
class c is exp(logit_scale) times the mean over the K pairs of the
cosine between image prompt k and class c's text prompt k.

The text sequence is cut after the last prompt slot of the longest class:
no kept row reads a later one under the causal mask.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import clip as C
from .precision import Precision
from .tokenizer import tokenize

State = Dict[str, torch.Tensor]


class RPOReference:
    def __init__(self, sd: C.StateDict, clip: dict, classnames: Sequence[str], template: str,
                 K: int):
        self.sd, self.clip, self.K = sd, clip, int(K)
        device = sd["token_embedding.weight"].device
        tokens = tokenize([template.replace("_", name) for name in classnames],
                          clip["context_length"])
        lens = tokens.argmax(axis=-1) + 1  # real tokens, EOT included
        T = int(lens.max()) + self.K
        ids = torch.from_numpy(tokens[:, :T].astype(np.int64)).to(device)
        self.x0 = sd["token_embedding.weight"][ids] + sd["positional_embedding"][:T]
        lens_t = torch.from_numpy(lens.astype(np.int64)).to(device)
        rows = torch.arange(T, device=device)[:, None]
        cols = torch.arange(T, device=device)[None, :]
        blocked = (cols > rows)[None] | (cols[None] >= lens_t[:, None, None])
        zero = torch.zeros((), device=device)
        self.text_mask = torch.where(blocked, zero - float("inf"), zero)[:, None]
        slots = lens_t[:, None] + torch.arange(self.K, device=device)[None]  # (n_cls, K)
        self.slots = slots
        self.onehot = (torch.arange(T, device=device)[None, :, None] == slots[:, None, :]).float()

    def text_features(self, state: State, p: Precision) -> torch.Tensor:
        """(n_cls, K, embed): the text prompts' rows after the tower."""
        sd = self.sd
        is_prompt = self.onehot.sum(-1, keepdim=True)
        x = self.x0 * (1 - is_prompt) + torch.einsum("ctk,kd->ctd", self.onehot,
                                                    state["text_prompt"])
        x = C.text_transformer(sd, self.clip, p.cast(x), self.text_mask, p)
        x = C.layer_norm(x, sd, "ln_final", p)
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        return p.mm(x[rows, self.slots], sd["text_projection"])

    def image_features(self, state: State, images_u8: torch.Tensor, p: Precision) -> torch.Tensor:
        """(B, K, embed): the image prompts' rows after the tower."""
        sd, K = self.sd, self.K
        x = C.vision_tokens(sd, self.clip, images_u8, p)
        B, S, _ = x.shape
        x = torch.cat([x, p.cast(state["img_prompt"])[None].expand(B, K, -1)], dim=1)
        mask = torch.zeros(S + K, S + K, device=x.device)
        mask[:, S:] = float("-inf")
        x = C.vision_transformer(sd, self.clip, x, mask, p)
        return p.mm(C.layer_norm(x[:, -K:], sd, "visual.ln_post", p), sd["visual.proj"])

    def logits(self, state: State, images_u8: torch.Tensor, p: Precision,
               text_f: torch.Tensor = None) -> torch.Tensor:
        if text_f is None:
            text_f = self.text_features(state, p)
        img = C.normalized(self.image_features(state, images_u8, p))
        txt = C.normalized(text_f)
        scale = torch.exp(self.sd["logit_scale"])
        return scale * torch.einsum("bke,cke->bc", img, txt) / self.K
