"""CoCoOp (Zhou et al., CVPR 2022) as the paper states it, in plain PyTorch.

A meta-net (Linear embed -> embed/16, ReLU, Linear -> text width) maps
each image's normalised CLIP feature to a bias that is added to each of
the n_ctx shared context vectors.  For every (image, class) the prompt
"<SOS> ctx_1 .. ctx_n <class name> . <EOT>" runs through the causal text
tower; the EOT row, projected, is the class's text feature for that
image.  The logit is exp(logit_scale) times the cosine of the image and
text features.  The trainable state is ``ctx`` (n_ctx, width) and
``meta_net`` {w1, b1, w2, b2}, weights in (in, out) layout.

The text sequence is cut after the longest EOT: under the causal mask no
row up to an EOT reads a later one.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import clip as C
from .precision import Precision
from .tokenizer import tokenize


class CoCoOpReference:
    def __init__(self, sd: C.StateDict, clip: dict, classnames: Sequence[str], n_ctx: int,
                 chunk: int = 10):
        self.sd, self.clip, self.n_ctx, self.chunk = sd, clip, int(n_ctx), int(chunk)
        device = sd["token_embedding.weight"].device
        prefix = " ".join(["X"] * self.n_ctx)
        tokens = tokenize([f"{prefix} {name.replace('_', ' ')}." for name in classnames],
                          clip["context_length"])
        eot = tokens.argmax(axis=-1)
        L = int(eot.max()) + 1
        ids = torch.from_numpy(tokens[:, :L].astype(np.int64)).to(device)
        self.emb = sd["token_embedding.weight"][ids]  # (n_cls, L, d)
        self.eot = torch.from_numpy(eot.astype(np.int64)).to(device)
        self.mask = C.causal_mask(L, device)

    def meta_net(self, state: Dict, imf: torch.Tensor, p: Precision) -> torch.Tensor:
        net = state["meta_net"]
        return p.mm(torch.relu(p.mm(imf, net["w1"]) + net["b1"]), net["w2"]) + net["b2"]

    def text_features(self, ctx_b: torch.Tensor, p: Precision) -> torch.Tensor:
        """ctx_b (c, n_ctx, d), one context per image -> (c, n_cls, embed)."""
        sd, n = self.sd, self.n_ctx
        c = ctx_b.shape[0]
        n_cls, L, d = self.emb.shape
        emb = self.emb[None].expand(c, n_cls, L, d)
        ctx = p.cast(ctx_b)[:, None].expand(c, n_cls, n, d)
        x = torch.cat([emb[:, :, :1], ctx, emb[:, :, 1 + n:]], dim=2)
        x = p.cast(x + sd["positional_embedding"][:L]).reshape(c * n_cls, L, d)
        x = C.layer_norm(C.text_transformer(sd, self.clip, x, self.mask, p), sd, "ln_final", p)
        eot = self.eot.repeat(c)
        x = x[torch.arange(c * n_cls, device=x.device), eot]
        return p.mm(x, sd["text_projection"]).reshape(c, n_cls, -1)

    def logits(self, state: Dict, images_u8: torch.Tensor, p: Precision) -> torch.Tensor:
        imf = C.normalized(C.encode_image(self.sd, self.clip, images_u8, p))
        ctx_b = state["ctx"][None] + self.meta_net(state, imf, p)[:, None, :]
        scale = torch.exp(self.sd["logit_scale"])
        out = []
        for i in range(0, imf.shape[0], self.chunk):
            tf = C.normalized(self.text_features(ctx_b[i:i + self.chunk], p))
            out.append(scale * torch.einsum("cnd,cd->cn", tf, imf[i:i + self.chunk]))
        return torch.cat(out)
