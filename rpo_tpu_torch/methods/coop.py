"""CoOp: Context Optimization (Zhou et al., 2022).

Port of ``rpo_tpu/methods/coop.py``.  Learnable context vectors (n_ctx, d)
-- or (n_cls, n_ctx, d) with CSC -- are spliced into the embedded class
prompts at an ``end``/``middle``/``front`` class-token position, then run
through the frozen causal text tower; logits are cosine similarities
against frozen image features.

The per-class assembly is a host-precomputed (n_cls, 77) index plan
consumed by one gather and one ``where``, as in the JAX package.  The
causal text tower's shared (1, 1, L, L) bias goes to ``masked_attention``
and the image tower to ``rect_attention``.  A train step runs the text
tower once, under grad (the masked kernel's backward is the plain
recompute), and the frozen image tower without grad, in TRAIN.MICROBATCH
chunks where it is set.  Registered as ``"CoOp"`` for the engine
(TRAINER.COOP's N_CTX, CSC, CLASS_TOKEN_POSITION, CTX_INIT and PREC).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.registry import TRAINER_REGISTRY
from ..models.clip.layers import TextLayer, layer_norm
from ..models.clip.model import CLIPConfig, causal_mask, encode_image, text_transformer_run
from ..tokenizer import get_tokenizer, tokenize
from ..tokenizer.bpe import eot_len
from .base_trainer import CLIPMethodTrainer

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class CoOpTask:
    cfg: CLIPConfig
    n_cls: int
    n_ctx: int
    csc: bool
    text_tokens: np.ndarray  # (n_cls, 77)
    ctx_mask: np.ndarray  # (n_cls, 77) bool: position is a context slot
    ctx_idx: np.ndarray  # (n_cls, 77) int: which context vector
    emb_idx: np.ndarray  # (n_cls, 77) int: which frozen-embedding position
    # Sequence length run through the text tower: max over classes of
    # (EOT position + 1), rounded up to a multiple of 8.  Exact under the
    # causal mask: a query position only attends to keys <= itself and
    # only EOT positions are gathered.
    text_len: int = 77
    _copies: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def on(self, device, L: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The tokens and the plan, columns [:L] (``text_len`` by default),
        as tensors on ``device``: int64 ``tokens``, ``ctx_idx`` and
        ``emb_idx``, bool ``ctx_mask``.  Copied once, at their first use
        there, so that a captured train step copies nothing from the host."""
        L = self.text_len if L is None else int(L)
        key = (str(torch.device(device)), L)
        if key not in self._copies:
            def cut(a, dtype):
                return torch.from_numpy(np.ascontiguousarray(a[:, :L]).astype(dtype)).to(device)

            self._copies[key] = {"tokens": cut(self.text_tokens, np.int64),
                                 "ctx_idx": cut(self.ctx_idx, np.int64),
                                 "emb_idx": cut(self.emb_idx, np.int64),
                                 "ctx_mask": cut(self.ctx_mask, bool)}
        return self._copies[key]


def build_position_plan(
    n_ctx: int, name_lens: np.ndarray, position: str, context_length: int = 77
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Index plan of the end/middle/front assembly.  Position p of the
    final sequence takes either context vector ctx_idx[p] or frozen
    embedding emb_idx[p]."""
    n_cls = len(name_lens)
    L = context_length
    ctx_mask = np.zeros((n_cls, L), dtype=bool)
    ctx_idx = np.zeros((n_cls, L), dtype=np.int32)
    emb_idx = np.tile(np.arange(L, dtype=np.int32), (n_cls, 1))

    for c, name_len in enumerate(np.asarray(name_lens)):
        name_len = int(name_len)
        if position == "end":
            # [SOS][ctx*n_ctx][name,.,EOT,pad...]
            ctx_mask[c, 1 : 1 + n_ctx] = True
            ctx_idx[c, 1 : 1 + n_ctx] = np.arange(n_ctx)
        elif position == "middle":
            h = n_ctx // 2
            p = 1
            ctx_mask[c, p : p + h] = True
            ctx_idx[c, p : p + h] = np.arange(h)
            p += h
            emb_idx[c, p : p + name_len] = 1 + n_ctx + np.arange(name_len)
            p += name_len
            ctx_mask[c, p : p + (n_ctx - h)] = True
            ctx_idx[c, p : p + (n_ctx - h)] = h + np.arange(n_ctx - h)
            # remaining positions: identity (the suffix already sits at
            # 1+n_ctx+name_len onwards in the tokenized layout)
        elif position == "front":
            p = 1
            emb_idx[c, p : p + name_len] = 1 + n_ctx + np.arange(name_len)
            p += name_len
            ctx_mask[c, p : p + n_ctx] = True
            ctx_idx[c, p : p + n_ctx] = np.arange(n_ctx)
        else:
            raise ValueError(f"Unknown CLASS_TOKEN_POSITION {position!r}")
    return ctx_mask, ctx_idx, emb_idx


def make_task(
    cfg: CLIPConfig,
    classnames: Sequence[str],
    n_ctx: int,
    csc: bool,
    position: str,
    prompt_prefix: str,
) -> CoOpTask:
    """Tokenize '<prefix> <name>.' per class and build the splice plan."""
    tok = get_tokenizer()
    classnames = [name.replace("_", " ") for name in classnames]
    name_lens = np.asarray([len(tok.encode(name)) for name in classnames])
    prompts = [f"{prompt_prefix} {name}." for name in classnames]
    tokens = tokenize(prompts)
    ctx_mask, ctx_idx, emb_idx = build_position_plan(
        n_ctx, name_lens, position, cfg.context_length
    )
    return CoOpTask(
        cfg=cfg,
        n_cls=len(classnames),
        n_ctx=n_ctx,
        csc=csc,
        text_tokens=tokens,
        ctx_mask=ctx_mask,
        ctx_idx=ctx_idx,
        emb_idx=emb_idx,
        text_len=eot_len(tokens),
    )


def init_ctx(
    gen: torch.Generator,
    clip_params: Params,
    cfg: CLIPConfig,
    n_cls: int,
    n_ctx: int,
    csc: bool,
    ctx_init: str,
) -> Tuple[Params, str, int]:
    """Context init: the token embeddings of ``ctx_init``'s words if it is
    set, else N(0, 0.02) drawn from ``gen`` on its device; float32 either
    way (the training master copy).  Returns (params, prompt_prefix,
    n_ctx)."""
    if ctx_init:
        ctx_init = ctx_init.replace("_", " ")
        n_ctx = len(ctx_init.split(" "))
        emb = clip_params["text"]["token_embedding"]
        ids = torch.from_numpy(tokenize(ctx_init)[0, 1 : 1 + n_ctx].astype(np.int64))
        # as in the reference, CSC applies only to the random init: with
        # ctx_init the context stays one shared (n_ctx, d) tensor
        ctx = emb[ids.to(emb.device)].float().to(gen.device)
        prompt_prefix = ctx_init
    else:
        shape = (n_cls, n_ctx, cfg.text_width) if csc else (n_ctx, cfg.text_width)
        ctx = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * 0.02
        prompt_prefix = " ".join(["X"] * n_ctx)
    return {"ctx": ctx}, prompt_prefix, n_ctx


def assemble_prompt_embeddings(
    ctx: torch.Tensor, frozen_emb: torch.Tensor, task: CoOpTask
) -> torch.Tensor:
    """(n_cls, L, d) embedded prompts with the context spliced in.

    ctx: (n_ctx, d) or (n_cls, n_ctx, d); frozen_emb: token embeddings of
    the tokenized prompts (n_cls, L, d), where L may be the truncated
    ``task.text_len``; the plan arrays are sliced to match."""
    n_cls, L, d = frozen_emb.shape
    plan = task.on(frozen_emb.device, L)
    ctx_full = ctx.to(frozen_emb.dtype)
    if ctx_full.dim() == 2:
        ctx_full = ctx_full[None].expand(task.n_cls, *ctx_full.shape)
    ctx_idx = plan["ctx_idx"][:, :, None].expand(n_cls, L, d)
    emb_idx = plan["emb_idx"][:, :, None].expand(n_cls, L, d)
    g_ctx = torch.gather(ctx_full, 1, ctx_idx)
    g_emb = torch.gather(frozen_emb, 1, emb_idx)
    return torch.where(plan["ctx_mask"][:, :, None], g_ctx, g_emb)


def text_encoder(
    clip_params: Params,
    cfg: CLIPConfig,
    prompts_emb: torch.Tensor,
    tokens: torch.Tensor,
    text_layer: Optional[TextLayer] = None,
) -> torch.Tensor:
    """Causal text tower on pre-embedded prompts, then the EOT gather and
    the f32-accumulated projection.  Runs at ``prompts_emb``'s length
    (exact, see ``CoOpTask.text_len``); the shared causal bias goes to the
    masked attention kernel, or every whole block to ``text_layer`` where
    one is given (see ``layers.transformer``)."""
    t = clip_params["text"]
    L = prompts_emb.shape[1]
    x = prompts_emb + t["positional_embedding"][:L].to(prompts_emb.dtype)
    bias = causal_mask(L, x.device)[None, None]
    x = text_transformer_run(t, cfg, x, bias, text_layer)
    x = layer_norm(x, t["ln_final"])
    eot_pos = tokens.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot_pos]
    return torch.matmul(x, t["text_projection"])


def coop_text_features(params: Params, clip_params: Params, task: CoOpTask) -> torch.Tensor:
    """(n_cls, embed_dim) class text features in the backbone's dtype."""
    emb = clip_params["text"]["token_embedding"]
    tokens = task.on(emb.device)["tokens"]
    prompts_emb = assemble_prompt_embeddings(params["ctx"], emb[tokens], task)
    return text_encoder(clip_params, task.cfg, prompts_emb, tokens)


def coop_logits(
    params: Params,
    clip_params: Params,
    task: CoOpTask,
    images: torch.Tensor,
    image_features: Optional[torch.Tensor] = None,
    text_f: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, n_cls) cosine logits: both sides L2-normalised in float32, the
    scale exp(logit_scale) in float32."""
    if image_features is None:
        image_features = encode_image(clip_params, task.cfg, images)
    if text_f is None:
        text_f = coop_text_features(params, clip_params, task)
    img = image_features.float()
    txt = text_f.float()
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    scale = torch.exp(clip_params["logit_scale"].float())
    return scale * img @ txt.T


@TRAINER_REGISTRY.register()
class CoOp(CLIPMethodTrainer):
    """The JAX package's ``CoOp`` trainer: the context, the task, the
    per-task text features, the eval step and the train step."""

    prec_key = "COOP"
    model_name = "prompt_learner"

    def __init__(
        self,
        classnames: Sequence[str],
        n_ctx: int = 16,
        csc: bool = False,
        position: str = "end",
        ctx_init: str = "",
        **kwargs,
    ):
        """Settings as the CoOp scripts give them (N_CTX 16, CSC False,
        CLASS_TOKEN_POSITION end, no CTX_INIT); ``kwargs`` go to
        ``CLIPMethodTrainer`` (backbone, prec, seed, device, clip_params)."""
        self.classnames = list(classnames)
        self.n_ctx = int(n_ctx)
        self.csc = bool(csc)
        self.position = position or "end"
        self.ctx_init = ctx_init
        super().__init__(**kwargs)

    def method_kwargs(self, cfg) -> dict:
        tcfg = cfg.TRAINER.COOP
        return {"classnames": self.dm.classnames, "n_ctx": int(tcfg.N_CTX),
                "csc": bool(tcfg.CSC), "position": tcfg.CLASS_TOKEN_POSITION,
                "ctx_init": tcfg.CTX_INIT}

    def build_method(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params, prompt_prefix, n_ctx = init_ctx(
            gen, self.clip_params, self.clip_cfg, len(self.classnames), self.n_ctx,
            self.csc, self.ctx_init,
        )
        print(f'Initial context: "{prompt_prefix}"')
        print(f"Number of context words (tokens): {n_ctx}")
        self.task = make_task(
            self.clip_cfg, self.classnames, n_ctx, self.csc, self.position, prompt_prefix
        )
        self._frozen = {"clip": self.clip_params}

        task = self.task
        normalize = self._normalize

        def text_features(params, frozen):
            return coop_text_features(params, frozen["clip"], task)

        def eval_step(params, frozen, text_f, images_u8):
            return coop_logits(params, frozen["clip"], task, normalize(images_u8), text_f=text_f)

        # the text tower (text_features) is the per-step work the
        # TRAIN.MICROBATCH chunks share: once a step, on the live context,
        # under grad
        def logits_fn(params, frozen, images_u8, text_f):
            return eval_step(params, frozen, text_f, images_u8)

        self._install_steps(text_features, eval_step,
                            self._build_microbatched_train_step(logits_fn, text_features))
