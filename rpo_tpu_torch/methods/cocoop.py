"""CoCoOp: Conditional Context Optimization (Zhou et al., 2022).

Port of ``rpo_tpu/methods/cocoop.py``.  A meta-net (Linear d_e -> d_e/16
-> ReLU -> Linear -> d_t) maps each image's normalised CLIP feature to a
bias added to the shared context vectors; the causal text tower then runs
once per (image, class).  The eval path is the JAX package's flattened
branch: per chunk of images, the (chunk x n_cls) prompts are one batch of
text towers, and every layer of those towers is one launch of the
whole-layer kernel (``ops/fused_text_layer.py``); the image tower goes to
``rect_attention``.  CoCoOp has no per-task text features.

The fused text layer is forward-only, so a train step runs the text
towers block by block on ``masked_attention`` under grad: below a batch
of ``ACCUM_BATCH`` one monolithic step, from it on exact gradient
accumulation over chunks of ``ACCUM_CHUNK`` images behind one frozen
image tower over the batch (``_make_grad_accum_train_step``).
Registered as ``"CoCoOp"`` for the engine (TRAINER.COCOOP's N_CTX,
CTX_INIT and PREC).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..engine.registry import TRAINER_REGISTRY
from ..models.clip.layers import TextLayer
from ..models.clip.model import encode_image
from ..ops.fused_text_layer import fused_text_layer, with_text_kernel_layout
from ..parallel import dp
from .base_trainer import CLIPMethodTrainer
from .coop import CoOpTask, init_ctx, make_task, text_encoder

Params = Dict[str, torch.Tensor]

ACCUM_BATCH = 16  # train batches from this size on accumulate over chunks
ACCUM_CHUNK = 8  # images a chunk of the accumulation (rpo_tpu/methods/cocoop.py:225)


def init_meta_net(gen: torch.Generator, vis_dim: int, ctx_dim: int) -> Params:
    """Two-layer MLP with torch nn.Linear's default init, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weights and biases, in the (in, out) layout, float32,
    drawn from ``gen`` on its device."""
    hidden = vis_dim // 16

    def uniform(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return u * (2 * bound) - bound

    return {
        "w1": uniform((vis_dim, hidden), vis_dim),
        "b1": uniform((hidden,), vis_dim),
        "w2": uniform((hidden, ctx_dim), hidden),
        "b2": uniform((ctx_dim,), hidden),
    }


def meta_net_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype))
    return h @ p["w2"].to(x.dtype) + p["b2"].to(x.dtype)


def prompt_assembler(frozen_emb: torch.Tensor, task: CoOpTask):
    """A function ctx_b (c, n_ctx, d) -> (c, n_cls, L, d) prompts:
    ``coop.assemble_prompt_embeddings`` with each image's shared context
    ctx_b[i], as one gather (the JAX package's vmap over images).  The
    plan's index tensors and the frozen embeddings' gather are made once,
    for every chunk."""
    n_cls, L, d = frozen_emb.shape
    plan = task.on(frozen_emb.device, L)
    emb_idx = plan["emb_idx"][:, :, None].expand(n_cls, L, d)
    g_emb = torch.gather(frozen_emb, 1, emb_idx)[None]
    ctx_idx = plan["ctx_idx"]
    ctx_mask = plan["ctx_mask"][None, :, :, None]

    def assemble(ctx_b: torch.Tensor) -> torch.Tensor:
        return torch.where(ctx_mask, ctx_b.to(frozen_emb.dtype)[:, ctx_idx], g_emb)

    return assemble


def cocoop_logits(
    params: Params,
    clip_params: Params,
    task: CoOpTask,
    images: Optional[torch.Tensor],
    chunk: int = 0,
    image_features: Optional[torch.Tensor] = None,
    text_layer: TextLayer = fused_text_layer,
) -> torch.Tensor:
    """(B, n_cls) logits with image-conditioned contexts: the JAX package's
    flattened eval branch (``rpo_tpu/methods/cocoop.py:117-133``).  Per
    chunk of ``chunk`` images (the whole batch if ``chunk`` <= 0 or >= B),
    the chunk's prompts go through the text tower as one (chunk * n_cls, L,
    d) batch whose blocks run ``text_layer`` (bf16; in float32 the blocks
    run one by one on the masked attention, see ``layers.transformer``); the
    text features and the image features are L2-normalised in float32, and
    the logits are exp(logit_scale) times their per-image dot products."""
    cfg = task.cfg
    if image_features is None:
        image_features = encode_image(clip_params, cfg, images).float()
    imf = image_features / torch.linalg.vector_norm(image_features, dim=-1, keepdim=True)
    bias = meta_net_apply(params["meta_net"], imf)  # (B, ctx_dim)
    ctx_shifted = params["ctx"].float()[None] + bias[:, None, :]  # (B, n_ctx, ctx_dim)

    emb = clip_params["text"]["token_embedding"]
    tokens = task.on(emb.device)["tokens"]
    frozen_emb = emb[tokens]
    scale = torch.exp(clip_params["logit_scale"].float())
    n_cls, L = tokens.shape
    assemble = prompt_assembler(frozen_emb, task)

    def per_chunk(ctx_cc: torch.Tensor, imf_cc: torch.Tensor) -> torch.Tensor:
        c = ctx_cc.shape[0]
        flat = assemble(ctx_cc).reshape(c * n_cls, L, -1)
        toks = tokens[None].expand(c, n_cls, L).reshape(c * n_cls, L)
        tf = text_encoder(clip_params, cfg, flat, toks, text_layer).float()
        tf = tf / torch.linalg.vector_norm(tf, dim=-1, keepdim=True)
        return scale * torch.einsum("cnd,cd->cn", tf.view(c, n_cls, -1), imf_cc)

    B = imf.shape[0]
    if chunk <= 0 or chunk >= B:
        return per_chunk(ctx_shifted, imf)
    if B % chunk:
        raise ValueError(f"batch {B} is not divisible by chunk {chunk}")
    return torch.cat([per_chunk(ctx_shifted[i:i + chunk], imf[i:i + chunk])
                      for i in range(0, B, chunk)])


def eval_chunk(batch: int) -> int:
    """The eval step's image chunk: the largest divisor of the batch that
    is at most 10 (``rpo_tpu/methods/cocoop.py:246-248``)."""
    chunk = max(1, min(10, batch))
    while batch % chunk:
        chunk -= 1
    return chunk


@TRAINER_REGISTRY.register()
class CoCoOp(CLIPMethodTrainer):
    """The JAX package's ``CoCoOp`` trainer: the context and meta-net, the
    task, the eval step, the train step and the checkpoint remap."""

    prec_key = "COCOOP"
    model_name = "prompt_learner"

    def __init__(self, classnames: Sequence[str], n_ctx: int = 4, ctx_init: str = "", **kwargs):
        """Settings as ``configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml``
        gives them (N_CTX 4, no CTX_INIT; the context is shared, the class
        token at the end); ``kwargs`` go to ``CLIPMethodTrainer`` (backbone,
        prec, seed, device, clip_params)."""
        self.classnames = list(classnames)
        self.n_ctx = int(n_ctx)
        self.ctx_init = ctx_init
        super().__init__(**kwargs)

    def method_kwargs(self, cfg) -> dict:
        tcfg = cfg.TRAINER.COCOOP
        return {"classnames": self.dm.classnames, "n_ctx": int(tcfg.N_CTX),
                "ctx_init": tcfg.CTX_INIT}

    def build_method(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        cfg = self.clip_cfg
        ctx_params, prompt_prefix, n_ctx = init_ctx(
            gen, self.clip_params, cfg, len(self.classnames), self.n_ctx, False, self.ctx_init
        )
        print(f'Initial context: "{prompt_prefix}"')
        print(f"Number of context words (tokens): {n_ctx}")
        self.params = {
            "ctx": ctx_params["ctx"],
            "meta_net": init_meta_net(gen, cfg.embed_dim, cfg.text_width),
        }
        self.task = task = make_task(cfg, self.classnames, n_ctx, False, "end", prompt_prefix)
        if self.tensor_parallel:
            # a rank's heads need a sum over the model group inside each
            # layer, which the whole-layer kernel has no place for
            print("CoCoOp eval under TRAIN.TENSOR_PARALLEL: the text towers run unfused")
            self._frozen = {"clip": self.clip_params}
        else:
            # the text tower's weight matrices also in the fused kernel's
            # layout, laid out once here for every eval launch
            text = self.clip_params["text"]
            self._frozen = {"clip": {**self.clip_params, "text": {
                **text, "blocks": with_text_kernel_layout(text["blocks"])}}}
        normalize = self._normalize

        # training: the text towers block by block on the masked attention
        # (the fused layer is forward-only); small batches in one step
        def logits_fn(params, frozen, images_u8, _ctx):
            return cocoop_logits(params, frozen["clip"], task, normalize(images_u8),
                                 text_layer=None)

        # large batches: the frozen image tower once over the batch, in
        # float32, then the chunks' text towers with their gradients one
        # chunk at a time
        def precompute(frozen, images_u8):
            return encode_image(frozen["clip"], task.cfg, normalize(images_u8)).float()

        def chunk_logits(params, frozen, imf):
            return cocoop_logits(params, frozen["clip"], task, None, image_features=imf,
                                 text_layer=None)

        # under a mesh each rank accumulates over its own rows' chunks, then
        # one all-reduce: legal where JAX's scan over a sharded batch is not
        mesh = self.mesh
        steps = self._train_steps = {
            "monolithic": self._make_train_step(logits_fn, microbatch=0, mesh=mesh),
            "accumulated": self._make_grad_accum_train_step(precompute, chunk_logits, ACCUM_CHUNK,
                                                            mesh=mesh),
        }
        ranks = 1 if mesh is None else mesh.dp

        def loss_and_grads(params, frozen, images_u8, *rest):
            # the step by the global batch: this rank's rows times the ranks
            B = (images_u8["img"] if isinstance(images_u8, dict) else images_u8).shape[0] * ranks
            return steps["accumulated" if B >= ACCUM_BATCH else "monolithic"](
                params, frozen, images_u8, *rest)

        # no text features; eval_step below
        self._install_steps(None, None, loss_and_grads)

    def loss_and_grads_of(self, kind: str, images_u8, labels, mask):
        """``loss_and_grads`` by the step of ``kind``, "monolithic" or
        "accumulated", whatever the batch: for a comparison of the two."""
        with self._tp_scope():
            return self._train_steps[kind](self.params, self._frozen,
                                           *self._batch(images_u8, labels, mask))[:3]

    @torch.no_grad()
    def eval_step(self, images_u8, text_layer: TextLayer = fused_text_layer) -> torch.Tensor:
        """(B, n_cls) logits for a uint8 (B, H, W, 3) batch: the image
        tower once over the batch, then ``cocoop_logits`` in chunks of
        ``eval_chunk(B)`` images.  ``text_layer`` replaces the kernel (for
        a comparison with its plain version).  Under a
        mesh the batch is this rank's rows and the logits are gathered to
        the global batch; under tensor parallelism the text towers run
        unfused."""
        images = self._normalize(torch.as_tensor(images_u8).to(self.device))
        clip = self._frozen["clip"]
        with self._tp_scope():
            imf = encode_image(clip, self.clip_cfg, images).float()
            logits = cocoop_logits(self.params, clip, self.task, None,
                                   chunk=eval_chunk(imf.shape[0]), image_features=imf,
                                   text_layer=None if self.tensor_parallel else text_layer)
        return logits if self.mesh is None else dp.gather_rows(logits, self.mesh)

    def set_ckpt_state(self, name: str, state) -> None:
        """Reference torch checkpoints too: their prompt_learner state is
        flat ('ctx', 'meta_net.linear1.weight', ...) with torch's (out, in)
        Linear layout, remapped here to the nested (in, out) pytree."""
        if "meta_net.linear1.weight" in state:
            state = {
                "ctx": state["ctx"],
                "meta_net": {
                    "w1": _transposed(state["meta_net.linear1.weight"]),
                    "b1": state["meta_net.linear1.bias"],
                    "w2": _transposed(state["meta_net.linear2.weight"]),
                    "b2": state["meta_net.linear2.bias"],
                },
            }
        super().set_ckpt_state(name, state)


def _transposed(a):
    return a.T if isinstance(a, torch.Tensor) else np.asarray(a).T
