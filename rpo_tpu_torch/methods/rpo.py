"""RPO: Read-only Prompt Optimization (ICCV 2023).

Port of ``rpo_tpu/methods/rpo.py``.  The method learns K text-prompt
vectors (K, d_t) and K visual-prompt vectors (K, d_v) injected into a
frozen CLIP under read-only attention masks: prompts read the frozen
tokens; frozen tokens (and other prompts, and the prompt itself) never
read the prompts.

The host-side task (tokens, masks) is a copy of the JAX package's.  The
text side caches each layer's frozen K/V once per task and pushes only
the K prompt rows per class through the tower; the eval vision side runs
the rect tower, where every row attends to the frozen rows only (the
``rect_attention`` kernel in every block, or, given ``vision_layer=
fused_rect_residual_block``, one attention-half and one MLP-half kernel
per block).  Training runs the split vision tower
(``encode_image_prompts_split``): the frozen rows without grad, the K
prompt rows cross-attending to each layer's frozen K/V; ``rpo_loss`` is
its cross-entropy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.clip.layers import (
    VisionLayer,
    cross_residual_block,
    layer_norm,
    layer_params,
    n_layers,
    rect_residual_block,
    residual_block_kv,
)
from ..models.clip.model import CLIPConfig, causal_mask, text_transformer_run, vision_embed
from ..ops.attention import NEG_INF
from ..tokenizer import EOT_TOKEN, tokenize

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# masks (host-side, static per task)
# ---------------------------------------------------------------------------

def build_text_mask(len_prompts: np.ndarray, context_length: int = 77) -> np.ndarray:
    """(n_cls, 1, L, L) float32 additive bias.

    Per class c with idx = #real tokens (incl. EOT):
      col >= idx           -> masked (frozen tokens never see prompts/pads;
                              a prompt sees neither itself nor other prompts)
      col >  row (causal)  -> masked
      otherwise            -> visible
    """
    L = context_length
    rows = np.arange(L)[:, None]
    cols = np.arange(L)[None, :]
    causal = cols > rows  # (L, L)
    idx = np.asarray(len_prompts).reshape(-1, 1, 1)  # (n_cls, 1, 1)
    blocked = causal[None] | (cols[None] >= idx)  # (n_cls, L, L)
    return np.where(blocked, NEG_INF, 0.0).astype(np.float32)[:, None]


def build_prompt_col_mask(len_prompts: np.ndarray, kv_len: int) -> np.ndarray:
    """(n_cls, 1, 1, kv_len) float32 additive bias for the cached-KV path:
    prompt rows of class c may read only the frozen columns
    ``col < len_prompts[c]``."""
    cols = np.arange(kv_len)[None, :]
    blocked = cols >= np.asarray(len_prompts)[:, None]
    return np.where(blocked, NEG_INF, 0.0).astype(np.float32)[:, None, None, :]


def build_visual_mask(seq_len: int, K: int) -> np.ndarray:
    """(1, 1, S, S) float32: last K columns masked for every row — visual
    prompts are appended after CLS+patches and are invisible to
    everything, including themselves."""
    mask = np.zeros((seq_len, seq_len), dtype=np.float32)
    mask[:, seq_len - K :] = NEG_INF
    return mask[None, None]


# ---------------------------------------------------------------------------
# task construction (host-side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RPOTask:
    """Static per-(dataset, class-subset) state.

    ``prompt_onehot[c, p, i] = 1`` iff position p of class c's sequence is
    prompt slot i (p == len_prompts[c] + i).
    """

    cfg: CLIPConfig
    K: int
    n_cls: int
    text_tokens: np.ndarray  # (n_cls, 77) int32
    len_prompts: np.ndarray  # (n_cls,) int32 — #real tokens incl. EOT
    text_mask: np.ndarray  # (n_cls, 1, 77, 77) f32
    visual_mask: np.ndarray  # (1, 1, S, S) f32
    prompt_onehot: np.ndarray  # (n_cls, 77, K) f32


def make_task(cfg: CLIPConfig, classnames, prompt_template: str, K: int) -> RPOTask:
    """Tokenize per-class prompts and build masks.

    prompt_template uses '_' as the classname slot, e.g. "a photo of a _."
    """
    if K < 1:
        raise ValueError("K should be bigger than 0")
    prompts = [prompt_template.replace("_", c) for c in classnames]
    tokens = tokenize(prompts, cfg.context_length)
    len_prompts = tokens.argmax(axis=-1).astype(np.int32) + 1
    if int((len_prompts + K).max()) > cfg.context_length:
        raise ValueError(
            f"K={K} prompt tokens do not fit after the longest classname "
            f"(max len {int(len_prompts.max())}, context {cfg.context_length})"
        )
    seq_len = cfg.vision_seq_len + K
    n_cls = len(classnames)
    positions = np.arange(cfg.context_length)[None, :, None]  # (1, 77, 1)
    slots = len_prompts[:, None, None] + np.arange(K)[None, None, :]  # (n_cls, 1, K)
    prompt_onehot = (positions == slots).astype(np.float32)  # (n_cls, 77, K)
    return RPOTask(
        cfg=cfg,
        K=K,
        n_cls=n_cls,
        text_tokens=tokens,
        len_prompts=len_prompts,
        text_mask=build_text_mask(len_prompts, cfg.context_length),
        visual_mask=build_visual_mask(seq_len, K),
        prompt_onehot=prompt_onehot,
    )


# ---------------------------------------------------------------------------
# prompt params
# ---------------------------------------------------------------------------

def init_prompts(
    gen: torch.Generator, clip_params: Params, cfg: CLIPConfig, K: int
) -> Params:
    """EOT/CLS embedding + 0.1 * L2-normalized Gaussian noise, in float32
    (the training master copy), drawn from ``gen`` on its device."""
    vocab = clip_params["text"]["token_embedding"].shape[0]
    if EOT_TOKEN >= vocab:
        raise ValueError(f"EOT token {EOT_TOKEN} out of vocab ({vocab})")

    def noise(width):
        n = torch.randn((K, width), generator=gen, device=gen.device, dtype=torch.float32)
        return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)

    eot_emb = clip_params["text"]["token_embedding"][EOT_TOKEN].float().to(gen.device)
    text_prompt = eot_emb[None, :] + 0.1 * noise(cfg.text_width)
    cls_emb = clip_params["visual"]["class_embedding"].float().to(gen.device)
    img_prompt = cls_emb[None, :] + 0.1 * noise(cfg.vision_width)
    return {"text_prompt": text_prompt, "img_prompt": img_prompt}


def precompute_text_x(clip_params: Params, task: RPOTask) -> torch.Tensor:
    """Frozen embedded class prompts + positional: the text tower input
    before prompt injection.  Computed once per task."""
    t = clip_params["text"]
    tokens = torch.from_numpy(task.text_tokens.astype(np.int64)).to(t["token_embedding"].device)
    emb = t["token_embedding"][tokens]
    return emb + t["positional_embedding"].to(emb.dtype)


def precompute_text_kv(clip_params: Params, task: RPOTask) -> Dict[str, torch.Tensor]:
    """Per-layer frozen-text K/V.

    The text mask blocks every column >= idx_c for every row, so frozen
    rows see exactly the plain causal context at every layer and prompt
    rows read only frozen columns.  Each layer's frozen K/V is computed
    once per task, truncated to T = max(len_prompts) columns (columns past
    the longest real sequence are masked for every class).  The causal
    tower's attention is the masked attention kernel.

    Returns {"k", "v"}: (L_layers, n_cls, H, T, Dh).
    """
    cfg = task.cfg
    t = clip_params["text"]
    x = precompute_text_x(clip_params, task)
    bias = causal_mask(cfg.context_length, x.device)[None, None]
    kv_len = int(task.len_prompts.max())
    ks, vs = [], []
    for i in range(n_layers(t["blocks"])):
        x, k, v = residual_block_kv(x, layer_params(t["blocks"], i), cfg.text_heads, bias)
        ks.append(k[:, :, :kv_len])
        vs.append(v[:, :, :kv_len])
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def make_frozen(clip_params: Params, task: RPOTask, cache_text_kv: bool = True) -> Params:
    """Bundle every non-trainable tensor the RPO forward reads.

    cache_text_kv=True adds the per-layer frozen-text K/V cache, which
    switches encode_text_with_prompts to the prompt-rows-only path; False
    keeps what the masked text formulation reads instead.
    """
    device = clip_params["logit_scale"].device
    bundle = {"clip": clip_params}
    if cache_text_kv:
        kv = precompute_text_kv(clip_params, task)
        bundle["text_kv"] = kv
        bundle["prompt_col_mask"] = torch.from_numpy(
            build_prompt_col_mask(task.len_prompts, kv["k"].shape[-2])
        ).to(device)
    else:
        bundle["text_x"] = precompute_text_x(clip_params, task)
        bundle["prompt_onehot"] = torch.from_numpy(task.prompt_onehot).to(device)
        bundle["text_mask"] = torch.from_numpy(task.text_mask).to(device)
    return bundle


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def encode_text_prompts_cached(prompts: Params, frozen: Params, task: RPOTask) -> torch.Tensor:
    """Fast text path: push ONLY the K prompt rows per class through the
    tower, cross-attending each layer to the precomputed frozen K/V.

    Prompt vectors REPLACE the embedded tokens at their positions, so they
    carry no positional embedding: the initial row state is the raw
    prompt vector, identical across classes (an ``expand``: under grad
    the gradient sums over the classes).  The column-broadcast bias takes
    the plain attention math, no kernel.
    """
    cfg = task.cfg
    t = frozen["clip"]["text"]
    kv = frozen["text_kv"]
    bias = frozen["prompt_col_mask"]
    dtype = kv["k"].dtype
    tp = prompts["text_prompt"].to(dtype)  # (K, d_t)
    x = tp[None].expand(task.n_cls, task.K, cfg.text_width)
    for i in range(n_layers(t["blocks"])):
        x = cross_residual_block(
            x, kv["k"][i], kv["v"][i], layer_params(t["blocks"], i), cfg.text_heads, bias
        )
    x = layer_norm(x, t["ln_final"])  # (n_cls, K, d_t) — rows ARE the prompts
    return torch.matmul(x, t["text_projection"])


def encode_text_with_prompts(prompts: Params, frozen: Params, task: RPOTask) -> torch.Tensor:
    """Masked text tower -> prompt-position features (n_cls, K, embed).

    Takes the prompt-rows-only path when the bundle carries the K/V cache
    (make_frozen's default); otherwise runs the full 77-token tower under
    the RPO text mask."""
    if "text_kv" in frozen:
        return encode_text_prompts_cached(prompts, frozen, task)
    cfg = task.cfg
    t = frozen["clip"]["text"]
    text_x = frozen["text_x"]
    dtype = text_x.dtype
    onehot = frozen["prompt_onehot"].to(dtype)  # (n_cls, 77, K)
    tp = prompts["text_prompt"].to(dtype)  # (K, d_t)
    is_prompt = onehot.sum(dim=-1, keepdim=True)  # (n_cls, 77, 1) 0/1
    injected = torch.einsum("cpk,kd->cpd", onehot, tp)
    x = text_x * (1.0 - is_prompt).to(dtype) + injected
    x = text_transformer_run(t, cfg, x, frozen["text_mask"])
    x = layer_norm(x, t["ln_final"])
    feats = torch.einsum("cpk,cpd->ckd", onehot.to(x.dtype), x)  # (n_cls, K, d_t)
    return torch.matmul(feats, t["text_projection"])


def encode_image_with_prompts(
    prompts: Params,
    frozen: Params,
    task: RPOTask,
    images: torch.Tensor,
    vision_layer: Optional[VisionLayer] = None,
) -> torch.Tensor:
    """Vision tower with appended prompts -> prompt features (B, K, embed).

    One joint pass per layer over cls+patches+prompts in which keys and
    values come only from the frozen rows (rect_residual_block): the
    visual mask blocks the K prompt columns for every row, so the masked
    K/V are never computed and no (S, S) bias exists.  ``vision_layer``
    (``fused_rect_residual_block`` or its plain version) runs each whole
    block instead; None keeps ``rect_residual_block``.
    """
    cfg = task.cfg
    v = frozen["clip"]["visual"]
    K = task.K
    x = vision_embed(v, cfg, images)  # (B, 197, d_v) — cls+patches+pos
    dtype = x.dtype
    n_kv = x.shape[1]  # frozen rows: cls + patches
    ip = prompts["img_prompt"].to(dtype)[None].expand(x.shape[0], K, cfg.vision_width)
    x = torch.cat([x, ip], dim=1)  # append prompts
    x = layer_norm(x, v["ln_pre"])
    for i in range(n_layers(v["blocks"])):
        blk = layer_params(v["blocks"], i)
        if vision_layer is None:
            x = rect_residual_block(x, blk, cfg.vision_heads, n_kv)
        else:
            x = vision_layer(x, blk, cfg.vision_heads, n_kv)
    feats = layer_norm(x[:, -K:, :], v["ln_post"])  # (B, K, d_v)
    return torch.matmul(feats, v["proj"])


def encode_image_prompts_split(
    prompts: Params,
    frozen: Params,
    task: RPOTask,
    images: torch.Tensor,
) -> torch.Tensor:
    """Training-path vision tower: frozen rows and prompt rows split ->
    prompt features (B, K, embed).

    The visual mask blocks the K prompt columns for every row, so the
    cls+patch rows see plain self-attention, independent of the prompts,
    and the prompt rows read only frozen columns.  The (B, 197, d_v)
    frozen rows run ``residual_block_kv`` under ``torch.no_grad()`` (the
    JAX ``stop_gradient``); the (B, K, d_v) prompt rows run
    ``cross_residual_block`` on that layer's k, v, so the backward covers
    the K prompt rows only.  The same function as
    ``encode_image_with_prompts``; both attentions are bias-free and go
    to the rect attention kernel.
    """
    cfg = task.cfg
    v = frozen["clip"]["visual"]
    K = task.K
    with torch.no_grad():
        x_f = layer_norm(vision_embed(v, cfg, images), v["ln_pre"])  # (B, 197, d_v)
    dtype = x_f.dtype
    ip = prompts["img_prompt"].to(dtype)[None].expand(x_f.shape[0], K, cfg.vision_width)
    x_p = layer_norm(ip, v["ln_pre"])
    for i in range(n_layers(v["blocks"])):
        blk = layer_params(v["blocks"], i)
        with torch.no_grad():
            x_f, k, v_heads = residual_block_kv(x_f, blk, cfg.vision_heads)
        x_p = cross_residual_block(x_p, k, v_heads, blk, cfg.vision_heads)
    feats = layer_norm(x_p, v["ln_post"])  # (B, K, d_v)
    return torch.matmul(feats, v["proj"])


def rpo_logits(
    prompts: Params,
    frozen: Params,
    task: RPOTask,
    images: torch.Tensor,
    text_f: Optional[torch.Tensor] = None,
    vision_layer: Optional[VisionLayer] = None,
    split_vision: bool = False,
) -> torch.Tensor:
    """(B, n_cls) classification logits: mean over K prompt pairs of the
    scaled cosine similarity.  Pass a precomputed ``text_f`` for
    evaluation (the text tower runs once per task).  ``split_vision``
    selects the training tower (``encode_image_prompts_split``), else
    ``encode_image_with_prompts`` runs with ``vision_layer``."""
    if text_f is None:
        text_f = encode_text_with_prompts(prompts, frozen, task)
    if split_vision:
        if vision_layer is not None:
            raise ValueError("the split vision tower takes no vision_layer")
        img_f = encode_image_prompts_split(prompts, frozen, task, images)
    else:
        img_f = encode_image_with_prompts(prompts, frozen, task, images, vision_layer)
    text_f = text_f.float()
    img_f = img_f.float()
    text_f = text_f / torch.linalg.vector_norm(text_f, dim=-1, keepdim=True)
    img_f = img_f / torch.linalg.vector_norm(img_f, dim=-1, keepdim=True)
    scale = torch.exp(frozen["clip"]["logit_scale"].float())
    # mean over K of per-pair cosine logits == einsum / K
    return scale * torch.einsum("bke,cke->bc", img_f, text_f) / task.K


def rpo_loss(
    prompts: Params,
    frozen: Params,
    task: RPOTask,
    images: torch.Tensor,
    labels: torch.Tensor,
    split_vision: bool = True,
):
    """Cross-entropy over the batch; returns (loss, logits).  The split
    vision tower by default: the training path."""
    logits = rpo_logits(prompts, frozen, task, images, split_vision=split_vision)
    log_probs = torch.log_softmax(logits, dim=-1)
    loss = -log_probs.gather(-1, labels.long()[:, None]).mean()
    return loss, logits
