"""Shared trainer plumbing for the CLIP prompt methods.

Port of ``rpo_tpu/methods/base_trainer.py``: the precision map, the
per-task text-feature cache, ``model_inference``, the checkpoint-state
install with its shape validation, and the train step (masked
cross-entropy, gradients of the trainable tensors only, SGD, masked
top-1 accuracy) with its optimizer state.  A subclass's
``build_method()`` sets ``self.task``, ``self.params`` and
``self._frozen`` and calls ``_install_steps`` with

  text_features(params, frozen) -> per-task tensors for eval (or None)
  eval_step(params, frozen, text_f, images_u8, rect_attn, masked_attn) -> logits

and, for a method that trains, the ``loss_and_grads`` function that
``_make_train_step`` builds (or ``_make_grad_accum_train_step``, exact
gradient accumulation over image chunks: CoCoOp at batch 16 and above).

The engine's hooks (``forward_backward``, ``forward_backward_multi``)
run a step, or a group of N steps (TRAIN.STEPS_PER_DISPATCH), as one
replay of a captured CUDA graph on the card (``step_graph.StepGraph``,
JAX's ``jax.jit`` and ``make_multi``); ``before_train`` captures the
graphs the epoch loop will replay when TRAIN.PREWARM_COMPILE is set,
else each is captured at its first use.  On the CPU, which a caller
asks for, the hooks run the same steps one by one.  ``train_step`` and
``loss_and_grads`` run one step eagerly, with the kernels replaceable by
their plain versions.  Images go through ``make_image_prep``: with
INPUT.DEVICE_RESIZE a train batch is the {img, box, flip} of raw sources
and the crops, resized on the device (``ops/preprocess.py``).

A trainer is built one of two ways.  Its keyword constructor takes the
settings as arguments (the caller then sets ``current_lr`` before a
step); ``TrainerBase.from_cfg`` (``engine.build_trainer``, the CLI)
reads them from a config in ``build_model`` and adds the engine around
the same object: the data manager, the epoch loop with its LR schedule,
checkpoints, resume and the final test.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from ..device import DeviceLike, resolve_device
from ..engine import optim
from ..engine.trainer import TrainerBase, _load_checkpoint_file
from ..models.clip.model import ARCHS, CLIPConfig, cast_params
from ..models.clip.pretrained import load_backbone
from ..models.clip.resnet import conv_layout
from ..ops.attention import Attention, MaskedAttention
from ..ops.masked_attention import masked_attention
from ..ops.preprocess import _mean_std_u8, device_eval_preprocess, device_train_preprocess
from ..ops.rect_attention import rect_attention
from .step_graph import StepGraph, batch_spec, train_batch_spec


def make_image_prep(size: int, mean, std, dtype, device_resize: int = 0):
    """uint8 images -> the normalised ``dtype`` batch, by what arrives
    (``make_image_prep`` of the JAX package, with INPUT.SIZE = ``size``):

    - without ``device_resize``, ``(x - mean*255) / (std*255)`` in
      float32 (``device_normalize_fn``'s arithmetic);
    - with it, a {img, box, flip} train batch goes through
      ``device_train_preprocess`` (crops, resize and flips on the
      device), a (B, size, size, 3) batch is normalised, and a batch of
      any other size (the raw eval sources) goes through
      ``device_eval_preprocess``.

    The constants are copied to a device once, at their first use there,
    so that a captured step copies nothing from the host."""
    stats = {}

    def on(device):
        if device not in stats:
            stats[device] = _mean_std_u8(mean, std, device)
        return stats[device]

    def prep(images_u8):
        if isinstance(images_u8, dict):
            img = images_u8["img"]
            x = device_train_preprocess(img, images_u8["box"], images_u8["flip"], size,
                                        *on(img.device))
        elif not int(device_resize) or tuple(images_u8.shape[1:3]) == (size, size):
            m, s = on(images_u8.device)
            x = (images_u8.float() - m) / s
        else:
            x = device_eval_preprocess(images_u8, size, *on(images_u8.device))
        return x.to(dtype)

    return prep


def prewarm_plan(group: int, num_batches: int):
    """Which train programs will the epoch loop dispatch?  As
    ``engine.trainer._run_epoch_inner``: the grouped one for full groups
    of ``group`` batches only; the trailing partial group (and every
    batch, when ``group == 1`` or the epoch is shorter than one group)
    goes through the one-step program.  Returns ``(warm_grouped,
    warm_single)``."""
    warm_grouped = group > 1 and num_batches >= group
    warm_single = not warm_grouped or num_batches % group != 0
    return warm_grouped, warm_single


def _rows(images, a: int, b: int):
    """Rows [a, b) of an image batch: a tensor, or the device-resize
    {img, box, flip} dict."""
    if isinstance(images, dict):
        return {key: t[a:b] for key, t in images.items()}
    return images[a:b]


def prec_dtype(prec: str) -> torch.dtype:
    """Map a reference PREC name to the compute dtype.

    ``fp16`` and ``amp`` both map to bfloat16, as in the JAX package: the
    reference's amp path pairs fp16 compute with a GradScaler because
    fp16's 5-bit exponent underflows gradients, and bf16 keeps fp32's
    8-bit exponent, so the distinction collapses.
    """
    return {"fp16": torch.bfloat16, "amp": torch.bfloat16, "fp32": torch.float32}[prec]


class CLIPMethodTrainer(TrainerBase):
    prec_key = ""  # e.g. "RPO": the config's TRAINER.RPO.PREC
    model_name = "model"
    log_acc = True  # the CoOp family logs accuracy; RPO only the loss

    def __init__(
        self,
        backbone: str = "ViT-B/16",
        prec: str = "fp16",
        seed: int = 1,
        device: DeviceLike = None,
        clip_params: Optional[dict] = None,
        clip_cfg: Optional[CLIPConfig] = None,
        momentum: float = 0.9,
        weight_decay: float = 5e-4,
        nesterov: bool = False,
        dampening: float = 0.0,
        microbatch: int = 0,
        pixel_mean=CLIP_PIXEL_MEAN,
        pixel_std=CLIP_PIXEL_STD,
        device_resize: int = 0,
    ):
        """``clip_params`` (a nested dict of tensors on ``device``, with
        ``clip_cfg``, its architecture: ``ARCHS[backbone]`` where None)
        replaces the backbone that ``load_backbone`` resolves otherwise: a
        checkpoint (``$CLIP_CHECKPOINT``, the cache directory), else random
        weights drawn from ``seed``.  A ModifiedResNet's conv kernels are
        laid out for the convolution once, here (``resnet.conv_layout``).
        Images are normalised with ``pixel_mean`` and ``pixel_std``
        (INPUT.PIXEL_MEAN/STD; CLIP's, as every method config sets them),
        through ``make_image_prep`` with ``device_resize``
        (INPUT.DEVICE_RESIZE: 0 for images already at the model's size).
        ``momentum``, ``weight_decay``, ``nesterov`` and ``dampening`` are
        the SGD settings (OPTIM.MOMENTUM, WEIGHT_DECAY, SGD_NESTEROV,
        SGD_DAMPNING; nesterov with dampening raises); ``microbatch``
        (TRAIN.MICROBATCH) computes the train forward in chunks of that
        many images inside the one loss and gradient."""
        if prec not in ("fp16", "fp32", "amp"):
            raise ValueError(f"PREC must be fp16, fp32 or amp, got {prec!r}")
        if nesterov and dampening:
            raise ValueError("Nesterov momentum requires zero dampening")
        self._momentum = float(momentum)
        self._weight_decay = float(weight_decay)
        self._nesterov = bool(nesterov)
        self._dampening = float(dampening)
        self._microbatch = int(microbatch)
        self.current_lr: Optional[float] = None
        self.device = resolve_device(device)
        self.seed = max(int(seed), 0)
        dtype = prec_dtype(prec)
        if clip_params is None:
            clip_params, clip_cfg = load_backbone(backbone, seed=self.seed, device=self.device)
        self.clip_cfg = ARCHS[backbone] if clip_cfg is None else clip_cfg
        self.clip_params = cast_params(clip_params, dtype)
        if not self.clip_cfg.is_vit:
            self.clip_params = {**self.clip_params,
                                "visual": conv_layout(self.clip_params["visual"])}
        self._normalize = make_image_prep(self.clip_cfg.image_resolution, pixel_mean, pixel_std,
                                          dtype, device_resize)
        self.params = None
        self._loss_and_grads = None
        self._optimizer = None
        self._graphs = {}  # (steps, batch_spec) -> StepGraph
        self.build_method()
        self._reset_optimizer()

    def build_method(self) -> None:
        raise NotImplementedError

    # -- the engine's build, from a config (TrainerBase.from_cfg) -----------
    def cfg_prec(self, cfg) -> str:
        """The method's PREC in ``cfg``: TRAINER.<prec_key>.PREC."""
        return cfg.TRAINER[self.prec_key].PREC

    def check_cfg(self, cfg) -> None:
        if self.cfg_prec(cfg) not in ("fp16", "fp32", "amp"):
            raise ValueError(f"TRAINER.{self.prec_key}.PREC must be fp16, fp32 or amp")

    def method_kwargs(self, cfg) -> dict:
        """The method's own keyword settings, read from ``cfg`` and the data
        manager (RPO: its classnames, prompt template and K)."""
        return {}

    def build_model(self, clip_params: Optional[dict] = None, device: DeviceLike = None) -> None:
        """The keyword constructor with the settings of ``self.cfg``: the
        backbone and its precision, the seed, the SGD settings,
        TRAIN.MICROBATCH, the pixel statistics, INPUT.DEVICE_RESIZE and the
        method's own; then, for a method with trainable tensors,
        MODEL.INIT_WEIGHTS and the model's registration.  ``clip_params``
        replaces the backbone that ``load_backbone`` resolves (a
        checkpoint, else random weights); ``device`` None is the CUDA
        card."""
        cfg = self.cfg
        prec = self.cfg_prec(cfg)
        backbone = cfg.MODEL.BACKBONE.NAME
        if prec == "amp":
            print("PREC 'amp': bf16 compute, no GradScaler (bf16 keeps fp32's exponent "
                  "range; identical to PREC 'fp16')")
        seed = max(int(cfg.SEED), 0)
        device = resolve_device(device)
        print(f"Loading CLIP (backbone: {backbone})")
        if clip_params is None:
            clip_params, clip_cfg = load_backbone(backbone, seed=seed, device=device)
        elif backbone in ARCHS:
            clip_cfg = ARCHS[backbone]
        else:
            raise KeyError(f"Unknown backbone {backbone!r}; known: {sorted(ARCHS)}")
        if int(cfg.INPUT.SIZE[0]) != clip_cfg.image_resolution:
            raise ValueError(f"cfg_imsize ({cfg.INPUT.SIZE[0]}) must equal to clip_imsize "
                             f"({clip_cfg.image_resolution})")
        print("Building custom CLIP")
        type(self).__init__(
            self, **self.method_kwargs(cfg), backbone=backbone, prec=prec, seed=seed,
            device=device, clip_params=clip_params, clip_cfg=clip_cfg,
            momentum=float(cfg.OPTIM.MOMENTUM), weight_decay=float(cfg.OPTIM.WEIGHT_DECAY),
            nesterov=bool(cfg.OPTIM.SGD_NESTEROV), dampening=float(cfg.OPTIM.SGD_DAMPNING),
            microbatch=int(cfg.TRAIN.MICROBATCH), pixel_mean=cfg.INPUT.PIXEL_MEAN,
            pixel_std=cfg.INPUT.PIXEL_STD, device_resize=int(cfg.INPUT.DEVICE_RESIZE))
        if self.params is None:  # nothing to initialise or save (zero-shot CLIP)
            return
        if cfg.MODEL.INIT_WEIGHTS:
            # the trainable tensors from a checkpoint file before training
            # (the reference's load_pretrained_weights)
            ckpt = _load_checkpoint_file(cfg.MODEL.INIT_WEIGHTS)
            print(f"Initializing {self.model_name} from {cfg.MODEL.INIT_WEIGHTS}")
            self.set_ckpt_state(self.model_name, ckpt["state_dict"])
        self.register_model(self.model_name)
        names = {f"{self.model_name}.{k}" for k in self.params}
        print(f"Parameters to be updated: {names}")

    def _install_steps(self, text_features, eval_step, loss_and_grads=None) -> None:
        self._text_features = text_features
        self._eval_step = eval_step
        self._loss_and_grads = loss_and_grads
        self._text_f_cache = None
        if not hasattr(self, "_frozen"):
            raise RuntimeError("build_method must set self._frozen")

    def _reset_optimizer(self) -> None:
        """SGD at ``sgd_init`` over the trainable tensors: the optimizer's
        buffers zeroed in place once it exists (a captured step keeps
        reading them), else a new one; none for a method with nothing to
        train (zero-shot CLIP)."""
        if self._optimizer is not None:
            self._optimizer.reset()
        elif self.params:
            self._optimizer = optim.sgd(self.params, self._momentum, self._weight_decay,
                                        self._nesterov, self._dampening)

    # -- training -------------------------------------------------------------
    def _make_train_step(self, logits_fn, precompute=None, microbatch: Optional[int] = None):
        """The standard step's loss and gradients over
        ``logits_fn(params, frozen, images_u8, ctx, rect_attn, masked_attn)
        -> (B, n_cls)``: masked cross-entropy in which padded rows weigh 0,
        gradients of the trainable tensors only.  Returns
        ``loss_and_grads(params, frozen, images_u8, labels, mask, rect_attn,
        masked_attn) -> (loss, logits, grads)``; ``train_step`` adds the
        SGD update and the masked accuracy.

        ``ctx`` is per-step work shared across chunks (RPO's text tower,
        on the live prompts, under grad), made once by
        ``precompute(params, frozen, masked_attn)``, None without one.
        ``microbatch`` (``self._microbatch``, TRAIN.MICROBATCH, when None)
        computes the forward in chunks of that many images inside the one
        loss and gradient; it engages only for batches it divides evenly
        and is smaller than, else the step is monolithic.  The math is the
        monolithic step's row by row."""
        mb = self._microbatch if microbatch is None else int(microbatch)

        def batch_logits(p, frozen, images_u8, rect_attn, masked_attn):
            ctx = None if precompute is None else precompute(p, frozen, masked_attn)
            B = (images_u8["img"] if isinstance(images_u8, dict) else images_u8).shape[0]
            if not 0 < mb < B or B % mb:
                return logits_fn(p, frozen, images_u8, ctx, rect_attn, masked_attn)
            return torch.cat([
                logits_fn(p, frozen, _rows(images_u8, i * mb, (i + 1) * mb), ctx, rect_attn,
                          masked_attn)
                for i in range(B // mb)])

        def loss_and_grads(params, frozen, images_u8, labels, mask, rect_attn, masked_attn):
            # the trainable tensors as autograd leaves sharing their storage
            leaves = optim.tree_map(lambda t: t.detach().requires_grad_(True), params)
            with torch.enable_grad():
                logits = batch_logits(leaves, frozen, images_u8, rect_attn, masked_attn)
                logp = torch.log_softmax(logits, dim=-1)
                nll = -logp.gather(-1, labels[:, None])[:, 0]
                loss = torch.sum(nll * mask) / torch.sum(mask)
                flat = list(optim.tree_leaves(leaves))
                grads = torch.autograd.grad(loss, flat)
            it = iter(grads)
            return loss.detach(), logits.detach(), optim.tree_map(lambda _: next(it), leaves)

        return loss_and_grads

    def _make_grad_accum_train_step(self, precompute, chunk_logits_fn, chunk_size: int):
        """Exact gradient accumulation over image chunks, with the
        ``loss_and_grads`` signature of ``_make_train_step``'s (the JAX
        package's ``_make_grad_accum_train_step``).

        ``precompute(frozen, images_u8, rect_attn) -> (B, ...)`` is the
        shared per-batch work, run once without grad.  It takes no params:
        a param-dependent precompute would drop its gradients across
        chunks and make the accumulation inexact.  The chunk is
        ``chunk_size`` rows, decremented until it divides B (a batch below
        it is one chunk).  Each chunk's ``chunk_logits_fn(params, frozen,
        ctx_chunk, masked_attn) -> (c, n_cls)`` runs forward and backward
        at once, so that one chunk's activations are alive at a time, and
        adds the gradient of sum(nll * mask).  Divided by sum(mask), the
        sums are the loss and the gradients; the logits are the chunks'
        in order.  A Python loop: inside a captured graph it unrolls."""

        def loss_and_grads(params, frozen, images_u8, labels, mask, rect_attn, masked_attn):
            with torch.no_grad():
                batch_ctx = precompute(frozen, images_u8, rect_attn)
            B = batch_ctx.shape[0]
            c = max(1, min(int(chunk_size), B))
            while B % c:
                c -= 1
            leaves = optim.tree_map(lambda t: t.detach().requires_grad_(True), params)
            flat = list(optim.tree_leaves(leaves))
            grads, nll_sum, logits = None, 0.0, []
            for i in range(0, B, c):
                with torch.enable_grad():
                    chunk_logits = chunk_logits_fn(leaves, frozen, batch_ctx[i:i + c], masked_attn)
                    logp = torch.log_softmax(chunk_logits, dim=-1)
                    nll = -logp.gather(-1, labels[i:i + c, None])[:, 0]
                    chunk_sum = torch.sum(nll * mask[i:i + c])
                    chunk_grads = torch.autograd.grad(chunk_sum, flat)
                grads = chunk_grads if grads is None else [
                    a + b for a, b in zip(grads, chunk_grads)]
                nll_sum = nll_sum + chunk_sum.detach()
                logits.append(chunk_logits.detach())
            denom = torch.sum(mask)
            it = iter(grads)
            return (nll_sum / denom, torch.cat(logits),
                    optim.tree_map(lambda _: next(it) / denom, leaves))

        return loss_and_grads

    def _no_train_step(self) -> NotImplementedError:
        return NotImplementedError(f"{type(self).__name__} has no train step; the trainers that "
                                   "train are RPO, CoOp, CoCoOp and LP")

    def _batch(self, images_u8, labels, mask):
        """A batch on the device: uint8 images (or the device-resize
        {img, box, flip} dict), int64 labels and the float32 row mask (0
        for a padded row)."""
        dev = self.device
        if isinstance(images_u8, dict):
            images = {key: torch.as_tensor(t).to(dev) for key, t in images_u8.items()}
        else:
            images = torch.as_tensor(images_u8).to(dev)
        return (images, torch.as_tensor(labels).to(dev, torch.int64),
                torch.as_tensor(mask).to(dev, torch.float32))

    def loss_and_grads(
        self,
        images_u8,
        labels,
        mask,
        rect_attn: Attention = rect_attention,
        masked_attn: MaskedAttention = masked_attention,
    ):
        """(loss, logits, grads) of the train step at the current
        trainable state, without the update.  ``rect_attn`` and
        ``masked_attn`` replace the attention kernels (for a comparison
        with their plain versions)."""
        return self._grads_on(self._batch(images_u8, labels, mask), rect_attn, masked_attn)

    def _grads_on(self, batch, rect_attn, masked_attn):
        if self._loss_and_grads is None:
            raise self._no_train_step()
        return self._loss_and_grads(self.params, self._frozen, *batch, rect_attn, masked_attn)

    def _step_on(self, images, labels, mask, rect_attn: Attention = rect_attention,
                 masked_attn: MaskedAttention = masked_attention):
        """One SGD step on a batch on the device, at the optimizer's
        learning-rate tensor: (masked loss, masked top-1 accuracy) as
        device scalars.  Tensor operations only, no host sync: the step a
        ``StepGraph`` captures, and ``train_step``'s."""
        loss, logits, grads = self._grads_on((images, labels, mask), rect_attn, masked_attn)
        self._optimizer.update(self.params, grads)
        self._text_f_cache = None
        acc = torch.sum((logits.argmax(-1) == labels) * mask) / torch.sum(mask)
        return loss, acc

    def train_step(
        self,
        images_u8,
        labels,
        mask,
        lr: float,
        rect_attn: Attention = rect_attention,
        masked_attn: MaskedAttention = masked_attention,
    ):
        """One SGD step at ``lr`` on a (B, H, W, 3) uint8 batch (or the
        device-resize {img, box, flip}), run eagerly; returns the masked
        loss and the masked top-1 accuracy as device scalars (no host
        sync).  Clears the text-feature cache."""
        if self._loss_and_grads is None:
            raise self._no_train_step()
        batch = self._batch(images_u8, labels, mask)
        self._optimizer.set_lr(lr)
        return self._step_on(*batch, rect_attn, masked_attn)

    @staticmethod
    def _train_images(batch):
        """The images of an engine batch: its ``img``, or with
        INPUT.DEVICE_RESIZE the {img, box, flip} dict."""
        if "box" in batch:
            return {"img": batch["img"], "box": batch["box"], "flip": batch["flip"]}
        return batch["img"]

    def _summary(self, loss, acc) -> dict:
        summary = {"loss": loss}
        if self.log_acc:
            summary["acc"] = 100.0 * acc
        return summary

    def _graph(self, n_steps: int, spec) -> StepGraph:
        """The captured graph of ``n_steps`` steps over batches of
        ``spec``, captured at its first use."""
        graph = self._graphs.get((n_steps, spec))
        if graph is None:
            graph = StepGraph(self._step_on, n_steps, spec, self._graph_bound, self.device)
            self._graphs[(n_steps, spec)] = graph
        return graph

    def _graph_bound(self) -> list:
        """What a captured step reads or writes besides its inputs."""
        return list(optim.tree_leaves(self.params)) + self._optimizer.state_tensors() + [
            self._frozen]

    def _dispatch(self, batches) -> list:
        """The steps of ``batches`` at ``self.current_lr``: one replay of
        the graph of ``len(batches)`` steps on the card, the eager steps
        in sequence on the CPU.  Returns their summaries."""
        if self.current_lr is None:
            raise RuntimeError("set current_lr (lr_at_epoch) before a train step")
        if self._loss_and_grads is None:
            raise self._no_train_step()
        if self.device.type != "cuda":
            return [self._summary(*self.train_step(self._train_images(b), b["label"], b["mask"],
                                                   self.current_lr)) for b in batches]
        graph = self._graph(len(batches), batch_spec(batches[0]))
        self._optimizer.set_lr(self.current_lr)
        losses, accs = graph.run(batches)
        self._text_f_cache = None
        return [self._summary(losses[i], accs[i]) for i in range(len(batches))]

    def forward_backward(self, batch) -> dict:
        """The engine's hook: one step on ``{"img", "label", "mask"}`` (and
        ``"box"``, ``"flip"`` with INPUT.DEVICE_RESIZE) at
        ``self.current_lr``; ``{"loss"}`` (and ``"acc"`` in percent where
        ``log_acc``), device scalars."""
        return self._dispatch([batch])[0]

    def forward_backward_multi(self, batches) -> list:
        """A group of batches as ONE dispatch (TRAIN.STEPS_PER_DISPATCH):
        the same sequential SGD steps, one replay of the group's graph on
        the card; a summary per batch."""
        return self._dispatch(list(batches))

    def before_train(self) -> None:
        super().before_train()
        if bool(self.cfg.TRAIN.PREWARM_COMPILE):
            self._prewarm_graphs()

    def _prewarm_graphs(self) -> None:
        """Capture, before the first batch, the train graphs that
        ``prewarm_plan`` says the epoch loop will replay, at the loader's
        batch shapes (JAX's ``_prewarm_compiles``, run here after the
        resume, so the graphs read the resumed state).  Nothing to
        prepare on the CPU, where the steps run eagerly."""
        if self.device.type != "cuda" or self._loss_and_grads is None:
            return
        cfg = self.cfg
        spec = train_batch_spec(int(cfg.DATALOADER.TRAIN_X.BATCH_SIZE),
                                self.clip_cfg.image_resolution, int(cfg.INPUT.DEVICE_RESIZE))
        group = max(1, int(cfg.TRAIN.STEPS_PER_DISPATCH))
        warm_grouped, warm_single = prewarm_plan(group, len(self.dm.train_loader_x))
        steps = [n for n, warm in ((group, warm_grouped), (1, warm_single)) if warm]
        for n in steps:
            self._graph(n, spec)
        print(f"Captured the train step as CUDA graph(s) of {steps} step(s) a replay")

    def get_optim_state(self, name: str):
        """The momentum tree (zeros before the first update)."""
        return optim.sgd_momentum(self._optimizer, self.params)

    def set_optim_state(self, name: str, state) -> None:
        """Install a checkpoint's momentum tree, copied into the
        optimizer's buffers.  A resumed optimizer is past its first update
        (step 1), which only dampening's first-buffer rule reads."""
        optim.sgd_state_from_numpy(self._optimizer, self.params, state, step=1)

    @torch.no_grad()
    def text_features(self):
        """The per-task text features, computed once and cached until the
        trainable state changes."""
        if self._text_features is not None and self._text_f_cache is None:
            self._text_f_cache = self._text_features(self.params, self._frozen)
        return self._text_f_cache

    @torch.no_grad()
    def eval_step(
        self,
        images_u8,
        rect_attn: Attention = rect_attention,
        masked_attn: MaskedAttention = masked_attention,
    ) -> torch.Tensor:
        """(B, n_cls) logits for a uint8 (B, H, W, 3) batch, on the device.
        ``rect_attn`` and ``masked_attn`` replace the attention kernels
        (for a comparison with their plain versions); the cached text
        features are computed with the kernels."""
        images = torch.as_tensor(images_u8).to(self.device)
        return self._eval_step(
            self.params, self._frozen, self.text_features(), images, rect_attn, masked_attn
        )

    def model_inference_async(self, images) -> torch.Tensor:
        """The logits left on the device; ``test()`` converts them."""
        return self.eval_step(images)

    def model_inference(self, images: np.ndarray) -> np.ndarray:
        return self.eval_step(images).float().cpu().numpy()

    # -- checkpoint state ---------------------------------------------------
    def get_ckpt_state(self, name: str):
        return self.params

    def set_ckpt_state(self, name: str, state) -> None:
        """Install checkpointed trainable state (a dict of arrays or tensors,
        or of such dicts, as CoCoOp's ``meta_net``; each leaf copied to
        float32 on the device, into the trainable tensor it replaces, so
        that a captured train step goes on reading it), validated against
        the method's own:
        Dassl's strict=False semantics — stale / unexpected top-level keys
        are dropped with a warning, missing ones keep their current init,
        but a SHAPE mismatch of any leaf fails here at the load site."""
        state = dict(state)  # never mutate the caller's dict
        for stale in ("token_prefix", "token_suffix"):
            state.pop(stale, None)

        def as_f32(a):
            if isinstance(a, dict):
                return {k: as_f32(v) for k, v in a.items()}
            if isinstance(a, torch.Tensor):
                return a.detach().to(self.device, torch.float32, copy=True)
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(self.device)

        if self.params is None:
            self.params = as_f32(state)
            self._text_f_cache = None
            self._reset_optimizer()
            return
        unexpected = sorted(k for k in state if k not in self.params)
        missing = sorted(k for k in self.params if k not in state)
        if unexpected:
            print(f"WARNING: ignoring unexpected checkpoint keys for {name}: {unexpected}")
        if missing:
            print(f"WARNING: checkpoint for {name} missing keys {missing}; "
                  "keeping their current values")

        def install(key, old, new):
            """``new`` in float32 on the device, in ``old``'s structure and
            shapes (``key`` is the top-level key, for the message)."""
            if isinstance(old, dict):
                if not isinstance(new, dict) or set(new) != set(old):
                    got = sorted(new) if isinstance(new, dict) else type(new).__name__
                    raise ValueError(f"checkpoint structure mismatch for {name}.{key}: got "
                                     f"{got}, expected {sorted(old)}")
                return {k: install(key, old[k], new[k]) for k in old}
            arr = as_f32(new)
            if tuple(arr.shape) != tuple(old.shape):
                raise ValueError(
                    f"checkpoint shape mismatch for {name}.{key}: got "
                    f"{tuple(arr.shape)}, expected {tuple(old.shape)} — "
                    "is this a checkpoint from a different method/backbone?"
                )
            return arr

        # validate every leaf before the first copy: a bad checkpoint
        # changes nothing
        new = {k: install(k, old, state[k]) for k, old in self.params.items() if k in state}
        with torch.no_grad():
            optim.tree_map(lambda old, arr: old.copy_(arr), {k: self.params[k] for k in new},
                           new)
        self._text_f_cache = None
        self._reset_optimizer()
