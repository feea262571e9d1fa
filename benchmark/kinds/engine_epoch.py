"""Training epochs through the engine: the loader over a tree of JPEG files
and the epoch loop of ``rpo_tpu_torch/engine/trainer.py``, back to back.

Traffic keys: ``trainer`` (TRAINER.NAME), ``trainer_config`` and
``dataset_config`` (the engine's YAML files, from the checkout's root),
``n_cls``, ``shots``, ``per_class`` (a class's images in the tree before
the few-shot draw), ``sources``, ``source_size`` (width, height) and
``jpeg_quality`` (the JPEG files, drawn from the seed), ``device_resize``
(INPUT.DEVICE_RESIZE), ``num_workers`` (DATALOADER.NUM_WORKERS), ``batch``
(the trainer config's DATALOADER.TRAIN_X.BATCH_SIZE, which set-up
checks).

Set-up makes ``sources`` JPEG files with Pillow from the seed and writes a
Caltech101 tree of ``n_cls`` classes from their bytes
(``rpo_tpu_torch/tools/fake_datasets.py``) under the temporary directory;
builds the trainer through the engine (``build_trainer``: the data manager,
its ``BatchLoader`` over the tree, RPO) on the benchmark's weights, under
the backbone name of ``ARCHS`` that has the configuration's widths;
installs the trainable state; runs ``before_train`` (the step's graph
captured) and one whole epoch at the schedule's second epoch, keeping the
first ``CHECKED_STEPS`` steps' batches as the loader handed them over (the
decoded sources, the crop boxes and flips it drew, the labels), their
losses, the momentum after the first and the state after the last.  The
window empties the program's record of spans (``tracing.reset``) and runs
whole epochs through ``run_epoch`` until ``--seconds`` have passed; its
rate is every step's images over all of its time, which ends with a
synchronise.

The check: the reference takes the same steps from the same state on the
same batches, each source cropped, resized and flipped by
``reference/resize.py``.
"""
from __future__ import annotations

import os
import random
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .. import compare, inputs
from ..inputs import Phases
from ..methods.common import port_clip
from ..reference import precision
from ..reference.resize import crop_resize_flip
from ..reference.sgd import leaves, train_steps
from .train import CHECKED_STEPS, _copy

ROOT = Path(__file__).resolve().parents[2]  # the checkout, whose configs/ the engine reads

KEPT = ("img", "box", "flip", "label", "mask")


def jpeg_sources(directory: str, traffic: dict, seed: int):
    """``sources`` JPEG files of ``source_size``: a coarse random colour
    field resized by Pillow's bicubic filter, plus pixel noise, so that a
    file decodes like a photograph rather than like noise."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    W, H = traffic["source_size"]
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(traffic["sources"]):
        coarse = rng.integers(0, 256, (H // 25, W // 25, 3), dtype=np.uint8)
        field = np.asarray(Image.fromarray(coarse).resize((W, H), Image.BICUBIC), np.int16)
        pixels = np.clip(field + rng.normal(0, 6, (H, W, 3)).round(), 0, 255).astype(np.uint8)
        paths.append(os.path.join(directory, f"source_{i:03d}.jpg"))
        Image.fromarray(pixels).save(paths[-1], quality=traffic["jpeg_quality"])
    return paths


class Session:
    def __init__(self, cell):
        import rpo_tpu_torch.methods  # noqa: F401  registers the trainers
        from rpo_tpu_torch.engine.config import get_cfg_default
        from rpo_tpu_torch.engine.trainer import build_trainer
        from rpo_tpu_torch.models.clip.model import ARCHS
        from rpo_tpu_torch.tools.fake_datasets import write_tree

        self.cell = cell
        cfg_b, tr, dev = cell.config, cell.traffic, cell.device
        self.phases = phases = Phases(cell.sync)
        s_weights, s_state, s_data, _ = inputs.seeds(cell.seed)
        self.tmp = tempfile.mkdtemp(prefix="engine_epoch_")
        data_root = os.path.join(self.tmp, "data")
        sources = jpeg_sources(os.path.join(self.tmp, "sources"), tr, s_data)
        write_tree("Caltech101", data_root, sources, n_classes=tr["n_cls"],
                   per_class=tr["per_class"])
        phases("tree")

        sd = inputs.state_dict(cfg_b["clip"], s_weights, dev)
        self.state = cell.method.make_state(cfg_b, sd, s_state, dev)
        self.sd = inputs.to_host(sd)
        del sd
        phases("weights")
        clip_params, clip_cfg = port_clip(cfg_b, self.sd, dev)
        phases("convert")
        backbone = next(name for name, arch in ARCHS.items() if arch == clip_cfg)
        side = clip_cfg.image_resolution

        cfg = get_cfg_default()
        cfg.merge_from_file(str(ROOT / tr["dataset_config"]))
        cfg.merge_from_file(str(ROOT / tr["trainer_config"]))
        cfg.merge_from_list([
            "TRAINER.NAME", tr["trainer"], "DATASET.ROOT", data_root,
            "DATASET.NUM_SHOTS", str(tr["shots"]), "DATASET.SUBSAMPLE_CLASSES", "all",
            "INPUT.DEVICE_RESIZE", str(tr["device_resize"]),
            "DATALOADER.NUM_WORKERS", str(tr["num_workers"]),
            "OUTPUT_DIR", os.path.join(self.tmp, "output"), "SEED", str(s_data % 2 ** 31),
            "MODEL.BACKBONE.NAME", backbone, "INPUT.SIZE", f"({side}, {side})",
            f"TRAINER.{tr['trainer']}.PREC", cfg_b["prec"]])
        cfg.freeze()
        settings = {"batch": (int(cfg.DATALOADER.TRAIN_X.BATCH_SIZE), tr["batch"]),
                    "K": (int(cfg.TRAINER.RPO.K), cfg_b["K"]),
                    "prompt": (cfg.DATASET.PROMPT, cfg_b["prompt_template"]),
                    "momentum": (float(cfg.OPTIM.MOMENTUM), cfg_b["momentum"]),
                    "weight_decay": (float(cfg.OPTIM.WEIGHT_DECAY), cfg_b["weight_decay"])}
        differ = {k: v for k, v in settings.items() if v[0] != v[1]}
        if differ:
            raise ValueError(f"the engine's settings differ from the configuration's: {differ}")
        random.seed(cfg.SEED)  # the few-shot draw and the loader's order, as the CLI seeds them
        np.random.seed(cfg.SEED)
        self.trainer = trainer = build_trainer(cfg, clip_params=clip_params, device=dev)
        del clip_params
        trainer.set_ckpt_state(cell.method.MODEL, self.state)
        self.classnames = list(trainer.dm.classnames)
        if len(self.classnames) != tr["n_cls"]:
            raise ValueError(f"{len(self.classnames)} classes in the tree, not {tr['n_cls']}")
        phases("trainer")
        trainer.before_train()
        phases("before_train (graph capture)")

        self.kept = {"batches": [], "losses": []}
        self._keep_first_steps()
        self.epochs = 0
        self._epoch()
        phases("first epoch")
        wd, kept = cfg_b["weight_decay"], self.kept
        p0 = kept["p0"]
        self.prog = {"losses": [float(v) for v in kept["losses"]],
                     "grad1": {k: kept["m1"][k] - wd * p0[k] for k in p0},
                     "update": {k: kept["p_end"][k] - p0[k] for k in p0}}

    def _keep_first_steps(self) -> None:
        """Wrap the trainer's ``forward_backward`` for the first
        ``CHECKED_STEPS`` calls of the epoch loop, then take the wrapper
        away."""
        trainer, kept, model = self.trainer, self.kept, self.cell.method.MODEL
        step = trainer.forward_backward

        def forward_backward(batch):
            n = len(kept["batches"])
            if n == 0:
                kept["p0"], kept["lr"] = _copy(trainer.params), trainer.current_lr
            kept["batches"].append({k: np.array(batch[k]) for k in KEPT})
            out = step(batch)
            kept["losses"].append(out["loss"])
            if n == 0:
                kept["m1"] = _copy(trainer.get_optim_state(model))
            if n + 1 == CHECKED_STEPS:
                kept["p_end"] = _copy(trainer.params)
                del trainer.forward_backward
            return out

        trainer.forward_backward = forward_backward

    def _epoch(self) -> int:
        """One epoch through the engine's ``run_epoch``: the schedule's
        epochs after the warm-up one in turn (the first of them again after
        the last), each at its own learning rate."""
        from rpo_tpu_torch.engine.optim import lr_at_epoch

        trainer = self.trainer
        trainer.epoch = 1 + self.epochs % max(trainer.max_epoch - 1, 1)
        trainer.current_lr = lr_at_epoch(trainer.cfg.OPTIM, trainer.epoch)
        self.epochs += 1
        trainer.run_epoch()
        return trainer.num_batches

    def window(self, seconds: float) -> dict:
        from rpo_tpu_torch import tracing

        trainer, B = self.trainer, self.cell.traffic["batch"]
        step, losses = trainer.forward_backward, []

        def forward_backward(batch):
            out = step(batch)
            losses.append(out["loss"])
            return out

        trainer.forward_backward = forward_backward
        tracing.reset()  # from here the record's unprofiled spans are the window's
        t0 = time.perf_counter()
        end, steps = t0 + seconds, 0
        while time.perf_counter() < end:
            steps += self._epoch()
        self.cell.sync()
        wall = time.perf_counter() - t0
        del trainer.forward_backward
        failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
        return {"steps": steps, "wall_s": wall, "host_s": wall, "failed": failed,
                "metrics": {"train_images_per_s": steps * B / wall}}

    def traced(self, tw) -> int:
        with tw.span("epoch"):
            steps = self._epoch()
        with tw.span("synchronize"):
            self.cell.sync()
        return steps

    def release(self) -> None:
        if self.trainer is not None:
            dm = self.trainer.dm
            for loader in (dm.train_loader_x, dm.val_loader, dm.test_loader):
                if loader is not None:
                    loader.pool.shutdown(wait=True)
        self.trainer = None
        shutil.rmtree(self.tmp, ignore_errors=True)
        self.cell.free()

    def check(self, p) -> Dict[str, float]:
        cell, cfg, dev = self.cell, self.cell.config, self.cell.device
        size = cfg["clip"]["image_resolution"]
        precision.no_tf32()
        ref = cell.method.reference(cfg, inputs.as_float32(self.sd, dev), self.classnames)
        batches = []
        for b in self.kept["batches"]:
            if not (b["mask"] == 1).all():
                raise ValueError("a checked batch holds padding rows")
            images = torch.stack([crop_resize_flip(torch.from_numpy(img), box, bool(flip), size)
                                  for img, box, flip in zip(b["img"], b["box"], b["flip"])])
            batches.append((images.to(dev), torch.from_numpy(b["label"]).long().to(dev)))
        out = train_steps(lambda state, images: ref.logits(state, images, p), self.state,
                          batches, self.kept["lr"], cfg["momentum"], cfg["weight_decay"])
        start = leaves(self.state)
        ref_out = {"losses": out["losses"], "grad1": out["grad1"],
                   "update": {k: out["params"][k] - start[k] for k in start}}
        return compare.train_numbers(self.prog, ref_out)
