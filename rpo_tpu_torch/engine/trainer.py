"""Trainer base: the Dassl TrainerX lifecycle.

Port of ``rpo_tpu/engine/trainer.py``, with the same contract:
  - ``train()``: the epoch loop, ``forward_backward`` per batch, the
    per-epoch LR, periodic and final checkpoints, the final test and the
    ``Finish training`` log marker (parse_test_res.py);
  - ``test()``: the eval loop and the evaluator's ``=> result`` /
    ``* accuracy:`` block;
  - ``register_model`` / ``load_model`` and the checkpoint names
    (``model.pth.tar-<epoch>``, ``model-best.pth.tar``), whose payload is
    the JAX package's: a pickle of numpy arrays, so a checkpoint written
    by either package loads in the other.  Only the trainable tensors are
    saved, never class-dependent buffers, so a checkpoint loads under
    another class set.

With TRAIN.STEPS_PER_DISPATCH = N > 1 the epoch loop hands full groups
of N batches to ``forward_backward_multi`` where the trainer has one (one
dispatch a group) and the trailing partial group to ``forward_backward``.

Under a process group (one rank a card) every rank runs the same loop
on its rows of each batch; rank 0 alone writes the checkpoints (the
others wait at a barrier after each save), and the evaluator reads the
logits gathered over the ranks with the labels of the whole batch
(``all_label``), the padded rows dropped.

A subclass provides ``build_model(**kwargs)``, ``forward_backward``,
``model_inference(_async)``, the checkpoint-state accessors and
``self.device``.  ``build_trainer`` builds one through ``from_cfg``.
"""
from __future__ import annotations

import glob
import os
import pickle
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import tracing
from ..parallel import dp
from .evaluator import ClassificationEvaluator
from .optim import lr_at_epoch
from .registry import TRAINER_REGISTRY


def build_trainer(cfg, **build_kwargs):
    """Name -> trainer instance built from ``cfg`` (Dassl build_trainer).
    ``build_kwargs`` go to the trainer's ``build_model`` (the port's
    trainers take ``clip_params=`` and ``device=``)."""
    trainer_cls = TRAINER_REGISTRY.get(cfg.TRAINER.NAME)
    print(f"Loading trainer: {cfg.TRAINER.NAME}")
    return trainer_cls.from_cfg(cfg, **build_kwargs)


def _to_numpy(tree):
    """Tensors of a nested dict -> float32 numpy arrays (None stays)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return np.asarray(tree)


def _load_checkpoint_file(path: str) -> Dict[str, Any]:
    """A checkpoint: the pickled numpy payload of either package, or a
    torch-format checkpoint of the reference framework (the released
    prompt checkpoints), whose tensors become float32 numpy arrays."""
    # route by the leading zip local-header magic, not zipfile.is_zipfile,
    # which scans the trailing 64 KB for a signature that a raw float32
    # payload can hold by chance; a pickle starts with the \x80 opcode
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"PK\x03\x04":  # torch >= 1.6 save format
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        out = dict(ckpt)
        out["state_dict"] = {
            k: v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in ckpt["state_dict"].items()
        }
        return out
    with open(path, "rb") as f:
        return pickle.load(f)


class MetricMeter:
    """Per-batch metrics kept as they come (device scalars): converted to
    floats only at print time, so a step waits for the device once per
    PRINT_FREQ batches, not every step (``.item()`` is a host sync)."""

    def __init__(self):
        self.meters: Dict[str, List] = {}

    def update(self, summary: Dict) -> None:
        for k, v in summary.items():
            self.meters.setdefault(k, []).append(v)

    def __str__(self) -> str:
        parts = []
        for k, vals in self.meters.items():
            floats = [float(v) for v in vals]
            self.meters[k] = floats  # cache the conversions
            parts.append(f"{k} {floats[-1]:.4f} ({np.mean(floats):.4f})")
        return " ".join(parts)


def device_prefetch(iterator, device, depth: int = 2, keys=("img", "label", "mask")):
    """Batches with ``keys`` already on ``device``, ``depth`` copies in
    flight: on a CUDA device each array goes through pinned host memory
    with a non-blocking copy, which overlaps the running step."""
    device = torch.device(device)
    queue = deque()

    def put(batch):
        out = dict(batch)
        for key in keys:
            if key in batch:
                t = torch.from_numpy(np.ascontiguousarray(batch[key]))
                out[key] = (t.pin_memory().to(device, non_blocking=True)
                            if device.type == "cuda" else t)
        return out

    it = iter(iterator)
    try:
        for _ in range(depth):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        yield queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass


def _waited(loader):
    """The loader's batches, each wait for the next (the one that finds the
    end too) in a ``loader_wait`` span."""
    it = iter(loader)
    try:
        while True:
            with tracing.span("loader_wait"):
                batch = next(it, None)
            if batch is None:
                return
            yield batch
    finally:
        if hasattr(it, "close"):  # an epoch left early stops the loader's producer
            it.close()


class TrainerBase:
    """Abstract trainer.  Subclasses implement build_model(),
    forward_backward(batch), model_inference(images), the checkpoint state
    accessors, and set ``self.device``."""

    @classmethod
    def from_cfg(cls, cfg, **build_kwargs):
        """The trainer built by the engine from ``cfg``: the output
        directory, the data manager and the evaluator, then
        ``build_model(**build_kwargs)``.  Bypasses a subclass's own
        ``__init__``, which the port's method trainers keep for building
        them from keyword settings."""
        self = cls.__new__(cls)
        self.cfg = cfg
        self.check_cfg(cfg)
        self.output_dir = cfg.OUTPUT_DIR
        os.makedirs(self.output_dir, exist_ok=True)

        self.start_epoch = 0
        self.epoch = 0
        self.max_epoch = int(cfg.OPTIM.MAX_EPOCH)
        self._model_names: List[str] = []
        self.best_result = -np.inf

        # imported here: the data package imports the engine's registry
        from ..data.manager import DataManager

        print("Building data manager")
        self.dm = DataManager(cfg)
        self.dm.show_dataset_summary()
        self.evaluator = ClassificationEvaluator(cfg, self.dm.classnames)

        self.build_model(**build_kwargs)
        return self

    # -- subclass surface ---------------------------------------------------
    def check_cfg(self, cfg) -> None:  # optional override
        pass

    def build_model(self, **build_kwargs) -> None:
        raise NotImplementedError

    def forward_backward(self, batch) -> Dict[str, Any]:
        raise NotImplementedError

    def model_inference(self, images) -> np.ndarray:
        """images (B, H, W, 3) uint8 -> logits (B, n_cls) numpy."""
        raise NotImplementedError

    def model_inference_async(self, images):
        """Like model_inference but may return the logits on the device;
        test() converts them when it drains, so the next batch is issued
        before this one's copy to the host."""
        return self.model_inference(images)

    def get_ckpt_state(self, name: str) -> Dict[str, Any]:
        raise NotImplementedError

    def set_ckpt_state(self, name: str, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def get_optim_state(self, name: str):
        return None

    def set_optim_state(self, name: str, state) -> None:
        pass

    def update_lr(self) -> None:
        """Advance the per-epoch schedule (called at the last batch of each
        epoch, as the reference does).  Subclasses read self.current_lr."""
        self.current_lr = lr_at_epoch(self.cfg.OPTIM, min(self.epoch + 1, self.max_epoch - 1))

    # -- model registry / checkpoints --------------------------------------
    def register_model(self, name: str) -> None:
        if name in self._model_names:
            raise KeyError(f"Model {name} already registered")
        self._model_names.append(name)

    def save_model(self, epoch: int, is_best: bool = False) -> None:
        if dp.is_main():
            self._save_model(epoch, is_best)
        dp.barrier()  # every rank reads what rank 0 wrote from here on

    def _save_model(self, epoch: int, is_best: bool) -> None:
        for name in self._model_names:
            model_dir = os.path.join(self.output_dir, name)
            os.makedirs(model_dir, exist_ok=True)
            payload = {
                "state_dict": _to_numpy(self.get_ckpt_state(name)),
                "epoch": epoch + 1,
                "optimizer": _to_numpy(self.get_optim_state(name)),
                "val_result": self.best_result,
            }

            def atomic_dump(path):
                # write then rename: a job killed mid-write leaves no
                # truncated checkpoint behind
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
                os.replace(tmp, path)

            fpath = os.path.join(model_dir, f"model.pth.tar-{epoch + 1}")
            atomic_dump(fpath)
            print(f"Checkpoint saved to {fpath}")
            if is_best:
                atomic_dump(os.path.join(model_dir, "model-best.pth.tar"))

    def load_model(self, directory: str, epoch: Optional[int] = None) -> None:
        """The reference's semantics: the best model by default, a given
        epoch's ``model.pth.tar-<epoch>`` when asked; class-dependent
        buffers are never in the payload, so base -> new transfer is safe."""
        if not directory:
            print("Note that load_model() is skipped as no pretrained model is given")
            return
        model_file = "model-best.pth.tar" if epoch is None else f"model.pth.tar-{epoch}"
        for name in self._model_names:
            model_path = os.path.join(directory, name, model_file)
            if not os.path.exists(model_path):
                raise FileNotFoundError(f'Model not found at "{model_path}"')
            checkpoint = _load_checkpoint_file(model_path)
            state_dict = checkpoint["state_dict"]
            # the reference drops stale class-dependent buffers; ours never
            # saves them, but a reference checkpoint may hold them
            for stale in ("token_prefix", "token_suffix"):
                state_dict.pop(stale, None)
            print(f'Loading weights to {name} from "{model_path}" '
                  f"(epoch = {checkpoint['epoch']})")
            self.set_ckpt_state(name, state_dict)

    def resume_model_if_exist(self, directory: str) -> int:
        if not directory or not self._model_names:
            return 0
        name0 = self._model_names[0]
        epochs = []
        for p in glob.glob(os.path.join(directory, name0, "model.pth.tar-*")):
            # a .tmp left by a job killed mid-write cannot be resumed from
            try:
                epochs.append(int(p.rsplit("-", 1)[1]))
            except ValueError:
                continue
        if not epochs:
            print("No checkpoint found, train from scratch")
            return 0
        latest = max(epochs)
        for name in self._model_names:
            path = os.path.join(directory, name, f"model.pth.tar-{latest}")
            checkpoint = _load_checkpoint_file(path)
            self.set_ckpt_state(name, checkpoint["state_dict"])
            if checkpoint.get("optimizer") is not None:
                self.set_optim_state(name, checkpoint["optimizer"])
            # the best so far at save time: without it, a worse epoch after
            # the resume would overwrite model-best.pth.tar
            val_result = checkpoint.get("val_result")
            if val_result is not None and np.isfinite(val_result):
                self.best_result = max(self.best_result, float(val_result))
            print(f'Resumed {name} from "{path}" (epoch {checkpoint["epoch"]})')
        return latest

    # -- lifecycle ----------------------------------------------------------
    def before_train(self) -> None:
        # Dassl before_train: resume from cfg.RESUME if given, else from
        # OUTPUT_DIR, so relaunching a killed job with the same command
        # picks up its own checkpoints
        resume_dir = self.cfg.RESUME or self.cfg.OUTPUT_DIR
        self.start_epoch = self.resume_model_if_exist(resume_dir)
        self.time_start = time.time()
        self.current_lr = lr_at_epoch(self.cfg.OPTIM, self.start_epoch)
        if bool(self.cfg.TRAIN.DEBUG_NANS):
            # the reference's own NaN detector (torch anomaly mode)
            torch.autograd.set_detect_anomaly(True)
            print("NaN debugging enabled (torch.autograd.set_detect_anomaly)")

    def train(self) -> None:
        self.before_train()
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.run_epoch()
            self.after_epoch()
        self.after_train()

    def run_epoch(self) -> None:
        profile_dir = str(self.cfg.TRAIN.PROFILE_DIR)
        profiling = bool(profile_dir) and self.epoch + 1 == int(self.cfg.TRAIN.PROFILE_EPOCH)
        prof = None
        if profiling:
            from torch.profiler import ProfilerActivity, profile

            tracing.reset()  # the summary after the export is this epoch's

            os.makedirs(profile_dir, exist_ok=True)
            print(f"Capturing a torch.profiler trace of epoch {self.epoch + 1} -> {profile_dir}")
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            try:
                prof = profile(activities=activities)
                prof.start()
            except Exception as exc:  # profiling must never kill a run
                print(f"(!) profiler unavailable: {exc}")
                prof = None
        try:
            self._run_epoch_inner()
        finally:
            if prof is not None:
                prof.stop()
                path = os.path.join(profile_dir, f"trace_epoch{self.epoch + 1}.json")
                prof.export_chrome_trace(path)
                print(f"Profiler trace saved to {path}")
                for name, s in tracing.summary().items():
                    n = s["count"]
                    print(f"span {tracing.PREFIX}{name}: {n} calls, {s['total_ms'] / n:.3f} ms "
                          f"a call, {s['self_ms'] / n:.3f} ms self")
                tracing.reset()

    def _run_epoch_inner(self) -> None:
        meter = MetricMeter()
        loader = self.dm.train_loader_x
        self.num_batches = len(loader)
        print_freq = max(1, int(self.cfg.TRAIN.PRINT_FREQ))
        group_size = max(1, int(self.cfg.TRAIN.STEPS_PER_DISPATCH))
        use_multi = group_size > 1 and hasattr(self, "forward_backward_multi")
        t_start = time.time()
        data_t, batch_t = [], []
        t0 = time.time()

        def handle(summary, bt=None):
            batch_t.append(bt if bt is not None else time.time() - t0 - data_t[-1])
            meter.update(summary)
            if (self.batch_idx + 1) % print_freq == 0 or self.batch_idx + 1 == self.num_batches:
                nb_remain = (self.max_epoch - self.epoch - 1) * self.num_batches + (
                    self.num_batches - self.batch_idx - 1)
                eta = nb_remain * float(np.mean(batch_t) + np.mean(data_t))
                eta_str = time.strftime("%H:%M:%S", time.gmtime(int(eta)))
                print(
                    f"epoch [{self.epoch + 1}/{self.max_epoch}] "
                    f"batch [{self.batch_idx + 1}/{self.num_batches}] "
                    f"time {batch_t[-1]:.3f} ({np.mean(batch_t):.3f}) "
                    f"data {data_t[-1]:.3f} ({np.mean(data_t):.3f}) "
                    f"{meter} "
                    f"lr {self.current_lr:.4e} "
                    f"eta {eta_str}"
                )
            if self.batch_idx + 1 == self.num_batches:
                self.update_lr()

        if use_multi:
            # full groups of TRAIN.STEPS_PER_DISPATCH batches go to the
            # grouped step, one dispatch each; a group's data and step
            # time are split evenly over its batches
            self.batch_idx = -1
            group = []

            def flush():
                nonlocal group, t0
                load_elapsed = time.time() - t0
                summaries = self.forward_backward_multi(group)
                step_elapsed = time.time() - t0 - load_elapsed
                for summary in summaries:
                    self.batch_idx += 1
                    data_t.append(load_elapsed / len(group))
                    handle(summary, bt=step_elapsed / len(group))
                group = []
                t0 = time.time()

            for batch in _waited(loader):
                group.append(batch)
                if len(group) == group_size:
                    flush()
            # the trailing partial group through the one-step program, as
            # in the JAX package, which compiles no grouped program for a
            # remainder: here no graph is captured for one
            for batch in group:
                self.batch_idx += 1
                data_t.append(time.time() - t0)
                handle(self.forward_backward(batch))
                t0 = time.time()
        else:
            # host batches: the trainer's step moves them to the device
            # (on the card through its graph's pinned staging buffers)
            for self.batch_idx, batch in enumerate(_waited(loader)):
                data_t.append(time.time() - t0)
                handle(self.forward_backward(batch))
                t0 = time.time()
        epoch_time = time.time() - t_start
        print(f"epoch [{self.epoch + 1}/{self.max_epoch}] done in {epoch_time:.1f}s")

    def after_epoch(self) -> None:
        cfg = self.cfg
        last_epoch = self.epoch + 1 == self.max_epoch
        do_test = not cfg.TEST.NO_TEST
        meet_freq = (cfg.TRAIN.CHECKPOINT_FREQ > 0
                     and (self.epoch + 1) % cfg.TRAIN.CHECKPOINT_FREQ == 0)
        if do_test and cfg.TEST.FINAL_MODEL == "best_val":
            # test(split="val") falls back to the test split when the
            # dataset has no val list (Dassl behaviour)
            result = self.test(split="val")
            if result > self.best_result:
                self.best_result = result
                self.save_model(self.epoch, is_best=True)
        if meet_freq or last_epoch:
            self.save_model(self.epoch)

    def after_train(self) -> None:
        print("Finish training")
        if not self.cfg.TEST.NO_TEST:
            if self.cfg.TEST.FINAL_MODEL == "best_val":
                print("Deploy the model with the best val performance")
                self.load_model(self.output_dir)
            self.test()
        elapsed = round(time.time() - self.time_start)
        print(f"Elapsed: {time.strftime('%H:%M:%S', time.gmtime(elapsed))}")

    # -- evaluation ---------------------------------------------------------
    def test(self, split: Optional[str] = None) -> float:
        cfg = self.cfg
        split = split or cfg.TEST.SPLIT
        if split == "val" and self.dm.val_loader is not None:
            loader = self.dm.val_loader
        else:
            split = "test"
            loader = self.dm.test_loader
        print(f"Evaluate on the *{split}* set")
        self.evaluator.reset()
        # up to three batches in flight: the next batches are issued
        # before an earlier batch's logits come off the device; images
        # are copied ahead two deep (labels stay on the host, where the
        # evaluator reads them)
        pending: deque = deque()

        def drain() -> None:
            logits_dev, labels, n = pending.popleft()
            logits = _to_numpy(logits_dev)
            self.evaluator.process(logits[:n], labels[:n])

        for batch in device_prefetch(loader, self.device, keys=("img",)):
            # under a mesh the logits are gathered: the whole batch's labels
            labels = batch.get("all_label", batch["label"])
            pending.append((self.model_inference_async(batch["img"]), labels, batch["n"]))
            if len(pending) > 2:
                drain()
        while pending:
            drain()
        results = self.evaluator.evaluate()
        return float(results["accuracy"])
