"""Host-resized input against device-resized input, for eval and for train.

Port of the JAX package's ``tools/bench_device_preprocess.py``.  For
fixed-size small sources (EuroSAT's are 64 x 64), is it faster to (A)
resize to 224 on the host and copy (B, 224, 224, 3) uint8 to the card a
batch, or (B) copy the raw (B, S, S, 3) sources and resize them on the
card (``ops/preprocess.py``, INPUT.DEVICE_RESIZE)?  Every iteration
starts from a host numpy batch, so the copy to the card is in the time,
as it is in a real run.

- ``--phase eval``: RPO's eval step at batch 100; (A) a batch the host
  resized with the data path's Pillow-exact resample, (B) the sources
  through ``device_eval_preprocess``; beside them the host's resample
  time a batch and the two paths' top-1 agreement.
- ``--phase train``: RPO's train step as the engine runs it (a replay of
  the captured graph) at batch 4; (A) host crops already at 224, (B) the
  sources with their crop boxes and flips through
  ``device_train_preprocess`` in the step.

    python -m rpo_tpu_torch.tools.bench_device_preprocess [--phase eval|train]
        [--src 64] [--batch N] [--iters 20] [--n-cls 51] [--k 24] [--backbone ViT-B/16]

It prints one JSON line with images/s of both paths (the best of three
passes of ``--iters`` iterations each) and the card's name and power
limit.  It runs on the CUDA card; ``RPO_TPU_FORCE_CPU=1`` asks for the CPU,
where the rates are the CPU's and the line says so.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import numpy as np
import torch


def _trainer(args, device):
    from ..methods.rpo_trainer import RPO

    classnames = [f"object category {i}" for i in range(args.n_cls)]
    return RPO(classnames, K=args.k, backbone=args.backbone, seed=1, device=device,
               device_resize=args.src)


def _rate(step, n_images: int, iters: int, sync) -> float:
    """Images/s of ``step()`` at the best of three passes of ``iters``
    calls, after one call of warm-up (builds, graph captures)."""
    step()
    sync()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        sync()
        times.append(time.perf_counter() - t0)
    return iters * n_images / min(times)


def bench_eval(args, trainer, sync) -> dict:
    from ..data.transforms import resample

    size = trainer.clip_cfg.image_resolution
    rng = np.random.RandomState(0)
    small = rng.randint(0, 256, size=(args.batch, args.src, args.src, 3)).astype(np.uint8)
    t0 = time.perf_counter()
    big = np.stack([resample(im, (size, size), "bicubic") for im in small])
    host_resize_s = time.perf_counter() - t0
    a = _rate(lambda: trainer.eval_step(big), args.batch, args.iters, sync)
    b = _rate(lambda: trainer.eval_step(small), args.batch, args.iters, sync)
    la = trainer.eval_step(big).float().cpu().numpy()
    lb = trainer.eval_step(small).float().cpu().numpy()
    return {"metric": "device_resize_eval_images_per_sec", "value": round(b, 2),
            "vs_baseline": round(b / a, 3), "extras": {
                "host_resized_images_per_sec": round(a, 2),
                "device_resized_images_per_sec": round(b, 2),
                "h2d_bytes_per_batch_host_path": int(big.nbytes),
                "h2d_bytes_per_batch_device_path": int(small.nbytes),
                "host_resample_seconds_per_batch": round(host_resize_s, 4),
                "top1_agreement_host_vs_device_resize": float(
                    (la.argmax(-1) == lb.argmax(-1)).mean()),
                "src_size": args.src, "batch": args.batch}}


def bench_train(args, trainer, sync) -> dict:
    from ..data.transforms import sample_rrc_box

    size = trainer.clip_cfg.image_resolution
    B = args.batch
    rng = np.random.RandomState(0)
    draw = random.Random(0)
    common = {"label": rng.randint(0, args.n_cls, size=B).astype(np.int64),
              "mask": np.ones(B, np.float32)}
    full = {"img": rng.randint(0, 256, size=(B, size, size, 3)).astype(np.uint8), **common}
    aug = {"img": rng.randint(0, 256, size=(B, args.src, args.src, 3)).astype(np.uint8),
           "box": np.asarray([sample_rrc_box(args.src, args.src, rng=draw) for _ in range(B)],
                             np.int32),
           "flip": rng.randint(0, 2, size=B).astype(np.int32), **common}
    trainer.current_lr = 0.01
    a = _rate(lambda: trainer.forward_backward(full), B, args.iters, sync)
    b = _rate(lambda: trainer.forward_backward(aug), B, args.iters, sync)
    return {"metric": "device_augment_train_images_per_sec", "value": round(b, 2),
            "vs_baseline": round(b / a, 3), "extras": {
                "host_augmented_images_per_sec": round(a, 2),
                "device_augmented_images_per_sec": round(b, 2),
                "h2d_bytes_per_step_host_path": int(full["img"].nbytes),
                "h2d_bytes_per_step_device_path": int(
                    aug["img"].nbytes + aug["box"].nbytes + aug["flip"].nbytes),
                "train_batch": B, "src_size": args.src}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=["eval", "train"], default="eval")
    ap.add_argument("--src", type=int, default=64, help="source image size")
    ap.add_argument("--batch", type=int, default=None, help="default: 100 eval, 4 train")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--n-cls", type=int, default=51)
    ap.add_argument("--k", type=int, default=24)
    ap.add_argument("--backbone", default="ViT-B/16")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 100 if args.phase == "eval" else 4

    from ..device import resolve_device
    from ..ops.selftest import nvidia_smi_line

    device = resolve_device("cpu" if os.environ.get("RPO_TPU_FORCE_CPU") else None)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    trainer = _trainer(args, device)
    out = (bench_eval if args.phase == "eval" else bench_train)(args, trainer, sync)
    out["unit"] = "images/sec" if on_card else "images/sec on the CPU, not a device measurement"
    out["device"] = torch.cuda.get_device_name(device) if on_card else "cpu"
    out["nvidia_smi"] = nvidia_smi_line() if on_card else "not available (cpu run)"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
