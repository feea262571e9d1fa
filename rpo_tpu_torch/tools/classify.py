"""Classify images with a trained prompt checkpoint: the serving path.

Port of the JAX package's ``tools/classify.py``.  It builds the trainer
(any registered method) from the same configs as the CLI, loads its
checkpoint, runs the eval preprocessing and the trainer's eval step over
image files, directories or ``synthetic://`` URIs, and prints the top-k
classes of each image (``--json``: one JSON object a line):

    python -m rpo_tpu_torch.tools.classify \\
        --trainer CoOp \\
        --dataset-config-file configs/datasets/caltech101.yaml \\
        --config-file configs/trainers/CoOp/rn50_ep50.yaml \\
        --model-dir output/.../seed1 --load-epoch 50 \\
        [--top-k 5] [--batch-size 100] [--json] \\
        image1.jpg photos/ ... [KEY VALUE config overrides]

It runs on the CUDA card; ``RPO_TPU_FORCE_CPU=1`` asks for the CPU.  The
batches go through ``trainer.model_inference`` as the test split's do;
``synthetic://`` images need no Pillow, files do.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".gif")


def _is_image_arg(p: str) -> bool:
    return os.path.isdir(p) or p.lower().endswith(IMAGE_EXTS) or p.startswith("synthetic://")


def split_images_and_opts(positionals):
    """argparse hands all contiguous positionals to the first nargs='+'
    slot, so 'img.jpg KEY VALUE' arrives as one list: the leading run of
    image files, directories and URIs, then the KEY VALUE overrides."""
    for i, p in enumerate(positionals):
        if not _is_image_arg(p):
            return positionals[:i], positionals[i:]
    return list(positionals), []


def collect_images(paths):
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(os.path.join(p, name) for name in sorted(os.listdir(p))
                       if name.lower().endswith(IMAGE_EXTS))
        else:
            out.append(p)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("images", nargs="+", help="image files, directories and/or synthetic:// "
                    "URIs, optionally followed by KEY VALUE config overrides")
    ap.add_argument("--trainer", required=True)
    ap.add_argument("--dataset-config-file", required=True)
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--model-dir", default="", help="checkpoint directory "
                    "(omit for zero-shot / freshly initialized prompts)")
    ap.add_argument("--load-epoch", type=int, default=None)
    ap.add_argument("--root", default="", help="dataset root (classnames only)")
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--json", action="store_true", help="one JSON object per line")
    args, extra = ap.parse_known_args(argv)

    image_args, opts = split_images_and_opts(args.images)
    if len(opts) % 2:
        print(f"config overrides must be KEY VALUE pairs, got {opts}", file=sys.stderr)
        return 1
    files = collect_images(image_args)
    if not files:
        print("no images found", file=sys.stderr)
        return 1

    from rpo_tpu_torch import cli
    from rpo_tpu_torch.data.transforms import TransformPipeline
    from rpo_tpu_torch.device import resolve_device
    from rpo_tpu_torch.engine import build_trainer

    device = resolve_device("cpu" if os.environ.get("RPO_TPU_FORCE_CPU") else None)
    ns = argparse.Namespace(
        root=args.root, output_dir=tempfile.mkdtemp(prefix="rpo_classify_"), resume="",
        seed=-1, source_domains=None, target_domains=None, transforms=None,
        config_file=args.config_file, dataset_config_file=args.dataset_config_file,
        trainer=args.trainer, backbone="", head="", eval_only=True, model_dir=args.model_dir,
        load_epoch=args.load_epoch, no_train=True, opts=list(opts) + list(extra))
    cfg = cli.setup_cfg(ns)
    trainer = build_trainer(cfg, device=device)
    if args.model_dir:
        trainer.load_model(args.model_dir, epoch=args.load_epoch)
    classnames = trainer.dm.classnames
    tp = TransformPipeline(cfg.INPUT)

    B = max(1, int(args.batch_size))
    k = min(args.top_k, len(classnames))
    for lo in range(0, len(files), B):
        chunk = files[lo:lo + B]
        imgs = np.stack([tp(f, train=False) for f in chunk])
        logits = np.asarray(trainer.model_inference(imgs), np.float32)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        for f, p in zip(chunk, probs):
            idx = np.argsort(-p)[:k]
            if args.json:
                print(json.dumps({"image": f, "top": [
                    {"class": classnames[i], "prob": round(float(p[i]), 4)} for i in idx]}))
            else:
                print(f"{f}: " + ", ".join(f"{classnames[i]} ({p[i]:.1%})" for i in idx))
    return 0


if __name__ == "__main__":
    sys.exit(main())
