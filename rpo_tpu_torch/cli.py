"""Command-line entry point of the port, flag-compatible with the JAX
package's (``rpo_tpu/cli.py``, the reference's train.py):

    python -m rpo_tpu_torch.cli --root $DATA --seed 1 --trainer RPO \\
        --dataset-config-file configs/datasets/synthetic.yaml \\
        --config-file configs/trainers/RPO/main_K24.yaml \\
        --output-dir output/... DATASET.NUM_SHOTS 16 DATASET.SUBSAMPLE_CLASSES base

It runs on the CUDA card, and raises without one.  ``RPO_TPU_FORCE_CPU=1``
(the JAX CLI's switch) asks for the CPU instead.
"""
from __future__ import annotations

import argparse
import os
import platform
import random
import sys

import numpy as np
import torch

# registry side effects: the trainers and datasets the engine can name
import rpo_tpu_torch.data.datasets  # noqa: F401
import rpo_tpu_torch.methods  # noqa: F401
from rpo_tpu_torch.device import resolve_device
from rpo_tpu_torch.engine import build_trainer, get_cfg_default, setup_logger


def print_args(args, cfg):
    print("***************")
    print("** Arguments **")
    print("***************")
    for key in sorted(args.__dict__):
        print(f"{key}: {args.__dict__[key]}")
    print("************")
    print("** Config **")
    print("************")
    print(cfg)


def reset_cfg(cfg, args):
    if args.root:
        cfg.DATASET.ROOT = args.root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.resume:
        cfg.RESUME = args.resume
    if args.seed:
        cfg.SEED = args.seed
    if args.source_domains:
        cfg.DATASET.SOURCE_DOMAINS = tuple(args.source_domains)
    if args.target_domains:
        cfg.DATASET.TARGET_DOMAINS = tuple(args.target_domains)
    if args.transforms:
        cfg.INPUT.TRANSFORMS = tuple(args.transforms)
    if args.trainer:
        cfg.TRAINER.NAME = args.trainer
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone
    if args.head:
        cfg.MODEL.HEAD.NAME = args.head


def setup_cfg(args):
    cfg = get_cfg_default()
    if args.dataset_config_file:
        cfg.merge_from_file(args.dataset_config_file)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    reset_cfg(cfg, args)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def collect_env_info(device: torch.device) -> str:
    lines = [
        f"Python: {sys.version.split()[0]}",
        f"Platform: {platform.platform()}",
        f"PyTorch: {torch.__version__} (CUDA {torch.version.cuda})",
        f"Device: {device}",
    ]
    if device.type == "cuda":
        lines.append(f"Card: {torch.cuda.get_device_name(device)}")
    return "\n".join(lines)


def main(args, **build_kwargs):
    """Run the CLI on parsed ``args``; returns the trainer.  ``build_kwargs``
    go to the trainer's build (``clip_params=`` replaces the random
    backbone)."""
    device = resolve_device("cpu" if os.environ.get("RPO_TPU_FORCE_CPU") else None)
    cfg = setup_cfg(args)
    if cfg.SEED >= 0:
        print(f"Setting fixed seed: {cfg.SEED}")
        set_random_seed(cfg.SEED)

    setup_logger(cfg.OUTPUT_DIR)

    print_args(args, cfg)
    print("Collecting env info ...")
    print(f"** System info **\n{collect_env_info(device)}\n")

    trainer = build_trainer(cfg, device=device, **build_kwargs)

    if args.eval_only:
        trainer.load_model(args.model_dir, epoch=args.load_epoch)
        trainer.test()
        return trainer

    if not args.no_train:
        trainer.train()
    return trainer


def build_parser() -> argparse.ArgumentParser:
    """The reference's flag surface, as the JAX CLI has it."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, default="", help="path to dataset")
    parser.add_argument("--output-dir", type=str, default="", help="output directory")
    parser.add_argument(
        "--resume", type=str, default="",
        help="checkpoint directory (from which the training resumes)",
    )
    parser.add_argument(
        "--seed", type=int, default=-1,
        help="only positive value enables a fixed seed",
    )
    parser.add_argument("--source-domains", type=str, nargs="+", help="source domains for DA/DG")
    parser.add_argument("--target-domains", type=str, nargs="+", help="target domains for DA/DG")
    parser.add_argument("--transforms", type=str, nargs="+", help="data augmentation methods")
    parser.add_argument("--config-file", type=str, default="", help="path to config file")
    parser.add_argument(
        "--dataset-config-file", type=str, default="",
        help="path to config file for dataset setup",
    )
    parser.add_argument("--trainer", type=str, default="", help="name of trainer")
    parser.add_argument("--backbone", type=str, default="", help="name of CNN backbone")
    parser.add_argument("--head", type=str, default="", help="name of head")
    parser.add_argument("--eval-only", action="store_true", help="evaluation only")
    parser.add_argument(
        "--model-dir", type=str, default="",
        help="load model from this directory for eval-only mode",
    )
    parser.add_argument(
        "--load-epoch", type=int, help="load model weights at this epoch for evaluation"
    )
    parser.add_argument("--no-train", action="store_true", help="do not call trainer.train()")
    parser.add_argument(
        "opts", default=None, nargs=argparse.REMAINDER,
        help="modify config options using the command-line",
    )
    return parser


def cli_main() -> None:
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli_main()
