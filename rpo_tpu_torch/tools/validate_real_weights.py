"""Validate the port against real CLIP weights, or say exactly why not.

Port of the JAX package's ``scripts/validate_real_weights.py``:

    python -m rpo_tpu_torch.tools.validate_real_weights \\
        [--backbone ViT-B/16] [--root $DATA] [--dataset caltech101] \\
        [--rpo-checkpoint output/.../prompt_learner/model.pth.tar-15] \\
        [--reference DIR]

Stages (each runs when its inputs exist, and says loudly when it is
skipped):
  1. The checkpoint: ``$CLIP_CHECKPOINT``, else ``$CLIP_CACHE_DIR`` (or
     ``~/.cache/clip``), as ``models/clip/pretrained.py`` resolves it.
     Nothing is downloaded.
  2. Tower parity on real weights: the same state dict in the port
     (``convert.load_clip``) and in the reference implementation's torch
     CLIP (``clip/model.py``'s ``build_model`` of the checkout that
     ``--reference`` names), ``encode_image`` and ``encode_text`` compared
     in float32 on fixed inputs.  Without ``--reference`` it is skipped.
  3. Semantic smoke: real weights order obvious text similarities right;
     random weights fail it at once.
  4. Zero-shot evaluation on a dataset under ``--root``: ZeroshotCLIP's
     accuracy on the base and new halves against the published CLIP
     ViT-B/16 numbers.
  5. An RPO prompt checkpoint (``--rpo-checkpoint``, ``--root``) on the
     base or new split.

It runs on the CUDA card; ``RPO_TPU_FORCE_CPU=1`` asks for the CPU.
Exit codes: 0 everything that could run passed; 1 a validation failed;
2 no weights (the diagnosis is printed).
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published zero-shot CLIP ViT-B/16 accuracies under the CoOp/RPO protocol
# (base/new class halves, Table 1 of the CoCoOp and RPO papers)
ZEROSHOT_EXPECTED = {
    "caltech101": {"base": 96.84, "new": 94.00},
    "imagenet": {"base": 72.43, "new": 68.14},
    "oxford_pets": {"base": 91.17, "new": 97.26},
}
TOLERANCE_PCT = 1.5
PARITY_TOL = 2e-3  # largest error over the largest feature, each tower


class ValidationFailed(Exception):
    pass


def diagnose_missing(backbone: str) -> None:
    explicit = os.environ.get("CLIP_CHECKPOINT")
    cache_dir = os.environ.get("CLIP_CACHE_DIR", os.path.expanduser("~/.cache/clip"))
    print(f"No real weights for {backbone}. Resolution attempted:")
    print(f"  1. $CLIP_CHECKPOINT = {explicit!r}" + ("" if explicit else " (unset)")
          + ("" if not explicit or os.path.exists(explicit) else " (file missing)"))
    print(f"  2. cache dir {cache_dir}: no checkpoint of {backbone} found")
    print("  3. no download: the port resolves checkpoints offline only")
    print("To validate: copy the official ViT-B-16.pt into the cache dir or set "
          "$CLIP_CHECKPOINT, then re-run this tool.")


def _reference_clip_module(reference: str):
    path = os.path.join(reference, "clip", "model.py")
    spec = importlib.util.spec_from_file_location("_reference_clip_model", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tower_parity(path: str, params, cfg, reference: str, device) -> None:
    """The same checkpoint in the reference's torch CLIP and in the port,
    both in float32: each tower's largest error over its largest feature
    within PARITY_TOL."""
    from ..models.clip.model import encode_image, encode_text
    from ..tokenizer import tokenize

    module = _reference_clip_module(reference)
    with open(path, "rb") as f:
        try:
            sd = torch.jit.load(f, map_location="cpu").state_dict()
        except RuntimeError:
            f.seek(0)
            sd = torch.load(f, map_location="cpu")
    model = module.build_model(sd).float().eval()
    rng = np.random.RandomState(0)
    images = rng.randn(2, cfg.image_resolution, cfg.image_resolution, 3).astype(np.float32)
    tokens = np.asarray(tokenize(["a photo of a dog.", "a diagram of a large airplane"]))
    with torch.no_grad():
        ref_img = model.encode_image(torch.from_numpy(images.transpose(0, 3, 1, 2))).numpy()
        ref_txt = model.encode_text(torch.from_numpy(tokens)).numpy()
        img = encode_image(params, cfg, torch.from_numpy(images).to(device)).cpu().numpy()
        txt = encode_text(params, cfg, torch.from_numpy(tokens).to(device)).cpu().numpy()
    img_err = np.abs(ref_img - img).max() / (np.abs(ref_img).max() + 1e-9)
    txt_err = np.abs(ref_txt - txt).max() / (np.abs(ref_txt).max() + 1e-9)
    print(f"tower parity vs the reference's torch CLIP: image rel-err {img_err:.2e}, "
          f"text rel-err {txt_err:.2e}")
    if not (img_err < PARITY_TOL and txt_err < PARITY_TOL):
        raise ValidationFailed("REAL-WEIGHTS TOWER PARITY FAILED")
    print("tower parity: OK")


def semantic_smoke(params, cfg, device) -> None:
    from ..models.clip.model import encode_text
    from ..tokenizer import tokenize

    texts = ["a photo of a cat.", "a photo of a kitten.", "a photo of an airplane."]
    with torch.no_grad():
        feats = encode_text(params, cfg, torch.from_numpy(np.asarray(tokenize(texts))).to(device))
    feats = feats.float().cpu().numpy()
    feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    kitten, plane = float(feats[0] @ feats[1]), float(feats[0] @ feats[2])
    print(f"semantic smoke: sim(cat,kitten)={kitten:.3f} sim(cat,airplane)={plane:.3f}")
    if not kitten > plane + 0.05:
        raise ValidationFailed("SEMANTIC SMOKE FAILED: the weights do not behave like trained CLIP")
    print("semantic smoke: OK")


def _cfg(args, backbone: str, trainer: str, subsample: str):
    from ..engine import get_cfg_default

    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(REPO, f"configs/datasets/{args.dataset}.yaml"))
    cfg.merge_from_file(os.path.join(REPO, "configs/trainers/RPO/main_K24.yaml"))
    cfg.TRAINER.NAME = trainer
    cfg.DATASET.ROOT = args.root
    cfg.DATASET.NUM_SHOTS = -1
    cfg.DATASET.SUBSAMPLE_CLASSES = subsample
    cfg.MODEL.BACKBONE.NAME = backbone
    cfg.OUTPUT_DIR = args.output_dir
    return cfg


def zeroshot_eval(args, backbone: str, device) -> None:
    from ..engine import build_trainer

    for split in ("base", "new"):
        acc = build_trainer(_cfg(args, backbone, "ZeroshotCLIP", split), device=device).test()
        expected = ZEROSHOT_EXPECTED.get(args.dataset, {}).get(split)
        line = f"zero-shot {args.dataset}/{split}: accuracy {acc:.2f}%"
        if expected is not None:
            line += f" (published {expected:.2f}%, tolerance {TOLERANCE_PCT}%)"
            if abs(acc - expected) > TOLERANCE_PCT:
                raise ValidationFailed(
                    f"ZERO-SHOT ACCURACY OUT OF TOLERANCE: {acc:.2f} vs {expected:.2f}")
        print(line)
    print("zero-shot eval: OK")


def rpo_checkpoint_eval(args, backbone: str, device) -> None:
    from ..engine import build_trainer

    cfg = _cfg(args, backbone, "RPO", args.rpo_subsample)
    cfg.MODEL.INIT_WEIGHTS = args.rpo_checkpoint
    acc = build_trainer(cfg, device=device).test()
    print(f"RPO checkpoint {args.rpo_checkpoint} on {args.dataset}/{args.rpo_subsample}: "
          f"accuracy {acc:.2f}% (compare to the released-table value for this dataset/seed)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backbone", default="ViT-B/16")
    ap.add_argument("--root", default="", help="dataset root ($DATA)")
    ap.add_argument("--dataset", default="caltech101")
    ap.add_argument("--rpo-checkpoint", default="",
                    help="a trained or released RPO prompt checkpoint to evaluate")
    ap.add_argument("--rpo-subsample", default="base", choices=["base", "new", "all"])
    ap.add_argument("--output-dir", default="output/validate_real_weights")
    ap.add_argument("--reference", default="",
                    help="a checkout of the reference implementation, for stage 2")
    args = ap.parse_args(argv)

    import rpo_tpu_torch.data.datasets  # noqa: F401 - the registries the engine names
    import rpo_tpu_torch.methods  # noqa: F401

    from ..device import resolve_device
    from ..models.clip.convert import load_clip
    from ..models.clip.pretrained import find_checkpoint

    try:
        path = find_checkpoint(args.backbone)
    except FileNotFoundError as exc:  # a $CLIP_CHECKPOINT that does not exist
        print(exc)
        diagnose_missing(args.backbone)
        return 2
    if path is None:
        diagnose_missing(args.backbone)
        return 2
    print(f"weights: {path}")
    device = resolve_device("cpu" if os.environ.get("RPO_TPU_FORCE_CPU") else None)
    params, cfg = load_clip(path, device)
    print(f"loaded {args.backbone}: resolution {cfg.image_resolution}, embed {cfg.embed_dim}, "
          f"on {device}")
    try:
        if args.reference and os.path.isdir(args.reference):
            tower_parity(path, params, cfg, args.reference, device)
        else:
            print("tower parity: SKIPPED (pass --reference with a checkout of the reference "
                  "implementation, whose clip/model.py builds its torch CLIP)")
        semantic_smoke(params, cfg, device)
        if args.root and os.path.isdir(args.root):
            zeroshot_eval(args, args.backbone, device)
            if args.rpo_checkpoint:
                rpo_checkpoint_eval(args, args.backbone, device)
        else:
            print(f"dataset eval: SKIPPED (pass --root pointing at a data root containing "
                  f"{args.dataset}; see DATASETS.md for the expected layout)")
            if args.rpo_checkpoint:
                print("RPO checkpoint eval: SKIPPED (needs --root)")
    except ValidationFailed as exc:
        print(f"validate_real_weights: FAILED: {exc}")
        return 1
    print("validate_real_weights: PASSED (all runnable stages)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
