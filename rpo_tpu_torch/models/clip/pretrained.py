"""The CLIP backbone a trainer starts from, resolved offline.

Port of ``rpo_tpu/models/clip/pretrained.py``.  The order:

  1. ``$CLIP_CHECKPOINT``, a file (a missing one raises
     ``FileNotFoundError``: never train on other weights than those asked
     for);
  2. ``$CLIP_CACHE_DIR`` or ``~/.cache/clip``: the OpenAI file name of the
     backbone (its SHA-256 checked against the published one, with a
     warning on a mismatch), else an alternate format of it
     (``.safetensors``, ``.bin``, the HF repo's name for the ViTs);
  3. random weights from a seed, with a loud warning.

Nothing is downloaded: the JAX package's opt-in download is not ported.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import torch

from ...device import DeviceLike, resolve_device
from .model import ARCHS, CLIPConfig, Params, cast_params, init_clip

_FILENAMES = {
    "ViT-B/16": "ViT-B-16.pt",
    "ViT-B/32": "ViT-B-32.pt",
    "RN50": "RN50.pt",
    "RN101": "RN101.pt",
    "RN50x4": "RN50x4.pt",
    "RN50x16": "RN50x16.pt",
}

# HF-hub repo basenames accepted as alternate cache file names (the HF
# CLIPModel layout is remapped by convert.py)
_HF_NAMES = {
    "ViT-B/16": "clip-vit-base-patch16",
    "ViT-B/32": "clip-vit-base-patch32",
}

# the published SHA-256 of each OpenAI release file (the path element of
# its download URL), to check a cached file against
_SHA256 = {
    "RN50": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "RN101": "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599",
    "RN50x4": "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd",
    "RN50x16": "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa",
    "ViT-B/32": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
    "ViT-B/16": "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f",
}


def find_checkpoint(backbone_name: str) -> Optional[str]:
    """The checkpoint file for ``backbone_name``, or None (random weights)."""
    explicit = os.environ.get("CLIP_CHECKPOINT")
    if explicit:
        if not os.path.exists(explicit):
            raise FileNotFoundError(
                f"$CLIP_CHECKPOINT={explicit!r} does not exist "
                "(unset it to use the cache-dir resolution)")
        return explicit
    cache_dir = os.environ.get("CLIP_CACHE_DIR", os.path.expanduser("~/.cache/clip"))
    fname = _FILENAMES.get(backbone_name)
    if not fname:
        return None
    path = os.path.join(cache_dir, fname)
    if not os.path.exists(path):
        # any locally present variant of the same backbone: the converter
        # takes open_clip envelopes, HF CLIPModel state dicts, safetensors
        stem = os.path.splitext(fname)[0]
        alternates = [f"{stem}.safetensors", f"{stem}.bin"]
        hf_repo = _HF_NAMES.get(backbone_name)
        if hf_repo:
            alternates += [f"{hf_repo}.safetensors", f"{hf_repo}.bin"]
        for alt in alternates:
            alt_path = os.path.join(cache_dir, alt)
            if os.path.exists(alt_path):
                print(f"Using alternate-format checkpoint {alt_path} for {backbone_name} "
                      "(auto-converted layout)")
                return alt_path
        return None
    # a cached file at the OpenAI name is checked against the published
    # SHA-256 and loaded anyway: it may be deliberate custom weights, and
    # random weights would be worse than trying it
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != _SHA256[backbone_name]:
        print(f"(!) {path} does not match the published SHA256 for this backbone (custom "
              "weights, or a truncated download)")
    return path


_UNRESOLVED = object()  # path=None means "resolved to no checkpoint"


def load_backbone(backbone_name: str, dtype: Optional[torch.dtype] = None, seed: int = 0,
                  path=_UNRESOLVED, device: DeviceLike = None) -> Tuple[Params, CLIPConfig]:
    """Resolve and load, or randomly initialise, a CLIP backbone on the
    device (None: the CUDA card): (params, its CLIPConfig).  A checkpoint's
    config is inferred from its shapes; random weights are drawn from
    ``seed``.  ``path`` lets a caller that already ran
    :func:`find_checkpoint` skip a second resolution (a cache hit hashes
    the whole file); pass its result, None included.  ``dtype`` casts the
    floating leaves (``cast_params``); None keeps float32."""
    if path is _UNRESOLVED:
        path = find_checkpoint(backbone_name)
    device = resolve_device(device)
    if path is not None:
        from .convert import load_clip

        print(f"Loading CLIP (backbone: {backbone_name}) from {path}")
        params, cfg = load_clip(path, device)
    else:
        if backbone_name not in ARCHS:
            raise KeyError(f"Unknown backbone {backbone_name!r} and no checkpoint found; "
                           f"known: {sorted(ARCHS)}")
        cfg = ARCHS[backbone_name]
        print(f"WARNING: no checkpoint found for {backbone_name} (set $CLIP_CHECKPOINT or "
              "$CLIP_CACHE_DIR); using RANDOM weights — accuracy will be chance level")
        params = init_clip(torch.Generator(device=device).manual_seed(int(seed)), cfg)
    if dtype is not None:
        params = cast_params(params, dtype)
    return params, cfg
