"""The CLIP backbone a trainer starts from.

Port of ``rpo_tpu/models/clip/pretrained.py``'s random-initialisation
path only: no CLIP checkpoint ships with the repository, and converting
one (``rpo_tpu/models/clip/convert.py``) is not ported yet.  A checkpoint
named by ``$CLIP_CHECKPOINT`` therefore raises rather than training
against weights other than the ones asked for; no cache directory is
searched and nothing is downloaded.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch

from ...device import DeviceLike, resolve_device
from .model import ARCHS, CLIPConfig, Params, init_clip


def load_backbone(backbone_name: str, seed: int = 0,
                  device: DeviceLike = None) -> Tuple[Params, CLIPConfig]:
    """Random float32 CLIP weights for ``backbone_name``, drawn from
    ``seed`` on the device (None: the CUDA card), after a loud warning."""
    explicit = os.environ.get("CLIP_CHECKPOINT")
    if explicit:
        raise NotImplementedError(
            f"$CLIP_CHECKPOINT={explicit!r}: loading a CLIP checkpoint is not ported to "
            "rpo_tpu_torch yet (unset it to train on random weights)")
    if backbone_name not in ARCHS:
        raise KeyError(f"Unknown backbone {backbone_name!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[backbone_name]
    print(f"WARNING: no checkpoint for {backbone_name} (loading one is not ported yet); "
          "using RANDOM weights — accuracy will be chance level")
    gen = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
    return init_clip(gen, cfg), cfg
