"""Image normalisation on the device (port of ``device_normalize_fn``)."""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

# CLIP's pixel statistics (the RPO configs' INPUT.PIXEL_MEAN / PIXEL_STD)
CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def device_normalize_fn(mean: Iterable[float], std: Iterable[float], dtype=None):
    """uint8 (B, H, W, 3) -> ``(x - mean*255) / (std*255)`` computed in
    float32 and rounded once to ``dtype`` (float32 when None)."""
    mean_u8 = torch.from_numpy(np.asarray(list(mean), np.float32) * 255.0)
    std_u8 = torch.from_numpy(np.asarray(list(std), np.float32) * 255.0)

    def normalize(images_u8: torch.Tensor) -> torch.Tensor:
        dev = images_u8.device
        out = (images_u8.float() - mean_u8.to(dev)) / std_u8.to(dev)
        return out.to(dtype) if dtype is not None else out

    return normalize
