"""The crop, resize and flip of a train image, in plain PyTorch: the
reference of the device's augmentation under INPUT.DEVICE_RESIZE.

Pillow's antialiased bicubic resample of a crop box, written out from its
definition: for output sample i of an axis cut to [start, start + length)
and resized to ``out``, the centre start + (i + 0.5) * scale, the support
2 * max(scale, 1) either side, the window's ends truncated as Pillow
truncates them, the Catmull-Rom kernel (a = -0.5) at (x - centre + 0.5) /
max(scale, 1), normalised over the window.  The horizontal pass comes
first; each pass is rounded and clamped to uint8's range, as Pillow does
between its passes; the flip follows the resize.  Float64 throughout.
"""
from __future__ import annotations

import torch


def cubic(x: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    x = x.abs()
    near = ((a + 2) * x - (a + 3)) * x * x + 1
    far = ((x - 5) * x + 8) * x * a - 4 * a
    return torch.where(x < 1, near, torch.where(x < 2, far, torch.zeros_like(x)))


def weights(src: int, out: int, start: float, length: float) -> torch.Tensor:
    """(out, src) float64: the samples of [start, start + length) of a
    src-long axis, resized to ``out``."""
    scale = length / out
    stretch = max(scale, 1.0)
    support = 2.0 * stretch
    w = torch.zeros(out, src, dtype=torch.float64)
    for i in range(out):
        centre = start + (i + 0.5) * scale
        lo, hi = max(0, int(centre - support + 0.5)), min(src, int(centre + support + 0.5))
        x = torch.arange(lo, hi, dtype=torch.float64)
        k = cubic((x - centre + 0.5) / stretch)
        w[i, lo:hi] = k / k.sum()
    return w


def crop_resize_flip(image_u8: torch.Tensor, box, flip: bool, size: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> (size, size, 3) uint8: the box (left, top,
    width, height) resized to ``size`` and flipped left to right if
    ``flip``."""
    H, W, _ = image_u8.shape
    left, top, width, height = (float(v) for v in box)
    dev = image_u8.device
    wx = weights(W, size, left, width).to(dev)
    wy = weights(H, size, top, height).to(dev)
    x = image_u8.double()
    x = torch.einsum("pw,hwc->hpc", wx, x).round().clamp(0, 255)
    x = torch.einsum("oh,hpc->opc", wy, x).round().clamp(0, 255)
    if flip:
        x = x.flip(1)
    return x.to(torch.uint8)
