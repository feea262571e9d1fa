"""Image preprocessing on the device: bicubic resize, crop, flip, normalise.

Port of ``rpo_tpu/ops/preprocess.py`` for ``INPUT.DEVICE_RESIZE``: the host
ships uint8 source pixels (and, for a train batch, the crop boxes and
flips it drew) and the resample runs on the device as two separable
weight-matrix products, horizontal then vertical, each rounded and
clamped to uint8's range as Pillow does between its passes; the flip
comes after the resize, as on the host (crop, then flip).

The products are float32 ``torch.matmul``/``einsum`` calls, the JAX
package's XLA einsums at ``Precision.HIGHEST``: no Pallas kernel stands
behind them, so none stands behind these.  They need full float32
matmuls, PyTorch's default (``torch.backends.cuda.matmul.allow_tf32``
False): TF32 keeps about three digits and would break the one-uint8-step
agreement with the host's resample.  ``device_train_preprocess`` builds
each image's weights from the box tensors with tensor operations and
reads nothing back to the host, so a CUDA graph can capture it.

Only bicubic resampling is implemented; ``TransformPipeline`` refuses
INPUT.DEVICE_RESIZE with another INPUT.INTERPOLATION.
"""
from __future__ import annotations

from typing import Iterable, Tuple, Union

import numpy as np
import torch

Stats = Union[Iterable[float], torch.Tensor]


def _cubic(x, a: float = -0.5, xp=np):
    """Catmull-Rom bicubic kernel, one copy of the coefficients for the
    static host weights (``xp=np``) and the per-image device weights
    (``xp=torch``)."""
    x = xp.abs(x)
    out = xp.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0, 0.0)
    out = xp.where((x >= 1.0) & (x < 2.0), (((x - 5.0) * x + 8.0) * x - 4.0) * a, out)
    return out


def _mean_std_u8(mean: Stats, std: Stats, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalisation constants scaled to uint8's range, float32 on
    ``device``; tensors pass through (a caller that must not copy to the
    device inside a CUDA graph makes them once beforehand)."""
    def one(values):
        if isinstance(values, torch.Tensor):
            return values
        return torch.from_numpy(np.asarray(list(values), np.float32) * 255.0).to(device)
    return one(mean), one(std)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) Pillow-style antialiased bicubic weight matrix."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    W = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        xs = np.arange(xmin, xmax)
        w = _cubic((xs - center + 0.5) / filterscale)
        W[i, xmin:xmax] = w / w.sum()
    return W


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """Round (half to even, as ``jnp.round``) and clamp to [0, 255]."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def resize_bicubic(images: torch.Tensor, out_h: int, out_w: int,
                   quantize: bool = True) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C) float32 by two products with
    the static weights, horizontal first.  ``quantize`` rounds and clamps
    to uint8's range after each pass, as Pillow does (it clips the cubic
    overshoot between the passes)."""
    B, H, W, C = images.shape
    dev = images.device
    wv = torch.from_numpy(resize_weights(H, out_h)).to(dev)
    wh = torch.from_numpy(resize_weights(W, out_w)).to(dev)
    x = images.float()
    x = torch.einsum("pw,bhwc->bhpc", wh, x)
    if quantize:
        x = _round_u8(x)
    x = torch.einsum("oh,bhpc->bopc", wv, x)
    if quantize:
        x = _round_u8(x)
    return x


def device_eval_preprocess(images_u8: torch.Tensor, size: int, mean: Stats,
                           std: Stats) -> torch.Tensor:
    """The eval transform on the device for a uniform (B, H, W, 3) uint8
    batch: the shorter side resized to ``size`` (aspect kept), the centre
    crop, normalised."""
    B, H, W, _ = images_u8.shape
    if W <= H:
        rw, rh = size, (int(size * H / W) if H != W else size)
    else:
        rh, rw = size, int(size * W / H)
    x = resize_bicubic(images_u8.float(), rh, rw)
    top = int(round((rh - size) / 2.0))
    left = int(round((rw - size) / 2.0))
    x = x[:, top:top + size, left:left + size, :]
    mean_a, std_a = _mean_std_u8(mean, std, images_u8.device)
    return (x - mean_a) / std_a


def _traced_resize_weights(src: int, out: int, start: torch.Tensor,
                           length: torch.Tensor) -> torch.Tensor:
    """(B, out, src) bicubic weights resizing the window [start, start +
    length) of a src-long axis to ``out`` samples, for each image's
    ``start`` and ``length`` (tensors of shape (B,)), built on the device.

    ``resize_weights``' arithmetic in float32 tensor operations: for
    output i, center = start + (i + 0.5) * scale, support 2 * filterscale,
    the window [xmin, xmax) truncated toward zero as Python's ``int``, the
    cubic kernel normalised over the window.  The shapes are static; the
    boxes move only values."""
    dev = start.device
    start = start.float()[:, None, None]  # (B, 1, 1)
    length = torch.clamp(length.float(), min=1.0)[:, None, None]
    scale = length / out
    filterscale = torch.clamp(scale, min=1.0)
    support = 2.0 * filterscale
    i = torch.arange(out, dtype=torch.float32, device=dev)[:, None]  # (out, 1)
    j = torch.arange(src, dtype=torch.float32, device=dev)[None, :]  # (1, src)
    center = start + (i + 0.5) * scale  # (B, out, 1)
    xmin = torch.clamp(torch.trunc(center - support + 0.5), min=0.0)
    xmax = torch.clamp(torch.trunc(center + support + 0.5), max=float(src))
    w = _cubic((j - center + 0.5) / filterscale, xp=torch)
    w = torch.where((j >= xmin) & (j < xmax), w, 0.0)
    norm = torch.sum(w, dim=-1, keepdim=True)
    return w / torch.where(norm == 0.0, 1.0, norm)


def device_train_preprocess(images_u8: torch.Tensor, boxes: torch.Tensor, flips: torch.Tensor,
                            size: int, mean: Stats, std: Stats) -> torch.Tensor:
    """The train augmentation on the device for uniform sources:
    RandomResizedCrop from the host's integer boxes (left, top, crop_w,
    crop_h), the horizontal flip, normalisation.

    (B, S, S, 3) uint8, (B, 4) int32 boxes and (B,) flips -> (B, size,
    size, 3) float32.  Each image's resample weights come from its box
    (``_traced_resize_weights``); a full-frame box (0, 0, S, S) is the
    plain resize.  The flip follows the resize, as on the host."""
    B, S = images_u8.shape[0], images_u8.shape[1]
    mean_a, std_a = _mean_std_u8(mean, std, images_u8.device)
    wh = _traced_resize_weights(S, size, boxes[:, 0], boxes[:, 2])  # (B, size, S)
    wv = _traced_resize_weights(S, size, boxes[:, 1], boxes[:, 3])
    x = images_u8.float()
    x = _round_u8(torch.einsum("bpw,bhwc->bhpc", wh, x))
    x = _round_u8(torch.einsum("boh,bhpc->bopc", wv, x))
    x = torch.where((flips > 0)[:, None, None, None], x.flip(2), x)
    return (x - mean_a) / std_a
