"""Host-side image transforms on numpy arrays, and normalisation on the
device.

Port of ``rpo_tpu/data/transforms.py``.  The host decodes, resizes,
crops and flips each image to an HWC uint8 array; the device turns the
uint8 batch into normalised floats (``device_normalize_fn``).  With
INPUT.DEVICE_RESIZE > 0 the host ships each image at that source size
instead (``raw_source``) and the resize runs on the device
(``ops/preprocess.py``).

The resize is Pillow's ``Image.resize(..., BICUBIC | BILINEAR, box=...)``
written in numpy (``resample``): the same filter taps, the same 22-bit
fixed-point coefficients and the same round, shift and clamp after each
pass, horizontal first, so its uint8 output equals Pillow's.  A JPEG
goes first to the native pipeline (``rpo_tpu_torch/_native``: libjpeg's
decode and the same resample in C++), which also reads an image's size
from its header; where that library is unavailable or refuses the file,
Pillow decodes it (imported only then: the synthetic path needs none).
"""
from __future__ import annotations

import ctypes
import math
import random
import zlib
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from .._native import get_lib

# CLIP's pixel statistics (the RPO configs' INPUT.PIXEL_MEAN / PIXEL_STD)
CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)

# Pillow's fixed point (Resample.c): coefficients in units of 2**-22, the
# sum of a pass seeded with half a unit, then shifted and clamped to uint8
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel, a = -0.5, each branch in its order of
    operations."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# name -> (kernel, support); any other name is bicubic, as in the JAX package
_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


def _coefficients(in_size: int, in0: float, in1: float, out_size: int,
                  interpolation: str) -> np.ndarray:
    """(out_size, in_size) float64 matrix of Pillow's integer coefficients
    (``precompute_coeffs`` then ``normalize_coeffs_8bpc``) for resizing
    [in0, in1) of an axis to out_size."""
    kernel, support = _FILTERS.get(interpolation, _FILTERS["bicubic"])
    scale = (in1 - in0) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = in0 + (np.arange(out_size) + 0.5) * scale
    # C's (int) casts truncate toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size)
    taps = xmin[:, None] + np.arange(ksize)
    valid = taps < xmax[:, None]
    w = np.where(valid, kernel((taps - center[:, None] + 0.5) * (1.0 / filterscale)), 0.0)
    total = np.cumsum(w, axis=1)[:, -1:]  # Pillow's sum, left to right
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    # to int, rounding half away from zero
    w = np.trunc(w * (1 << _PRECISION_BITS) + np.where(w < 0, -0.5, 0.5))
    out = np.zeros((out_size, in_size))
    rows = np.broadcast_to(np.arange(out_size)[:, None], taps.shape)
    out[rows[valid], taps[valid]] = w[valid]
    return out


def _pass(img: np.ndarray, coeffs: np.ndarray, axis: int) -> np.ndarray:
    """One resample pass of a uint8 HWC array along ``axis`` (1: columns,
    0: rows).  The products and sums are integers below 2**53, so the
    float64 matmul is exact."""
    moved = np.moveaxis(img, axis, -1).astype(np.float64)
    acc = moved @ coeffs.T + (1 << (_PRECISION_BITS - 1))
    out = np.clip(np.floor(acc / (1 << _PRECISION_BITS)), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, -1, axis))


def resample(img: np.ndarray, size: Tuple[int, int], interpolation: str = "bicubic",
             box: Optional[Tuple[float, float, float, float]] = None) -> np.ndarray:
    """Pillow's ``Image.resize(size, filter, box)`` of an HWC uint8 array:
    ``size`` is (width, height), ``box`` (left, top, right, bottom) in
    source pixels, the whole image when None."""
    h, w = img.shape[:2]
    out_w, out_h = size
    left, top, right, bottom = box if box is not None else (0, 0, w, h)
    if (out_w, out_h) == (w, h) and (left, top, right, bottom) == (0, 0, w, h):
        return img.copy()
    kx = _coefficients(w, left, right, out_w, interpolation)
    ky = _coefficients(h, top, bottom, out_h, interpolation)
    if out_w != w or left or right != out_w:
        rows = np.flatnonzero(ky.any(axis=0))  # the rows the vertical pass reads
        first, last = (rows[0], rows[-1] + 1) if rows.size else (0, 0)
        img = _pass(img[first:last], kx, 1)
        ky = ky[:, first:last]
    if out_h != h or top or bottom != out_h:
        img = _pass(img, ky, 0)
    return img


def load_image(impath: str) -> np.ndarray:
    """An HWC uint8 RGB array: synthesised for a ``synthetic://`` URI,
    else decoded from the file with Pillow (imported here only)."""
    if impath.startswith("synthetic://"):
        return synth_image(impath)
    from PIL import Image

    with Image.open(impath) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def synth_image(uri: str, size: int = 224) -> np.ndarray:
    """Deterministic pseudo-image for tests and benchmarks, keyed by a
    stable hash of the URI (Python's ``hash`` is salted per process)."""
    seed = zlib.crc32(uri.encode()) % (2 ** 31)
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(size, size, 3), dtype=np.uint8)


def resize_shorter(img: np.ndarray, size: int, interpolation: str = "bicubic") -> np.ndarray:
    """torchvision Resize(int) semantics: shorter side -> size, keep aspect."""
    h, w = img.shape[:2]
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        ow, oh = size, int(size * h / w)
    else:
        ow, oh = int(size * w / h), size
    return resample(img, (ow, oh), interpolation)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if w < size or h < size:  # pad with black like torchvision when smaller
        new = np.zeros((max(h, size), max(w, size), 3), np.uint8)
        top, left = (max(h, size) - h) // 2, (max(w, size) - w) // 2
        new[top:top + h, left:left + w] = img
        img = new
        h, w = img.shape[:2]
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img[top:top + size, left:left + size]


def sample_rrc_box(
    w: int,
    h: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    rng=random,
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box sampling.  ``rng`` is any object
    with the ``random.Random`` draw API (the global module by default;
    the loader passes a private per-epoch Random).
    Returns (left, top, crop_w, crop_h)."""
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return left, top, cw, ch
    # fallback: center crop to in-range aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


class TransformPipeline:
    """cfg.INPUT -> callable(impath, train, plan) -> HWC uint8 array.

    Train: random_resized_crop and random_flip where INPUT.TRANSFORMS
    names them; eval: resize-shorter and center-crop.  Normalisation runs
    on the device.  With INPUT.DEVICE_RESIZE = S > 0, eval images leave
    the host as (S, S) sources and the train batches' crops and flips run
    on the device (``BatchLoader._make_device_augment_batch``).
    """

    def __init__(self, cfg_input):
        self.size = int(cfg_input.SIZE[0])
        self.interpolation = str(cfg_input.INTERPOLATION)
        self.scale = tuple(cfg_input.RRCROP_SCALE)
        transforms = tuple(cfg_input.TRANSFORMS)
        self.use_rrc = "random_resized_crop" in transforms
        self.use_flip = "random_flip" in transforms
        self.device_resize = int(getattr(cfg_input, "DEVICE_RESIZE", 0))
        if self.device_resize and self.interpolation != "bicubic":
            # the device resample is bicubic only; mixing kernels between
            # the host and device paths would skew accuracy
            raise ValueError(
                "INPUT.DEVICE_RESIZE requires INPUT.INTERPOLATION 'bicubic' (got "
                f"{self.interpolation!r}); all CLIP protocol configs set bicubic")

    def image_size(self, impath: str) -> Tuple[int, int]:
        """(width, height), from the header only for a file: a JPEG's
        through the native library where it is available, so that a host
        without Pillow still plans its crops."""
        if impath.startswith("synthetic://"):
            return (224, 224)
        if is_jpeg(impath):
            lib = get_lib()
            if lib is not None:
                w, h = ctypes.c_int(), ctypes.c_int()
                if lib.rpo_image_size(impath.encode(), ctypes.byref(w), ctypes.byref(h)) == 0:
                    return (w.value, h.value)
        from PIL import Image

        with Image.open(impath) as img:
            return img.size

    def make_plan(self, impath: str, train: bool, size=None, rng=None):
        """Draw all augmentation randomness for one image: (box or None,
        flip), or None for eval or when no augmentation is configured.

        Called in item order against one ``rng`` stream (the loader's
        private per-epoch Random; None means the global module), which is
        what keeps a seeded run reproducible while the resizing fans out
        to a thread pool.  The flip is drawn whenever enabled, with or
        without the crop (Dassl applies them independently).  ``size``
        (w, h) skips the header read; the draws are the same."""
        if not train or not (self.use_rrc or self.use_flip):
            return None
        if rng is None:
            rng = random
        box = None
        if self.use_rrc:
            w, h = size if size is not None else self.image_size(impath)
            box = sample_rrc_box(w, h, self.scale, rng=rng)
        flip = bool(self.use_flip and rng.random() < 0.5)
        return (box, flip)

    def raw_source(self, impath: str, box=None) -> np.ndarray:
        """The (S, S, 3) uint8 source of the device-resize path.  An
        (S, S) image ships as it is (its crop, resize and flip run on the
        device); any other size is brought to (S, S) here: with ``box``
        (a crop box in the image's own coordinates) the crop is applied
        here, so that the augmentation still covers the whole frame,
        without it the eval resize-shorter and centre crop."""
        S = self.device_resize
        img = load_image(impath)
        h, w = img.shape[:2]
        if (w, h) != (S, S):
            if box is not None:
                left, top, cw, ch = box
                img = resample(img, (S, S), self.interpolation,
                               box=(left, top, left + cw, top + ch))
            else:
                img = center_crop(resize_shorter(img, S, self.interpolation), S)
        return np.ascontiguousarray(img, dtype=np.uint8)

    def __call__(self, impath: str, train: bool, plan=None) -> np.ndarray:
        if not train and self.device_resize:
            # eval: the raw source; the eval step resizes, crops and
            # normalises on the device
            return self.raw_source(impath)
        if train and self.device_resize:
            # the host equivalent of the device-augment batch for one
            # item: the source, then the planned box and flip resampled
            # here (the loader's batches run this on the device)
            if plan is None:
                plan = self.make_plan(impath, train)
            box, flip = plan if plan is not None else (None, False)
            S = self.device_resize
            exact = self.image_size(impath) == (S, S)
            # another size: the box (in the image's coordinates) is
            # applied inside raw_source, and the device sees the full frame
            img = self.raw_source(impath, box=None if exact else box)
            left, top, cw, ch = box if (box is not None and exact) else (0, 0, S, S)
            img = resample(img, (self.size, self.size), self.interpolation,
                           box=(left, top, left + cw, top + ch))
            if flip:
                img = img[:, ::-1]
            return np.ascontiguousarray(img)
        if train and plan is None:
            plan = self.make_plan(impath, train)
        native = self._native_path(impath, train, plan)
        if native is not None:
            return native
        img = load_image(impath)
        box, flip = plan if (train and plan is not None) else (None, False)
        if box is not None:
            left, top, cw, ch = box
            img = resample(img, (self.size, self.size), self.interpolation,
                           box=(left, top, left + cw, top + ch))
        else:
            img = center_crop(resize_shorter(img, self.size, self.interpolation), self.size)
        if flip:
            img = img[:, ::-1]
        return np.ascontiguousarray(img)

    def _native_path(self, impath: str, train: bool, plan) -> Optional[np.ndarray]:
        """The C++ decode, resize and crop of one JPEG (bicubic only), or
        None where the library is unavailable or refuses the file.  The
        randomness is in ``plan``: the library only carries it out."""
        if self.interpolation != "bicubic" or not is_jpeg(impath):
            return None
        lib = get_lib()
        if lib is None:
            return None
        path_b = impath.encode()
        out = np.empty((self.size, self.size, 3), dtype=np.uint8)
        out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if train and plan is not None and plan[0] is not None:
            (left, top, cw, ch), flip = plan
            rc = lib.rpo_train_preprocess(path_b, left, top, cw, ch, int(flip), self.size,
                                          out_ptr)
        else:
            rc = lib.rpo_eval_preprocess(path_b, self.size, out_ptr)
            if rc == 0 and train and plan is not None and plan[1]:
                out = out[:, ::-1].copy()  # a flip without a crop
        return out if rc == 0 else None


def is_jpeg(impath: str) -> bool:
    """Whether the native pipeline may take the path (by its suffix)."""
    return impath.lower().endswith((".jpg", ".jpeg"))


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
