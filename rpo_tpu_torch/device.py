"""Device selection: the port runs on the CUDA card unless told otherwise."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def no_tf32() -> None:
    """Full float32 on the card: no TF32 in cuBLAS's matmuls (PyTorch's
    default already) nor in cuDNN's convolutions (PyTorch's default is
    TF32 there).  A float32 run of the port (PREC fp32, ``clip.load``
    without a dtype) keeps the JAX package's float32 contract; bfloat16
    runs are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card.  Without one this raises rather than
    carrying on quietly on the CPU: a caller who wants the CPU (the tests,
    which hold the port against the JAX package there) passes
    ``device="cpu"``.  A CUDA device turns TF32 off (``no_tf32``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        no_tf32()
    return device
