"""Device selection: the port runs on the CUDA card unless told otherwise."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def no_tf32_no_bf16_reduction() -> None:
    """Full-precision sums on the card, as the JAX package's contract has
    them (matmuls accumulate in float32):

    - no TF32 in cuBLAS's matmuls (PyTorch's default already);
    - no TF32 in cuDNN's convolutions (PyTorch's default is TF32 there);
    - no reduced-precision reduction in cuBLAS's bfloat16 matmuls
      (PyTorch's default allows one, which may sum split-K partials in
      bfloat16).

    A float32 run (PREC fp32, ``clip.load`` without a dtype) keeps the
    float32 contract and a bfloat16 run sums in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card.  Without one this raises rather than
    carrying on quietly on the CPU: a caller who wants the CPU (the tests,
    which hold the port against the JAX package there) passes
    ``device="cpu"``.  A CUDA device turns TF32 and cuBLAS's
    reduced-precision bfloat16 reduction off (``no_tf32_no_bf16_reduction``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        no_tf32_no_bf16_reduction()
    return device
