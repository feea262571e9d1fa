"""Device selection: the port runs on the CUDA card unless told otherwise.

One process drives one card.  Under a process group (``torchrun``, one
rank a card) a rank's card is ``cuda:$LOCAL_RANK``; a lone process takes
the current card, ``cuda`` (card 0 unless ``torch.cuda.set_device`` said
otherwise).
"""
from __future__ import annotations

import os
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

    ``None`` means the CUDA card: ``cuda:$LOCAL_RANK`` under an initialised
    process group (each rank its own card, made the current one, so that
    NCCL and the kernels' launches go there), ``cuda`` otherwise.  Without
    a card this raises rather than carrying on quietly on the CPU: a
    caller who wants the CPU (the tests, which hold the port against the
    JAX package there) passes ``device="cpu"``.  A CUDA device turns TF32
    and cuBLAS's reduced-precision bfloat16 reduction off
    (``no_tf32_no_bf16_reduction``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {local} but only {torch.cuda.device_count()} CUDA card(s) are "
                    "visible: launch one rank a card")
            device = f"cuda:{local}"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is not None:
            torch.cuda.set_device(device)
        no_tf32_no_bf16_reduction()
    return device
