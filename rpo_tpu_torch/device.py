"""Device selection: the port runs on the CUDA card unless told otherwise."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card.  Without one this raises rather than
    carrying on quietly on the CPU: a caller who wants the CPU (the tests,
    which hold the port against the JAX package there) passes
    ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
