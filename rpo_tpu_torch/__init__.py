"""rpo_tpu_torch: the PyTorch/CUDA port of rpo_tpu.

The module layout and function names follow ``rpo_tpu`` one to one, so
each function here has its JAX counterpart at the same path.  The port
imports torch and numpy only: it never imports jax or anything of
``rpo_tpu`` and keeps its own copies of the framework-free parts
(tokenizer, task masks, evaluator).

Entry points run on the CUDA card unless the caller passes a device
(``device="cpu"``), and raise when no card is present; see
``rpo_tpu_torch.device.resolve_device``.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
