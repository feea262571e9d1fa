"""The precision the reference computes in.

A ``Precision`` has ``mm`` (a matrix product) and ``cast`` (the rounding
of an activation where the program rounds one to its compute type):

- ``EXACT``: float32 throughout, no rounding; TF32 is turned off in
  cuBLAS and cuDNN before the reference runs (``no_tf32``).
- ``E4M3``: the control, the configuration's precision one step down:
  where the program keeps bfloat16 (every product's operands, every
  activation it rounds), float8 e4m3 under one scale a tensor (its
  largest magnitude mapped to 448); products summed in float32 and
  LayerNorm, softmax and the logits in float32, as the program has them.
  The rounding passes gradients straight through, so the control trains.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale, back in
    float32; the gradient passes straight through."""
    scale = E4M3_MAX / t.detach().abs().amax().clamp(min=1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return t + (q - t).detach()


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    cast: Callable[[torch.Tensor], torch.Tensor]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.cast(a), self.cast(b))


EXACT = Precision("float32", lambda t: t)
E4M3 = Precision("float8", to_e4m3)
