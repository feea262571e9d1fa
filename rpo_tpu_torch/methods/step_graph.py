"""The train step as one CUDA graph: N SGD steps a replay.

The port's counterpart of ``_install_steps``' ``jax.jit`` of the train
step and of ``make_multi``'s ``lax.scan`` over a group of batches
(``rpo_tpu/methods/base_trainer.py:378-478``).  A ``StepGraph`` captures
``n_steps`` calls of a trainer's step, unrolled over the slots of static
device buffers:

- inputs: ``img`` uint8 (N, B, H, W, 3), or with INPUT.DEVICE_RESIZE the
  (N, B, S, S, 3) sources with ``box`` (N, B, 4) and ``flip`` (N, B)
  int32; ``label`` int64 and ``mask`` float32 (N, B);
- outputs: the N losses and accuracies.

The step updates the prompts and the optimizer's buffers in place in
their own storage, and reads the learning rate from the optimizer's
device scalar, which the trainer fills before a replay.  A group then
costs one copy of each input from pinned host memory and one
``replay()``: JAX's one transfer and one program launch per group.  A
graph runs on a CUDA device only; on the CPU the trainer runs the same
steps one by one.

Before the capture one step runs on a side stream (the kernels' builds
and launch attributes, cuBLAS's handles, the normalisation constants on
the device), and the state it moved is put back, in place, after the
capture: capturing moves nothing.  The kernel wrappers count their calls
where they make them: in the warm-up step and once for each launch the
capture records, never at a replay.  ``launches_per_replay`` keeps what
the capture recorded and ``replays`` how often it ran; a profile of a
replay shows its kernels on the device.
"""
from __future__ import annotations

import gc
from contextlib import contextmanager
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..ops import fused_rect_layer, fused_text_layer, masked_attention, rect_attention

# the kernels' launch counters, read around a capture: (module, attribute)
KERNEL_COUNTERS = (
    (rect_attention, "launches"),
    (masked_attention, "launches"),
    (fused_text_layer, "launches"),
    (fused_rect_layer, "attn_half_launches"),
    (fused_rect_layer, "mlp_half_launches"),
)
WARMUP_STEPS = 1  # eager steps on a side stream before a capture
INPUT_DTYPES = {"img": torch.uint8, "box": torch.int32, "flip": torch.int32,
                "label": torch.int64, "mask": torch.float32}

Spec = Tuple[Tuple[str, Tuple[int, ...]], ...]
Step = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def batch_spec(batch: Mapping) -> Spec:
    """The inputs a batch fills, with one step's shape of each: the keys
    of ``INPUT_DTYPES`` it holds (numpy arrays or tensors)."""
    return tuple((key, tuple(np.shape(batch[key]))) for key in INPUT_DTYPES if key in batch)


def train_batch_spec(batch_size: int, size: int, device_resize: int = 0) -> Spec:
    """``batch_spec`` of the loader's train batches: (B, size, size, 3)
    images, or with ``device_resize`` = S the (B, S, S, 3) sources with
    their boxes and flips."""
    side = device_resize or size
    shapes = {"img": (batch_size, side, side, 3), "label": (batch_size,),
              "mask": (batch_size,)}
    if device_resize:
        shapes.update(box=(batch_size, 4), flip=(batch_size,))
    return tuple((key, shapes[key]) for key in INPUT_DTYPES if key in shapes)


def _counts() -> List[int]:
    return [getattr(module, name) for module, name in KERNEL_COUNTERS]


@contextmanager
def state_kept(tensors: Sequence[torch.Tensor]):
    """Run the body, then copy every tensor back to its value before it,
    in its own storage."""
    saved = [t.detach().clone() for t in tensors]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)


@contextmanager
def no_collection():
    """Keep Python's cyclic collector off for the body: a dead trainer's
    graph freed inside a capture (its executable destroyed, its memory
    pool released) would invalidate the capture.  The collection that
    would have run there runs first instead: ``torch.cuda.graph``
    collects before a capture only under
    ``torch.compiler.config.force_cudagraph_gc``, off by default, so
    without it the dead trainers' graph pools stay held."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """``n_steps`` calls of ``step(images, labels, mask) -> (loss, acc)``
    captured as one CUDA graph over static inputs of ``spec``.

    ``bound()`` lists the objects the step reads or writes besides its
    inputs (the trainable and optimizer tensors, the frozen bundle): the
    tensors among them are put back after the warm-up, and a replay
    raises if any of them is no longer the object captured (a graph
    would go on training storage that was replaced)."""

    def __init__(self, step: Step, n_steps: int, spec: Spec, bound: Callable[[], list],
                 device) -> None:
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}; on the CPU the "
                             "trainer runs its steps one by one")
        if n_steps < 1:
            raise ValueError(f"n_steps must be at least 1, got {n_steps}")
        self.n_steps = int(n_steps)
        self.spec = spec
        self.device = device
        self._bound = bound
        self._captured = list(bound())
        self.inputs = {key: self._dummy(key, shape) for key, shape in spec}
        self.staging = {key: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for key, t in self.inputs.items()}
        self._staged = None  # the event after the last copy out of the staging buffers
        self.replays = 0
        self._capture(step)

    def _dummy(self, key: str, shape) -> torch.Tensor:
        """A valid batch in every slot until the first run: mask 1,
        full-frame boxes, the rest 0."""
        t = torch.zeros((self.n_steps,) + tuple(shape), dtype=INPUT_DTYPES[key],
                        device=self.device)
        if key == "mask":
            t.fill_(1.0)
        elif key == "box":
            side = dict(self.spec)["img"][1]
            t.copy_(torch.tensor([0, 0, side, side], dtype=torch.int32))
        return t

    def _slot(self, i: int):
        """Step ``i``'s (images, labels, mask): images a tensor, or the
        {img, box, flip} dict of the device-resize path."""
        inp = self.inputs
        images = ({key: inp[key][i] for key in ("img", "box", "flip")} if "box" in inp
                  else inp["img"][i])
        return images, inp["label"][i], inp["mask"][i]

    def _steps(self, step: Step):
        out = [step(*self._slot(i)) for i in range(self.n_steps)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    def _capture(self, step: Step) -> None:
        tensors = [t for t in self._captured if isinstance(t, torch.Tensor)]
        with state_kept(tensors):
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    step(*self._slot(0))
            current.wait_stream(side)
            before = _counts()
            self.graph = torch.cuda.CUDAGraph()
            with no_collection():
                with torch.cuda.graph(self.graph):
                    self.losses, self.accs = self._steps(step)
            after = _counts()
        self.launches_per_replay: Dict[str, int] = {
            f"{module.__name__.rsplit('.', 1)[-1]}.{name}": a - b
            for (module, name), a, b in zip(KERNEL_COUNTERS, after, before)}

    def _load(self, batches: Sequence[Mapping]) -> None:
        """Copy the host batches (numpy arrays or CPU tensors) into the
        inputs through the pinned staging buffers, one non-blocking copy
        of each input."""
        with tracing.span("stage_wait"):
            if self._staged is not None:
                self._staged.synchronize()  # the last copy out of staging is done
        with tracing.span("stage_copy"):
            for key, buf in self.inputs.items():
                for i, batch in enumerate(batches):
                    value = batch[key]
                    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
                        raise ValueError(f"batch {key} is on {value.device}: the graph takes "
                                         "host batches")
                    if tuple(np.shape(value)) != tuple(buf.shape[1:]):
                        raise ValueError(f"batch {key} of shape {tuple(np.shape(value))}, the "
                                         f"graph's is {tuple(buf.shape[1:])}")
                    self.staging[key][i].copy_(torch.as_tensor(np.asarray(value)))
                buf.copy_(self.staging[key], non_blocking=True)
            self._staged = torch.cuda.Event()
            self._staged.record(torch.cuda.current_stream(self.device))

    def run(self, batches: Sequence[Mapping]) -> Tuple[torch.Tensor, torch.Tensor]:
        """One replay on ``n_steps`` batches; returns copies of the (N,)
        losses and accuracies (the outputs are overwritten by the next
        replay)."""
        if len(batches) != self.n_steps:
            raise ValueError(f"{len(batches)} batches for a graph of {self.n_steps} steps")
        bound = self._bound()
        if len(bound) != len(self._captured) or any(
                a is not b for a, b in zip(bound, self._captured)):
            raise RuntimeError("the trainable state or the frozen bundle was replaced after the "
                               "train step was captured")
        self._load(batches)
        with tracing.span("replay"):
            self.graph.replay()
        self.replays += 1
        return self.losses.clone(), self.accs.clone()
