"""Faults planted in the program under test, to show that the check
catches them (``tests/``, and ``calibrate.py --fault`` on the card).

- ``unchanged``: a train step that returns its state unchanged (the
  optimizer's update does nothing);
- ``half_batch``: half of the batch left out, the mean taken over the
  rest (the mask's second half zeroed inside the step);
- ``label``: a token altered where it is produced: the batch's first
  label moved on by one class inside the step;
- ``answer``: an answer altered where it is produced: the first image's
  logits of every eval batch rolled by one class.

``planted(method, fault)`` is the method module with ``build_trainer``
planting the fault in each trainer it builds; the rest of a run is as it
is.
"""
from __future__ import annotations

import types

import torch

FAULTS = ("unchanged", "half_batch", "label", "answer")


def plant(trainer, fault: str) -> None:
    if fault == "unchanged":
        trainer._optimizer.update = lambda params, grads: None
    elif fault in ("half_batch", "label"):
        inner, n_cls = trainer._loss_and_grads, len(trainer.classnames)

        def faulty(params, frozen, images, labels, mask, *rest):
            if fault == "half_batch":
                keep = torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2
                mask = mask * keep
            else:
                labels = torch.cat([(labels[:1] + 1) % n_cls, labels[1:]])
            return inner(params, frozen, images, labels, mask, *rest)

        trainer._loss_and_grads = faulty
    elif fault == "answer":
        infer = trainer.model_inference_async

        def altered(images):
            out = infer(images)
            return torch.cat([out[:1].roll(1, dims=1), out[1:]])

        trainer.model_inference_async = altered
    else:
        raise ValueError(f"unknown fault {fault!r}; the faults are {FAULTS}")


def planted(method: types.ModuleType, fault: str) -> types.SimpleNamespace:
    def build_trainer(*args, **kwargs):
        trainer = method.build_trainer(*args, **kwargs)
        plant(trainer, fault)
        return trainer

    return types.SimpleNamespace(**{**vars(method), "build_trainer": build_trainer})
