"""Profile a train or eval step of the port and rank its device operations.

Port of the JAX package's ``tools/profile_step.py``: ``torch.profiler``
over ``--steps`` steady steps at that tool's defaults (ViT-B/16, K 24,
n_cls 51, a random backbone from seed 1 in bf16; batch 4 for ``train``, 8
for ``cocoop-train``, 100 for the eval phases):

    python -m rpo_tpu_torch.tools.profile_step [--phase train|eval|cocoop-train|cocoop-eval]
        [--steps 20] [--batch N] [--n-cls N] [--k K] [--backbone ViT-B/16]
        [--trace-dir DIR] [--top 25]

The train phases profile the step as the engine runs it: a replay of the
trainer's captured CUDA graph (``methods/step_graph.py``'s ``StepGraph``,
captured at the first step, after a warm-up step on a side stream and
with Python's cyclic collector off), from a host uint8 batch to the
updated trainable tensors.  The eval phases run the trainer's eval step
on a batch already on the card (RPO with its cached text features;
CoCoOp's image tower, then its per-image text towers on the fused text
layer).

It prints the top device operations by total time a step, the same
operations by group (``tools.timing.kernel_group``), and the window's
wall time, device busy time and idle share; ``--trace-dir`` also gets a
Chrome trace.  It runs on the CUDA card; ``RPO_TPU_FORCE_CPU=1`` asks for
the CPU, where it ranks the CPU operators and prints the device time as
not measured.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch


def build(args, device=None):
    """A callable that runs one step of ``args.phase`` and returns its
    output (the loss of a train step, the logits of an eval batch) on
    ``device`` (None: the CUDA card)."""
    from ..methods.cocoop import CoCoOp
    from ..methods.rpo_trainer import RPO
    from ..models.clip.model import ARCHS

    cfg = ARCHS[args.backbone]
    classnames = [f"object category {i}" for i in range(args.n_cls)]
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (args.batch, cfg.image_resolution, cfg.image_resolution, 3)
                         ).astype(np.uint8)
    if args.phase.startswith("cocoop"):
        trainer = CoCoOp(classnames, n_ctx=4, ctx_init="a photo of a", backbone=args.backbone,
                         seed=1, device=device)
    else:
        trainer = RPO(classnames, K=args.k, backbone=args.backbone, seed=1, device=device)
    if args.phase.endswith("eval"):
        on_device = torch.as_tensor(images).to(trainer.device)
        return lambda: trainer.eval_step(on_device)
    trainer.current_lr = 0.002 if args.phase == "cocoop-train" else 0.01
    batch = {"img": images, "label": rng.randint(0, args.n_cls, args.batch).astype(np.int64),
             "mask": np.ones(args.batch, np.float32)}
    return lambda: trainer.forward_backward(batch)["loss"]


def rank(events, steps: int, top: int, on_device: bool):
    """Lines ranking ``events`` (``key_averages()``) by total time a step:
    each operation, then the operations by ``kernel_group``; and the
    device's busy microseconds over the window (0 on the CPU)."""
    from .timing import kernel_group

    totals, counts = defaultdict(float), defaultdict(int)
    for evt in events:
        if on_device:
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = evt.self_device_time_total
        else:
            us = evt.self_cpu_time_total
        if us > 0:
            totals[evt.key] += us
            counts[evt.key] += evt.count
    groups = defaultdict(float)
    for key, us in totals.items():
        groups[kernel_group(key)] += us
    busy = sum(totals.values())
    lines = [f"{us / steps:9.1f} us/step  x{counts[key]:5d}  {key[:100]}"
             for key, us in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]
    lines.append("by group:")
    lines += [f"{us / steps:9.1f} us/step  {us / busy:6.1%}  {group}" if busy else group
              for group, us in sorted(groups.items(), key=lambda kv: -kv[1])]
    return lines, (busy if on_device else 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=["train", "eval", "cocoop-train", "cocoop-eval"],
                    default="train")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--n-cls", type=int, default=51)
    ap.add_argument("--k", type=int, default=24)
    ap.add_argument("--backbone", default="ViT-B/16")
    ap.add_argument("--trace-dir", default="", help="write a Chrome trace of the window here")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = {"train": 4, "cocoop-train": 8}.get(args.phase, 100)

    from torch.profiler import ProfilerActivity, profile

    from ..device import resolve_device

    device = resolve_device("cpu" if os.environ.get("RPO_TPU_FORCE_CPU") else None)
    on_device = device.type == "cuda"
    sync = torch.cuda.synchronize if on_device else (lambda: None)
    run_one = build(args, device)
    run_one()  # build the kernels, capture the graph
    run_one()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_device else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = None
        for _ in range(args.steps):
            out = run_one()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    if not bool(torch.isfinite(out.float()).all()):
        print(f"profile_step: the {args.phase} step's output is not finite", file=sys.stderr)
        return 1
    lines, busy_us = rank(prof.key_averages(), args.steps, args.top, on_device)
    where = torch.cuda.get_device_name(device) if on_device else "cpu"
    print(f"{'device' if on_device else 'CPU'} ops by total time ({args.phase}, {args.steps} "
          f"steps, batch {args.batch}, {args.backbone}, on {where}):")
    print("\n".join(lines))
    if on_device and busy_us:
        print(f"window: wall {wall_us / args.steps / 1e3:.3f} ms a step, device busy "
              f"{busy_us / args.steps / 1e3:.3f} ms a step, idle share "
              f"{max(0.0, 1 - busy_us / wall_us):.1%}")
    else:
        print(f"window: wall {wall_us / args.steps / 1e3:.3f} ms a step on {where}; device busy "
              "and idle share not measured")
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, f"{args.phase}.json")
        prof.export_chrome_trace(path)
        print(f"trace: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
