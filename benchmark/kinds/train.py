"""Training traffic: the engine's hook ``forward_backward`` back to back.

Traffic keys: ``batch``, ``n_cls``, ``lr``, ``pool`` (host batches made in
set-up; the loop cycles through them).  A batch is uint8 (B, H, W, 3)
images as the loader hands them over, uniform labels and mask 1.  Each
call is one replay of the trainer's captured step; the window ends with a
synchronise.

Set-up drives the trainer through its first ``CHECKED_STEPS`` steps on
the pool's first batches, by the window's own call, and keeps the losses,
the momentum after step 1 and the trainable state after the last; the
reference takes the same steps from the same state afterwards.  Then
``WARM_STEPS`` more replays, and the same object goes on into the window.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import compare, inputs
from ..inputs import Phases
from ..methods.common import set_up
from ..reference import precision
from ..reference.sgd import leaves, train_steps

CHECKED_STEPS = 3
WARM_STEPS = 5
TRACED_STEPS = 50


def _copy(tree) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in leaves(tree).items()}


class Session:
    def __init__(self, cell):
        self.cell = cell
        cfg, tr, dev = cell.config, cell.traffic, cell.device
        self.phases = phases = Phases(cell.sync)
        program = set_up(cell, phases)
        self.sd, self.classnames, self.state = program.sd, program.classnames, program.state
        self.trainer, s_data = program.trainer, program.data_seed
        self.trainer.current_lr = tr["lr"]
        B = tr["batch"]
        images = inputs.image_pool(tr["pool"], B, cfg["clip"]["image_resolution"], s_data, dev)
        labels = inputs.labels_pool(tr["pool"], B, tr["n_cls"], s_data)
        mask = np.ones(B, np.float32)
        self.pool = [{"img": images[i], "label": labels[i], "mask": mask}
                     for i in range(tr["pool"])]
        phases("pool")

        step = self.trainer.forward_backward
        p0 = _copy(self.trainer.params)
        losses = []
        for i in range(CHECKED_STEPS):
            losses.append(step(self.pool[i])["loss"])
            if i == 0:
                m1 = _copy(self.trainer.get_optim_state(cell.method.MODEL))
                phases("first step (graph capture)")
        p_end = _copy(self.trainer.params)
        for i in range(CHECKED_STEPS, CHECKED_STEPS + WARM_STEPS):
            step(self.pool[i % len(self.pool)])
        self.next = CHECKED_STEPS + WARM_STEPS
        phases("steps")
        wd = cfg["weight_decay"]
        self.prog = {"losses": [float(v) for v in losses],
                     "grad1": {k: m1[k] - wd * p0[k] for k in p0},
                     "update": {k: p_end[k] - p0[k] for k in p0}}

    def window(self, seconds: float) -> dict:
        step, pool, B = self.trainer.forward_backward, self.pool, self.cell.traffic["batch"]
        losses, host, i = [], 0.0, self.next
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            a = time.perf_counter()
            if a >= end:
                break
            losses.append(step(pool[i % len(pool)])["loss"])
            host += time.perf_counter() - a
            i += 1
        self.cell.sync()
        wall = time.perf_counter() - t0
        self.next = i
        steps = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
        return {"steps": steps, "wall_s": wall, "host_s": host, "failed": failed,
                "metrics": {"train_images_per_s": steps * B / wall}}

    def traced(self, tw) -> int:
        step, pool = self.trainer.forward_backward, self.pool
        for j in range(TRACED_STEPS):
            with tw.span("forward_backward"):
                step(pool[(self.next + j) % len(pool)])
        with tw.span("synchronize"):
            self.cell.sync()
        self.next += TRACED_STEPS
        return TRACED_STEPS

    def release(self) -> None:
        self.trainer = None
        self.cell.free()

    def check(self, p) -> Dict[str, float]:
        cell, cfg, dev = self.cell, self.cell.config, self.cell.device
        precision.no_tf32()
        ref = cell.method.reference(cfg, inputs.as_float32(self.sd, dev), self.classnames)
        batches = [(torch.as_tensor(b["img"]).to(dev), torch.as_tensor(b["label"]).to(dev))
                   for b in self.pool[:CHECKED_STEPS]]
        out = train_steps(lambda state, images: ref.logits(state, images, p), self.state,
                          batches, cell.traffic["lr"], cfg["momentum"], cfg["weight_decay"])
        start = leaves(self.state)
        ref_out = {"losses": out["losses"], "grad1": out["grad1"],
                   "update": {k: out["params"][k] - start[k] for k in start}}
        return compare.train_numbers(self.prog, ref_out)
