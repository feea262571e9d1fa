"""Evaluation traffic: the loop of the engine's ``TrainerBase.test``.

Traffic keys: ``batch``, ``n_cls``, ``pool`` (host batches made in
set-up; the loop cycles through them).  Batches go through the port's
``engine.trainer.device_prefetch`` (pinned host memory, a non-blocking
copy, two batches ahead) to the trainer's ``model_inference_async``, with
at most three batches in flight; each batch's logits are drained to a
host numpy array.  A batch's latency runs from the moment its host array
is handed to the loop to the moment its logits are on the host.  The
window stops handing batches over after ``--seconds``, drains what is in
flight and ends there; its rate is every batch over all of its time.

Set-up runs ``WARM_BATCHES`` through the same loop (the task's text
features are made at the first, as ``test()`` makes them).  The check
compares the logits of ``CHECKED_BATCHES`` of the window's batches, drawn
from the seed, with the reference's for the same images.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque
from typing import Dict

import numpy as np
import torch

from .. import compare, inputs
from ..inputs import Phases
from ..methods.common import set_up
from ..reference import precision

WARM_BATCHES = 4
CHECKED_BATCHES = 4
TRACED_BATCHES = 8
IN_FLIGHT = 3
REFERENCE_ROWS = 50  # images a block of the reference


class Session:
    def __init__(self, cell):
        from rpo_tpu_torch.engine.trainer import device_prefetch

        self.prefetch = device_prefetch
        self.cell = cell
        cfg, tr, dev = cell.config, cell.traffic, cell.device
        self.phases = phases = Phases(cell.sync)
        program = set_up(cell, phases)
        self.sd, self.classnames, self.state = program.sd, program.classnames, program.state
        self.trainer, s_data = program.trainer, program.data_seed
        self.s_sample = program.sample_seed
        self.pool = inputs.image_pool(tr["pool"], tr["batch"], cfg["clip"]["image_resolution"],
                                      s_data, dev)
        phases("pool")
        self.next = 0
        self._loop(count=WARM_BATCHES)
        phases("warm batches")

    def _loop(self, count=None, deadline=None, tw=None) -> dict:
        pool, trainer, first = self.pool, self.trainer, self.next
        span = tw.span if tw is not None else (lambda name: contextlib.nullcontext())
        handed, latencies, logits_out = {}, [], []
        host = 0.0

        def feed():
            for i in itertools.count(first):
                if count is not None and i - first >= count:
                    return
                if deadline is not None and time.perf_counter() >= deadline:
                    return
                handed[i] = time.perf_counter()
                yield {"img": pool[i % len(pool)], "i": i}

        pending = deque()

        def drain():
            logits, i = pending.popleft()
            with span("drain"):
                out = logits.float().cpu().numpy()
            latencies.append(time.perf_counter() - handed.pop(i))
            logits_out.append((i % len(pool), out))

        batches = self.prefetch(feed(), self.cell.device, keys=("img",))
        while True:
            a = time.perf_counter()
            with span("prefetch put"):
                batch = next(batches, None)
            if batch is None:
                break
            with span("launch"):
                logits = trainer.model_inference_async(batch["img"])
            host += time.perf_counter() - a
            pending.append((logits, batch["i"]))
            if len(pending) >= IN_FLIGHT:
                drain()
        while pending:
            drain()
        self.next = first + len(latencies)
        return {"latencies": latencies, "logits": logits_out, "host_s": host}

    def window(self, seconds: float) -> dict:
        B = self.cell.traffic["batch"]
        t0 = time.perf_counter()
        out = self._loop(deadline=t0 + seconds)
        wall = time.perf_counter() - t0
        n = len(out["latencies"])
        failed = sum(1 for _, lg in out["logits"] if not np.isfinite(lg).all())
        chosen = inputs.pick(self.s_sample, list(range(n)), CHECKED_BATCHES)
        self.checked = [out["logits"][j] for j in chosen]
        p95 = float(np.percentile(np.asarray(out["latencies"]) * 1e3, 95)) if n else float("nan")
        return {"steps": n, "wall_s": wall, "host_s": out["host_s"], "failed": failed,
                "metrics": {"eval_images_per_s": n * B / wall, "eval_batch_ms_p95": p95}}

    def traced(self, tw) -> int:
        self._loop(count=TRACED_BATCHES, tw=tw)
        return TRACED_BATCHES

    def release(self) -> None:
        self.trainer = None
        self.cell.free()

    @torch.no_grad()
    def check(self, p) -> Dict[str, float]:
        cell, dev = self.cell, self.cell.device
        precision.no_tf32()
        ref = cell.method.reference(cell.config, inputs.as_float32(self.sd, dev), self.classnames)
        prog, want = [], []
        for idx, logits in self.checked:
            images = torch.from_numpy(self.pool[idx]).to(dev)
            want.append(torch.cat([ref.logits(self.state, images[i:i + REFERENCE_ROWS], p)
                                   for i in range(0, len(images), REFERENCE_ROWS)]).cpu().numpy())
            prog.append(logits)
        return compare.eval_numbers(np.concatenate(prog), np.concatenate(want))
