"""What the multi-rank CPU tests' spawned ranks run.

The ranks start with the spawn method and import this module, not the
test file: it imports neither ``jax`` nor ``rpo_tpu`` (the parent holds
their results against the JAX package).  A test file spawns one world of
gloo ranks once for all its cases (``run_world``): trainer jobs through
``rpo_tpu_torch.tools.dryrun_multichip``'s ``build`` and ``execute``
(operations on global batches, each rank on its rows), and loader jobs
(``DataManager`` under the group: each rank's rows of every batch).
"""
import os
import random

import numpy as np
import torch

from rpo_tpu_torch.tools.dryrun_multichip import build, execute, spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def loader_batches(opts, epochs: int = 2) -> dict:
    """Every batch of two epochs of the port's DataManager (synthetic,
    RPO main.yaml, ``opts``) seeded as the CLI seeds: {(epoch, split):
    [batch dicts]}; under a process group each rank's rows."""
    from rpo_tpu_torch.data.manager import DataManager
    from rpo_tpu_torch.engine.config import get_cfg_default

    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(REPO, "configs/datasets/synthetic.yaml"))
    cfg.merge_from_file(os.path.join(REPO, "configs/trainers/RPO/main.yaml"))
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    random.seed(1)
    np.random.seed(1)
    dm = DataManager(cfg)
    return {(epoch, split): [dict(b) for b in getattr(dm, split)]
            for epoch in range(epochs) for split in ("train_loader_x", "test_loader")}


def _rank(rank: int, jobs, directory: str) -> None:
    # the lowest priority on the host: the JAX package's tests run XLA's
    # in-process collectives, whose threads must all be scheduled within a
    # timeout
    os.nice(19)
    for name, kind, spec, ops in jobs:
        if kind == "trainer":
            out = execute(build(spec, "cpu"), ops)
        else:
            out = loader_batches(spec)
        torch.save(out, os.path.join(directory, f"{name}-{rank}.pt"))


def run_world(world: int, jobs, directory) -> dict:
    """Every job, (name, "trainer" | "loader", spec, ops), on ``world``
    gloo ranks spawned once, their FileStore and results under
    ``directory``; {name: [each rank's results]}."""
    directory = str(directory)
    spawn_world(world, _rank, (jobs, directory), directory)
    return {name: [torch.load(os.path.join(directory, f"{name}-{r}.pt"), weights_only=False)
                   for r in range(world)] for name, _, _, _ in jobs}
