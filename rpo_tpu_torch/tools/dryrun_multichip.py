"""The port's multi-rank paths held to one process, at TINY.

Port of ``dryrun_multichip`` (``__graft_entry__.py``): ``n`` ranks of a
gloo process group (on the CPU, or sharing the card with ``--device
cuda``), each running the trainer's own steps on its rows of the same
global batches, against a single-process replay of the same steps
(JAX's tolerances: float32 rtol 1e-5 / atol 1e-6, logits 1e-5, bfloat16
1e-2; bf16 logits and gradients as ``BF16_LOGITS_ATOL`` and ``GRAD_REL``
say why):

- in float32 and bfloat16, on a masked uneven batch (its last three rows
  padding): one data-parallel train step (loss, accuracy, prompts; the
  momentum, a gradient, within 1e-4 of its largest entry), a grouped
  dispatch of two batches, and the eval step's gathered logits;
- the device-augment train batch (INPUT.DEVICE_RESIZE: sources, boxes
  and flips);
- TRAIN.MICROBATCH 1 under the data mesh (float32);
- with ``n`` even, dp x tp at tp 2 on TINY_W128 (whose towers have two
  heads to split): the eval logits and a train step.

    python -m rpo_tpu_torch.tools.dryrun_multichip [--device cpu|cuda] N

prints one JSON line and exits 0 when every check holds.  ``spawn_world``
and ``execute`` are the harness the CPU tests drive too: ``execute`` runs
a list of operations on GLOBAL batches through a trainer, which under a
mesh gets this rank's rows of each.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

CLASSNAMES = [f"class {i}" for i in range(8)]
K = 4
TOL = {"fp32": dict(rtol=1e-5, atol=1e-6), "fp16": dict(rtol=1e-2, atol=1e-2)}
# fp32 logits: JAX's eval tolerance (tests/test_data_parallel.py)
LOGITS_TOL = {"fp32": dict(rtol=1e-5, atol=1e-5)}
# A rank's rows are a smaller batch than one process's: the BLAS kernels
# block the products differently, so a bf16 rounding flips here and there
# and the flips compound through the towers.  bf16 logits are held to the
# eval gate of PERF.md section 2 (max abs err 5e-2), and a gradient (the
# first step's momentum), a sum over the rows in the ranks' order, to
# GRAD_REL of its largest entry (fp32 1e-4 plus atol; bf16 0.1, the bound
# of tests/test_torch_port_rpo_train.py)
BF16_LOGITS_ATOL = 5e-2
GRAD_REL = {"fp32": 1e-4, "fp16": 0.1}
LR = 0.01


# ---- the harness ------------------------------------------------------------

def _entry(rank: int, world: int, store_path: str, device: str, fn: Callable, args) -> None:
    """A spawned rank: the gloo group over a FileStore, ``fn(rank, *args)``
    inside it."""
    import torch.distributed as dist

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    if device.startswith("cuda"):
        torch.cuda.set_device(0)  # the ranks share the one card
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        fn(rank, *args)
        # no rank leaves (closing its connections) while another still
        # reads from it
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_world(world: int, fn: Callable, args: Sequence, directory: str,
                device: str = "cpu") -> None:
    """``fn(rank, *args)`` in ``world`` spawned processes joined in a gloo
    group through a FileStore under ``directory`` (no TCP port: several
    such worlds may run on one host at once)."""
    import torch.multiprocessing as mp

    store = os.path.join(directory, f"store-{os.getpid()}-{time.monotonic_ns()}")
    mp.spawn(_entry, args=(world, store, device, fn, tuple(args)), nprocs=world, join=True)


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):  # a copy: the trainer updates its tensors in place
        return t.detach().float().cpu().numpy().copy()
    return t


def build(spec: dict, device: str):
    """A trainer from ``spec``: "method" (a registered name: RPO, CoOp,
    CoCoOp, LP, ZeroshotCLIP, ZeroshotCLIP2), "arch", "prec", "clip" (a
    tree of CPU tensors or numpy arrays), "prompts" (the trainable state to
    start from) and "kwargs" (the constructor's)."""
    from .. import methods  # noqa: F401  registers the trainers
    from ..engine.registry import TRAINER_REGISTRY
    from ..models.clip.bridge import params_from_numpy

    clip = params_from_numpy(_np(spec["clip"]), device, dtype=spec.get("clip_dtype"))
    cls = TRAINER_REGISTRY.get(spec["method"])
    extra = {"K": spec.get("K", K)} if spec["method"] == "RPO" else {}
    trainer = cls(spec.get("classnames", CLASSNAMES), backbone=spec["arch"], prec=spec["prec"],
                  device=device, clip_params=clip, seed=1, **extra, **spec.get("kwargs", {}))
    if spec.get("prompts") is not None:
        trainer.set_ckpt_state(trainer.model_name, _np(spec["prompts"]))
    return trainer


def execute(trainer, ops: Sequence[tuple]) -> List[dict]:
    """Each operation on GLOBAL batches, this rank's rows of them under a
    mesh; a result dict each, numpy:

    - ("step", images, labels, mask, lr): one train step -> loss, acc,
      params, momentum;
    - ("group", [batch dicts], lr): the grouped dispatch -> losses, params;
    - ("grads", images, labels, mask): loss_and_grads -> loss, grads;
    - ("eval", images): the eval step's (gathered) logits;
    - ("reset", prompts): the trainable state and a fresh optimizer."""
    from ..parallel import dp, tp

    mesh = trainer.mesh
    tensor_parallel = mesh is not None and mesh.tp > 1
    shard_step = tp.shard_train_step_tp if tensor_parallel else dp.shard_train_step
    shard_multi = tp.shard_multi_step_tp if tensor_parallel else dp.shard_multi_step
    out = []
    for op in ops:
        kind = op[0]
        if kind == "step":
            step = trainer.train_step if mesh is None else shard_step(trainer.train_step, mesh)
            loss, acc = step(*op[1:4], op[4])
            out.append({"loss": float(loss), "acc": float(acc), "params": _np(trainer.params),
                        "momentum": _np(trainer.get_optim_state(trainer.model_name))})
        elif kind == "group":
            trainer.current_lr = op[2]
            run = trainer.forward_backward_multi if mesh is None else shard_multi(
                trainer.forward_backward_multi, mesh)
            summaries = run(op[1])
            out.append({"losses": [float(s["loss"]) for s in summaries],
                        "params": _np(trainer.params)})
        elif kind == "grads":
            run = trainer.loss_and_grads if mesh is None else shard_step(
                trainer.loss_and_grads, mesh)
            loss, _, grads = run(*op[1:4])
            out.append({"loss": float(loss), "grads": _np(grads)})
        elif kind == "eval":
            images = op[1]
            a, b = dp.local_rows(len(images), mesh)
            out.append({"logits": _np(trainer.eval_step(images[a:b]))})
        elif kind == "reset":
            trainer.set_ckpt_state(trainer.model_name, _np(op[1]))
            out.append({})
        else:
            raise ValueError(f"unknown operation {kind!r}")
    return out


def _rank_job(rank: int, jobs, directory: str, device: str) -> None:
    """A rank's jobs: (name, spec, ops) each, its results saved to
    ``<directory>/<name>-<rank>.pt``."""
    for name, spec, ops in jobs:
        trainer = build(spec, device)
        torch.save(execute(trainer, ops), os.path.join(directory, f"{name}-{rank}.pt"))
        del trainer


def run_jobs(world: int, jobs, directory: str, device: str = "cpu") -> dict:
    """Every job on ``world`` ranks; {name: [each rank's results]}."""
    spawn_world(world, _rank_job, (jobs, directory, device), directory, device)
    return {name: [torch.load(os.path.join(directory, f"{name}-{r}.pt"), weights_only=False)
                   for r in range(world)] for name, _, _ in jobs}


# ---- the checks ---------------------------------------------------------------

def _batch(rng, B: int, size: int, n_pad: int, n_cls: int = len(CLASSNAMES)):
    images = rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8)
    labels = rng.randint(0, n_cls, B).astype(np.int64)
    labels[B - n_pad:] = n_cls - 1  # padding rows carry any label
    mask = (np.arange(B) < B - n_pad).astype(np.float32)
    return images, labels, mask


def _aug_batch(rng, B: int, n_pad: int):
    _, labels, mask = _batch(rng, B, 16, n_pad)
    images = {"img": rng.randint(0, 256, (B, 16, 16, 3)).astype(np.uint8),
              "box": np.concatenate([rng.randint(0, 4, (B, 2)), rng.randint(8, 13, (B, 2))],
                                    axis=1).astype(np.int32),
              "flip": rng.randint(0, 2, B).astype(np.int32)}
    return images, labels, mask


def plan(n: int) -> List[tuple]:
    """The jobs of ``dryrun_multichip(n)``: (name, spec, ops)."""
    from ..models.clip.model import ARCHS, init_clip

    rng = np.random.RandomState(0)
    B = 2 * n
    n_pad = min(3, B - 1)
    clip = _np(init_clip(torch.Generator().manual_seed(0), ARCHS["TINY"]))
    jobs = []
    for prec in ("fp32", "fp16"):
        spec = {"method": "RPO", "arch": "TINY", "prec": prec, "clip": clip}
        images, labels, mask = _batch(rng, B, 32, n_pad)
        group = [dict(zip(("img", "label", "mask"), _batch(rng, B, 32, n_pad)))
                 for _ in range(2)]
        jobs.append((f"dp-{prec}", spec, [
            ("step", images, labels, mask, LR), ("group", group, LR), ("eval", images)]))
    aug = _aug_batch(rng, B, n_pad)
    jobs.append(("device-augment", {"method": "RPO", "arch": "TINY", "prec": "fp32",
                                    "clip": clip, "kwargs": {"device_resize": 16}},
                 [("step", *aug, LR)]))
    jobs.append(("microbatch", {"method": "RPO", "arch": "TINY", "prec": "fp32", "clip": clip,
                                "kwargs": {"microbatch": 1}},
                 [("step", *_batch(rng, B, 32, n_pad), LR)]))
    if n >= 2 and n % 2 == 0:
        clip128 = _np(init_clip(torch.Generator().manual_seed(0), ARCHS["TINY_W128"]))
        Bt = 2 * (n // 2)
        images, labels, mask = _batch(rng, Bt, 32, 1)
        jobs.append(("tp", {"method": "RPO", "arch": "TINY_W128", "prec": "fp32",
                            "clip": clip128, "kwargs": {"tensor_parallel": 2}},
                     [("eval", images), ("step", images, labels, mask, LR)]))
    return jobs


def _compare(name: str, got: List[dict], want: List[dict], prec: str) -> List[str]:
    """Every number of ``got`` (a rank's results) against ``want``, at the
    bounds of ``prec`` (TOL, LOGITS_TOL, GRAD_REL)."""
    faults = []
    tol = TOL[prec]

    def close(what, a, b, kind="value"):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = np.abs(a - b).max()
        if kind == "gradient":  # a sum over the batch in another order
            big = np.abs(b).max()
            if err > tol["atol"] * (prec == "fp32") + GRAD_REL[prec] * big:
                faults.append(f"{name} {what}: max err {err:.3e} at max|g| {big:.3e}")
            return
        if kind == "logits" and prec != "fp32":
            if not err <= BF16_LOGITS_ATOL:
                faults.append(f"{name} {what}: max abs err {err:.3e} > {BF16_LOGITS_ATOL}")
            return
        try:
            np.testing.assert_allclose(a, b, **(LOGITS_TOL[prec] if kind == "logits" else tol))
        except AssertionError as exc:
            lines = str(exc).strip().splitlines()
            faults.append(f"{name} {what}: " + "; ".join(
                ln.strip() for ln in lines if "Max" in ln or "Mismatched" in ln))

    for i, (g, w) in enumerate(zip(got, want)):
        for key, value in w.items():
            if isinstance(value, dict):
                for leaf in value:
                    close(f"op {i} {key}.{leaf}", g[key][leaf], value[leaf],
                          "gradient" if key in ("momentum", "grads") else "value")
            else:
                close(f"op {i} {key}", g[key], value, "logits" if key == "logits" else "value")
    return faults


def dryrun_multichip(n: int, device: str = "cpu") -> dict:
    """Run the jobs on ``n`` ranks and on one process; the JSON-able
    summary (``ok`` False lists the faults)."""
    if n < 1:
        raise ValueError(f"n must be at least 1, got {n}")
    t0 = time.perf_counter()
    jobs = plan(n)
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as tmp:
        ranked = run_jobs(n, jobs, tmp, device)
    faults, summary = [], {}
    for name, spec, ops in jobs:
        single = execute(build({**spec, "kwargs": {k: v for k, v in spec.get("kwargs", {}).items()
                                                   if k != "tensor_parallel"}}, device), ops)
        for r, got in enumerate(ranked[name]):
            faults += _compare(f"{name} rank {r}", got, single, spec["prec"])
        step = next(i for i, op in enumerate(ops) if op[0] == "step")
        summary[name] = {"loss": single[step]["loss"], "ranks": n,
                         "rank0_loss": ranked[name][0][step]["loss"]}
    return {"dryrun_multichip": n, "device": device, "ok": not faults, "faults": faults,
            "checks": summary, "seconds": round(time.perf_counter() - t0, 1)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                   help="where each rank runs (cuda: every rank on the one card)")
    args = p.parse_args(argv)
    out = dryrun_multichip(args.n, args.device)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
