"""Data parallelism over CUDA ranks: one process a card.

Port of ``rpo_tpu/parallel/dp.py``.  The JAX package has one controller
that sees every device and shards a global batch over a ``Mesh``; the
port takes PyTorch's idiom, one process a card (``torchrun``), and keeps
JAX's arithmetic:

- every rank runs the same seeded sampler and draws every row's
  augmentation plan, then decodes only its own rows ``local_rows`` of
  the batch padded to ``pad_multiple(B, dp)`` (``data/loader.py``), so
  the ranks' rows concatenate to the JAX package's global batch;
- the frozen backbone and the prompts are whole on every rank;
- a train step takes the gradient of its rows' ``sum(nll * mask)`` and
  all-reduces the gradients, the nll sum, the correct count and
  ``sum(mask)`` in one collective (``reduce_step``, the algebra of JAX's
  ``train_step_spmd``), divides by the global mask total, and every rank
  makes the same SGD update.  A rank whose rows are all padding adds
  zeros;
- an eval step runs on the rank's rows and all-gathers the logits back
  to the global batch (``gather_rows``).

A ``Mesh`` is this process's place in the group: rank, world size,
backend and, for dp x tp (``tp.make_mesh_2d``), the ``data`` and ``model``
subgroups.  Rank r is row r // tp and column r % tp of JAX's (dp, tp)
device grid.  NCCL runs on cards; gloo, on the CPU or for two ranks on
one card, runs the collectives of a CUDA tensor through the host.

The wrappers named after JAX's step compilers take a GLOBAL batch, as
JAX's do, and hand the step this rank's rows: the tests and
``tools/dryrun_multichip.py`` drive them.  The trainer's own steps take
this rank's rows, which its loader makes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp x tp) grid of ranks.  ``data_group``
    joins the ranks of one column (the same model shard, different
    rows); ``model_group`` the ranks of one row (None without tensor
    parallelism).  A group None is the whole world."""
    rank: int
    world: int
    backend: str
    dp: int
    tp: int = 1
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.tp}

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives (NCCL's;
        gloo's run on the host)."""
        return self.backend == "nccl"


_MESHES: dict = {}  # (dp, tp) -> (the world group it was made in, Mesh)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def grid_mesh(dp: int, tp: int) -> Mesh:
    """The (dp x tp) mesh of the initialised process group, its subgroups
    made once: every rank makes every subgroup, in the same order, as
    ``dist.new_group`` asks."""
    if not is_initialized():
        raise RuntimeError("no process group: launch with torchrun (or init_process_group)")
    world = dist.get_world_size()
    if dp * tp != world:
        raise ValueError(f"dp*tp = {dp}*{tp} != {world} devices")
    cached = _MESHES.get((dp, tp))
    if cached is not None and cached[0] is dist.group.WORLD:
        return cached[1]
    rank = dist.get_rank()
    data_group = model_group = None
    if tp > 1:
        for d in range(dp):
            g = dist.new_group([d * tp + m for m in range(tp)])
            if rank // tp == d:
                model_group = g
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)])
            if rank % tp == m:
                data_group = g
    mesh = Mesh(rank, world, dist.get_backend(), dp, tp, data_group, model_group)
    if mesh.backend == "nccl":
        # NCCL makes its communicators at their first collective: make them
        # here, eagerly, so that no capture of a step is the first
        probe = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
        for group in [g for g in (None, data_group, model_group) if g is not None] + [None]:
            dist.all_reduce(probe, group=group)
        torch.cuda.synchronize()
    _MESHES[(dp, tp)] = (dist.group.WORLD, mesh)
    return mesh


def make_mesh() -> Mesh:
    """The 1-D data mesh over every rank of the process group."""
    return grid_mesh(world_size(), 1)


def is_main() -> bool:
    """Rank 0, or a lone process: the one that writes files."""
    return not is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Every rank waits here (nothing without a process group)."""
    if is_initialized():
        dist.barrier()


def pad_multiple(batch_size: int, n_devices: int) -> int:
    """Smallest batch size >= batch_size divisible by n_devices (padded
    rows are masked out of the loss and metrics)."""
    return ((batch_size + n_devices - 1) // n_devices) * n_devices


def local_rows(n_rows: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """This rank's rows [a, b) of a batch of ``n_rows`` (a multiple of the
    data axis, as the loader pads it)."""
    if mesh is None:
        return 0, n_rows
    if n_rows % mesh.dp:
        raise ValueError(f"a batch of {n_rows} rows does not divide over {mesh.dp} data ranks; "
                         "pad it to pad_multiple(B, dp)")
    per = n_rows // mesh.dp
    return mesh.data_rank * per, (mesh.data_rank + 1) * per


def rows_of(images, a: int, b: int):
    """Rows [a, b) of an image batch: an array, or the device-resize
    {img, box, flip} dict."""
    if isinstance(images, dict):
        return {key: t[a:b] for key, t in images.items()}
    return images[a:b]


def _host_staged(t: torch.Tensor, mesh: Mesh) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (the data group by default), in
    place; returns ``t``."""
    group = mesh.data_group if group is None else group
    if _host_staged(t, mesh):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Each data rank's rows of ``t`` (the same count on every rank),
    concatenated in rank order: the global batch's.  A one-rank data group
    gathers through its collective too, so that a one-rank run takes the
    path of a larger group."""
    src = t.contiguous().cpu() if _host_staged(t, mesh) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.dp)]
    dist.all_gather(parts, src, group=mesh.data_group)
    return torch.cat(parts).to(t.device)


def reduce_step(mesh: Mesh, grads: Sequence[torch.Tensor], nll_sum: torch.Tensor,
                correct: torch.Tensor, mask_sum: torch.Tensor):
    """``train_step_spmd``'s psums as one all-reduce over the data group:
    the rank's gradients of ``sum(nll * mask)``, its nll sum, correct
    count and ``sum(mask)`` flattened into one float32 buffer, summed, and
    divided by the global mask total.  Returns (loss, grads, acc): every
    rank the same."""
    flat = [g.reshape(-1).float() for g in grads]
    scalars = torch.stack([nll_sum.float(), correct.float(), mask_sum.float()])
    buf = torch.cat(flat + [scalars])
    all_reduce_sum(buf, mesh)
    nll, cor, denom = buf[-3], buf[-2], buf[-1]
    out: List[torch.Tensor] = []
    at = 0
    for g in grads:
        n = g.numel()
        out.append((buf[at:at + n] / denom).view(g.shape).to(g.dtype))
        at += n
    return nll / denom, out, cor / denom


def shard_eval_step_local(eval_step: Callable, mesh: Mesh) -> Callable:
    """``eval_step(params, frozen, text_f, images)`` on this rank's rows,
    its logits gathered back to the global batch: evaluation needs no
    other collective, every logit row depends on its own image only, so
    the kernels run on each rank's rows whole."""

    def step(params, frozen, text_f, images):
        return gather_rows(eval_step(params, frozen, text_f, images), mesh)

    return step


def shard_train_step(step: Callable, mesh: Mesh) -> Callable:
    """A trainer's one-rank-rows step, ``step(images, labels, mask, *rest)``
    (``train_step``, ``loss_and_grads``), called on a GLOBAL batch: this
    rank's rows go to the step (the batch padded to the data axis first,
    padded rows masked out).  It takes the places of JAX's
    ``shard_train_step`` and ``shard_train_step_spmd`` both: the port's
    step is always the per-rank algebra."""

    def run(images, labels, mask, *rest, **kw):
        n = len(labels)
        total = pad_multiple(n, mesh.dp)
        if total != n:
            images, labels, mask = pad_batch(images, labels, mask, total)
        a, b = local_rows(total, mesh)
        return step(rows_of(images, a, b), labels[a:b], mask[a:b], *rest, **kw)

    return run


def shard_multi_step(multi_step: Callable, mesh: Mesh) -> Callable:
    """A grouped step on a list of GLOBAL batches (TRAIN.STEPS_PER_DISPATCH,
    each a {"img", "label", "mask"} dict, with "box", "flip" under
    INPUT.DEVICE_RESIZE): each batch's rows of this rank go to
    ``multi_step``, the batch dim split as ``P(None, "data")`` does (JAX's
    ``shard_multi_step`` and ``shard_multi_step_spmd``)."""

    def run(batches, *rest, **kw):
        mine = []
        for batch in batches:
            n = len(batch["label"])
            a, b = local_rows(n, mesh)
            mine.append({key: (value[a:b] if key != "n" else value)
                         for key, value in batch.items()})
        return multi_step(mine, *rest, **kw)

    return run


def pad_batch(images, labels, mask, total: int):
    """A batch zero-padded to ``total`` rows, the padded rows masked out
    (the loader's padding: zero images, label 0, full-frame boxes)."""
    n = len(labels)

    def pad(a, fill=None):
        a = np.asarray(a)
        out = np.zeros((total,) + a.shape[1:], a.dtype)
        out[:n] = a
        if fill is not None:
            out[n:] = fill
        return out

    if isinstance(images, dict):
        side = np.asarray(images["img"]).shape[1]
        images = {"img": pad(images["img"]), "flip": pad(images["flip"]),
                  "box": pad(images["box"], np.asarray([0, 0, side, side], np.int32))}
    else:
        images = pad(images)
    return images, pad(labels), pad(mask)
