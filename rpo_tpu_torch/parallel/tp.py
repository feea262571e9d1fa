"""Tensor parallelism over a (data x model) grid of CUDA ranks.

Port of ``rpo_tpu/parallel/tp.py``.  The JAX package shards two
activation families over the ``model`` mesh axis and lets GSPMD derive
the collectives; the port writes them by hand, in Megatron's form, with
JAX's numbers:

- attention: each rank of a ``model`` group owns H/tp heads, i.e. the
  matching columns of q, k and v and rows of the out-projection
  (``shard_params``, sliced once from the whole weights);
- the MLP: each owns 4W/tp columns of fc and the matching rows of proj;
- a row-parallel product (out-projection, proj) sums its float32 partial
  products over the group (``row_parallel``), casts once to the
  activation dtype and adds the bias once, after the cast: JAX's einsum
  with ``preferred_element_type=float32``, then ``astype``, then ``+ b``;
- under grad, a column-parallel product's input sums its gradient over
  the group on the way back (``column_input``), so the gradients of the
  whole, replicated prompts are whole on every rank.

Shapes that do not divide stay whole on every rank, as JAX's
``shard_heads`` and ``shard_hidden`` leave them.  Inside ``tensor_parallel_scope``
a block knows it holds a slice from its weights' shapes (q/k/v narrower
than 3D, fc narrower than 4D); the scope gives the group it sums over.
Under tp a whole-layer kernel (the fused text layer, the fused rect
halves) cannot be split without a reduction in its middle, so the tp
path runs the unfused layers, whose attention is the rect and masked
kernels on the rank's heads, where JAX's scope turns its Pallas path off.

The batch shards over the ``data`` groups as in ``dp.py``.  Without a
process group one process drives one card: TRAIN.TENSOR_PARALLEL is then
validated against the visible cards and runs on one.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

from . import dp as dpmod

_TLS = threading.local()
_WARNED_SINGLE_DEVICE: set = set()


def device_count() -> int:
    """The devices a run splits over: the process group's ranks, else
    the visible cards (at least 1: the CPU, or one card)."""
    if dpmod.is_initialized():
        return dpmod.world_size()
    return max(1, torch.cuda.device_count())


def resolve_tp(cfg) -> int:
    """The model-axis size from ``cfg.TRAIN.TENSOR_PARALLEL``, validated
    against ``device_count()``.  0 = tensor parallelism off (tp 0 or 1).
    A request that cannot be met is never silent: a count the devices do
    not divide by raises; with one device it warns once for each
    requested value (a long-lived sweep warns for each distinct config)
    and the run goes on on one device."""
    tp = int(getattr(cfg.TRAIN, "TENSOR_PARALLEL", 0) or 0)
    n = device_count()
    if tp < 2:
        return 0
    if n < 2:
        if tp not in _WARNED_SINGLE_DEVICE:
            _WARNED_SINGLE_DEVICE.add(tp)
            print(
                f"(!) TRAIN.TENSOR_PARALLEL={tp} requested but only {n} "
                "device is visible — tensor parallelism disabled, running "
                "single-device"
            )
        return 0
    if n % tp != 0:
        raise ValueError(
            f"TRAIN.TENSOR_PARALLEL={tp} does not divide the "
            f"{n} visible devices"
        )
    return tp


def data_axis_size(cfg) -> int:
    """Devices along the batch-sharded axis: device_count / tp.  Loader
    batch padding must divide by THIS, not the raw device count."""
    tp = resolve_tp(cfg)
    return device_count() // tp if tp else device_count()


def factor(n: int, dp: Optional[int] = None, tp: Optional[int] = None):
    """(dp, tp) for ``n`` devices, either factor given (JAX's
    ``make_mesh_2d`` factoring and error)."""
    if dp is None and tp is None:
        dp, tp = 1, n
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    return dp, tp


def make_mesh_2d(dp: Optional[int] = None, tp: Optional[int] = None) -> dpmod.Mesh:
    """The (dp x tp) mesh over the process group's ranks; give either
    factor and the other is inferred.  Rank r is row r // tp, column
    r % tp: adjacent ranks (one host's cards) share a model group."""
    return dpmod.grid_mesh(*factor(dpmod.world_size(), dp, tp))


def setup_tp_mesh(cfg):
    """Resolve ``TRAIN.TENSOR_PARALLEL`` over the process group and build
    the dp x tp mesh, printing JAX's mesh line with the backend for
    "ICI".  Returns ``(mesh, dp, tp)``, or None when tensor parallelism is
    off or no group is up."""
    if not dpmod.is_initialized():
        return None
    tp = resolve_tp(cfg)
    if not tp:
        return None
    mesh = make_mesh_2d(tp=tp)
    print(f"Multiple devices detected (n={mesh.world}), tensor-parallel "
          f"mesh over {mesh.backend} (dp={mesh.dp} x tp={mesh.tp})")
    return mesh, mesh.dp, mesh.tp


def current_tp_scope() -> Optional[dpmod.Mesh]:
    """The mesh when running under ``tensor_parallel_scope`` (this thread),
    else None."""
    return getattr(_TLS, "mesh", None)


@contextlib.contextmanager
def tensor_parallel_scope(mesh: Optional[dpmod.Mesh]):
    """The sliced blocks run inside sum over ``mesh.model_group``.  A mesh
    None (or without a model axis) is no scope."""
    prev = getattr(_TLS, "mesh", None)
    _TLS.mesh = mesh if mesh is not None and mesh.tp > 1 else None
    try:
        yield
    finally:
        _TLS.mesh = prev


# ---- the sliced weights -----------------------------------------------------

def _slice_block_stack(blocks: dict, heads: int, tp: int, rank: int) -> dict:
    """A stacked block pytree with this rank's heads and hidden columns:
    q/k/v columns and out-projection rows of heads [rank*H/tp, ...) when
    tp divides the heads; fc columns and proj rows of the rank's 4W/tp
    when tp divides 4W.  Biases of the row-parallel products stay whole
    (added once, after the sum)."""
    out = dict(blocks)
    out.pop("kernel", None)  # a whole layer's kernel layout: unused under tp
    attn, mlp = blocks["attn"], blocks["mlp"]
    D = attn["qkv_w"].shape[-2]
    if heads % tp == 0:
        w = D // tp
        cols = torch.cat([torch.arange(i * D + rank * w, i * D + (rank + 1) * w)
                          for i in range(3)]).to(attn["qkv_w"].device)
        rows = slice(rank * w, (rank + 1) * w)
        out["attn"] = {"qkv_w": attn["qkv_w"].index_select(-1, cols).contiguous(),
                       "qkv_b": attn["qkv_b"].index_select(-1, cols).contiguous(),
                       "out_w": attn["out_w"][:, rows].contiguous(),
                       "out_b": attn["out_b"]}
    hidden = mlp["fc_w"].shape[-1]
    if hidden % tp == 0:
        h = hidden // tp
        part = slice(rank * h, (rank + 1) * h)
        out["mlp"] = {"fc_w": mlp["fc_w"][..., part].contiguous(),
                      "fc_b": mlp["fc_b"][..., part].contiguous(),
                      "proj_w": mlp["proj_w"][:, part].contiguous(),
                      "proj_b": mlp["proj_b"]}
    return out


def shard_params(clip_params: dict, cfg, mesh: Optional[dpmod.Mesh]) -> dict:
    """The CLIP params with the transformer blocks of both towers sliced
    for this rank of ``mesh``'s model group (the whole params without a
    model axis).  A ModifiedResNet's image tower stays whole."""
    if mesh is None or mesh.tp < 2:
        return clip_params
    out = dict(clip_params)
    out["text"] = {**clip_params["text"], "blocks": _slice_block_stack(
        clip_params["text"]["blocks"], cfg.text_heads, mesh.tp, mesh.model_rank)}
    if cfg.is_vit:
        out["visual"] = {**clip_params["visual"], "blocks": _slice_block_stack(
            clip_params["visual"]["blocks"], cfg.vision_heads, mesh.tp, mesh.model_rank)}
    return out


def attention_sliced(qkv_w: torch.Tensor) -> bool:
    """Whether a block's (D, 3D') q/k/v weight holds a slice of the heads:
    inside the scope only, where every block comes from ``shard_params``."""
    return current_tp_scope() is not None and qkv_w.shape[-1] < 3 * qkv_w.shape[-2]


def out_proj_sliced(out_w: torch.Tensor) -> bool:
    """Whether a block's (D', D) out-projection holds a slice of the rows."""
    return current_tp_scope() is not None and out_w.shape[-2] < out_w.shape[-1]


def mlp_sliced(fc_w: torch.Tensor) -> bool:
    """Whether a block's (D, 4D') fc weight holds a slice of the hidden
    (CLIP's MLP is 4x in both towers)."""
    return current_tp_scope() is not None and fc_w.shape[-1] < 4 * fc_w.shape[-2]


def _scope_mesh() -> dpmod.Mesh:
    mesh = current_tp_scope()
    if mesh is None:
        raise RuntimeError("a block sliced for tensor parallelism ran outside "
                           "tensor_parallel_scope: its partial products have no group to sum over")
    return mesh


class _SumGradOverModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (in
    float32) on the way back: the input of a column-parallel product."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.float().contiguous()
        dpmod.all_reduce_sum(total, ctx.mesh, group=ctx.mesh.model_group)
        return total.to(grad.dtype), None


class _SumOverModel(torch.autograd.Function):
    """The sum over the model group forward; identity backward (the sum is
    replicated, each rank's partial gets the whole gradient)."""

    @staticmethod
    def forward(ctx, partial, mesh):
        total = partial.clone()
        dpmod.all_reduce_sum(total, mesh, group=mesh.model_group)
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def column_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the input of a column-parallel product of a sliced block:
    under grad its gradient is summed over the model group."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _SumGradOverModel.apply(x, _scope_mesh())


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) with a float32 result.  On a card, bf16 or fp16
    operands multiply on the tensor cores and accumulate and write in
    float32 (``torch.mm``'s ``out_dtype``); elsewhere the float32 product
    of the operands, which is the same sum: a product of two bf16 values
    is exact in float32."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _PartialProduct(torch.autograd.Function):
    """``h @ w`` with a float32 result from operands in their own dtype:
    JAX's einsum with ``preferred_element_type=float32``.  Backward, each
    input's gradient is a float32-accumulated product cast to the input's
    dtype.  Where ``row_parallel`` casts the summed partial to ``h``'s own
    dtype, the incoming gradient holds values of that dtype, so it is cast
    to it exactly and multiplies on the tensor cores too."""

    @staticmethod
    def forward(ctx, h, w, out_dtype):
        ctx.save_for_backward(h, w)
        ctx.exact = out_dtype == h.dtype
        return _mm_f32(h.reshape(-1, h.shape[-1]), w).view(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        h, w = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        if ctx.exact:
            g = g.to(h.dtype)
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = _mm_f32(g, w.t()).to(h.dtype).view(h.shape)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(h.reshape(-1, h.shape[-1]).t(), g).to(w.dtype)
        return dh, dw, None


def row_parallel(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``h @ w`` of a row-parallel product (this rank's rows of ``w``):
    the float32 partial summed over the model group, cast to ``dtype``,
    then ``+ b`` once."""
    partial = _PartialProduct.apply(h, w, dtype)
    return _SumOverModel.apply(partial, _scope_mesh()).to(dtype) + b.to(dtype)


# ---- step wrappers (dp.py's signatures; batch over "data", model math over
# "model", state and backbone whole) -------------------------------------------

def shard_eval_step_tp(eval_step: Callable, mesh: dpmod.Mesh) -> Callable:
    """``eval_step(params, frozen, text_f, images)`` under dp x tp: this
    rank's data rows through the sliced towers, the logits gathered over
    the data group."""
    local = dpmod.shard_eval_step_local(eval_step, mesh)

    def step(params, frozen, text_f, images):
        with tensor_parallel_scope(mesh):
            return local(params, frozen, text_f, images)

    return step


def shard_train_step_tp(step: Callable, mesh: dpmod.Mesh) -> Callable:
    """A one-rank-rows step on a GLOBAL batch under dp x tp (the contract
    of ``dpmod.shard_train_step``)."""
    run = dpmod.shard_train_step(step, mesh)

    def scoped(*args, **kw):
        with tensor_parallel_scope(mesh):
            return run(*args, **kw)

    return scoped


def shard_multi_step_tp(multi_step: Callable, mesh: dpmod.Mesh) -> Callable:
    """A grouped step on GLOBAL batches under dp x tp (``dpmod.shard_multi_step``)."""
    run = dpmod.shard_multi_step(multi_step, mesh)

    def scoped(*args, **kw):
        with tensor_parallel_scope(mesh):
            return run(*args, **kw)

    return scoped
