"""The two halves of a bias-free rect transformer layer on CUDA kernels:
the kernels, their plain versions and the block they compose.

Port of ``rpo_tpu/ops/fused_rect_layer.py``.  The block is
``layers.rect_residual_block`` (every row attends to the first ``n_kv``
rows only) with each residual half fused:

- ``fused_rect_attn_half(x, ln_1, attn, n_heads, n_kv)``: x +
  out_proj(rect_attend(LN1(x))), q for all L rows, k and v for the first
  ``n_kv`` rows only; four kernel launches a call (LN1, one GEMM for q and
  the gathered k/v rows, the attention, the out projection with the
  residual) through a (B * L, 4d) scratch; ``attn_launch_plan`` gives
  their grids and shared bytes;
- ``fused_mlp_half(x, ln_2, mlp)``: x + proj(QuickGELU(fc(LN2(x)))) over
  the flattened rows, three kernel launches a call (LN2, then fc and proj,
  two tensor-core GEMMs with their epilogues fused, through a (rows, 5d)
  scratch; ``mlp_launch_plan`` gives their grids and shared bytes);
- ``fused_rect_residual_block(x, params, n_heads, n_kv)``: both.

On a CUDA tensor each half launches its kernels in
``csrc/fused_rect_layer.cu`` or raises; on a CPU tensor it runs its plain
version (``*_reference``), the same math in plain PyTorch. There is no
fallback from a kernel to its plain version. ``attn_half_launches`` and
``mlp_half_launches`` count the calls that launched (an attention-half
call is four CUDA launches, an MLP-half call three). Both halves are
forward-only, as the TPU kernels are: the functions raise when grad is
enabled and an input requires it. The JAX switch ``RPO_TPU_FUSED_RECT``
has no counterpart: a caller passes the block function
(``rpo.rpo_logits``' ``vision_layer``). The weight matrices go to the
kernels in the fragment-major layout of
``fused_text_layer.with_kernel_layout``: a block that carries it (made
once by ``RPO.build_method``) hands it over, one without it is laid out at
each launch.  ``fused_rect_attn_half_staged`` is the attention half's plain
version taken through the kernels' launch order and scratch layout, for
the tests.

Numerics, in the order of the TPU bodies (``_attn_half_kernel``,
``_mlp_half_kernel``): LayerNorm in f32, two-pass, with the scale and bias
first cast to the activation dtype; every projection accumulated in f32,
rounded, then its bias added in the activation dtype (two roundings);
per-head f32 scores times dh^-1/2, softmax normalised before the cast; p .
v accumulated in f32 and rounded; residual adds in the activation dtype;
QuickGELU rounded after every op (1.702 is 1.703125 in bf16).  The kernels
take bf16 only; the plain versions also run f32 (for the CPU tests).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .fused_text_layer import (_kernel_matrices, _refuse_grad, attend, ln_f32, proj,
                               quick_gelu_rounded)
from .rect_attention import _MAX_SHARED, _shared_bytes, rect_attention_reference

attn_half_launches = 0  # attention-half calls on the kernels (4 launches each) since set to 0
mlp_half_launches = 0   # MLP-half calls on the kernels (3 launches each) since then

_HEAD_DIM = 64
_MAX_WIDTH = 768
_MAX_KV = 256
_ERR_SHARED_MEMORY = -3
# The halves' launch geometry, mirrored from csrc/fused_rect_layer.cu
# (kGemmRows, kGemmCols, kGemmK, kGemmStages, kGemmThreads, kPadBf16,
# kLnRows, kThreads), which names mlp_launch_plan and attn_launch_plan as
# its mirrors, and from csrc/attention_tc.cuh (kTcThreads, kWarps, kTile;
# the D = 64 score widths of d64_score_tiles; its tc_smem_bytes is
# rect_attention._shared_bytes)
_GEMM_ROWS = 128
_GEMM_COLS = 128
_GEMM_K = 64
_GEMM_STAGES = 3
_GEMM_THREADS = 256
_PAD_BF16 = 8
_LN_ROWS = 16
_LN_THREADS = 512
_TC_THREADS = 128
_TC_WARPS = 4
_TC_TILE = 16
_SCORE_TILES = (2, 5, 13, 16)
_ATTN_WEIGHTS = (("ln_1", "scale"), ("ln_1", "bias"), ("attn", "qkv_w"), ("attn", "qkv_b"),
                 ("attn", "out_w"), ("attn", "out_b"))
_MLP_WEIGHTS = (("ln_2", "scale"), ("ln_2", "bias"), ("mlp", "fc_w"), ("mlp", "fc_b"),
                ("mlp", "proj_w"), ("mlp", "proj_b"))
_ATTN_MATRICES = (("attn", "qkv_w"), ("attn", "out_w"))
_MLP_MATRICES = (("mlp", "fc_w"), ("mlp", "proj_w"))


def fused_rect_attn_half_reference(x: torch.Tensor, ln_1: dict, attn: dict, n_heads: int,
                                   n_kv: int, eps: float = 1e-5) -> torch.Tensor:
    """The attention kernel's math in plain PyTorch, in the activation
    dtype of x (B, L, d)."""
    B, L, d = x.shape
    dt = x.dtype
    dh = d // n_heads

    def heads(t):
        return t.view(B, -1, n_heads, dh).permute(0, 2, 1, 3)

    y = ln_f32(x.float(), ln_1, dt, eps).to(dt)
    w, b = attn["qkv_w"], attn["qkv_b"]
    q = heads(proj(y, w[:, :d], b[:d]))
    # k and v exist for the first n_kv rows only: the rest are never projected
    k, v = (heads(proj(y[:, :n_kv], w[:, i * d:(i + 1) * d], b[i * d:(i + 1) * d]))
            for i in (1, 2))
    o = attend(q, k, v)
    return x + proj(o.permute(0, 2, 1, 3).reshape(B, L, d), attn["out_w"], attn["out_b"])


def fused_rect_attn_half_staged(x: torch.Tensor, ln_1: dict, attn: dict, n_heads: int,
                                n_kv: int, eps: float = 1e-5) -> torch.Tensor:
    """``fused_rect_attn_half_reference`` taken through the kernels' launch
    order on one flat scratch of 4 * B * L * d elements, with the strides
    and the k/v row map of ``fused_rect_attn_half_forward``: z = LN1(x) as
    (B * L, d) first, q | k | v as (B * L, 3d) after it; q over every row,
    k and v over the gathered rows < n_kv of each sequence; the attention
    on strided views of q | k | v, o written over z; the out projection
    and the residual.  The same function as the reference; the tests hold
    the two to ``torch.equal``, and no path calls it."""
    B, L, d = x.shape
    dt, rows, dh = x.dtype, B * L, d // n_heads
    scratch = torch.empty(4 * rows * d, dtype=dt, device=x.device)
    z = scratch[:rows * d].view(rows, d)
    qkv = scratch[rows * d:].view(rows, 3 * d)
    z.copy_(ln_f32(x.float(), ln_1, dt, eps).to(dt).view(rows, d))
    w, b = attn["qkv_w"], attn["qkv_b"]
    qkv[:, :d] = proj(z, w[:, :d], b[:d])
    # row r of the k/v problem is sequence row (r // n_kv) * L + r % n_kv
    kv_rows = (torch.arange(B, device=x.device)[:, None] * L
               + torch.arange(n_kv, device=x.device)).flatten()
    for i in (1, 2):
        qkv[kv_rows, i * d:(i + 1) * d] = proj(z[kv_rows], w[:, i * d:(i + 1) * d],
                                               b[i * d:(i + 1) * d])

    def heads(offset, n, ld):  # (B, H, n, dh) at strides (L * ld, dh, ld, 1)
        return scratch.as_strided((B, n_heads, n, dh), (L * ld, dh, ld, 1), offset)

    q, k, v = (heads(rows * d + i * d, n, 3 * d) for i, n in ((0, L), (1, n_kv), (2, n_kv)))
    heads(0, L, d).copy_(rect_attention_reference(q, k, v))  # o over z
    return x + proj(z.view(B, L, d), attn["out_w"], attn["out_b"])


def fused_mlp_half_reference(x: torch.Tensor, ln_2: dict, mlp: dict,
                             eps: float = 1e-5) -> torch.Tensor:
    """The MLP kernel's math in plain PyTorch, in the activation dtype of x."""
    z = ln_f32(x.float(), ln_2, x.dtype, eps).to(x.dtype)
    h = quick_gelu_rounded(proj(z, mlp["fc_w"], mlp["fc_b"]))
    return x + proj(h, mlp["proj_w"], mlp["proj_b"])


def _gemm_tiles(M: int, N: int) -> int:
    """The 128 x 128 output tiles of an (M, N) product on the GEMM core."""
    return -(-M // _GEMM_ROWS) * -(-N // _GEMM_COLS)


# threads and dynamic shared bytes of a launch of the GEMM core (kGemmSmem)
_GEMM_LAUNCH = {"threads": _GEMM_THREADS,
                "shared_bytes": _GEMM_STAGES * 2 * (_GEMM_ROWS * (_GEMM_K + _PAD_BF16)
                                                    + _GEMM_K * _GEMM_COLS)}


def mlp_launch_plan(rows: int, d: int) -> dict:
    """The launches of one ``fused_mlp_half`` call on ``rows`` rows of width
    ``d``, as ``fused_mlp_half_forward`` makes them: each launch's grid,
    threads and dynamic shared bytes, and the scratch's bf16 elements
    (z = LN2(x), then h)."""
    if rows < 1 or d < 64 or d % 64 or d > _MAX_WIDTH:
        raise ValueError(f"(rows {rows}, d {d}): the kernels take rows >= 1 and d a multiple "
                         f"of 64 up to {_MAX_WIDTH}")
    return {
        "launches": 3,
        "ln2": {"grid": -(-rows // _LN_ROWS), "threads": _LN_THREADS, "shared_bytes": 0},
        "fc": {"grid": _gemm_tiles(rows, 4 * d), **_GEMM_LAUNCH},
        "proj": {"grid": _gemm_tiles(rows, d), **_GEMM_LAUNCH},
        "scratch_elements": 5 * rows * d,
    }


def _attn_shape(L: int, d: int, n_heads: int, n_kv: int) -> None:
    """Raise on a shape the attention half's kernels do not take."""
    if n_heads < 1 or d != n_heads * _HEAD_DIM:
        raise ValueError(f"head dim {d}/{n_heads}: the kernel takes head dim {_HEAD_DIM}")
    if d > _MAX_WIDTH:
        raise ValueError(f"width {d}: the kernel takes d <= {_MAX_WIDTH}")
    if not 1 <= n_kv <= min(L, _MAX_KV):
        raise ValueError(f"n_kv {n_kv}: the kernel takes 1 <= n_kv <= min(L, {_MAX_KV}), L = {L}")


def attn_launch_plan(B: int, L: int, d: int, n_heads: int, n_kv: int) -> dict:
    """The launches of one ``fused_rect_attn_half`` call on x (B, L, d), as
    ``fused_rect_attn_half_forward`` makes them on a card whose blocks take
    232,448 bytes of shared memory (the H100): each launch's grid, threads
    and dynamic shared bytes, the q tiles that open the q/k/v grid, the
    attention's score tiles and (b, h) a block, and the scratch's bf16
    elements (z = LN1(x), later o; then q | k | v)."""
    if B < 1 or L < 1:
        raise ValueError(f"(B {B}, L {L}): the kernels take B >= 1 and L >= 1")
    _attn_shape(L, d, n_heads, n_kv)
    rows = B * L
    q_tiles = _gemm_tiles(rows, d)
    mt = -(-L // _TC_TILE)
    pack = 1 if mt >= _TC_WARPS else _TC_WARPS // mt
    while pack > 1 and _shared_bytes(torch.bfloat16, n_kv, _HEAD_DIM, pack) > _MAX_SHARED:
        pack -= 1
    return {
        "launches": 4,
        "ln1": {"grid": -(-rows // _LN_ROWS), "threads": _LN_THREADS, "shared_bytes": 0},
        "qkv": {"grid": q_tiles + _gemm_tiles(B * n_kv, 2 * d), **_GEMM_LAUNCH,
                "q_tiles": q_tiles},
        "attention": {"grid": -(-B * n_heads // pack), "threads": _TC_THREADS,
                      "shared_bytes": _shared_bytes(torch.bfloat16, n_kv, _HEAD_DIM, pack),
                      "score_tiles": next(w for w in _SCORE_TILES
                                          if -(-n_kv // _TC_TILE) <= w),
                      "pack": pack},
        "out": {"grid": q_tiles, **_GEMM_LAUNCH},
        "scratch_elements": 4 * rows * d,
    }


# argument and result types of the library's C entry points
_SIGNATURES = {
    "fused_rect_attn_half_forward": ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                                     + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
                                     ctypes.c_int),
    "fused_mlp_half_forward": ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                               + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "fused_rect_layer_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_rect_layer")
    if lib.fused_rect_attn_half_forward.argtypes is None:
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused {what} kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"x must be a contiguous non-empty (B, L, d), got shape "
                         f"{tuple(x.shape)}")


def _check_weights(x: torch.Tensor, names, weights, shapes) -> None:
    for (a, b), t, shape in zip(names, weights, shapes):
        if t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"{a}.{b} is {tuple(t.shape)} on {t.device}, expected {shape} "
                             f"on {x.device}")


def _check_attn(x: torch.Tensor, weights, n_heads: int, n_kv: int) -> None:
    """Raise on anything the attention kernel does not take."""
    _check_x(x, "rect attention half")
    B, L, d = x.shape
    _attn_shape(L, d, n_heads, n_kv)
    _check_weights(x, _ATTN_WEIGHTS, weights,
                   [(d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,)])


def _check_mlp(x: torch.Tensor, weights) -> None:
    """Raise on anything the MLP kernel does not take."""
    _check_x(x, "MLP half")
    d = x.shape[-1]
    if d % 64 or not 64 <= d <= _MAX_WIDTH:
        raise ValueError(f"width {d}: the kernel takes d a multiple of 64 up to {_MAX_WIDTH}")
    _check_weights(x, _MLP_WEIGHTS, weights,
                   [(d,), (d,), (d, 4 * d), (4 * d,), (4 * d, d), (d,)])


def _kernel_weights(blk: dict, names, matrices, kernel: Optional[dict]):
    """The weights in the kernel's order: the matrices fragment-major (from
    ``kernel`` where given), the vectors bf16 and contiguous."""
    mats = _kernel_matrices({**blk, "kernel": kernel} if kernel is not None else blk, matrices)
    return [mats[b] if (a, b) in matrices else blk[a][b].to(torch.bfloat16).contiguous()
            for a, b in names]


def _raise_on(lib: ctypes.CDLL, rc: int, x: torch.Tensor, what: str) -> None:
    if rc == _ERR_SHARED_MEMORY:
        raise ValueError(f"shape {tuple(x.shape)} does not fit one block's shared memory")
    if rc != 0:
        msg = lib.fused_rect_layer_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed ({rc}): {msg}")


def _launch_attn(x, ln_1, attn, n_heads, n_kv, eps, kernel) -> torch.Tensor:
    global attn_half_launches
    blk = {"ln_1": ln_1, "attn": attn}
    _check_attn(x, [blk[a][b] for a, b in _ATTN_WEIGHTS], n_heads, n_kv)
    weights = _kernel_weights(blk, _ATTN_WEIGHTS, _ATTN_MATRICES, kernel)
    B, L, d = x.shape
    lib = _lib()
    out = torch.empty_like(x)
    scratch = torch.empty(attn_launch_plan(B, L, d, n_heads, n_kv)["scratch_elements"],
                          dtype=x.dtype, device=x.device)  # z = LN1(x), later o; q | k | v
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_rect_attn_half_forward(
        x.device.index, x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        *(t.data_ptr() for t in weights), B, L, d, n_heads, n_kv, _HEAD_DIM ** -0.5, eps, stream,
    )
    _raise_on(lib, rc, x, "fused_rect_attn_half")
    attn_half_launches += 1
    return out


def _launch_mlp(x, ln_2, mlp, eps, kernel) -> torch.Tensor:
    global mlp_half_launches
    blk = {"ln_2": ln_2, "mlp": mlp}
    _check_mlp(x, [blk[a][b] for a, b in _MLP_WEIGHTS])
    weights = _kernel_weights(blk, _MLP_WEIGHTS, _MLP_MATRICES, kernel)
    d = x.shape[-1]
    rows = x.numel() // d
    lib = _lib()
    out = torch.empty_like(x)
    scratch = torch.empty(mlp_launch_plan(rows, d)["scratch_elements"], dtype=x.dtype,
                          device=x.device)  # z = LN2(x), then h
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_mlp_half_forward(
        x.device.index, x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        *(t.data_ptr() for t in weights), rows, d, eps, stream,
    )
    _raise_on(lib, rc, x, "fused_mlp_half")
    mlp_half_launches += 1
    return out


def _on_cpu(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {x.device}")


def fused_rect_attn_half(x: torch.Tensor, ln_1: dict, attn: dict, n_heads: int, n_kv: int,
                         eps: float = 1e-5, kernel: Optional[dict] = None) -> torch.Tensor:
    """x + out_proj(rect_attend(LN1(x))) over x (B, L, d), every row
    attending to the first ``n_kv`` rows: the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor.  ``kernel`` is a block's
    ``with_kernel_layout`` entry, if it has one."""
    _refuse_grad(x, {"ln_1": ln_1, "attn": attn}, _ATTN_WEIGHTS, "fused_rect_attn_half")
    if x.is_cuda:
        return _launch_attn(x, ln_1, attn, n_heads, n_kv, eps, kernel)
    _on_cpu(x, "fused_rect_attn_half")
    return fused_rect_attn_half_reference(x, ln_1, attn, n_heads, n_kv, eps)


def fused_mlp_half(x: torch.Tensor, ln_2: dict, mlp: dict, eps: float = 1e-5,
                   kernel: Optional[dict] = None) -> torch.Tensor:
    """x + proj(QuickGELU(fc(LN2(x)))) over x (B, L, d), row by row: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    _refuse_grad(x, {"ln_2": ln_2, "mlp": mlp}, _MLP_WEIGHTS, "fused_mlp_half")
    if x.is_cuda:
        return _launch_mlp(x, ln_2, mlp, eps, kernel)
    _on_cpu(x, "fused_mlp_half")
    return fused_mlp_half_reference(x, ln_2, mlp, eps)


def fused_rect_residual_block(x: torch.Tensor, params: dict, n_heads: int,
                              n_kv: int) -> torch.Tensor:
    """``layers.rect_residual_block`` with both halves fused: one
    attention-half call (four CUDA launches) and one MLP-half call (three).
    ``params`` is one layer's params ({ln_1, attn, ln_2, mlp}, and "kernel"
    where ``with_kernel_layout`` made it)."""
    kernel = params.get("kernel")
    x = fused_rect_attn_half(x, params["ln_1"], params["attn"], n_heads, n_kv, kernel=kernel)
    return fused_mlp_half(x, params["ln_2"], params["mlp"], kernel=kernel)


def fused_rect_residual_block_reference(x: torch.Tensor, params: dict, n_heads: int,
                                        n_kv: int) -> torch.Tensor:
    """``fused_rect_residual_block`` on the plain versions of both halves."""
    x = fused_rect_attn_half_reference(x, params["ln_1"], params["attn"], n_heads, n_kv)
    return fused_mlp_half_reference(x, params["ln_2"], params["mlp"])
