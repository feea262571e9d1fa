"""One whole pre-LN text layer as one kernel: the CUDA kernel, its plain
version, and the tower over a layer stack.

Port of ``rpo_tpu/ops/fused_text_layer.py``.  ``fused_text_layer(x, blk,
n_heads, mask)`` runs one residual block (``layers.residual_block``) on
x (N, L, d) with an additive (L, L) mask:

- on a CUDA tensor it launches ``csrc/fused_text_layer.cu`` or raises;
- on a CPU tensor it runs ``fused_text_layer_reference``, the same math in
  plain PyTorch.

There is no fallback from the kernel to the plain version.  ``launches``
counts the kernel launches.  The kernel is forward-only, as the TPU one
is: both functions raise when grad is enabled and an input requires it.
The JAX package's switches (``fused_text_scope``, ``RPO_TPU_FUSED_TEXT``,
interpret mode) have no counterpart: a caller passes the layer function
(``layers.transformer``'s ``text_layer``), and only CoCoOp's eval step
does.  ``with_text_kernel_layout`` adds the kernel's layout of the four
weight matrices (wgmma's core matrices) to a block stack once (CoCoOp's
build does it for its frozen text tower); a block without it is laid out
at every launch.  ``with_kernel_layout`` (fragment-major) is the rect
kernels' layout (``fused_rect_layer``), which this kernel refuses.

Numerics, in the order of the TPU body (``_layer_kernel``): LayerNorm in
f32, two-pass, with the scale and bias first cast to the activation
dtype; every projection accumulated in f32, rounded, then its bias added
in the activation dtype (two roundings); per-head f32 scores times
dh^-1/2 plus the mask, softmax normalised before the cast; p . v
accumulated in f32 and rounded; residual adds in the activation dtype.
QuickGELU rounds after every op, as the TPU body spells it out in the
activation dtype: t = 1.702 * h (1.703125 in bf16), exp(-t), 1 + e,
1 / (1 + e), h * sigmoid.  The CUDA kernel takes bf16 only; the plain
version also runs f32 (for the CPU tests).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = 0  # kernel launches since the count was last set to 0

_HEAD_DIMS = (32, 64)
_MAX_L = 80
_MAX_WIDTH = 768
_SCRATCH_ROWS = 80  # kMaxRows in csrc/fused_text_layer.cu
_ERR_SHARED_MEMORY = -3
_WEIGHTS = (("ln_1", "scale"), ("ln_1", "bias"), ("attn", "qkv_w"), ("attn", "qkv_b"),
            ("attn", "out_w"), ("attn", "out_b"), ("ln_2", "scale"), ("ln_2", "bias"),
            ("mlp", "fc_w"), ("mlp", "fc_b"), ("mlp", "proj_w"), ("mlp", "proj_b"))
# the (in, out) weight matrices, which the kernel reads in its own layout
_MATRICES = (("attn", "qkv_w"), ("attn", "out_w"), ("mlp", "fc_w"), ("mlp", "proj_w"))


def _refuse_grad(x: torch.Tensor, blk: dict, weights=_WEIGHTS,
                 what: str = "fused_text_layer") -> None:
    if torch.is_grad_enabled() and (x.requires_grad or any(
            blk[a][b].requires_grad for a, b in weights)):
        raise RuntimeError(f"{what} is forward-only: call it under torch.no_grad()")


def ln_f32(x32: torch.Tensor, p: dict, dt: torch.dtype, eps: float) -> torch.Tensor:
    """The kernels' LayerNorm of f32 rows: two-pass, the scale and bias
    first cast to the activation dtype ``dt``; f32 out (callers round)."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) * (x32 - mean)).mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return normed * p["scale"].to(dt).float() + p["bias"].to(dt).float()


def proj(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y @ w rounded to y's dtype, then + b in that dtype (two roundings).
    A bf16 matmul accumulates in f32 and rounds once (cuBLAS on the card,
    as in layers.py; tests/test_torch_port_layers.py checks the CPU)."""
    return torch.matmul(y, w.to(y.dtype)) + b.to(y.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-head f32 scores times dh^-1/2 (plus the f32 mask), softmax
    normalised before the cast to v's dtype, p . v accumulated in f32 and
    rounded.  q (..., Lq, dh), k and v (..., Lk, dh)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s + mask.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def quick_gelu_rounded(h: torch.Tensor) -> torch.Tensor:
    """QuickGELU in h's dtype, rounded after every op as the TPU bodies
    spell it: 1.702 * h, exp(-t), 1 + e, 1 / (1 + e), h * sigmoid."""
    one = torch.ones((), dtype=h.dtype)
    return h * (one / (one + torch.exp(-(torch.tensor(1.702, dtype=h.dtype) * h))))


def fused_text_layer_reference(x: torch.Tensor, blk: dict, n_heads: int, mask: torch.Tensor,
                               eps: float = 1e-5) -> torch.Tensor:
    """The kernel's math in plain PyTorch, in the activation dtype of x."""
    N, L, d = x.shape
    dt = x.dtype
    dh = d // n_heads
    a, m = blk["attn"], blk["mlp"]

    def heads(t):
        return t.view(N, L, n_heads, dh).permute(0, 2, 1, 3)

    y = ln_f32(x.float(), blk["ln_1"], dt, eps).to(dt)
    w, b = a["qkv_w"], a["qkv_b"]
    q, k, v = (heads(proj(y, w[:, i * d:(i + 1) * d], b[i * d:(i + 1) * d])) for i in range(3))
    o = attend(q, k, v, mask)
    x = x + proj(o.permute(0, 2, 1, 3).reshape(N, L, d), a["out_w"], a["out_b"])

    z = ln_f32(x.float(), blk["ln_2"], dt, eps).to(dt)
    h = quick_gelu_rounded(proj(z, m["fc_w"], m["fc_b"]))
    return x + proj(h, m["proj_w"], m["proj_b"])


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_text_layer")
    if lib.fused_text_layer_forward.argtypes is None:
        lib.fused_text_layer_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        )
        lib.fused_text_layer_forward.restype = ctypes.c_int
        lib.fused_text_layer_error_string.argtypes = [ctypes.c_int]
        lib.fused_text_layer_error_string.restype = ctypes.c_char_p
    return lib


_PLAN_KEYS = ("seqs", "blocks", "passes", "stages", "shared_bytes")


def launch_plan(N: int, L: int, d: int, n_heads: int, device: int = 0) -> dict:
    """The kernel's launch plan for x of shape (N, L, d) on CUDA device
    ``device``: sequences a block, blocks, the MLP's passes, the weight
    ring's stages and the dynamic shared bytes a block, as the C side
    computes them for the launch."""
    lib = _lib()
    fn = lib.fused_text_layer_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    rc = fn(device, N, L, d, n_heads, out)
    if rc != 0:
        raise ValueError(f"no launch plan for {(N, L, d)}, {n_heads} heads: "
                         f"{lib.fused_text_layer_error_string(rc).decode()}")
    return dict(zip(_PLAN_KEYS, out))


def _check(x: torch.Tensor, weights, n_heads: int, mask: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused text layer kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, L, d), got shape {tuple(x.shape)}")
    N, L, d = x.shape
    if n_heads < 1 or d % n_heads or d // n_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {d}/{n_heads} is not one of {_HEAD_DIMS}")
    if not (1 <= N and 1 <= L <= _MAX_L and d <= _MAX_WIDTH):
        raise ValueError(f"shape {tuple(x.shape)}: takes L <= {_MAX_L}, d <= {_MAX_WIDTH}")
    if tuple(mask.shape) != (L, L):
        raise ValueError(f"mask must be ({L}, {L}), got {tuple(mask.shape)}")
    shapes = [(d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,), (d, 4 * d), (4 * d,),
              (4 * d, d), (d,)]
    for (a, b), t, shape in zip(_WEIGHTS, weights, shapes):
        if t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"{a}.{b} is {tuple(t.shape)} on {t.device}, expected {shape} "
                             f"on {x.device}")


def _fragment_order() -> torch.Tensor:
    """Index into a row-major 16x16 tile of the 256 elements in the order the
    kernel loads them: lane l (g = l // 4, q = l % 4) takes 8, its B
    fragments of two m16n8k16 products (columns g and 8 + g; rows 2q, 2q+1,
    2q+8, 2q+9)."""
    lane, e = torch.arange(32)[:, None], torch.arange(8)[None, :]
    g, q, half, j = lane // 4, lane % 4, e // 4, e % 4
    row = 2 * q + j % 2 + 8 * (j // 2)
    return (row * 16 + 8 * half + g).reshape(-1)


_FRAGMENT_ORDER = _fragment_order()


def _fragment_major(w: torch.Tensor) -> torch.Tensor:
    """(..., K, N) -> (..., K/16, N/16, 256): each 16x16 tile's 512 bytes
    contiguous, in ``_FRAGMENT_ORDER``: the rect kernels' layout for their
    B operands (see ``gemm_tiles`` in csrc/fused_layer_common.cuh)."""
    *lead, K, N = w.shape
    tiles = w.reshape(*lead, K // 16, 16, N // 16, 16).transpose(-3, -2)
    tiles = tiles.reshape(*lead, K // 16, N // 16, 256)
    return tiles[..., _FRAGMENT_ORDER.to(w.device)].contiguous()


def _core_matrices(w: torch.Tensor) -> torch.Tensor:
    """(..., K, N) -> (..., K/16, N/16, 2, 2, 8, 8): the text kernel's layout
    for its wgmma B operands (K-major core matrices, no swizzle; see the
    note in csrc/fused_text_layer.cu).  Each 16x16 tile's 512 bytes are
    contiguous as four 8x8 core matrices, the column half outer and the k
    half inner; a core matrix is 8 columns of 8 contiguous k.  Element (k, n)
    lands at [k // 16, n // 16, n % 16 // 8, k % 16 // 8, n % 8, k % 8]."""
    *lead, K, N = w.shape
    n = len(lead)
    tiles = w.reshape(*lead, K // 16, 2, 8, N // 16, 2, 8)
    return tiles.permute(*range(n), *(n + i for i in (0, 3, 4, 1, 5, 2))).contiguous()


def with_text_kernel_layout(blocks: dict) -> dict:
    """``blocks`` (one layer's params, or a stack of them with a leading
    layer axis) plus, under ``"kernel"``, its four weight matrices in this
    kernel's layout (``_core_matrices``), in bf16.  Made once where frozen
    weights are installed (``CoCoOp.build_method``), it spares every launch
    the layout pass; a block without it is laid out at each launch.  The
    copies do not follow later in-place updates of the weights."""
    return {**blocks, "kernel": {b: _core_matrices(blocks[a][b].to(torch.bfloat16))
                                 for a, b in _MATRICES}}


def _text_kernel_matrices(blk: dict) -> dict:
    """The four weight matrices of one layer in this kernel's layout, by
    name: those of ``with_text_kernel_layout`` where ``blk`` carries them
    (checked against the weights' shapes and device; ``with_kernel_layout``'s
    fragment-major ones are refused), else made now."""
    made = blk.get("kernel")
    if made is None:
        return {b: _core_matrices(blk[a][b].to(torch.bfloat16)) for a, b in _MATRICES}
    for a, b in _MATRICES:
        K, N = blk[a][b].shape
        t = made[b]
        if (tuple(t.shape) != (K // 16, N // 16, 2, 2, 8, 8) or t.dtype != torch.bfloat16
                or t.device != blk[a][b].device or not t.is_contiguous()):
            raise ValueError(f"kernel layout of {a}.{b} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}: not with_text_kernel_layout's of this layer")
    return made


def with_kernel_layout(blocks: dict) -> dict:
    """``blocks`` (one layer's params, or a stack of them with a leading
    layer axis) plus, under ``"kernel"``, its four weight matrices in the
    rect kernels' layout (``_fragment_major``), in bf16.  Made once where
    frozen weights are installed (``RPO.build_method`` for the fused vision
    tower), it spares every launch the layout pass; a
    block without it is laid out at each launch.  The copies do not follow
    later in-place updates of the weights."""
    return {**blocks, "kernel": {b: _fragment_major(blocks[a][b].to(torch.bfloat16))
                                 for a, b in _MATRICES}}


def _kernel_matrices(blk: dict, matrices=_MATRICES) -> dict:
    """The named weight matrices of one layer (all four by default) in the
    rect kernels' layout, by name: those of ``with_kernel_layout`` where ``blk``
    carries them (the named ones checked against the weights' shapes and
    device), else made now."""
    made = blk.get("kernel")
    if made is None:
        return {b: _fragment_major(blk[a][b].to(torch.bfloat16)) for a, b in matrices}
    for a, b in matrices:
        K, N = blk[a][b].shape
        t = made[b]
        if (tuple(t.shape) != (K // 16, N // 16, 256) or t.dtype != torch.bfloat16
                or t.device != blk[a][b].device or not t.is_contiguous()):
            raise ValueError(f"kernel layout of {a}.{b} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}: not with_kernel_layout's of this layer")
    return made


def _launch(x: torch.Tensor, blk: dict, n_heads: int, mask: torch.Tensor, eps: float,
            scratch: Optional[torch.Tensor] = None,
            mats: Optional[dict] = None) -> torch.Tensor:
    """The launch; ``mats``, the four matrices as the loaded build takes
    them, is ``_text_kernel_matrices(blk)`` unless given (tools/time_fused.py
    hands earlier builds theirs)."""
    global launches
    weights = [blk[a][b] for a, b in _WEIGHTS]
    mask = mask.to(device=x.device, dtype=torch.float32).contiguous()
    _check(x, weights, n_heads, mask)
    if mats is None:
        mats = _text_kernel_matrices(blk)
    weights = [mats[b] if (a, b) in _MATRICES else t.to(torch.bfloat16).contiguous()
               for (a, b), t in zip(_WEIGHTS, weights)]
    N, L, d = x.shape
    lib = _lib()
    out = torch.empty_like(x)
    if scratch is None:  # else a caller's, of this shape (tools/time_fused.py reads its tail)
        scratch = torch.empty((N * L + _SCRATCH_ROWS, d), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_text_layer_forward(
        x.device.index, x.data_ptr(), out.data_ptr(), scratch.data_ptr(), mask.data_ptr(),
        *(t.data_ptr() for t in weights), N, L, d, n_heads, (d // n_heads) ** -0.5, eps, stream,
    )
    if rc == _ERR_SHARED_MEMORY:
        raise ValueError(f"shape {tuple(x.shape)} does not fit one block's shared memory")
    if rc != 0:
        msg = lib.fused_text_layer_error_string(rc).decode()
        raise RuntimeError(f"fused_text_layer kernel launch failed ({rc}): {msg}")
    launches += 1
    return out


def fused_text_layer(x: torch.Tensor, blk: dict, n_heads: int, mask: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """One residual block over x (N, L, d) with the additive (L, L) mask:
    the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor.
    ``blk`` is one layer's params ({ln_1, attn, ln_2, mlp})."""
    _refuse_grad(x, blk)
    if x.is_cuda:
        return _launch(x, blk, n_heads, mask, eps)
    if x.device.type != "cpu":
        raise ValueError(f"fused_text_layer runs on CUDA or the CPU, not {x.device}")
    return fused_text_layer_reference(x, blk, n_heads, mask, eps)


def fused_text_tower(x: torch.Tensor, stacked_blocks: dict, n_heads: int, mask: torch.Tensor,
                     layer=fused_text_layer) -> torch.Tensor:
    """The text transformer (``layers.transformer``) with ``layer`` as the
    body of every block.  x: (N, L, d); mask: additive (L, L).  L is padded
    to a multiple of 8 as on the TPU, exact under a causal mask: the padded
    key columns sit at j >= L > i for every real query row i, so they are
    always masked; the padded query rows are sliced off on return."""
    from ..models.clip.layers import layer_params, n_layers
    from ..models.clip.model import causal_mask

    _refuse_grad(x, stacked_blocks)
    N, L, d = x.shape
    mask = mask.to(device=x.device, dtype=torch.float32)
    Lp = (L + 7) // 8 * 8
    if Lp != L:
        x = torch.cat([x, x.new_zeros(N, Lp - L, d)], dim=1)
        full = causal_mask(Lp, x.device)
        full[:L, :L] = mask
        mask = full
    for i in range(n_layers(stacked_blocks)):
        x = layer(x, layer_params(stacked_blocks, i), n_heads, mask)
    return x[:, :L] if Lp != L else x
