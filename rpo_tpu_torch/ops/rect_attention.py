"""Bias-free rectangular attention: the CUDA kernel and its plain version.

Port of ``pallas_rect_attention`` and ``pallas_rect_attention_paired``
(``rpo_tpu/ops/pallas_attention.py``).  ``rect_attention(q, k, v)`` takes
q (B, H, Lq, D) against k, v (B, H, Lk, D):

- on a CUDA tensor it launches ``csrc/rect_attention.cu`` or raises;
- on a CPU tensor it runs ``rect_attention_reference``, the same math in
  plain PyTorch.

A bf16 tensor goes to the tensor-core kernel, which takes K and V of up to
768 rows at head dim 64 (1408 at 32, 384 at 128); an f32 tensor to the
SIMT kernel, which stages the scores too (273 rows at 64, 153 at 128).
The bf16 kernel takes one of three routes, by the shape alone:

- one pass, a warp holding a whole score row in registers: up to
  ``max_tiles(D)`` 16-column tiles (256 keys at head dim 32 and 64, 128
  at 128), every ViT-B/16 and text shape;
- split rows, ``split_row(Lk, D)``: at head dim 64, rows of 257 to 624
  keys (ViT-L/14@336px's 577) are split across the three warps of a
  group, each holding a slice of at most 13 tiles, and formed once;
- two passes, ``two_pass(Lk, D)``: any wider row (up to 768 keys at head
  dim 64, and past 256 at 32, past 128 at 128), whose scores are formed
  twice.

There is no fallback from the kernel to the plain version.  ``launches``
counts the kernel launches, so a run can show that its path went through
the kernel; each bf16 launch also stamps its route into the port's
record (``tracing.count``): ``rect_split_row``, ``rect_two_pass`` or
``rect_registers``.  The backward is a plain-PyTorch recompute, as in the JAX
package, which has no backward kernel either.

The plain math (``_softmax_attend``, ``_attention_bwd_math``) and the
library loader are shared with ``masked_attention``, whose kernel is the
biased instantiation in the same CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import tracing
from . import _build

launches = 0  # kernel launches since the count was last set to 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_GRID_YZ = 65535
_ERR_SHARED_MEMORY = -3  # kErrSharedMemory in csrc/rect_attention.cu
_MAX_SHARED = 232448  # bytes of shared memory one block can take on the H100 (sm_90)
_TILE = 16  # key columns of a score tile (kTile in csrc/attention_tc.cuh)
# the split-row route's geometry (kSplitSlice, kSplitWarps, kSplitGroups in
# csrc/attention_tc.cuh): score tiles a warp holds at most, warps of a
# group, groups of a block
_SPLIT_SLICE = 13
_SPLIT_WARPS = 3
_SPLIT_GROUPS = 4


def max_tiles(D: int) -> int:
    """The widest score row, in 16-column tiles, that a warp of the bf16
    kernel holds in registers: ``max_tiles(D)`` of
    ``csrc/attention_tc.cuh``, which a change to either goes into too."""
    return 8 if D == 128 else 16


def _split_bytes(Lk: int, D: int) -> int:
    """One split-row block's shared memory (``split_smem_bytes``): f32
    partial outputs of two warps of each group and the groups' row maxima
    and sums, then bf16: two Q tiles of each group, K and V."""
    ld, nkp = D + 8, -(-Lk // _TILE) * _TILE
    per_group = (_SPLIT_WARPS - 1) * _TILE * D + 2 * _SPLIT_WARPS * _TILE
    return 4 * _SPLIT_GROUPS * per_group + 2 * (_SPLIT_GROUPS * 2 * _TILE * ld + 2 * nkp * ld)


def split_row(Lk: int, D: int) -> bool:
    """Whether a bf16 launch over ``Lk`` keys at head dim ``D`` takes the
    kernel's split-row route (``split_row`` of ``csrc/attention_tc.cuh``):
    head dim 64, a padded key width wider than ``max_tiles(D)`` tiles and
    no wider than a group's warps hold, in one block's shared memory."""
    nkt = -(-Lk // _TILE)
    return (D == 64 and max_tiles(D) < nkt <= _SPLIT_WARPS * _SPLIT_SLICE
            and _split_bytes(Lk, D) <= _MAX_SHARED)


def two_pass(Lk: int, D: int) -> bool:
    """Whether a bf16 launch over ``Lk`` keys at head dim ``D`` takes the
    kernel's two-pass route: its padded key width is wider than
    ``max_tiles(D)`` tiles and the split-row route does not take it, so the
    scores are formed twice."""
    return -(-Lk // _TILE) > max_tiles(D) and not split_row(Lk, D)


def _softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The one copy of the kernels' math in plain PyTorch
    (``_softmax_attend``): f32 scores times D^-1/2, plus the f32 bias if
    any, f32 softmax normalised before the cast, probabilities rounded to
    v's dtype, f32-accumulated product with v, output in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    w = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(w.to(v.dtype).float(), v.float()).to(q.dtype)


def rect_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The rect kernel's math in plain PyTorch (``_softmax_attend`` with
    bias None)."""
    return _softmax_attend(q, k, v)


def _attention_bwd_math(q, k, v, bias, g, needs=(True, True, True)):
    """Softmax-recompute backward (``_attention_bwd_math``), shared by
    both kernels (bias None for the rect one).  ``needs`` (an autograd
    Function's ``needs_input_grad`` for q, k, v) says which of dq, dk, dv
    to compute; the others are None.  The split vision tower's prompt
    rows read k and v made without grad, so they ask for dq alone."""
    need_q, need_k, need_v = needs[:3]
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    w = torch.softmax(s, dim=-1)
    dv = torch.matmul(w.to(v.dtype).transpose(-1, -2), g) if need_v else None
    if not (need_q or need_k):
        return None, None, dv
    dw = torch.matmul(g, v.transpose(-1, -2)).float()
    ds = (w * (dw - (dw * w).sum(dim=-1, keepdim=True))).to(q.dtype)
    dq = torch.matmul(ds, k) * scale if need_q else None
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale if need_k else None
    return dq, dk, dv


def _lib() -> ctypes.CDLL:
    """``csrc/rect_attention.cu``, which holds both attention kernels."""
    lib = _build.load("rect_attention")
    if lib.rect_attention_forward.argtypes is None:
        strides = [ctypes.c_longlong] * 12
        lib.rect_attention_forward.argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 5
            + strides
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.masked_attention_forward.argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 4
            + strides
            + [ctypes.c_longlong] * 2
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.rect_attention_forward.restype = ctypes.c_int
        lib.masked_attention_forward.restype = ctypes.c_int
        lib.rect_attention_error_string.argtypes = [ctypes.c_int]
        lib.rect_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch_error(lib: ctypes.CDLL, name: str, rc: int, Lk: int, q: torch.Tensor) -> Exception:
    """The exception for a nonzero return code of a launch."""
    if rc == _ERR_SHARED_MEMORY:
        return ValueError(f"Lk={Lk} at D={q.shape[-1]} in {q.dtype} does not fit one block's "
                          "shared memory")
    msg = lib.rect_attention_error_string(rc).decode()
    return RuntimeError(f"{name} kernel launch failed ({rc}): {msg}")


def _shared_bytes(dtype: torch.dtype, Lk: int, D: int, pack: int = 1) -> int:
    """One block's shared memory in ``csrc/rect_attention.cu``
    (``tc_smem_bytes`` of ``csrc/attention_tc.cuh`` for bf16 with ``pack``
    (b, h) a block, ``split_smem_bytes`` on the split-row route, which
    takes one, ``smem_bytes`` for f32), which checks it again against the
    card's limit: a change to either formula goes into both."""
    if dtype == torch.bfloat16 and split_row(Lk, D):
        return _split_bytes(Lk, D)
    if dtype == torch.bfloat16:  # K and V padded to 16 rows, one 16-row Q tile per warp
        ld, nkp = D + 8, -(-Lk // 16) * 16
        return 2 * (pack * 2 * nkp * ld + 4 * 16 * ld)
    ld = D + 4  # f32: Q (64 rows), K, V and the 64 x (Lk | 1) scores
    return 4 * ((64 + Lk) * ld + Lk * D + 64 * (Lk | 1))


def _out_like(q: torch.Tensor) -> torch.Tensor:
    """(B, H, L, D) output written as (B, L, H, D), so that the head merge
    of the output projection is a view."""
    B, H, L, D = q.shape
    return torch.empty_strided((B, H, L, D), (L * H * D, D, H * D, 1), dtype=q.dtype,
                               device=q.device)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    dtype, device = q.dtype, q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {dtype}")
    if dtype not in _DTYPES:
        raise TypeError(f"rect_attention takes float32 or bfloat16, got {dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, L, D), got shapes {tuple(qs)}, {tuple(ks)}, "
                         f"{tuple(v.shape)}")
    B, H, Lq, D = qs
    Lk = ks[2]
    if ks != v.shape or ks[0] != B or ks[1] != H or ks[3] != D:
        raise ValueError(f"shapes q {tuple(qs)}, k {tuple(ks)}, v {tuple(v.shape)} do not match")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {_HEAD_DIMS}")
    if min(B, H, Lq, Lk) < 1 or max(B, H) > _MAX_GRID_YZ:
        raise ValueError(f"unsupported shape q {tuple(qs)}, k {tuple(ks)}")
    if _shared_bytes(dtype, Lk, D) > _MAX_SHARED:
        raise ValueError(f"Lk={Lk} at D={D} in {dtype} does not fit one block's shared memory")
    align = 16 // q.element_size()  # elements in 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v)):
        # rows are read as 16-byte vectors straight from the (possibly
        # strided) tensor: the last dim must be contiguous and every row
        # 16-byte aligned
        st = t.stride()
        if st[3] != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if t.data_ptr() % 16 or (st[0] | st[1] | st[2]) % align:
            raise ValueError(f"{name}'s rows are not 16-byte aligned")


def _stream(device: torch.device) -> int:
    """The current CUDA stream's handle on ``device``, without building a
    ``torch.cuda.Stream`` object at every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global launches
    _check(q, k, v)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    lib = _lib()
    out = _out_like(q)
    stream = _stream(q.device)
    rc = lib.rect_attention_forward(
        _DTYPES[q.dtype], q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Lq, Lk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        D ** -0.5, stream,
    )
    if rc != 0:
        raise _launch_error(lib, "rect_attention", rc, Lk, q)
    launches += 1
    if q.dtype == torch.bfloat16:
        tracing.count("rect_split_row" if split_row(Lk, D)
                      else "rect_two_pass" if two_pass(Lk, D) else "rect_registers")
    return out


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.is_cuda:
        return _launch(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"rect_attention runs on CUDA or the CPU, not {q.device}")
    return rect_attention_reference(q, k, v)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these tensors: where it does not
    (eval under ``no_grad``), the wrappers skip the autograd Function and
    its cost on the host."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _RectAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return _attention_bwd_math(q, k, v, None, g, ctx.needs_input_grad)


def rect_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bias-free attention of q (B, H, Lq, D) over k, v (B, H, Lk, D):
    the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if _needs_grad(q, k, v):
        return _RectAttention.apply(q, k, v)
    return _forward(q, k, v)


def unpair_heads(x: torch.Tensor, half: int) -> torch.Tensor:
    """(B, H/2, L, 2*half) -> (B, H, L, half): real head 2i is lanes
    [:half] of pair-head i, head 2i+1 lanes [half:]."""
    B, H2, L, D2 = x.shape
    if D2 != 2 * half:
        raise ValueError(f"paired head width {D2} is not 2 * {half}")
    return x.reshape(B, H2, L, 2, half).permute(0, 1, 3, 2, 4).reshape(B, 2 * H2, L, half)


def pair_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, half) -> (B, H/2, L, 2*half), the inverse of unpair_heads."""
    B, H, L, half = x.shape
    return x.reshape(B, H // 2, 2, L, half).permute(0, 1, 3, 2, 4).reshape(B, H // 2, L, 2 * half)


def rect_attention_paired(q2, k2, v2, half: int = 64) -> torch.Tensor:
    """``pallas_rect_attention_paired``'s signature over ``rect_attention``:
    unpacks the paired-head layout, attends per real head, packs back.
    The port's own path never pairs heads (pairing fills the TPU's 128
    lanes); this adapter exists to hold the port against that kernel."""
    return pair_heads(rect_attention(*(unpair_heads(t, half) for t in (q2, k2, v2))))
