"""The kernel selftest: every CUDA kernel of the package against its plain
version, at the main paths' shapes and at the kernels' edges, each check
isolated.

Port of ``rpo_tpu/ops/selftest.py``.  ``checks()`` is the table: each
``Check`` has a name, the kernel it holds, its shape, its own bound and a
thunk that measures and asserts nothing.  ``run_selftest`` runs the table
(``run_checks``) and returns the JAX package's dict (``metric``
``kernel_selftest``, ``value`` the checks passed, ``total``, ``checks``
by name, ``backend``, ``device``, ``seconds``), with the card's
``nvidia-smi`` name and power limit and each comparison's max abs error
added.  ``python -m rpo_tpu_torch.tools.kernel_selftest`` prints it as one
JSON line; ``chip_smoke.py`` phase 3 runs it before any timing.

The bounds, each check's own (none is the JAX package's single 2e-2):

- a bf16 output within ``tol`` (2e-2: inputs N(0, 1), about two bf16 ulps
  of outputs below 2) of the plain version's, an f32 one within 1e-5;
- an attention kernel's mean error against an f64 evaluation of its
  contract at most 1.1x its plain version's (``CONTRACT_RATIO``);
- a fused layer element by element within ``tol`` x max(|plain|, 1) and
  in the mean within 1e-4 (``FUSED_MEAN_TOL``), the weights laid out at
  the launch giving the same output as laid out once;
- the device preprocess within 2.01 uint8 steps of the host's
  Pillow-exact resample (``data/transforms.py``), in normalised units;
- a refusal: the wrapper raises on what its kernel does not take;
- a control, a check of its own: the bound must reject a planted fault
  (the plain version without a bias), else the bound holds nothing.

Where the port differs from the JAX package, and why:

- No fallback.  The JAX bench downgrades to its XLA path when this gate
  fails; nothing in the port switches to a plain version on a failed
  check.  Every consumer fails or reports.
- A CUDA error (an illegal address, a launch failure) leaves the context
  unusable, so it ends the run: the later checks are reported as
  ``not run: CUDA context lost at <name>`` and still count in ``total``.
- ``retries`` retries an exception that is not a CUDA error, as the JAX
  package retries its platform's transient faults.  A mismatch is never
  retried.
- ``kernels`` puts other functions in the kernels' slots (their plain
  versions, or a planted fault): the CPU tests pass it.  On the CPU a
  wrapper runs its plain version, so without it ``run_selftest`` raises
  there rather than hold a plain version to itself.

Not yet: the JAX package's shard_map check (its ``:210-253``), which
waits for the port of ``parallel/dp.py``.
"""
from __future__ import annotations

import math
import random
import subprocess
import sys
import time
import traceback
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

BF16_TOL = 2e-2
F32_TOL = 1e-5
# on the H100 the fused layers' mean error is 0 to 3.7e-5 at these shapes
# (rounding flips on a few elements in 10^3), while a dropped bias of std
# 0.02 moves it by about 1.6e-2
FUSED_MEAN_TOL = 1e-4
# both round at the same points, so they differ only in the f32 summation
# order; a slip in the rounding order moves outputs by about 1e-3, within
# BF16_TOL, and shows here
CONTRACT_RATIO = 1.1
NEG_INF = -1e9
K = 24  # main_K24's prompt count: 221 = 197 + 24 rows in the RPO eval tower
TRAIN_BATCH = 4  # main_K24's train batch
BASELINE_TRAIN_BATCH = 32  # configs/trainers/CoOp/vit_b16_ep50_ctxv1.yaml's
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# the device resize within two uint8 steps of the host's, in normalised units
U8_TOL = 2.01 / (min(CLIP_STD) * 255.0)

BF16, F32 = torch.bfloat16, torch.float32
# (label, (B, H, Lq, Lk, D), dtype, paired): the eval towers, then the
# kernel's edges: Lq 1 and 17, Lk either side of the 16-column pad and of
# the widest row held in registers (256 | 257 at head dim <= 64, 128 | 129
# at 128), head dims 32 and 128
RECT_CHECKS = (
    ("eval layer, path layout", (100, 12, 221, 197, 64), BF16, False),
    ("eval layer, paired adapter", (100, 6, 221, 197, 128), BF16, True),
    ("CoOp/zero-shot eval layer", (100, 12, 197, 197, 64), BF16, False),
    ("ragged tiny", (3, 2, 9, 5, 32), F32, False),
    ("TINY tower", (3, 1, 9, 5, 64), BF16, False),
    ("eval layer f32", (2, 12, 221, 197, 64), F32, False),
    ("head dim 128", (2, 4, 221, 197, 128), BF16, False),
    ("head dim 32", (2, 3, 70, 130, 32), BF16, False),
    ("Lk over 256: two score passes", (2, 2, 33, 300, 64), BF16, False),
    ("Lq 1, Lk 1", (2, 3, 1, 1, 64), BF16, False),
    ("Lq 17, Lk 16: one score tile", (2, 3, 17, 16, 64), BF16, False),
    ("Lk 17: one column into a second tile", (2, 3, 17, 17, 64), BF16, False),
    ("Lk 256: the widest row in registers", (2, 2, 17, 256, 64), BF16, False),
    ("Lk 257: the two-pass route", (2, 2, 17, 257, 64), BF16, False),
    ("Lq 1, Lk 300", (2, 2, 1, 300, 64), BF16, False),
    ("head dim 32, Lk 257", (2, 4, 17, 257, 32), BF16, False),
    ("head dim 128, Lk 16", (2, 4, 17, 16, 128), BF16, False),
    ("head dim 128, Lk 129: the two-pass route", (2, 4, 33, 129, 128), BF16, False),
)
# the RPO train step's split vision tower: the frozen rows, and the K
# prompt rows over them
TRAIN_SHAPES = (("train frozen rows", (TRAIN_BATCH, 12, 197, 197, 64)),
                ("train prompt rows", (TRAIN_BATCH, 12, K, 197, 64)))
# (label, (B, H, L, D), bias kind, dtype); short L: several (b, h) a block
# (4 at L = 16, 2 at 24), B*H not a multiple of that, the last block ragged
MASKED_CHECKS = (
    ("RPO set-up text K/V, shared causal", (51, 8, 77, 64), "causal", BF16),
    ("CoOp text, shared causal", (51, 8, 24, 64), "causal", BF16),
    ("zero-shot text, shared causal", (51, 8, 16, 64), "causal", BF16),
    ("RPO masked text form, per-class mask", (51, 8, 77, 64), "text", BF16),
    ("RPO masked vision form, shared visual mask", (4, 12, 221, 64), "visual", BF16),
    ("ragged per-batch, one row fully masked", (3, 2, 10, 32), "full row", F32),
    ("head dim 128", (2, 4, 77, 128), "causal", BF16),
    ("head dim 32", (2, 3, 70, 32), "text", BF16),
    ("L 16, B*H 15, per-class mask", (3, 5, 16, 64), "prefix", BF16),
    ("L 16, B*H 15, shared causal", (3, 5, 16, 64), "causal", BF16),
    ("L 16, B*H 15, per-batch, one row fully masked", (3, 5, 16, 64), "full row", BF16),
    ("L 24, B*H 9, per-class mask", (3, 3, 24, 64), "prefix", BF16),
    ("L 24, B*H 9, per-batch, one row fully masked", (3, 3, 24, 64), "full row", BF16),
    ("L 77, B*H 21, per-class text mask", (7, 3, 77, 64), "text", BF16),
    ("L 16, head dim 128, B*H 15", (3, 5, 16, 128), "causal", BF16),
)
SHARED_BIASES = ("causal", "visual")
# (label, (N, L, d, heads))
FUSED_TEXT_CHECKS = (
    ("CoCoOp eval chunk, the slice", (510, 16, 512, 8)),
    ("the JAX selftest shape", (408, 16, 512, 8)),
    ("ragged N, TINY widths, head dim 32", (13, 16, 64, 2)),
    ("L 80 (77 padded)", (4, 80, 512, 8)),
    ("d 768, L 80: the MLP in column passes", (3, 80, 768, 12)),
)
# (label, (B, L, d, heads, n_kv)): the RPO eval layer, the square tower
# (n_kv = L), a ragged small shape; the MLP half's GEMM edges (one row past
# a 128-row tile; d = 64, where proj's N fills half a 128-column block);
# the attention half's edges (L 13, four (b, h) a block, the last ragged;
# n_kv 256, its widest score row)
RECT_HALF_CHECKS = (
    ("RPO eval layer", (100, 221, 768, 12, 197)),
    ("square tower, n_kv = L", (100, 197, 768, 12, 197)),
    ("ragged small", (3, 37, 256, 4, 29)),
    ("129 rows", (3, 43, 768, 12, 40)),
    ("d 64", (2, 64, 64, 1, 50)),
    ("L 13", (3, 13, 128, 2, 9)),
    ("n_kv 256", (2, 257, 128, 2, 256)),
)
# the kernels' slots a check may call, by name
SLOTS = ("rect_attention", "masked_attention", "fused_text_layer", "fused_rect_attn_half",
         "fused_mlp_half", "device_eval_preprocess", "device_train_preprocess")


class Reading(NamedTuple):
    """What a check measured: ``err`` is held to the check's bound (at
    most), ``ok`` carries its other conditions (finite, ``torch.equal``,
    a refusal raised), ``detail`` says what else was measured, and
    ``max_abs_err`` is the output's largest error where the check compares
    one."""
    err: float
    ok: bool = True
    detail: str = ""
    max_abs_err: Optional[float] = None


@dataclass(frozen=True)
class Check:
    """One row of the table: ``run()`` returns a ``Reading`` or a bare
    error (a float) held to ``bound``."""
    name: str
    kernel: str  # the slot it holds, one of SLOTS
    shape: Tuple[int, ...]
    bound: float
    run: Callable[[], Union[Reading, float]]
    kind: str = "compare"  # compare | contract | refusal | control


# ---- inputs ---------------------------------------------------------------

def generator(name: str, device) -> torch.Generator:
    """A generator seeded from a check's name: each check draws the same
    inputs whatever runs before it, and again on a retry."""
    return torch.Generator(device=device).manual_seed(zlib.crc32(name.encode()))


def path_layout_qkv(gen, B, H, Lq, Lk, D, dtype, device="cuda"):
    """q, k, v as the rect eval tower hands them to the kernel: head views
    of the projection outputs (B, L, H*D) and (B, Lk, 2*H*D)."""
    q = torch.randn(B, Lq, H * D, generator=gen, device=device).to(dtype)
    kv = torch.randn(B, Lk, 2 * H * D, generator=gen, device=device).to(dtype)
    q = q.view(B, Lq, H, D).permute(0, 2, 1, 3)
    kv = kv.view(B, Lk, 2 * H, D).permute(0, 2, 1, 3)
    return q, kv[:, :H], kv[:, H:]


def fused_qkv(gen, B, H, L, D, dtype, device="cuda"):
    """q, k, v as a self-attention tower hands them to the kernel: head
    views of the fused QKV projection output (B, L, 3*H*D)."""
    qkv = torch.randn(B, L, 3 * H * D, generator=gen, device=device).to(dtype)
    qkv = qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def train_layout_qkv(gen, B, H, Lq, Lk, D, dtype, device="cuda"):
    """q, k, v as the split vision tower hands them to the kernel: k and v
    head views of the frozen rows' fused QKV output (B, Lk, 3*H*D); q of
    the same output (the frozen rows, Lq = Lk) or of the prompt rows' own
    q projection (B, Lq, H*D)."""
    q, k, v = fused_qkv(gen, B, H, Lk, D, dtype, device)
    if Lq != Lk:
        q = torch.randn(B, Lq, H * D, generator=gen, device=device).to(dtype)
        q = q.view(B, Lq, H, D).permute(0, 2, 1, 3)
    return q, k, v


def attention_bias(kind: str, B: int, L: int, device="cuda") -> torch.Tensor:
    """The masked kernel's f32 biases, built with numpy: the shared causal
    mask of the text towers, RPO's per-class text mask (causal, and every
    column >= the class's prompt length), RPO's shared visual mask (the
    last K columns), a per-batch causal mask with one row fully masked,
    and a per-class mask at any L: causal, and every column >= the class's
    length 1 + b % L."""
    i = np.arange(L)
    causal = np.where(i[None, :] > i[:, None], NEG_INF, 0.0).astype(np.float32)
    if kind == "causal":
        m = causal[None, None]
    elif kind in ("text", "prefix"):
        lens = 4 + np.arange(B) % (L - K - 4) if kind == "text" else 1 + np.arange(B) % L
        m = np.where((i[None, None, :] >= lens[:, None, None]) | (causal[None] < 0), NEG_INF, 0.0)
        m = m.astype(np.float32)[:, None]
    elif kind == "visual":
        m = np.zeros((1, 1, L, L), np.float32)
        m[..., L - K:] = NEG_INF
    elif kind == "full row":
        m = np.tile(causal, (B, 1, 1, 1)).reshape(B, 1, L, L)
        m[1, 0, 4, :] = NEG_INF
    else:
        raise KeyError(kind)
    return torch.from_numpy(m).to(device)


def random_block(gen, d: int, device="cuda") -> dict:
    """One pre-LN layer's params in bf16: CLIP's init scales, with nonzero
    biases and LayerNorm parameters other than (1, 0)."""
    def normal(*shape, std):
        return (torch.randn(*shape, generator=gen, device=device) * std).to(BF16)

    return {
        "ln_1": {"scale": 1 + normal(d, std=0.1), "bias": normal(d, std=0.1)},
        "attn": {"qkv_w": normal(d, 3 * d, std=d ** -0.5), "qkv_b": normal(3 * d, std=0.02),
                 "out_w": normal(d, d, std=d ** -0.5 / 5), "out_b": normal(d, std=0.02)},
        "ln_2": {"scale": 1 + normal(d, std=0.1), "bias": normal(d, std=0.1)},
        "mlp": {"fc_w": normal(d, 4 * d, std=(2 * d) ** -0.5), "fc_b": normal(4 * d, std=0.02),
                "proj_w": normal(4 * d, d, std=d ** -0.5 / 5), "proj_b": normal(d, std=0.02)},
    }


# ---- measures ---------------------------------------------------------------

def fused_errors(out: torch.Tensor, ref: torch.Tensor, tol: float = BF16_TOL):
    """(max abs error, mean abs error, largest error over its element's
    tolerance ``tol`` x max(|ref|, 1)) of a fused layer against its plain
    version."""
    diff = (out.float() - ref.float()).abs()
    bound = tol * ref.float().abs().clamp(min=1.0)
    return diff.max().item(), diff.mean().item(), (diff / bound).max().item()


def _max_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (out.float() - ref.float()).abs().max().item()


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def contract_reading(kernel, plain, q, k, v, bias=None) -> Reading:
    """The kernel and its plain version against an f64 evaluation of their
    contract (probabilities rounded to bf16, the output not rounded): the
    kernel's mean abs error over the plain version's, to be held to
    CONTRACT_RATIO."""
    with torch.no_grad():
        s64 = torch.matmul(q.double(), k.double().transpose(-1, -2)) * q.shape[-1] ** -0.5
        if bias is not None:
            s64 = s64 + bias.double()
        exact = torch.matmul(torch.softmax(s64, -1).to(BF16).double(), v.double())
        del s64
        means, parts = {}, []
        for what, fn in (("kernel", kernel), ("plain", plain)):
            out = fn()
            means[what] = (out.double() - exact).abs().mean().item()
            off = int((out != exact.to(BF16)).sum())
            parts.append(f"{what} mean abs {means[what]:.4e}, {off} of {out.numel()} off the "
                         "correctly rounded value")
    ratio = means["kernel"] / means["plain"]
    return Reading(ratio, True, "; ".join(parts) + f"; kernel / plain {ratio:.4f} (at most "
                   f"{CONTRACT_RATIO})")


def _refusal(call, exc_type) -> Reading:
    """A refusal check: ``call()`` must raise ``exc_type``."""
    try:
        call()
    except exc_type as exc:
        return Reading(0.0, True, f"refused: {type(exc).__name__}: {exc}")
    return Reading(0.0, False, f"took it: no {exc_type.__name__} raised")


def _grads_err(got, want) -> float:
    """Each gradient's largest error over max(its largest entry, 1), the
    worst of them."""
    return max((a.float() - b.float()).abs().max().item() / max(1.0, b.abs().max().item())
               for a, b in zip(got, want))


# ---- the table --------------------------------------------------------------

def checks(tol: float = BF16_TOL, device="cuda",
           kernels: Optional[Mapping[str, Callable]] = None) -> List[Check]:
    """The table, in the order the checks run; nothing runs here.
    ``kernels`` replaces the functions in the slots of ``SLOTS`` (the
    package's wrappers by default)."""
    from ..data import transforms as host
    from ..models.clip.layers import rect_residual_block
    from . import fused_rect_layer as frl
    from . import fused_text_layer as ftl
    from . import masked_attention as ma
    from . import preprocess
    from . import rect_attention as ra

    slot = {"rect_attention": ra.rect_attention, "masked_attention": ma.masked_attention,
            "fused_text_layer": ftl.fused_text_layer,
            "fused_rect_attn_half": frl.fused_rect_attn_half,
            "fused_mlp_half": frl.fused_mlp_half,
            "device_eval_preprocess": preprocess.device_eval_preprocess,
            "device_train_preprocess": preprocess.device_train_preprocess}
    unknown = set(kernels or {}) - set(slot)
    if unknown:
        raise KeyError(f"no kernel slot {sorted(unknown)}; the slots are {SLOTS}")
    slot.update(kernels or {})
    table: List[Check] = []

    def add(name, kernel, shape, bound, kind="compare"):
        def register(fn):
            table.append(Check(name, kernel, tuple(shape), bound, fn, kind))
            return fn
        return register

    def dname(dtype) -> str:
        return str(dtype)[6:]

    # -- rect attention ------------------------------------------------------
    def rect_check(name, shape, dtype, paired, layout):
        bound = tol if dtype == BF16 else F32_TOL

        @add(name, "rect_attention", shape, bound)
        def run():
            B, H, Lq, Lk, D = shape
            gen = generator(name, device)
            with torch.no_grad():
                if paired:
                    q, k, v = (torch.randn(B, H, n, D, generator=gen, device=device).to(dtype)
                               for n in (Lq, Lk, Lk))
                    out = ra.pair_heads(slot["rect_attention"](
                        *(ra.unpair_heads(t, D // 2) for t in (q, k, v))))
                    ref = ra.pair_heads(ra.rect_attention_reference(
                        *(ra.unpair_heads(t, D // 2) for t in (q, k, v))))
                else:
                    q, k, v = layout(gen, B, H, Lq, Lk, D, dtype, device)
                    out = slot["rect_attention"](q, k, v)
                    ref = ra.rect_attention_reference(q, k, v)
            err = _max_err(out, ref)
            return Reading(err, _finite(out), f"tol {bound:g}", err)

    for label, shape, dtype, paired in RECT_CHECKS:
        rect_check(f"kernel rect_attention {label} {shape} {dname(dtype)}", shape, dtype, paired,
                   path_layout_qkv)

    name = ("kernel rect_attention (100,12,197,197,64) bf16 against an f64 evaluation of its "
            "contract")

    @add(name, "rect_attention", (100, 12, 197, 197, 64), CONTRACT_RATIO, "contract")
    def rect_contract(name=name):
        q, k, v = fused_qkv(generator(name, device), 100, 12, 197, 64, BF16, device)
        return contract_reading(lambda: slot["rect_attention"](q, k, v),
                                lambda: ra.rect_attention_reference(q, k, v), q, k, v)

    @add("kernel rect_attention refuses f32 (1,1,8,197,128)", "rect_attention",
         (1, 1, 8, 197, 128), 0.0, "refusal")
    def rect_refuses_f32():
        z = torch.zeros(1, 1, 197, 128, device=device)
        return _refusal(lambda: slot["rect_attention"](z[:, :, :8], z, z), ValueError)

    for label, shape in TRAIN_SHAPES:
        rect_check(f"kernel rect_attention {label} {shape} bf16", shape, BF16, False,
                   train_layout_qkv)

    # -- masked attention ----------------------------------------------------
    def masked_check(label, shape, kind, dtype):
        B, H, L, D = shape
        bias_shape = (1 if kind in SHARED_BIASES else B, 1, L, L)
        name = (f"kernel masked_attention {label} {(B, H, L, L, D)} bias {bias_shape} "
                f"{dname(dtype)}")
        bound = tol if dtype == BF16 else F32_TOL

        @add(name, "masked_attention", (B, H, L, L, D), bound)
        def run():
            q, k, v = fused_qkv(generator(name, device), B, H, L, D, dtype, device)
            bias = attention_bias(kind, B, L, device)
            with torch.no_grad():
                out = slot["masked_attention"](q, k, v, bias)
                ref = ma.masked_attention_reference(q, k, v, bias)
                # a shared bias is read in place: as a per-batch copy
                same = bias.shape[0] != 1 or torch.equal(out, slot["masked_attention"](
                    q, k, v, bias.expand(B, 1, L, L).contiguous()))
            err = _max_err(out, ref)
            return Reading(err, _finite(out) and same,
                           f"tol {bound:g}; shared bias equal to a per-batch copy: {same}", err)

    for label, shape, kind, dtype in MASKED_CHECKS:
        masked_check(label, shape, kind, dtype)

    @add("kernel masked_attention refuses a (2,1,77,1) bias", "masked_attention",
         (2, 2, 77, 77, 64), 0.0, "refusal")
    def masked_refuses_column_bias():
        z = torch.zeros(2, 2, 77, 64, device=device, dtype=BF16)
        bias = torch.zeros(2, 1, 77, 1, device=device)
        return _refusal(lambda: slot["masked_attention"](z, z, z, bias), ValueError)

    # the contract at the text towers' lengths: 5 score tiles at L = 77, 2
    # at 24 and 16, each with the shared causal bias
    def masked_contract(L):
        name = (f"kernel masked_attention (51,8,{L},{L},64) shared causal bf16 against an f64 "
                "evaluation of its contract")

        @add(name, "masked_attention", (51, 8, L, L, 64), CONTRACT_RATIO, "contract")
        def run():
            q, k, v = fused_qkv(generator(name, device), 51, 8, L, 64, BF16, device)
            bias = attention_bias("causal", 51, L, device)
            return contract_reading(lambda: slot["masked_attention"](q, k, v, bias),
                                    lambda: ma.masked_attention_reference(q, k, v, bias),
                                    q, k, v, bias)

    for L in (77, 24, 16):
        masked_contract(L)

    # the baselines' train steps: the frozen image tower's square 197 rows
    # at CoOp's batch 32 and at batch 1 (CoCoOp, LP)
    for B in (BASELINE_TRAIN_BATCH, 1):
        shape = (B, 12, 197, 197, 64)
        rect_check(f"kernel rect_attention baseline train {shape} bf16", shape, BF16, False,
                   lambda gen, B, H, Lq, Lk, D, dtype, dev: fused_qkv(gen, B, H, Lk, D, dtype,
                                                                       dev))

    # under grad in the baselines' text towers: CoOp's 10 classes a step and
    # CoCoOp's 10 at batch 1, CoCoOp's chunk of 8 images x 10 classes at
    # batch 16, L = 16 on Synthetic (dq, dk and dv: the prompts' embeddings
    # require grad)
    def masked_grad(B, H=8, L=16, D=64):
        name = (f"kernel masked_attention under grad ({B},{H},{L},{L},{D}) shared causal bf16, "
                "dq dk dv against autograd through the plain version")

        @add(name, "masked_attention", (B, H, L, L, D), tol)
        def run():
            gen = generator(name, device)
            q, k, v = (t.detach().requires_grad_(True)
                       for t in fused_qkv(gen, B, H, L, D, BF16, device))
            bias = attention_bias("causal", B, L, device)
            with torch.enable_grad():
                out = slot["masked_attention"](q, k, v, bias)
                g = torch.randn(out.shape, generator=gen, device=device).to(out.dtype)
                got = torch.autograd.grad(out, (q, k, v), g)
                want = torch.autograd.grad(ma.masked_attention_reference(q, k, v, bias),
                                           (q, k, v), g)
            return Reading(_grads_err(got, want), all(map(_finite, got)),
                           f"max_abs_err / max(max|g|, 1), tol {tol:g}")

    for B in (10, 80):
        masked_grad(B)

    # -- the fused text layer ------------------------------------------------
    def fused_text_check(label, shape):
        N, L, d, heads = shape
        name = f"kernel fused_text_layer {label} {(N, L, d)} {heads} heads bf16"

        @add(name, "fused_text_layer", shape, 1.0)
        def run():
            gen = generator(name, device)
            raw = random_block(gen, d, device)
            blk = ftl.with_kernel_layout(raw)
            x = torch.randn(N, L, d, generator=gen, device=device).to(BF16)
            causal = attention_bias("causal", 1, L, device)[0, 0]
            with torch.no_grad():
                out = slot["fused_text_layer"](x, blk, heads, causal)
                ref = ftl.fused_text_layer_reference(x, blk, heads, causal)
                # the weights laid out at the launch instead of once beforehand
                same = torch.equal(out, slot["fused_text_layer"](x, raw, heads, causal))
            err, mean, worst = fused_errors(out, ref, tol)
            return Reading(worst, mean <= FUSED_MEAN_TOL and same and _finite(out),
                           f"max_abs_err {err:.3e}, max err / tol {worst:.3f} (tol {tol:g} x "
                           f"max(|plain|, 1) each), mean {mean:.3e} (tol {FUSED_MEAN_TOL:g}); "
                           f"per-launch layout gives the same output: {same}", err)

    for label, shape in FUSED_TEXT_CHECKS:
        fused_text_check(label, shape)

    def fused_text_control(label, shape):
        N, L, d, heads = shape
        name = (f"kernel fused_text_layer {label} {(N, L, d)}: the bounds reject the plain "
                "version without out_b (std 0.02)")

        @add(name, "fused_text_layer", shape, math.inf, "control")
        def run():
            gen = generator(name, device)
            blk = ftl.with_kernel_layout(random_block(gen, d, device))
            x = torch.randn(N, L, d, generator=gen, device=device).to(BF16)
            causal = attention_bias("causal", 1, L, device)[0, 0]
            no_bias = {**blk, "attn": {**blk["attn"],
                                       "out_b": torch.zeros_like(blk["attn"]["out_b"])}}
            with torch.no_grad():
                out = slot["fused_text_layer"](x, blk, heads, causal)
                _, mean, worst = fused_errors(
                    out, ftl.fused_text_layer_reference(x, no_bias, heads, causal), tol)
            caught = worst > 1 or mean > FUSED_MEAN_TOL
            return Reading(worst, caught, f"mean {mean:.3e}, max err / tol {worst:.3f}: "
                           f"{'caught' if caught else 'NOT caught'}")

    fused_text_control(*FUSED_TEXT_CHECKS[0])

    @add("kernel fused_text_layer refuses f32", "fused_text_layer", (13, 16, 64, 2), 0.0,
         "refusal")
    def fused_text_refuses_f32():
        gen = generator("kernel fused_text_layer refuses f32", device)
        blk = ftl.with_kernel_layout(random_block(gen, 64, device))
        x = torch.randn(13, 16, 64, generator=gen, device=device)
        causal = attention_bias("causal", 1, 16, device)[0, 0]
        with torch.no_grad():
            return _refusal(lambda: slot["fused_text_layer"](x, blk, 2, causal), TypeError)

    # -- the fused rect halves -------------------------------------------------
    def halves(gen, shape):
        B, L, d, heads, n_kv = shape
        raw = random_block(gen, d, device)
        return raw, ftl.with_kernel_layout(raw), torch.randn(B, L, d, generator=gen,
                                                             device=device).to(BF16)

    def rect_half_check(what, label, shape):
        B, L, d, heads, n_kv = shape
        name = f"kernel {what} {label} {(B, L, d)} n_kv {n_kv} {heads} heads bf16"

        @add(name, what, shape, 1.0)
        def run():
            raw, blk, x = halves(generator(name, device), shape)
            with torch.no_grad():
                if what == "fused_rect_attn_half":
                    out = slot[what](x, blk["ln_1"], blk["attn"], heads, n_kv,
                                     kernel=blk["kernel"])
                    ref = frl.fused_rect_attn_half_reference(x, blk["ln_1"], blk["attn"], heads,
                                                             n_kv)
                    per_launch = slot[what](x, raw["ln_1"], raw["attn"], heads, n_kv)
                else:
                    out = slot[what](x, blk["ln_2"], blk["mlp"], kernel=blk["kernel"])
                    ref = frl.fused_mlp_half_reference(x, blk["ln_2"], blk["mlp"])
                    per_launch = slot[what](x, raw["ln_2"], raw["mlp"])
            err, mean, worst = fused_errors(out, ref, tol)
            same = torch.equal(out, per_launch)
            return Reading(worst, mean <= FUSED_MEAN_TOL and same and _finite(out),
                           f"max_abs_err {err:.3e}, max err / tol {worst:.3f} (tol {tol:g} x "
                           f"max(|plain|, 1) each), mean {mean:.3e} (tol {FUSED_MEAN_TOL:g}); "
                           f"per-launch layout gives the same output: {same}", err)

    for label, shape in RECT_HALF_CHECKS:
        for what in ("fused_rect_attn_half", "fused_mlp_half"):
            rect_half_check(what, label, shape)

    def rect_half_control(what, bias, label, shape):
        B, L, d, heads, n_kv = shape
        name = (f"kernel {what} {label}: the bounds reject the plain version without {bias} "
                "(std 0.02)")

        @add(name, what, shape, math.inf, "control")
        def run():
            _, blk, x = halves(generator(name, device), shape)
            with torch.no_grad():
                if what == "fused_rect_attn_half":
                    out = slot[what](x, blk["ln_1"], blk["attn"], heads, n_kv,
                                     kernel=blk["kernel"])
                    attn = {**blk["attn"], bias: torch.zeros_like(blk["attn"][bias])}
                    ref = frl.fused_rect_attn_half_reference(x, blk["ln_1"], attn, heads, n_kv)
                else:
                    out = slot[what](x, blk["ln_2"], blk["mlp"], kernel=blk["kernel"])
                    mlp = {**blk["mlp"], bias: torch.zeros_like(blk["mlp"][bias])}
                    ref = frl.fused_mlp_half_reference(x, blk["ln_2"], mlp)
            _, mean, worst = fused_errors(out, ref, tol)
            caught = worst > 1 or mean > FUSED_MEAN_TOL
            return Reading(worst, caught, f"mean {mean:.3e}, max err / tol {worst:.3f}: "
                           f"{'caught' if caught else 'NOT caught'}")

    rect_half_control("fused_rect_attn_half", "out_b", *RECT_HALF_CHECKS[0])
    rect_half_control("fused_mlp_half", "proj_b", *RECT_HALF_CHECKS[0])

    edge = RECT_HALF_CHECKS[-1][1]

    @add("kernel fused_rect_attn_half refuses f32", "fused_rect_attn_half", edge, 0.0, "refusal")
    def attn_half_refuses_f32():
        _, blk, x = halves(generator("kernel fused_rect_attn_half refuses f32", device), edge)
        with torch.no_grad():
            return _refusal(lambda: slot["fused_rect_attn_half"](
                x.float(), blk["ln_1"], blk["attn"], edge[3], edge[4]), TypeError)

    @add("kernel fused_mlp_half refuses a grad-enabled input", "fused_mlp_half", edge, 0.0,
         "refusal")
    def mlp_half_refuses_grad():
        _, blk, x = halves(generator("kernel fused_mlp_half refuses a grad-enabled input",
                                     device), edge)
        with torch.enable_grad():
            return _refusal(lambda: slot["fused_mlp_half"](
                x.clone().requires_grad_(True), blk["ln_2"], blk["mlp"]), RuntimeError)

    # -- the JAX selftest's checks that the phase-3 list lacked ----------------
    name = ("kernel rect_attention paired backward (4, 6, 221, 197, 128) bf16, dq dk dv against "
            "autograd through the plain version")

    @add(name, "rect_attention", (4, 6, 221, 197, 128), tol)
    def paired_backward(name=name):
        B, H2, Lq, Lk, D2 = 4, 6, 221, 197, 128
        gen = generator(name, device)
        q2, k2, v2 = (torch.randn(B, H2, n, D2, generator=gen, device=device).to(BF16)
                      .requires_grad_(True) for n in (Lq, Lk, Lk))
        with torch.enable_grad():
            out = ra.pair_heads(slot["rect_attention"](
                *(ra.unpair_heads(t, D2 // 2) for t in (q2, k2, v2))))
            g = torch.randn(out.shape, generator=gen, device=device).to(out.dtype)
            got = torch.autograd.grad(out, (q2, k2, v2), g)
            ref = ra.pair_heads(ra.rect_attention_reference(
                *(ra.unpair_heads(t, D2 // 2) for t in (q2, k2, v2))))
            want = torch.autograd.grad(ref, (q2, k2, v2), g)
        return Reading(_grads_err(got, want), all(map(_finite, got)),
                       f"max_abs_err / max(max|g|, 1), tol {tol:g}")

    name = ("kernel rect_attention rect residual block (4, 221, 768) 12 heads n_kv 197 bf16, the "
            "whole layer against plain attention")

    @add(name, "rect_attention", (4, 221, 768, 12, 197), tol)
    def residual_block(name=name):
        gen = generator(name, device)
        blk = random_block(gen, 768, device)
        x = (torch.randn(4, 221, 768, generator=gen, device=device) * 0.1).to(BF16)
        with torch.no_grad():
            out = rect_residual_block(x, blk, 12, 197, rect_attn=slot["rect_attention"])
            ref = rect_residual_block(x, blk, 12, 197, rect_attn=ra.rect_attention_reference)
        err = _max_err(out, ref)
        rel = ((out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
        return Reading(rel, _finite(out), f"max_abs_err {err:.3e}; max err / max(|plain|, 1), "
                       f"tol {tol:g}", err)

    # the device preprocess (INPUT.DEVICE_RESIZE) against the host's
    # Pillow-exact resample, within two uint8 steps in normalised units
    mean_h = np.asarray(CLIP_MEAN, np.float32) * 255.0
    std_h = np.asarray(CLIP_STD, np.float32) * 255.0
    name = ("kernel device_eval_preprocess (4, 64, 64) -> 224 + (4, 48, 48) -> 32 vs the host "
            "resample")

    @add(name, "device_eval_preprocess", (4, 64, 64, 224), U8_TOL)
    def eval_preprocess(name=name):
        r = np.random.RandomState(zlib.crc32(name.encode()))
        errs = []
        for S, out_size in ((64, 224), (48, 32)):
            src = r.randint(0, 256, size=(4, S, S, 3)).astype(np.uint8)
            out = slot["device_eval_preprocess"](torch.from_numpy(src).to(device), out_size,
                                                 CLIP_MEAN, CLIP_STD).float().cpu().numpy()
            for i in range(len(src)):
                ref = host.center_crop(host.resize_shorter(src[i], out_size, "bicubic"),
                                       out_size).astype(np.float32)
                errs.append(np.abs(out[i] - (ref - mean_h) / std_h).max())
        err = float(max(errs))
        return Reading(err, bool(np.isfinite(err)), f"tol {U8_TOL:.4g} (2.01 uint8 steps)", err)

    name = ("kernel device_train_preprocess (4, 64, 64) -> 224 + (4, 16, 16) -> 32, boxes and "
            "flips, vs the host resample")

    @add(name, "device_train_preprocess", (4, 64, 64, 224), U8_TOL)
    def train_preprocess(name=name):
        r = np.random.RandomState(zlib.crc32(name.encode()))
        rr = random.Random(11)
        errs = []
        for S, out_size in ((64, 224), (16, 32)):
            B = 4
            src = r.randint(0, 256, size=(B, S, S, 3)).astype(np.uint8)
            boxes = [(0, 0, S, S)] + [host.sample_rrc_box(S, S, rng=rr) for _ in range(B - 1)]
            flips = [i % 2 for i in range(B)]
            out = slot["device_train_preprocess"](
                torch.from_numpy(src).to(device),
                torch.tensor(boxes, dtype=torch.int32, device=device),
                torch.tensor(flips, dtype=torch.int32, device=device),
                out_size, CLIP_MEAN, CLIP_STD).float().cpu().numpy()
            for i, ((left, top, cw, ch), flip) in enumerate(zip(boxes, flips)):
                ref = host.resample(src[i], (out_size, out_size), "bicubic",
                                    box=(left, top, left + cw, top + ch)).astype(np.float32)
                if flip:
                    ref = ref[:, ::-1]
                errs.append(np.abs(out[i] - (ref - mean_h) / std_h).max())
        err = float(max(errs))
        return Reading(err, bool(np.isfinite(err)), f"tol {U8_TOL:.4g} (2.01 uint8 steps)", err)

    return table


# ---- the runner -------------------------------------------------------------

def is_cuda_error(exc: BaseException) -> bool:
    """Whether ``exc`` reports a CUDA error, after which the context may be
    unusable: torch's CUDA error types, a ``CUDA error`` message, or a
    wrapper's failed launch."""
    accelerator = getattr(torch, "AcceleratorError", None)
    if isinstance(exc, torch.cuda.CudaError) or (accelerator and isinstance(exc, accelerator)):
        return True
    return isinstance(exc, RuntimeError) and any(
        w in str(exc) for w in ("CUDA error", "kernel launch failed"))


def _status(reading: Reading, bound: float) -> str:
    if reading.ok and reading.err <= bound:
        status = f"ok (err={reading.err:.2e})"
    elif reading.err > bound:
        status = f"FAILED: mismatch err={reading.err:.3e} >= tol={bound:.3g}"
    else:
        status = f"FAILED: mismatch err={reading.err:.3e}"
    return f"{status}; {reading.detail}" if reading.detail else status


def run_checks(table, retries: int = 1, verbose: bool = True) -> dict:
    """Run each check isolated; the JAX package's results dict:

    {"metric": "kernel_selftest", "value": n_passed, "unit": "checks",
     "total": n, "checks": {name: "ok (err=..)" | "FAILED: ..." |
     "not run: ..."}, "max_abs_err": {name: err}}

    Never raises on a check's fault: a failure is a string in ``checks``."""
    results: Dict[str, str] = {}
    errors: Dict[str, float] = {}
    n_pass = 0
    lost = None  # the check whose CUDA error ended the run
    for check in table:
        if lost is not None:
            status = f"not run: CUDA context lost at {lost}"
        else:
            for attempt in range(retries + 1):
                try:
                    reading = check.run()
                except Exception as exc:  # noqa: BLE001 - isolation is the point
                    status = f"FAILED: {type(exc).__name__}: {exc}"
                    if verbose:
                        traceback.print_exc(file=sys.stderr)
                    if is_cuda_error(exc):
                        lost = check.name
                        break
                    continue
                if not isinstance(reading, Reading):
                    reading = Reading(float(reading))
                status = _status(reading, check.bound)
                if reading.max_abs_err is not None:
                    errors[check.name] = reading.max_abs_err
                break
        results[check.name] = status
        n_pass += status.startswith("ok")
        if verbose:
            print(f"kernel selftest: {check.name}: {status}", file=sys.stderr, flush=True)
    return {"metric": "kernel_selftest", "value": n_pass, "unit": "checks",
            "total": len(results), "checks": results, "max_abs_err": errors}


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, else why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not available ({type(exc).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "not available (no output)"


def run_selftest(tol: float = BF16_TOL, retries: int = 1, verbose: bool = True, device=None,
                 *, kernels: Optional[Mapping[str, Callable]] = None,
                 only: Optional[Callable[[Check], bool]] = None) -> dict:
    """Every check of ``checks()`` on ``device`` (None: the CUDA card,
    through ``resolve_device``, which raises without one), isolated, with
    ``retries`` retries of an exception that is not a CUDA error; the
    results dict of ``run_checks`` with ``backend``, ``device``,
    ``seconds`` and ``nvidia_smi``.

    ``kernels`` and ``only`` are for the CPU tests: functions in the
    kernels' slots, and the checks to run.  On the CPU ``kernels`` is
    required."""
    from ..device import resolve_device

    device = resolve_device(device)
    if device.type != "cuda" and kernels is None:
        raise RuntimeError(
            f"the kernel selftest holds the CUDA kernels on a card; on {device} the wrappers run "
            "their plain versions, so the checks would hold them to themselves (the CPU tests "
            "pass kernels= to put functions in the kernels' slots)")
    t0 = time.perf_counter()
    table = checks(tol, device, kernels)
    if only is not None:
        table = [c for c in table if only(c)]
    out = run_checks(table, retries, verbose)
    errors = out.pop("max_abs_err")
    out.update(backend=device.type,
               device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               seconds=round(time.perf_counter() - t0, 1), nvidia_smi=nvidia_smi_line(),
               max_abs_err=errors)
    return out


def first_max_abs_err(results: dict, kernel: str) -> Optional[float]:
    """The max abs error of the first comparison of ``kernel`` in the
    table's order, the main path's shape (None if it did not run)."""
    prefix = f"kernel {kernel} "
    return next((err for name, err in results["max_abs_err"].items()
                 if name.startswith(prefix)), None)
