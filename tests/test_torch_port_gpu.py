"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each skips without a CUDA card.  This file imports no JAX
(the machine with the card has none), so it runs there without the JAX
package's conftest:

    python -m pytest --noconftest -q tests/test_torch_port_gpu.py
"""
import numpy as np
import pytest
import torch

from rpo_tpu_torch.methods.rpo import build_text_mask, build_visual_mask
from rpo_tpu_torch.models.clip.model import causal_mask
from rpo_tpu_torch.ops import masked_attention as ma
from rpo_tpu_torch.ops import rect_attention as ra


@pytest.fixture(autouse=True)
def full_precision_matmuls():
    """No TF32 and no reduced-precision bf16 reduction in cuBLAS: the
    port's parity contract is "accumulate in f32, round once"."""
    flags = (torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"), (
        torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction")
    saved = [getattr(obj, name) for obj, name in flags]
    for obj, name in flags:
        setattr(obj, name, False)
    yield
    for (obj, name), value in zip(flags, saved):
        setattr(obj, name, value)


def _path_layout(gen, B, H, Lq, Lk, D, dtype):
    """q, k, v as the rect eval tower hands them over: head views of the
    projection outputs (B, Lq, H*D) and (B, Lk, 2*H*D)."""
    q = torch.randn(B, Lq, H * D, generator=gen, device="cuda").to(dtype)
    kv = torch.randn(B, Lk, 2 * H * D, generator=gen, device="cuda").to(dtype)
    q = q.view(B, Lq, H, D).permute(0, 2, 1, 3)
    kv = kv.view(B, Lk, 2 * H, D).permute(0, 2, 1, 3)
    return q, kv[:, :H], kv[:, H:]


def _train_layout(gen, B, H, Lq, Lk, D, dtype):
    """q, k, v as the split vision tower hands them over: k and v head
    views of the frozen rows' fused QKV output (B, Lk, 3*H*D); q from the
    same output (frozen rows, Lq = Lk) or from the prompt rows' q
    projection (B, Lq, H*D)."""
    qkv = torch.randn(B, Lk, 3 * H * D, generator=gen, device="cuda").to(dtype)
    qkv = qkv.view(B, Lk, 3, H, D).permute(2, 0, 3, 1, 4)
    if Lq == Lk:
        return qkv[0], qkv[1], qkv[2]
    q = torch.randn(B, Lq, H * D, generator=gen, device="cuda").to(dtype)
    return q.view(B, Lq, H, D).permute(0, 2, 1, 3), qkv[1], qkv[2]


BF16 = torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,dtype,tol,layout",
    [
        ((100, 12, 221, 197, 64), BF16, 2e-2, "contiguous"),
        ((3, 2, 9, 5, 32), torch.float32, 1e-5, "contiguous"),
        ((2, 12, 221, 197, 64), torch.float32, 1e-5, "contiguous"),
        ((2, 4, 221, 197, 128), BF16, 2e-2, "contiguous"),
        ((2, 3, 70, 130, 32), BF16, 2e-2, "contiguous"),
        ((2, 2, 33, 300, 64), BF16, 2e-2, "contiguous"),  # Lk > 256: the two-pass route
        # the bf16 kernel's edges: Lq 1 and 17 (one row, one row into a
        # second tile), Lk either side of the 16-column pad (1, 16, 17) and
        # of the widest row held in registers (256 | 257 at D <= 64, 128 |
        # 129 at D = 128), the path's strided views, head dims 32 and 128
        ((2, 3, 1, 1, 64), BF16, 2e-2, "contiguous"),
        ((2, 3, 17, 16, 64), BF16, 2e-2, "contiguous"),
        ((2, 3, 17, 17, 64), BF16, 2e-2, "path"),
        ((2, 2, 17, 256, 64), BF16, 2e-2, "path"),
        ((2, 2, 17, 257, 64), BF16, 2e-2, "path"),
        ((2, 2, 1, 300, 64), BF16, 2e-2, "path"),
        ((5, 12, 221, 197, 64), BF16, 2e-2, "path"),
        ((2, 4, 17, 1, 32), BF16, 2e-2, "path"),
        ((2, 4, 1, 257, 32), BF16, 2e-2, "path"),
        ((2, 4, 17, 16, 128), BF16, 2e-2, "path"),
        ((2, 4, 17, 128, 128), BF16, 2e-2, "path"),
        ((2, 4, 33, 129, 128), BF16, 2e-2, "path"),
        ((2, 4, 17, 300, 128), BF16, 2e-2, "path"),
        # the split vision tower of the RPO train step at batch 4: the
        # frozen rows, and the 24 prompt rows over them
        ((4, 12, 197, 197, 64), BF16, 2e-2, "train"),
        ((4, 12, 24, 197, 64), BF16, 2e-2, "train"),
    ],
)
def test_kernel_matches_plain_version_on_gpu(shape, dtype, tol, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H, Lq, Lk, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    if layout == "path":
        q, k, v = _path_layout(gen, B, H, Lq, Lk, D, dtype)
    elif layout == "train":
        q, k, v = _train_layout(gen, B, H, Lq, Lk, D, dtype)
    else:
        q, k, v = (
            torch.randn(B, H, n, D, generator=gen, device="cuda").to(dtype) for n in (Lq, Lk, Lk)
        )
    before = ra.launches
    got = ra.rect_attention(q, k, v)
    torch.cuda.synchronize()
    assert ra.launches == before + 1
    assert bool(torch.isfinite(got).all())
    err = (got.float() - ra.rect_attention_reference(q, k, v).float()).abs().max().item()
    assert err <= tol


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(1, 1, 8, 128, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        ra.rect_attention(q, torch.zeros(1, 1, 197, 128, device="cuda"),
                          torch.zeros(1, 1, 197, 128, device="cuda"))
    kv = torch.zeros(1, 1, 769, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        ra.rect_attention(kv[:, :, :8], kv, kv)
    with pytest.raises(ValueError, match="head dim"):
        ra.rect_attention(*(torch.zeros(1, 1, 8, 48, device="cuda"),) * 3)
    with pytest.raises(TypeError):
        ra.rect_attention(*(torch.zeros(1, 1, 8, 64, device="cuda", dtype=torch.float16),) * 3)


@pytest.mark.gpu
def test_backward_through_the_kernel_on_gpu():
    """The kernel's forward under autograd, with the plain recompute as
    its backward, against autograd through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    base = [torch.randn(2, 3, n, 64, generator=gen, device="cuda") for n in (21, 17, 17)]
    cot = torch.randn(2, 3, 21, 64, generator=gen, device="cuda")
    grads = []
    for fn in (ra.rect_attention, ra.rect_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in base]
        (fn(*leaves) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _bias(kind, B, L):
    """The f32 biases of the masked kernel's paths, on the card."""
    if kind == "shared causal":
        return causal_mask(L, "cuda")[None, None]
    if kind == "per-class text mask":
        return torch.from_numpy(build_text_mask(np.arange(B) % (L - 8) + 4, L)).cuda()
    if kind == "shared visual mask":
        return torch.from_numpy(build_visual_mask(L, 24)).cuda()
    if kind == "per-batch, one row fully masked":
        bias = causal_mask(L, "cuda")[None, None].repeat(B, 1, 1, 1)
        bias[1, 0, 4, :] = -1e9
        return bias
    raise KeyError(kind)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,kind,dtype,tol",
    [
        ((51, 8, 77, 64), "shared causal", torch.bfloat16, 2e-2),
        ((51, 8, 24, 64), "shared causal", torch.bfloat16, 2e-2),
        ((51, 8, 77, 64), "per-class text mask", torch.bfloat16, 2e-2),
        ((4, 12, 221, 64), "shared visual mask", torch.bfloat16, 2e-2),
        ((3, 2, 10, 32), "per-batch, one row fully masked", torch.float32, 1e-5),
        ((2, 4, 77, 128), "shared causal", torch.bfloat16, 2e-2),
        ((2, 3, 70, 32), "per-class text mask", torch.bfloat16, 2e-2),
        # short L, several (b, h) a block (4 at L = 16, 2 at 24), B*H not a
        # multiple of that: the last block ragged
        ((3, 5, 16, 64), "shared causal", torch.bfloat16, 2e-2),
        ((3, 5, 16, 64), "per-class text mask", torch.bfloat16, 2e-2),
        ((3, 5, 16, 64), "per-batch, one row fully masked", torch.bfloat16, 2e-2),
        ((3, 3, 24, 64), "per-class text mask", torch.bfloat16, 2e-2),
        ((3, 3, 24, 64), "per-batch, one row fully masked", torch.bfloat16, 2e-2),
        ((7, 3, 77, 64), "per-batch, one row fully masked", torch.bfloat16, 2e-2),
        ((5, 3, 16, 32), "per-class text mask", torch.bfloat16, 2e-2),
        ((3, 5, 16, 128), "shared causal", torch.bfloat16, 2e-2),
    ],
)
def test_masked_kernel_matches_plain_version_on_gpu(shape, kind, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H, L, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, H, L, D, generator=gen, device="cuda").to(dtype) for _ in range(3))
    bias = _bias(kind, B, L)
    before = ma.launches
    got = ma.masked_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert ma.launches == before + 1
    want = ma.masked_attention_reference(q, k, v, bias)
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= tol
    if bias.shape[0] == 1:  # read in place: the same as a per-batch copy
        copy = ma.masked_attention(q, k, v, bias.expand(B, 1, L, L).contiguous())
        assert torch.equal(got, copy)


@pytest.mark.gpu
def test_masked_kernel_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    z = torch.zeros(2, 2, 8, 64, device="cuda")
    with pytest.raises(ValueError, match="last two dims"):
        ma.masked_attention(z, z, z, torch.zeros(1, 1, 8, 1, device="cuda"))
    with pytest.raises(ValueError, match="square"):
        ma.masked_attention(z, z[:, :, :5], z[:, :, :5], torch.zeros(1, 1, 8, 5, device="cuda"))
    with pytest.raises(ValueError, match="head dim"):
        ma.masked_attention(*(torch.zeros(1, 1, 8, 48, device="cuda"),) * 3,
                            torch.zeros(1, 1, 8, 8, device="cuda"))


@pytest.mark.gpu
def test_backward_through_the_masked_kernel_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    base = [torch.randn(3, 2, 21, 64, generator=gen, device="cuda") for _ in range(3)]
    cot = torch.randn(3, 2, 21, 64, generator=gen, device="cuda")
    bias = _bias("per-batch, one row fully masked", 3, 21)
    grads = []
    for fn in (ma.masked_attention, ma.masked_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in base]
        (fn(*leaves, bias) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _text_block(gen, d):
    """One text layer's bf16 params on the card: CLIP's init scales, with
    nonzero biases and LayerNorm parameters other than (1, 0)."""
    def normal(*shape, std):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    return {
        "ln_1": {"scale": 1 + normal(d, std=0.1), "bias": normal(d, std=0.1)},
        "attn": {"qkv_w": normal(d, 3 * d, std=d ** -0.5), "qkv_b": normal(3 * d, std=0.02),
                 "out_w": normal(d, d, std=d ** -0.5 / 5), "out_b": normal(d, std=0.02)},
        "ln_2": {"scale": 1 + normal(d, std=0.1), "bias": normal(d, std=0.1)},
        "mlp": {"fc_w": normal(d, 4 * d, std=(2 * d) ** -0.5), "fc_b": normal(4 * d, std=0.02),
                "proj_w": normal(4 * d, d, std=d ** -0.5 / 5), "proj_b": normal(d, std=0.02)},
    }


@pytest.mark.gpu
@pytest.mark.parametrize(
    "N,L,d,heads",
    [
        (510, 16, 512, 8),  # the CoCoOp eval chunk
        (13, 11, 64, 2),  # ragged N, L padded to 16 by the tower, head dim 32
        (4, 80, 512, 8),
        (3, 77, 768, 12),  # L padded to 80; the MLP in column passes
        # the weight ring's edges: K (d = 64) shorter than a stage, head dim 64
        (7, 16, 64, 1),
        # 2 sequences of 24 a block (48 rows, 3 row tiles), N odd: the last
        # block holds one
        (9, 24, 512, 8),
        (5, 16, 512, 16),  # head dim 32 at d = 512: 6 q/k/v tiles a head
        (6, 16, 768, 12),  # d = 768 at 64 rows: two column blocks, a 3-stage ring
        (2, 80, 768, 12),  # d = 768, L = 80: 2 x 2 passes, the smallest ring
    ],
)
def test_fused_text_layer_matches_plain_version_on_gpu(N, L, d, heads):
    """Through ``fused_text_tower`` with a one-layer stack, so that L = 11
    and 77 take the tower's padding, with the weights laid out at each
    launch and once beforehand (``with_kernel_layout``): the same output.
    Tolerance, each element: 2e-2 of max(|plain|, 1) (a bf16 rounding flip
    from summation order is at most 2^-7 of the element); the mean: 1e-4
    (0 to 3.7e-5 on the H100; a dropped bias of std 0.02 gives ~1.6e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.ops import fused_text_layer as ftl

    gen = torch.Generator(device="cuda").manual_seed(0)
    blocks = {k: {n: t[None] for n, t in v.items()} for k, v in _text_block(gen, d).items()}
    x = torch.randn(N, L, d, generator=gen, device="cuda").to(torch.bfloat16)
    mask = causal_mask(L, "cuda")
    before = ftl.launches
    with torch.no_grad():
        got = ftl.fused_text_tower(x, blocks, heads, mask)
        torch.cuda.synchronize()
        assert ftl.launches == before + 1
        assert torch.equal(got, ftl.fused_text_tower(x, ftl.with_kernel_layout(blocks), heads,
                                                     mask))
        want = ftl.fused_text_tower(x, blocks, heads, mask, layer=ftl.fused_text_layer_reference)
    assert tuple(got.shape) == (N, L, d) and bool(torch.isfinite(got).all())
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 2e-2 * want.float().abs().clamp(min=1.0)).all())
    assert diff.mean().item() <= 1e-4


@pytest.mark.gpu
def test_fused_text_layer_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.ops import fused_text_layer as ftl

    gen = torch.Generator(device="cuda").manual_seed(1)
    blk = _text_block(gen, 256)
    x = torch.zeros(2, 16, 256, device="cuda", dtype=torch.bfloat16)
    mask = causal_mask(16, "cuda")
    with torch.no_grad():
        with pytest.raises(TypeError, match="bfloat16"):
            ftl.fused_text_layer(x.float(), blk, 4, mask)
        with pytest.raises(ValueError, match="head dim"):
            ftl.fused_text_layer(x, blk, 2, mask)  # head dim 128
    with pytest.raises(RuntimeError, match="forward-only"):
        ftl.fused_text_layer(x.clone().requires_grad_(True), blk, 4, mask)


def _cuda_launches(fn, name):
    """The CUDA kernels whose names hold ``name`` that one call of ``fn``
    launches, by torch.profiler (after a warm call).  A profiler window
    can come back with no device event at all: such a window is taken
    again, up to three times, as ``tools.timing`` does."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            break
    return sum(e.count for e in device if name in e.key)


def _fused_errors(got, want):
    """(largest error over its element's tolerance 2e-2 x max(|plain|, 1),
    mean abs error) of a fused kernel against its plain version."""
    diff = (got.float() - want.float()).abs()
    return (diff / (2e-2 * want.float().abs().clamp(min=1.0))).max().item(), diff.mean().item()


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,L,d,heads,n_kv",
    [
        (100, 221, 768, 12, 197),  # the RPO eval vision layer
        (100, 197, 768, 12, 197),  # n_kv = L: the square tower
        (3, 37, 256, 4, 29),  # ragged: rows not a multiple of 16 or 64
        (3, 43, 768, 12, 40),  # 129 rows: one past the MLP GEMMs' 128-row tile
        (2, 64, 768, 12, 64),  # 128 rows: exactly one tile
        (2, 64, 64, 1, 50),  # d = 64: proj's N fills half a 128-column block
        (3, 13, 128, 2, 9),  # L 13: four (b, h) a block of the attention, the last ragged
        (2, 257, 128, 2, 256),  # n_kv 256: the attention's widest score row
    ],
)
def test_fused_rect_halves_match_plain_versions_on_gpu(B, L, d, heads, n_kv):
    """Each half against its plain version, element by element (2e-2 of
    max(|plain|, 1): a bf16 rounding flip from summation order is at most
    2^-7 of the element) and in the mean (1e-4; a dropped bias of std 0.02
    moves it by ~1.6e-2); one call each on the wrappers' counts, and on the
    device the CUDA launches their plans give (4: LN1, q/k/v, attention,
    out; 3: LN2, fc, proj); the weights laid out at the launch and once
    beforehand give the same output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.ops import fused_rect_layer as frl
    from rpo_tpu_torch.ops.fused_text_layer import with_kernel_layout

    gen = torch.Generator(device="cuda").manual_seed(2)
    blk = with_kernel_layout(_text_block(gen, d))
    x = torch.randn(B, L, d, generator=gen, device="cuda").to(torch.bfloat16)
    attn0, mlp0 = frl.attn_half_launches, frl.mlp_half_launches
    with torch.no_grad():
        a = frl.fused_rect_attn_half(x, blk["ln_1"], blk["attn"], heads, n_kv, kernel=blk["kernel"])
        m = frl.fused_mlp_half(x, blk["ln_2"], blk["mlp"], kernel=blk["kernel"])
        torch.cuda.synchronize()
        assert (frl.attn_half_launches, frl.mlp_half_launches) == (attn0 + 1, mlp0 + 1)
        assert torch.equal(a, frl.fused_rect_attn_half(x, blk["ln_1"], blk["attn"], heads, n_kv))
        assert torch.equal(m, frl.fused_mlp_half(x, blk["ln_2"], blk["mlp"]))
        a_ref = frl.fused_rect_attn_half_reference(x, blk["ln_1"], blk["attn"], heads, n_kv)
        m_ref = frl.fused_mlp_half_reference(x, blk["ln_2"], blk["mlp"])
        launches = {
            "fused_rect_attn_half": _cuda_launches(lambda: frl.fused_rect_attn_half(
                x, blk["ln_1"], blk["attn"], heads, n_kv, kernel=blk["kernel"]),
                "fused_rect_attn_half"),
            "fused_mlp_half": _cuda_launches(lambda: frl.fused_mlp_half(
                x, blk["ln_2"], blk["mlp"], kernel=blk["kernel"]), "fused_mlp_half"),
        }
    assert launches == {"fused_rect_attn_half": frl.attn_launch_plan(B, L, d, heads,
                                                                     n_kv)["launches"],
                        "fused_mlp_half": frl.mlp_launch_plan(B * L, d)["launches"]} == \
        {"fused_rect_attn_half": 4, "fused_mlp_half": 3}, launches
    for got, want in ((a, a_ref), (m, m_ref)):
        assert tuple(got.shape) == (B, L, d) and bool(torch.isfinite(got).all())
        worst, mean = _fused_errors(got, want)
        assert worst <= 1 and mean <= 1e-4, (worst, mean)


@pytest.mark.gpu
def test_fused_rect_bounds_catch_a_dropped_bias_on_gpu():
    """The plain versions without out_b, or without proj_b, fail the mean
    bound against the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.ops import fused_rect_layer as frl

    gen = torch.Generator(device="cuda").manual_seed(3)
    blk = _text_block(gen, 768)
    x = torch.randn(4, 221, 768, generator=gen, device="cuda").to(torch.bfloat16)
    no_out_b = {**blk["attn"], "out_b": torch.zeros_like(blk["attn"]["out_b"])}
    no_proj_b = {**blk["mlp"], "proj_b": torch.zeros_like(blk["mlp"]["proj_b"])}
    with torch.no_grad():
        a = frl.fused_rect_attn_half(x, blk["ln_1"], blk["attn"], 12, 197)
        m = frl.fused_mlp_half(x, blk["ln_2"], blk["mlp"])
        _, mean_a = _fused_errors(a, frl.fused_rect_attn_half_reference(x, blk["ln_1"], no_out_b,
                                                                         12, 197))
        _, mean_m = _fused_errors(m, frl.fused_mlp_half_reference(x, blk["ln_2"], no_proj_b))
    assert mean_a > 1e-4 and mean_m > 1e-4, (mean_a, mean_m)


@pytest.mark.gpu
def test_fused_rect_halves_raise_on_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.ops import fused_rect_layer as frl

    gen = torch.Generator(device="cuda").manual_seed(4)
    blk = _text_block(gen, 256)
    x = torch.zeros(2, 16, 256, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        with pytest.raises(TypeError, match="bfloat16"):
            frl.fused_rect_attn_half(x.float(), blk["ln_1"], blk["attn"], 4, 9)
        with pytest.raises(TypeError, match="bfloat16"):
            frl.fused_mlp_half(x.float(), blk["ln_2"], blk["mlp"])
        with pytest.raises(ValueError, match="head dim"):
            frl.fused_rect_attn_half(x, blk["ln_1"], blk["attn"], 8, 9)  # head dim 32
        with pytest.raises(ValueError, match="n_kv"):
            frl.fused_rect_attn_half(x, blk["ln_1"], blk["attn"], 4, 17)  # n_kv > L
    with pytest.raises(RuntimeError, match="forward-only"):
        frl.fused_rect_attn_half(x.clone().requires_grad_(True), blk["ln_1"], blk["attn"], 4, 9)
    with pytest.raises(RuntimeError, match="forward-only"):
        frl.fused_mlp_half(x.clone().requires_grad_(True), blk["ln_2"], blk["mlp"])


@pytest.mark.gpu
def test_rpo_train_step_kernels_against_plain_on_gpu():
    """The RPO train step at TINY_W128 in bf16 on the card: the masked
    kernel in the set-up, two rect launches a vision layer a step (frozen
    rows, prompt rows); loss, logits and prompt gradients against the
    same step fully on the plain versions (a K/V cache built with the
    plain masked attention, the plain rect attention in the tower); then
    three steps' losses.  Kernel and plain differ by bf16 rounding only:
    loss and logits within 5e-2 (chip_smoke's bound for logits), each
    gradient within 0.1 of its largest entry with a cosine >= 0.99."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.methods import rpo as core
    from rpo_tpu_torch.methods.rpo_trainer import RPO

    classnames = [f"object category {i}" for i in range(6)]
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    labels, mask = np.array([0, 3, 5, 1]), np.array([1, 1, 1, 0], np.float32)
    masked0, rect0 = ma.launches, ra.launches
    rpo = RPO(classnames, K=4, backbone="TINY_W128", prec="fp16", seed=1)
    assert ma.launches - masked0 == rpo.clip_cfg.text_layers
    loss, logits, grads = rpo.loss_and_grads(images, labels, mask)
    torch.cuda.synchronize()
    assert ra.launches - rect0 == 2 * rpo.clip_cfg.vision_layers
    plain = RPO(classnames, K=4, backbone="TINY_W128", prec="fp16", seed=1)
    plain._frozen = core.make_frozen(plain.clip_params, plain.task,
                                     masked_attn=ma.masked_attention_reference)
    refs = dict(rect_attn=ra.rect_attention_reference, masked_attn=ma.masked_attention_reference)
    rect1 = ra.launches
    p_loss, p_logits, p_grads = plain.loss_and_grads(images, labels, mask, **refs)
    assert ra.launches == rect1  # the plain run launches nothing
    assert bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (4, 6)
    assert abs(loss.item() - p_loss.item()) <= 5e-2
    assert (logits - p_logits).abs().max().item() <= 5e-2
    for key, g in grads.items():
        w = p_grads[key]
        err = (g - w).abs().max().item() / w.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0).item()
        assert err <= 0.1 and cos >= 0.99, (key, err, cos)
    for _ in range(3):
        a = rpo.train_step(images, labels, mask, 0.01)[0].item()
        b = plain.train_step(images, labels, mask, 0.01, **refs)[0].item()
        assert abs(a - b) <= 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("S,out", [(224, 224), (64, 224), (224, 64)])
def test_device_train_preprocess_on_gpu_equals_cpu(S, out):
    """The INPUT.DEVICE_RESIZE augmentation on the card against the same
    function on the CPU (which tests/test_torch_port_preprocess.py holds
    to the JAX package's): full-frame and random crop boxes, flips on and
    off; in uint8 steps (the normalisation undone and rounded) at most
    one step apart, on at most 1e-3 of the values (the two differ only in
    the order of the float32 sums, where a pass lands on a half step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.ops.preprocess import _mean_std_u8, device_train_preprocess

    rng = np.random.RandomState(5)
    n = 8
    imgs = torch.from_numpy(rng.randint(0, 256, (n, S, S, 3)).astype(np.uint8))
    w = rng.randint(S // 4, S + 1, n)
    h = rng.randint(S // 4, S + 1, n)
    left, top = rng.randint(0, S - w + 1), rng.randint(0, S - h + 1)
    boxes = torch.from_numpy(np.stack([left, top, w, h], 1).astype(np.int32))
    boxes[0] = torch.tensor([0, 0, S, S])
    flips = torch.from_numpy((np.arange(n) % 2).astype(np.int32))
    mean = [0.48145466, 0.4578275, 0.40821073]
    std = [0.26862954, 0.26130258, 0.27577711]

    def u8(device):
        m, s = _mean_std_u8(mean, std, device)
        x = device_train_preprocess(imgs.to(device), boxes.to(device), flips.to(device), out,
                                    m, s)
        return torch.round(x * s + m).cpu()

    diff = (u8("cuda") - u8("cpu")).abs()
    assert diff.max().item() <= 1
    assert int((diff > 0).sum()) <= 1e-3 * diff.numel()


def _gpu_baseline(name, **kw):
    """A baseline trainer at TINY_W128 on the card (6 classes), bf16 unless
    ``prec`` says otherwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.methods.cocoop import CoCoOp
    from rpo_tpu_torch.methods.coop import CoOp
    from rpo_tpu_torch.methods.linear_probe import LP

    cls = {"CoOp": CoOp, "CoCoOp": CoCoOp, "LP": LP}[name]
    kw.setdefault("prec", "fp16")
    return cls([f"object category {i}" for i in range(6)], backbone="TINY_W128", seed=1, **kw)


def _baseline_batches(n, B, seed=7):
    rng = np.random.RandomState(seed)
    return [{"img": rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8),
             "label": rng.randint(0, 6, B),
             "mask": np.array([1.0] * max(B - 1, 1) + [0.0] * min(B - 1, 1), np.float32)}
            for _ in range(n)]


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else v.detach().cpu().numpy().copy()
            for k, v in tree.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name,batch", [("CoOp", 4), ("CoCoOp", 1), ("CoCoOp", 16), ("LP", 4)])
def test_baseline_graph_replays_equal_eager_steps_on_gpu(name, batch):
    """Three eager steps and three replays of the captured one-step graph
    from the same state (the first trainable tensors, a fresh optimizer):
    the same losses and trainable tensors (torch.equal).  The capture
    records the step's kernels: the rect kernel once a vision layer, the
    masked kernel once a text layer a text tower (CoOp: one; CoCoOp: one
    below batch 16, one a chunk of 8 from 16 on; LP: none)."""
    from rpo_tpu_torch.engine import optim
    from rpo_tpu_torch.methods.step_graph import batch_spec

    trainer = _gpu_baseline(name)
    batches = _baseline_batches(3, batch)
    first = _tree_np(trainer.params)
    eager = torch.stack([trainer.train_step(b["img"], b["label"], b["mask"], 0.01)[0]
                         for b in batches])
    eager_params = [t.clone() for t in optim.tree_leaves(trainer.params)]
    trainer.set_ckpt_state(trainer.model_name, first)  # in place: a fresh optimizer
    trainer.current_lr = 0.01
    replays = torch.stack([trainer.forward_backward(b)["loss"] for b in batches])
    graph = trainer._graphs[(1, batch_spec(batches[0]))]
    assert graph.replays == 3
    assert torch.equal(replays, eager), (replays, eager)
    assert all(map(torch.equal, optim.tree_leaves(trainer.params), eager_params))
    cfg = trainer.clip_cfg
    towers = {"CoOp": 1, "CoCoOp": 2 if batch >= 16 else 1, "LP": 0}[name]
    assert graph.launches_per_replay["rect_attention.launches"] == cfg.vision_layers
    assert graph.launches_per_replay["masked_attention.launches"] == cfg.text_layers * towers


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["fp32", "fp16"])
def test_cocoop_accumulation_equals_monolithic_on_gpu(prec):
    """CoCoOp at batch 16 with two padded rows on the card: the accumulated
    step (the image tower once, the text towers in two chunks of 8)
    against the monolithic step on the same batch.  float32: loss within
    1e-5, logits within 1e-4, each gradient within 1e-5 + 1e-4 x its
    largest entry (reassociation only); bf16: chip_smoke's train bounds
    (loss 0.1, logits 5e-2, each gradient within 0.1 of its largest entry,
    cosine >= 0.99)."""
    from rpo_tpu_torch.engine import optim

    trainer = _gpu_baseline("CoCoOp", prec=prec)
    b = _baseline_batches(1, 16, seed=3)[0]
    b["mask"][-2:] = 0.0
    loss, logits, grads = trainer.loss_and_grads_of("accumulated", b["img"], b["label"],
                                                   b["mask"])
    m_loss, m_logits, m_grads = trainer.loss_and_grads_of("monolithic", b["img"], b["label"],
                                                         b["mask"])
    f32 = prec == "fp32"
    assert abs(loss.item() - m_loss.item()) <= (1e-5 if f32 else 0.1)
    assert (logits - m_logits).abs().max().item() <= (1e-4 if f32 else 5e-2)
    for g, w in zip(optim.tree_leaves(grads), optim.tree_leaves(m_grads)):
        err, big = (g - w).abs().max().item(), w.abs().max().item()
        if f32:
            assert err <= 1e-5 + 1e-4 * big, (err, big)
        else:
            cos = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0).item()
            assert err <= 0.1 * big and cos >= 0.99, (err, big, cos)


def _randomise_bn(tree, gen):
    """Every BN dict of a ResNet tree redrawn in place from ``gen``: scale
    ~ 1 +- 0.2, bias and mean ~ 0 +- 0.1, var in [0.5, 2)."""
    if isinstance(tree, list):
        for node in tree:
            _randomise_bn(node, gen)
    elif isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape
            tree["scale"] = 1 + 0.2 * torch.randn(c, generator=gen)
            tree["bias"] = 0.1 * torch.randn(c, generator=gen)
            tree["mean"] = 0.1 * torch.randn(c, generator=gen)
            tree["var"] = 0.5 + 1.5 * torch.rand(c, generator=gen)
        else:
            for node in tree.values():
                _randomise_bn(node, gen)


@pytest.mark.gpu
def test_rn50_bf16_tower_on_gpu_matches_the_cpu_port_in_fp32():
    """RN50's whole image tower (random weights, every BN statistic
    redrawn) in bf16 on the card, its kernels laid out once, against the
    same weights in float32 through the port on the CPU: per-image cosine
    >= 0.99 and max |diff| <= 5e-2 x max |feature| (chip_smoke's f32
    witness bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.models.clip.model import ARCHS, cast_params, encode_image
    from rpo_tpu_torch.models.clip.resnet import conv_layout, init_resnet_visual

    cfg = ARCHS["RN50"]
    gen = torch.Generator().manual_seed(0)
    visual = init_resnet_visual(gen, cfg)
    _randomise_bn(visual, gen)
    images = torch.randn(4, 224, 224, 3, generator=gen)
    want = encode_image({"visual": visual}, cfg, images)
    on_card = cast_params({"visual": visual}, torch.bfloat16)
    on_card = {"visual": conv_layout({k: _to_cuda(v) for k, v in on_card["visual"].items()})}
    got = encode_image(on_card, cfg, images.cuda()).float().cpu()
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=-1)
    err = (got - want).abs().max().item()
    assert got.shape == want.shape == (4, 1024) and bool(torch.isfinite(got).all())
    assert cos.min().item() >= 0.99 and err <= 5e-2 * want.abs().max().item(), (cos, err)


def _to_cuda(node):
    if isinstance(node, dict):
        return {k: _to_cuda(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_cuda(v) for v in node]
    return node.cuda()


@pytest.mark.gpu
def test_coop_rn50_graph_replays_equal_eager_steps_on_gpu():
    """CoOp on a random RN50 in bf16 (6 classes, batch 4 at 224): three
    eager steps and three replays of the captured one-step graph from the
    same state are torch.equal (cuDNN picks the same convolution
    algorithms in the eager step and in the capture: benchmark mode
    off); the capture records 12 masked launches (the text tower) and no
    rect one (the ResNet tower has no transformer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.engine import optim
    from rpo_tpu_torch.methods.coop import CoOp
    from rpo_tpu_torch.methods.step_graph import batch_spec

    assert not torch.backends.cudnn.benchmark
    trainer = CoOp([f"object category {i}" for i in range(6)], backbone="RN50", seed=1,
                   prec="fp16")
    rng = np.random.RandomState(7)
    batches = [{"img": rng.randint(0, 256, (4, 224, 224, 3)).astype(np.uint8),
                "label": rng.randint(0, 6, 4),
                "mask": np.array([1.0, 1.0, 1.0, 0.0], np.float32)} for _ in range(3)]
    first = _tree_np(trainer.params)
    eager = torch.stack([trainer.train_step(b["img"], b["label"], b["mask"], 0.01)[0]
                         for b in batches])
    eager_params = [t.clone() for t in optim.tree_leaves(trainer.params)]
    trainer.set_ckpt_state(trainer.model_name, first)
    trainer.current_lr = 0.01
    replays = torch.stack([trainer.forward_backward(b)["loss"] for b in batches])
    graph = trainer._graphs[(1, batch_spec(batches[0]))]
    assert graph.replays == 3
    assert torch.equal(replays, eager), (replays, eager)
    assert all(map(torch.equal, optim.tree_leaves(trainer.params), eager_params))
    assert graph.launches_per_replay["rect_attention.launches"] == 0
    assert graph.launches_per_replay["masked_attention.launches"] == trainer.clip_cfg.text_layers


@pytest.mark.gpu
def test_resolve_device_turns_reduced_precision_off():
    """``resolve_device()`` (every entry point's) leaves TF32 and cuBLAS's
    reduced-precision bf16 reduction off on the card, whatever they were;
    chip_smoke.py phase 1 takes its settings from it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.device import resolve_device

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device() == torch.device("cuda")
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.gpu
def test_kernel_selftest_passes_every_check_on_gpu():
    """The package's kernel selftest (``ops/selftest.py``): every check of
    its table, each kernel at its main paths' shapes and edges against its
    plain version, passes on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.ops.selftest import checks, run_selftest

    out = run_selftest(verbose=False)
    failed = {n: s for n, s in out["checks"].items() if not s.startswith("ok")}
    assert not failed
    assert out["value"] == out["total"] == len(checks())
    assert out["backend"] == "cuda" and out["device"] == torch.cuda.get_device_name(0)


@pytest.mark.gpu
def test_kernel_selftest_cli_on_gpu():
    """``python -m rpo_tpu_torch.tools.kernel_selftest`` prints one JSON
    line with every check passing, and exits 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import os
    import subprocess
    import sys

    from rpo_tpu_torch.ops.selftest import checks

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "rpo_tpu_torch.tools.kernel_selftest", "--quiet"],
                          cwd=root, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["value"] == out["total"] == len(checks())
