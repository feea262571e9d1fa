"""The port's fused rect-layer module against rpo_tpu.ops.fused_rect_layer.

On the CPU the port's ``fused_rect_attn_half``, ``fused_mlp_half`` and
``fused_rect_residual_block`` run their plain versions; the JAX side runs
its Pallas kernels in interpret mode.  Inputs and weights are made with
numpy from a seed and carried to both sides; the weights have nonzero
biases and LayerNorm parameters other than (1, 0), so that every bias add
and cast is exercised.  The port's unfused ``rect_residual_block`` computes
the same function and is held to the same bounds.

Tolerances: float32 max abs error <= 1e-5 (with rtol 1e-5): the same
operations in the same order up to f32 summation order.  bfloat16: every
element within 2e-2 of max(|reference|, 1) (a rounding flip from summation
order is one bf16 ulp, at most 2^-7 of the element, and a residual add can
stack two), and the mean abs error <= 5e-4: at one ViT-B/16 layer XLA and
PyTorch sum the LayerNorm and the 768- and 3072-deep products in other
orders, so a few percent of the roundings flip, while a dropped bias of
std 0.02 moves the mean by about 1.6e-2 (test_bf16_bounds_catch_a_dropped_bias).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpo_tpu.ops import fused_rect_layer as jfrl
from rpo_tpu_torch.models.clip import params_from_numpy
from rpo_tpu_torch.models.clip.layers import rect_residual_block
from rpo_tpu_torch.ops import fused_rect_layer as frl

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ELEMENT = 2e-2
BF16_MEAN = 5e-4
# (B, L, d, heads, n_kv)
SHAPES = {
    "ragged-small": (3, 13, 128, 2, 9),  # odd B, rows not a multiple of 224 or 16
    "n_kv=L": (3, 13, 128, 2, 13),
    "ViT-B/16-layer": (2, 221, 768, 12, 197),
    "129-rows": (3, 43, 128, 2, 40),  # one row past the MLP GEMMs' 128-row tile
}


def _block(seed, d):
    """One layer's params as numpy float32 arrays with CLIP's init scales,
    plus nonzero biases and perturbed LayerNorm parameters."""
    rng = np.random.RandomState(seed)

    def normal(*shape, std):
        return (rng.randn(*shape) * std).astype(np.float32)

    return {
        "ln_1": {"scale": 1 + normal(d, std=0.1), "bias": normal(d, std=0.1)},
        "attn": {"qkv_w": normal(d, 3 * d, std=d ** -0.5), "qkv_b": normal(3 * d, std=0.02),
                 "out_w": normal(d, d, std=d ** -0.5 / 5), "out_b": normal(d, std=0.02)},
        "ln_2": {"scale": 1 + normal(d, std=0.1), "bias": normal(d, std=0.1)},
        "mlp": {"fc_w": normal(d, 4 * d, std=(2 * d) ** -0.5), "fc_b": normal(4 * d, std=0.02),
                "proj_w": normal(4 * d, d, std=d ** -0.5 / 5), "proj_b": normal(d, std=0.02)},
    }


def _both(tree, dtype):
    """The same numpy tree as a JAX pytree and as the port's tensors, both
    in ``dtype`` (the port's from the JAX arrays, so bf16 rounds once)."""
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(JDT[dtype]), tree)
    return jtree, params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _x(seed, B, L, d, dtype):
    jx, tx = _both({"x": np.random.RandomState(seed).randn(B, L, d).astype(np.float32)}, dtype)
    return jx["x"], tx["x"]


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        diff = np.abs(got - want)
        worst = (diff / (BF16_ELEMENT * np.maximum(np.abs(want), 1.0))).max()
        assert worst <= 1 and diff.mean() <= BF16_MEAN, (worst, diff.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_halves_and_block_match_jax(shape, dtype):
    """Each half, the block and the unfused ``rect_residual_block`` against
    the JAX kernels run with interpret=True, on the same inputs."""
    B, L, d, heads, n_kv = SHAPES[shape]
    jblk, tblk = _both(_block(0, d), dtype)
    jx, tx = _x(1, B, L, d, dtype)
    want_attn = jfrl.fused_rect_attn_half(jx, jblk["ln_1"], jblk["attn"], heads, n_kv,
                                          interpret=True)
    want_mlp = jfrl.fused_mlp_half(jx, jblk["ln_2"], jblk["mlp"], interpret=True)
    want_block = jfrl.fused_rect_residual_block(jx, jblk, heads, n_kv, interpret=True)
    with torch.no_grad():
        got = {
            "attn": frl.fused_rect_attn_half(tx, tblk["ln_1"], tblk["attn"], heads, n_kv),
            "attn plain": frl.fused_rect_attn_half_reference(tx, tblk["ln_1"], tblk["attn"],
                                                             heads, n_kv),
            "mlp": frl.fused_mlp_half(tx, tblk["ln_2"], tblk["mlp"]),
            "mlp plain": frl.fused_mlp_half_reference(tx, tblk["ln_2"], tblk["mlp"]),
            "block": frl.fused_rect_residual_block(tx, tblk, heads, n_kv),
            "block plain": frl.fused_rect_residual_block_reference(tx, tblk, heads, n_kv),
            "unfused": rect_residual_block(tx, tblk, heads, n_kv),
        }
    for name, want in (("attn", want_attn), ("attn plain", want_attn), ("mlp", want_mlp),
                       ("mlp plain", want_mlp), ("block", want_block),
                       ("block plain", want_block), ("unfused", want_block)):
        assert got[name].dtype == tx.dtype, name
        _close(got[name], want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_staged_scratch_layout_is_the_plain_version(shape, dtype):
    """The attention half's plain version taken through the kernels' launch
    order, scratch layout, strides and k/v row map is the plain version,
    bit for bit."""
    B, L, d, heads, n_kv = SHAPES[shape]
    _, tblk = _both(_block(5, d), dtype)
    _, tx = _x(6, B, L, d, dtype)
    with torch.no_grad():
        got = frl.fused_rect_attn_half_staged(tx, tblk["ln_1"], tblk["attn"], heads, n_kv)
        want = frl.fused_rect_attn_half_reference(tx, tblk["ln_1"], tblk["attn"], heads, n_kv)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_bf16_bounds_catch_a_dropped_bias():
    """The bf16 bounds are tight enough to fail a plain version that drops
    out_b or proj_b (std 0.02)."""
    B, L, d, heads, n_kv = SHAPES["ragged-small"]
    jblk, tblk = _both(_block(2, d), "bfloat16")
    jx, tx = _x(3, B, L, d, "bfloat16")
    want_attn = jfrl.fused_rect_attn_half(jx, jblk["ln_1"], jblk["attn"], heads, n_kv,
                                          interpret=True)
    want_mlp = jfrl.fused_mlp_half(jx, jblk["ln_2"], jblk["mlp"], interpret=True)
    no_out_b = {**tblk["attn"], "out_b": torch.zeros(d, dtype=torch.bfloat16)}
    no_proj_b = {**tblk["mlp"], "proj_b": torch.zeros(d, dtype=torch.bfloat16)}
    with torch.no_grad():
        bad = [(frl.fused_rect_attn_half_reference(tx, tblk["ln_1"], no_out_b, heads, n_kv),
                want_attn),
               (frl.fused_mlp_half_reference(tx, tblk["ln_2"], no_proj_b), want_mlp)]
    for got, want in bad:
        with pytest.raises(AssertionError):
            _close(got, want, "bfloat16")


def test_refusals_and_no_launch_on_cpu():
    B, L, d, heads, n_kv = SHAPES["ragged-small"]
    _, blk = _both(_block(4, d), "bfloat16")
    x = torch.zeros(B, L, d, dtype=torch.bfloat16)
    before = (frl.attn_half_launches, frl.mlp_half_launches)
    with pytest.raises(RuntimeError, match="forward-only"):
        frl.fused_rect_attn_half(x.clone().requires_grad_(True), blk["ln_1"], blk["attn"], heads,
                                 n_kv)
    with pytest.raises(RuntimeError, match="forward-only"):
        frl.fused_mlp_half(x, blk["ln_2"], {**blk["mlp"], "fc_b": blk["mlp"]["fc_b"].clone()
                                            .requires_grad_(True)})
    with pytest.raises(RuntimeError, match="forward-only"):
        frl.fused_rect_residual_block(x.clone().requires_grad_(True), blk, heads, n_kv)
    attn_w = [blk[a][b] for a, b in frl._ATTN_WEIGHTS]
    mlp_w = [blk[a][b] for a, b in frl._MLP_WEIGHTS]
    frl._check_attn(x, attn_w, heads, n_kv)  # the kernels' own shapes pass
    frl._check_mlp(x, mlp_w)
    frl._check_attn(x, attn_w, heads, L)  # n_kv = L
    with pytest.raises(TypeError, match="bfloat16"):
        frl._check_attn(x.float(), attn_w, heads, n_kv)
    with pytest.raises(TypeError, match="bfloat16"):
        frl._check_mlp(x.half(), mlp_w)
    with pytest.raises(ValueError, match="head dim"):
        frl._check_attn(x, attn_w, 4, n_kv)  # head dim 32
    for bad in (0, L + 1):
        with pytest.raises(ValueError, match="n_kv"):
            frl._check_attn(x, attn_w, heads, bad)
    with pytest.raises(ValueError, match="n_kv"):
        frl._check_attn(torch.zeros(1, 300, d, dtype=torch.bfloat16), attn_w, heads, 257)
    with pytest.raises(ValueError, match="width"):
        frl._check_attn(torch.zeros(1, 4, 832, dtype=torch.bfloat16), attn_w, 13, 2)
    with pytest.raises(ValueError, match="width"):
        frl._check_mlp(torch.zeros(1, 4, 80, dtype=torch.bfloat16), mlp_w)
    with pytest.raises(ValueError, match="attn.qkv_w"):
        frl._check_attn(x, [attn_w[0], attn_w[1], attn_w[2][:, :d]] + attn_w[3:], heads, n_kv)
    with pytest.raises(ValueError, match="contiguous"):
        frl._check_mlp(x.transpose(0, 1), mlp_w)
    with torch.no_grad():
        out = frl.fused_rect_residual_block(x, blk, heads, n_kv)
    assert out.dtype == torch.bfloat16
    assert (frl.attn_half_launches, frl.mlp_half_launches) == before


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """Both fused sources include fused_layer_common.cuh: editing the header
    changes the library name, so the next launch rebuilds them."""
    from rpo_tpu_torch.ops import _build

    assert {p.name for p in _build.CSRC.glob("*.cuh")} >= {"fused_layer_common.cuh"}
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("k") != before
    (tmp_path / "h.cuh").write_text("// one\n")
    assert _build._target("k") == before


# (rows, d): the RPO eval layer, one row past and exactly one 128-row GEMM
# tile, d = 64 (proj's N half a 128-column block), a single row
PLAN_CASES = {
    (22100, 768): (1382, 4152, 1038),
    (129, 768): (9, 48, 12),
    (128, 768): (8, 24, 6),
    (128, 64): (8, 2, 1),
    (1, 64): (1, 2, 1),
    (100, 192): (7, 6, 2),
}


@pytest.mark.parametrize("rows,d", list(PLAN_CASES))
def test_mlp_launch_plan(rows, d):
    """Three launches: LN2 16 rows a block; fc and proj 128 x 128 tiles,
    row panels times column blocks; a (rows, 5d) scratch; every launch's
    shared bytes within one block's 232,448."""
    plan = frl.mlp_launch_plan(rows, d)
    assert plan["launches"] == 3
    assert (plan["ln2"]["grid"], plan["fc"]["grid"], plan["proj"]["grid"]) == PLAN_CASES[rows, d]
    assert plan["scratch_elements"] == 5 * rows * d
    assert (plan["ln2"]["threads"], plan["fc"]["threads"], plan["proj"]["threads"]) == (512, 256,
                                                                                      256)
    assert plan["ln2"]["shared_bytes"] == 0
    for k in ("fc", "proj"):
        assert 0 < plan[k]["shared_bytes"] <= 232448


@pytest.mark.parametrize("rows,d", [(0, 768), (10, 80), (10, 832), (10, 32)])
def test_mlp_launch_plan_refuses_what_the_kernels_do_not_take(rows, d):
    with pytest.raises(ValueError):
        frl.mlp_launch_plan(rows, d)


def _source_constants(*names):
    """Every namespace-level ``constexpr int`` of the named sources under
    csrc/, evaluated in order (integer division, sizeof(bf16) = 2)."""
    import re

    from rpo_tpu_torch.ops import _build

    values = {}
    for name in names:
        text = (_build.CSRC / name).read_text()
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
            expr = expr.replace("sizeof(bf16)", "2").replace("/", "//")
            values[key] = eval(expr, {}, dict(values))  # noqa: S307 - the repo's own source
    return values


def test_mlp_launch_plan_mirrors_the_source():
    """The launch plans' constants are the .cu's and the attention header's,
    read from the sources, and their GEMM shared bytes the source's
    kGemmSmem; the .cu names both plans, and the plans have no other owner
    (no C entry computes them)."""
    import re

    from rpo_tpu_torch.ops import _build

    c = _source_constants("fused_layer_common.cuh", "fused_rect_layer.cu")
    assert (c["kGemmRows"], c["kGemmCols"], c["kGemmK"], c["kGemmStages"], c["kGemmThreads"],
            c["kPadBf16"], c["kLnRows"], c["kThreads"]) == (
        frl._GEMM_ROWS, frl._GEMM_COLS, frl._GEMM_K, frl._GEMM_STAGES, frl._GEMM_THREADS,
        frl._PAD_BF16, frl._LN_ROWS, frl._LN_THREADS)
    plan = frl.mlp_launch_plan(22100, 768)
    attn = frl.attn_launch_plan(100, 221, 768, 12, 197)
    assert plan["fc"]["shared_bytes"] == plan["proj"]["shared_bytes"] == c["kGemmSmem"]
    assert attn["qkv"]["shared_bytes"] == attn["out"]["shared_bytes"] == c["kGemmSmem"]
    assert c["kDh"] == frl._HEAD_DIM and c["kMaxKeys"] == frl._MAX_KV
    # the warps cover the block tile: 8 warps of 64 x 32
    assert c["kGemmThreads"] // 32 == (c["kGemmRows"] // c["kGemmWarpRows"]) * c["kGemmColWarps"]
    tc = _source_constants("attention_tc.cuh")
    assert (tc["kTcThreads"], tc["kWarps"], tc["kTile"]) == (
        frl._TC_THREADS, frl._TC_WARPS, frl._TC_TILE)
    header = (_build.CSRC / "attention_tc.cuh").read_text()
    widths = re.search(r"int d64_score_tiles\(int Lk\) \{.*?return ([^;]+);", header, re.S)
    assert tuple(sorted({int(w) for w in re.findall(r"\d+", widths.group(1))})) == \
        frl._SCORE_TILES
    # the widths rect_attention.cu's dispatch instantiates at D = 64
    rect = (_build.CSRC / "rect_attention.cu").read_text()
    rect = rect[rect.index("case 64:", rect.index("int dispatch_bf16(")):]
    rect = rect[:rect.index("case 128:")]
    assert tuple(int(w) for w in re.findall(r"launch_tc<64, HAS_BIAS, (\d+)>", rect)) == \
        frl._SCORE_TILES
    source = " ".join((_build.CSRC / "fused_rect_layer.cu").read_text().replace("//", "").split())
    assert "mlp_launch_plan and attn_launch_plan in ops/fused_rect_layer.py" in source
    assert "fused_mlp_half_plan" not in source and "fused_mlp_half_plan" not in frl._SIGNATURES
    assert "csrc/fused_rect_layer.cu" in frl.__doc__ + Path(frl.__file__).read_text()


def test_every_kernel_is_named_for_its_half():
    """The profiler groups device time by kernel name: every kernel of
    fused_rect_layer.cu carries its half's name, and each half has the
    kernels its plan counts (the attention's one per score width)."""
    import re

    from rpo_tpu_torch.ops import _build

    source = (_build.CSRC / "fused_rect_layer.cu").read_text()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\([^)]*\)\)| "
                         r"__launch_bounds__\([^)]*\))?\s+(\w+)\(", source)
    assert kernels and all(k.startswith(("fused_rect_attn_half_", "fused_mlp_half_"))
                           for k in kernels), kernels
    assert sorted(k for k in kernels if k.startswith("fused_rect_attn_half_")) == [
        "fused_rect_attn_half_attention_kernel", "fused_rect_attn_half_ln1_kernel",
        "fused_rect_attn_half_out_kernel", "fused_rect_attn_half_qkv_kernel"]
    assert frl.attn_launch_plan(2, 64, 64, 1, 50)["launches"] == 4
    assert sorted(k for k in kernels if k.startswith("fused_mlp_half_")) == [
        "fused_mlp_half_gemm_kernel", "fused_mlp_half_ln2_kernel"]  # fc and proj: one template


# (B, L, d, heads, n_kv): chip_smoke.py's rect checks and a short L, where a
# block of the attention takes several (b, h)
ATTN_PLAN_CASES = {
    # ln1, qkv (q tiles first), attention grid, its shared bytes, score
    # tiles, (b, h) a block, out
    (100, 221, 768, 12, 197): (1382, 2886, 1038, 1200, 69120, 13, 1, 1038),
    (100, 197, 768, 12, 197): (1232, 2772, 924, 1200, 69120, 13, 1, 924),
    (3, 37, 256, 4, 29): (7, 6, 2, 12, 18432, 2, 1, 2),
    (3, 43, 768, 12, 40): (9, 24, 12, 36, 23040, 5, 1, 12),
    (2, 64, 64, 1, 50): (8, 2, 1, 2, 27648, 5, 1, 1),
    (3, 13, 128, 2, 9): (3, 3, 1, 2, 27648, 2, 4, 1),
}


@pytest.mark.parametrize("shape", list(ATTN_PLAN_CASES))
def test_attn_launch_plan(shape):
    """Four launches: LN1 16 rows a block; q/k/v the q tiles (all rows, d
    columns) then the gathered k/v tiles (B * n_kv rows, 2d columns), 128 x
    128 each; the attention one block of 4 warps per (b, h) at the
    narrowest score width that holds n_kv, several (b, h) a block where L
    has fewer than 4 row tiles; out on the q tiles; a 4 * B * L * d scratch;
    every launch's shared bytes within one block's 232,448."""
    B, L, d, heads, n_kv = shape
    plan = frl.attn_launch_plan(*shape)
    assert plan["launches"] == 4
    att = plan["attention"]
    assert (plan["ln1"]["grid"], plan["qkv"]["grid"], plan["qkv"]["q_tiles"], att["grid"],
            att["shared_bytes"], att["score_tiles"], att["pack"], plan["out"]["grid"]) == \
        ATTN_PLAN_CASES[shape]
    assert plan["scratch_elements"] == 4 * B * L * d
    assert (plan["ln1"]["threads"], plan["qkv"]["threads"], att["threads"],
            plan["out"]["threads"]) == (512, 256, 128, 256)
    assert plan["ln1"]["shared_bytes"] == 0
    for k in ("qkv", "attention", "out"):
        assert 0 < plan[k]["shared_bytes"] <= 232448


@pytest.mark.parametrize("shape,match", [
    ((3, 13, 128, 4, 9), "head dim"),  # head dim 32
    ((3, 13, 128, 2, 0), "n_kv"),
    ((3, 13, 128, 2, 14), "n_kv"),  # past L
    ((1, 300, 128, 2, 257), "n_kv"),  # past 256
    ((1, 4, 832, 13, 2), "width"),
    ((0, 13, 128, 2, 9), "B"),
])
def test_attn_launch_plan_refuses_what_the_kernels_do_not_take(shape, match):
    with pytest.raises(ValueError, match=match):
        frl.attn_launch_plan(*shape)
