"""The port's whole-layer text kernel module against
rpo_tpu.ops.fused_text_layer.

On the CPU the port's ``fused_text_layer`` runs its plain version; the JAX
side runs its Pallas kernel in interpret mode, as its own tests do.  Inputs
and weights are made with numpy from a seed and carried to both sides; the
weights have nonzero biases and LayerNorm parameters other than (1, 0), so
that every bias add and cast is exercised.

Tolerances: float32 max abs error <= 1e-5 (with rtol 1e-5): the same
operations in the same order up to f32 summation order.  bfloat16: max abs
error <= 2e-2 of the reference's largest magnitude (the relative band of
tests/test_fused_text_layer.py): every activation rounds to bf16 (2^-8
relative) and a summation-order difference can flip a rounding, which the
later layers carry on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpo_tpu.models.clip.model import causal_mask as jax_causal_mask
from rpo_tpu.ops import fused_text_layer as jftl
from rpo_tpu_torch.models.clip import params_from_numpy
from rpo_tpu_torch.models.clip.layers import layer_params, transformer
from rpo_tpu_torch.models.clip.model import causal_mask
from rpo_tpu_torch.ops import fused_text_layer as ftl

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_BAND = 2e-2
# (width, heads): TINY's text tower and one ViT-B/16 text layer
WIDTHS = {"TINY": (64, 2), "ViT-B/16": (512, 8)}


def _blocks(seed, n_layers, d):
    """A stacked block pytree of numpy float32 arrays with CLIP's init
    scales, plus nonzero biases and perturbed LayerNorm parameters."""
    rng = np.random.RandomState(seed)

    def normal(*shape, std):
        return (rng.randn(n_layers, *shape) * std).astype(np.float32)

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


def _x(seed, N, L, d, dtype):
    jx = jnp.asarray(np.random.RandomState(seed).randn(N, L, d).astype(np.float32)).astype(JDT[dtype])
    return jx, params_from_numpy({"x": np.asarray(jx)}, "cpu")["x"]


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= BF16_BAND * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [6, 13], ids=["N6", "ragged-N13"])
@pytest.mark.parametrize("arch", list(WIDTHS))
def test_layer_matches_jax(arch, N, dtype):
    d, heads = WIDTHS[arch]
    L = 16
    jblk, tblk = _both(_blocks(0, 1, d), dtype)
    jblk = jax.tree_util.tree_map(lambda a: a[0], jblk)
    tblk = layer_params(tblk, 0)
    jx, tx = _x(1, N, L, d, dtype)
    want = jftl.fused_text_layer(jx, jblk, heads, jax_causal_mask(L), block_rows=8, interpret=True)
    with torch.no_grad():
        got = ftl.fused_text_layer(tx, tblk, heads, causal_mask(L))
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [16, 11], ids=["L16", "L11-padded"])
def test_tower_matches_jax(L, dtype):
    d, heads = WIDTHS["TINY"]
    jblocks, tblocks = _both(_blocks(2, 2, d), dtype)
    jx, tx = _x(3, 13, L, d, dtype)
    want = jftl.fused_text_tower(jx, jblocks, heads, jax_causal_mask(L), block_rows=4,
                                 interpret=True)
    with torch.no_grad():
        got = ftl.fused_text_tower(tx, tblocks, heads, causal_mask(L))
    assert tuple(got.shape) == (13, L, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("L", [16, 11], ids=["L16", "L11-padded"])
def test_fused_tower_matches_unfused_transformer_fp32(L):
    """The whole-layer path equals the per-block loop in float32, as
    tests/test_fused_text_layer.py pins on the JAX side; ``transformer``
    takes it only for bf16, so the tower is called directly here."""
    d, heads = WIDTHS["TINY"]
    _, blocks = _both(_blocks(4, 2, d), "float32")
    x = torch.from_numpy(np.random.RandomState(5).randn(13, L, d).astype(np.float32))
    mask = causal_mask(L)
    with torch.no_grad():
        want = transformer(x, blocks, heads, mask[None, None])
        got = ftl.fused_text_tower(x, blocks, heads, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_transformer_takes_the_text_layer_only_where_the_guard_holds():
    """bf16 with a shared (1, 1, L, L) bias goes through ``text_layer``;
    f32, a per-batch bias or no ``text_layer`` keep the per-block loop."""
    d, heads = WIDTHS["TINY"]
    _, blocks = _both(_blocks(6, 2, d), "bfloat16")
    _, blocks32 = _both(_blocks(6, 2, d), "float32")
    x = torch.from_numpy(np.random.RandomState(7).randn(3, 16, d).astype(np.float32))
    bias = causal_mask(16)[None, None]
    calls = []

    def layer(x, blk, n_heads, mask):
        calls.append(tuple(x.shape))
        return ftl.fused_text_layer_reference(x, blk, n_heads, mask)

    with torch.no_grad():
        got = transformer(x.bfloat16(), blocks, heads, bias, text_layer=layer)
        assert calls == [(3, 16, d)] * 2
        want = ftl.fused_text_tower(x.bfloat16(), blocks, heads, bias[0, 0])
        assert torch.equal(got, want)
        transformer(x, blocks32, heads, bias, text_layer=layer)
        transformer(x.bfloat16(), blocks, heads, bias.expand(3, 1, 16, 16), text_layer=layer)
        transformer(x.bfloat16(), blocks, heads, bias)
    assert len(calls) == 2


def test_refusals_and_no_launch_on_cpu():
    d, heads = WIDTHS["TINY"]
    _, blocks = _both(_blocks(8, 2, d), "bfloat16")
    blk = layer_params(blocks, 0)
    x = torch.zeros(2, 16, d, dtype=torch.bfloat16)
    mask = causal_mask(16)
    before = ftl.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        ftl.fused_text_layer(x.clone().requires_grad_(True), blk, heads, mask)
    with pytest.raises(RuntimeError, match="forward-only"):
        ftl.fused_text_tower(x.clone().requires_grad_(True), blocks, heads, mask)
    weights = [blk[a][b] for a, b in ftl._WEIGHTS]
    ftl._check(x, weights, heads, mask)  # the kernel's own shape passes
    for width, n_heads in ((256, 2), (d, 4)):  # head dims 128 and 16
        with pytest.raises(ValueError, match="head dim"):
            ftl._check(torch.zeros(2, 16, width, dtype=torch.bfloat16), weights, n_heads, mask)
    big = torch.zeros(1, 96, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="L <= 80"):
        ftl._check(big, weights, heads, causal_mask(96))
    with pytest.raises(TypeError, match="bfloat16"):
        ftl._check(x.float(), weights, heads, mask)
    with torch.no_grad():
        out = ftl.fused_text_layer(x, blk, heads, mask)
    assert out.dtype == torch.bfloat16 and ftl.launches == before


def test_fragment_major_layout():
    """Lane l = 4 g + q of a 16x16 tile holds, in order, the B fragments of
    two m16n8k16 products: rows 2q, 2q+1, 2q+8, 2q+9 of column g, then of
    column 8 + g (the PTX ISA's fragment layout)."""
    w = torch.arange(32 * 48, dtype=torch.float32).reshape(32, 48)
    frag = ftl._fragment_major(w)
    assert tuple(frag.shape) == (2, 3, 256)
    for kt, nt, lane in ((0, 0, 0), (1, 2, 5), (1, 1, 31)):
        g, q = lane // 4, lane % 4
        want = [w[16 * kt + r, 16 * nt + c].item() for c in (g, 8 + g)
                for r in (2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9)]
        assert frag[kt, nt, 8 * lane:8 * lane + 8].tolist() == want
    assert sorted(ftl._FRAGMENT_ORDER.tolist()) == list(range(256))


def test_kernel_matrices_are_made_once_per_weight():
    """``with_kernel_layout`` lays every layer's four weight matrices out
    once: a layer's slice of the stack is what a launch would make from
    that layer alone, contiguous, and the plain version ignores it.  A
    layout that does not belong to the layer's weights is refused."""
    d, heads = WIDTHS["TINY"]
    _, blocks = _both(_blocks(9, 2, d), "bfloat16")
    prepared = ftl.with_kernel_layout(blocks)
    assert set(prepared) == set(blocks) | {"kernel"}
    for i in range(2):
        blk = layer_params(prepared, i)
        assert ftl._kernel_matrices(blk) is blk["kernel"]
        made = ftl._kernel_matrices(layer_params(blocks, i))
        for name, t in made.items():
            assert blk["kernel"][name].is_contiguous()
            torch.testing.assert_close(blk["kernel"][name], t, rtol=0, atol=0)
    x = torch.from_numpy(np.random.RandomState(10).randn(3, 16, d).astype(np.float32)).bfloat16()
    with torch.no_grad():
        assert torch.equal(ftl.fused_text_tower(x, prepared, heads, causal_mask(16)),
                           ftl.fused_text_tower(x, blocks, heads, causal_mask(16)))
    wrong = layer_params(prepared, 0)
    wrong["kernel"] = {**wrong["kernel"], "fc_w": wrong["kernel"]["proj_w"]}
    with pytest.raises(ValueError, match="kernel layout of mlp.fc_w"):
        ftl._kernel_matrices(wrong)
