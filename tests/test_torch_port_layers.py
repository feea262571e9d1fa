"""The port's attention and transformer layers against rpo_tpu's.

Every block gets the same random parameters (nonzero biases and
LayerNorm affine terms, made with numpy from a seed) and the same input
on both sides.  Where the JAX function reaches a Pallas kernel it runs in
interpret mode, forced on as tests/test_pallas_attention.py forces it.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpo_tpu.ops.attention as jattn
import rpo_tpu.ops.pallas_attention as jpallas
from rpo_tpu.models.clip import layers as jlayers
from rpo_tpu_torch.models.clip import layers as tlayers
from rpo_tpu_torch.models.clip.bridge import params_from_numpy
from rpo_tpu_torch.ops import attention as tattn

# f32: the same order of operations on both sides, so only summation
# order differs (width 128 -> a few f32 ulps of O(1) activations).
# bf16: every matmul output and activation is rounded to bf16 (2^-8
# relative); a summation-order difference flips a rounding now and then
# and a block compounds a few of them, so hold to 4 ulps of values that
# stay below 4 in magnitude.
TOL = {
    "float32": dict(atol=2e-5, rtol=1e-4),
    "bfloat16": dict(atol=4 * 2.0 ** -8 * 4, rtol=0),
}
DTYPES = ["float32", "bfloat16"]


def _block_params(r, D):
    def n(*shape, s=0.05):
        return (r.randn(*shape) * s).astype(np.float32)

    def ln():
        return {"scale": 1.0 + n(D, s=0.1), "bias": n(D, s=0.1)}

    return {
        "ln_1": ln(),
        "attn": {"qkv_w": n(D, 3 * D), "qkv_b": n(3 * D, s=0.1),
                 "out_w": n(D, D), "out_b": n(D, s=0.1)},
        "ln_2": ln(),
        "mlp": {"fc_w": n(D, 4 * D), "fc_b": n(4 * D, s=0.1),
                "proj_w": n(4 * D, D), "proj_b": n(D, s=0.1)},
    }


def _to_jax(tree, dtype):
    return {k: _to_jax(v, dtype) if isinstance(v, dict) else jnp.asarray(v).astype(dtype)
            for k, v in tree.items()}


def _to_np(jx):
    return np.asarray(jnp.asarray(jx).astype(jnp.float32))


def _case(dtype, seed=0, B=2, L=9, D=128):
    """Params and input on both sides, in ``dtype``."""
    r = np.random.RandomState(seed)
    p = _block_params(r, D)
    x = r.randn(B, L, D).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jp, jx = _to_jax(p, jdt), jnp.asarray(x).astype(jdt)
    tp = params_from_numpy(jp, "cpu")
    tx = torch.from_numpy(_to_np(jx)).to(getattr(torch, dtype))
    return jp, jx, tp, tx


def _close(t, j, dtype):
    np.testing.assert_allclose(t.detach().float().numpy(), _to_np(j), **TOL[dtype])


def _causal(L):
    i = np.arange(L)
    return np.where(i[None, :] > i[:, None], jattn.NEG_INF, 0.0).astype(np.float32)[None, None]


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """Force the JAX package's Pallas branches on, in interpret mode."""
    rect, paired = jpallas.pallas_rect_attention, jpallas.pallas_rect_attention_paired
    monkeypatch.setattr(jattn, "use_pallas_attention", lambda: True)
    monkeypatch.setattr(jpallas, "pallas_rect_attention",
                        lambda q, k, v, interpret=False: rect(q, k, v, True))
    monkeypatch.setattr(jpallas, "pallas_rect_attention_paired",
                        lambda q2, k2, v2, half=64, interpret=False: paired(q2, k2, v2, half, True))


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm(dtype):
    jp, jx, tp, tx = _case(dtype)
    _close(tlayers.layer_norm(tx, tp["ln_1"]), jlayers.layer_norm(jx, jp["ln_1"]), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    jp, jx, tp, tx = _case(dtype)
    _close(tlayers.mlp(tx, tp["mlp"]), jlayers.mlp(jx, jp["mlp"]), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [True, False], ids=["causal", "unmasked"])
def test_residual_block(dtype, masked):
    jp, jx, tp, tx = _case(dtype, seed=1)
    bias = _causal(jx.shape[1]) if masked else None
    want = jlayers.residual_block(jx, jp, 2, None if bias is None else jnp.asarray(bias))
    got = tlayers.residual_block(tx, tp, 2, None if bias is None else torch.from_numpy(bias))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_block_kv(dtype):
    jp, jx, tp, tx = _case(dtype, seed=2)
    bias = _causal(jx.shape[1])
    want = jlayers.residual_block_kv(jx, jp, 2, jnp.asarray(bias))
    got = tlayers.residual_block_kv(tx, tp, 2, torch.from_numpy(bias))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_heads", [2, 1], ids=["paired", "unpaired"])
def test_rect_residual_block(dtype, n_heads, jax_pallas_interpret):
    """head_dim 64 with even heads takes the JAX paired kernel, otherwise
    the unpaired one (both in interpret mode)."""
    D = 64 * n_heads
    jp, jx, tp, tx = _case(dtype, seed=3, L=12, D=D)
    want = jlayers.rect_residual_block(jx, jp, n_heads, 7)
    got = tlayers.rect_residual_block(tx, tp, n_heads, 7)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_residual_block(dtype):
    jp, jx, tp, tx = _case(dtype, seed=4)
    r = np.random.RandomState(5)
    B, H, Lk, Dh = 2, 2, 6, 64
    k, v = r.randn(B, H, Lk, Dh).astype(np.float32), r.randn(B, H, Lk, Dh).astype(np.float32)
    bias = np.zeros((B, 1, 1, Lk), np.float32)
    bias[0, ..., 4:] = jattn.NEG_INF
    jdt = getattr(jnp, dtype)
    want = jlayers.cross_residual_block(
        jx, jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt), jp, H, jnp.asarray(bias)
    )
    tk, tv = (torch.from_numpy(_to_np(jnp.asarray(a).astype(jdt))).to(tx.dtype) for a in (k, v))
    got = tlayers.cross_residual_block(tx, tk, tv, tp, H, torch.from_numpy(bias))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_heads", [2, 1], ids=["paired", "unpaired"])
def test_multihead_attention_rect(dtype, n_heads, jax_pallas_interpret):
    D = 64 * n_heads
    jp, jx, tp, tx = _case(dtype, seed=6, L=11, D=D)
    want = jattn.multihead_attention_rect(jx, jp["attn"], n_heads, 8)
    got = tattn.multihead_attention_rect(tx, tp["attn"], n_heads, 8)
    _close(got, want, dtype)


def test_transformer_stack():
    r = np.random.RandomState(7)
    layers = [_block_params(r, 128) for _ in range(3)]
    stacked = _stack(layers)
    x = r.randn(2, 9, 128).astype(np.float32)
    bias = _causal(9)
    want = jlayers.transformer(jnp.asarray(x), _to_jax(stacked, jnp.float32), 2, jnp.asarray(bias))
    got = tlayers.transformer(torch.from_numpy(x), params_from_numpy(stacked, "cpu"), 2,
                              torch.from_numpy(bias))
    _close(got, want, "float32")


def _stack(trees):
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else np.stack([t[k] for t in trees]) for k in first}


def test_cpu_bf16_matmul_rounds_once_from_f32():
    """The bf16 contract of _head_proj and mlp: the product accumulates in
    f32, rounds once to bf16, and only then is the bias added in bf16.
    PyTorch's CPU bf16 matmul does the first two itself: it equals the
    f32 product rounded to bf16, up to one-ulp flips on a small share of
    entries and the f32 summation-order error of entries that cancel.  A
    bf16 accumulation would be off by many ulps on most entries."""
    r = np.random.RandomState(8)
    x = torch.from_numpy(r.randn(2, 221, 768).astype(np.float32)).bfloat16()
    w = torch.from_numpy((r.randn(768, 768) * 0.05).astype(np.float32)).bfloat16()
    b = torch.from_numpy(r.randn(768).astype(np.float32)).bfloat16()
    prod = (x.float() @ w.float()).bfloat16()
    # f32 summation-order error bound of each entry
    sum_err = (x.float().abs() @ w.float().abs()) * 2.0 ** -20

    def heads(t):
        return t.view(2, 221, 12, 64).permute(0, 2, 1, 3)

    for got, want, rounded, err in [
        (x @ w, prod, prod, sum_err),
        (tattn._head_proj(x, w, b, 12), heads(prod + b), heads(prod), heads(sum_err)),
    ]:
        diff = (got.float() - want.float()).abs()
        ulps = (want.float().abs() + rounded.float().abs()) * 2.0 ** -7
        assert bool((diff <= ulps + err).all())
        assert float((diff > 0).float().mean()) < 1e-3
    params = {"fc_w": w, "fc_b": b, "proj_w": w.T.contiguous(), "proj_b": b}
    h = tlayers.quick_gelu(prod + b)
    want = (h.float() @ params["proj_w"].float()).bfloat16() + b
    diff = (tlayers.mlp(x, params).float() - want.float()).abs()
    assert float((diff > 0).float().mean()) < 1e-2


@pytest.mark.parametrize("exit_by", ["return", "raise"])
@pytest.mark.parametrize("swap", ["rect", "masked", "both"])
def test_attention_functions_swap_nest_and_restore(swap, exit_by):
    """``attention_functions`` puts the given functions in force for the
    layers above ``ops`` (a bias-free block and a rect block reach the
    rect one, a causal block the masked one), nests inside another, and
    restores the previous pair on a normal exit and on an exception."""
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    _, _, tp, tx = _case("float32", seed=8)
    causal = torch.from_numpy(_causal(tx.shape[1]))
    calls = []

    def recording(name, fn):
        return lambda *args: calls.append(name) or fn(*args)

    def run():
        calls.clear()
        out = (tlayers.residual_block(tx, tp, 2), tlayers.rect_residual_block(tx, tp, 2, 5),
               tlayers.residual_block(tx, tp, 2, causal))
        return out, list(calls)

    default = tattn.current_attention()
    assert default == (ra.rect_attention, ma.masked_attention)
    want, none = run()
    assert none == []
    outer_rect = recording("outer rect", ra.rect_attention_reference)
    inner = {kind: recording(f"inner {kind}", ref) for kind, ref in (
        ("rect", ra.rect_attention_reference), ("masked", ma.masked_attention_reference))
        if swap in (kind, "both")}
    rect_name = "inner rect" if "rect" in inner else "outer rect"
    masked_name = "inner masked" if "masked" in inner else None

    class Planted(Exception):
        pass

    with tattn.attention_functions(rect=outer_rect):
        assert tattn.current_attention() == (outer_rect, ma.masked_attention)
        assert run()[1] == ["outer rect", "outer rect"]
        with pytest.raises(Planted) if exit_by == "raise" else contextlib.nullcontext():
            with tattn.attention_functions(**inner):
                assert tattn.current_attention() == (
                    inner.get("rect", outer_rect), inner.get("masked", ma.masked_attention))
                got, seen = run()
                assert seen == [rect_name, rect_name] + [masked_name] * (masked_name is not None)
                assert all(map(torch.equal, got, want))
                if exit_by == "raise":
                    raise Planted
        assert tattn.current_attention() == (outer_rect, ma.masked_attention)
    assert tattn.current_attention() == default
    assert run()[1] == []
