"""The port's masked attention against the JAX package's ``pallas_attention``.

``masked_attention`` on a CPU tensor runs its plain version
(``masked_attention_reference``); the Pallas kernel runs in interpret mode,
as tests/test_pallas_attention.py runs it, and the XLA branch of
``rpo_tpu.ops.attention.dot_product_attention`` is the second oracle.
Inputs are made with numpy from a seed and fed to both sides.  The CUDA
kernel itself is checked by the ``gpu`` test at the end, which skips
without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpo_tpu.ops.attention as jattn
import rpo_tpu.ops.pallas_attention as jpallas
from rpo_tpu.methods.rpo import build_text_mask
from rpo_tpu_torch.ops import attention as tattn
from rpo_tpu_torch.ops import masked_attention as ma

NEG_INF = -1e9
# f32: the tolerance tests/test_pallas_attention.py holds the Pallas kernel
# to against XLA.  bf16: both sides round p and the output to bf16 once; a
# different f32 summation order can move either by one bf16 ulp (2^-8
# relative), so allow two ulps at the outputs' magnitude (< 4).
TOL = {
    "float32": dict(atol=1e-5, rtol=1e-5),
    "bfloat16": dict(atol=2 * 2.0 ** -8 * 4, rtol=0),
}


def _causal(L):
    i = np.arange(L)
    return np.where(i[None, :] > i[:, None], NEG_INF, 0.0).astype(np.float32)


def _bias(case, B, L):
    """The additive f32 bias of each case, (1 | B, 1, L, L)."""
    if case == "per_batch_causal_colblock":  # tests/test_pallas_attention.py:17-22
        bias = np.tile(_causal(L), (B, 1, 1, 1)).reshape(B, 1, L, L)
        for b in range(B):
            bias[b, 0, :, L - 1 - b :] = NEG_INF
        return bias
    if case == "shared_causal":
        return _causal(L)[None, None]
    if case == "fully_masked_row":
        bias = np.tile(_causal(L), (B, 1, 1, 1)).reshape(B, 1, L, L)
        bias[1, 0, 4, :] = NEG_INF  # every column of one row blocked
        return bias
    if case == "text_mask_77":  # the RPO per-class text mask
        return build_text_mask(np.array([5, 9, 13, 20])[:B], L)
    raise KeyError(case)


CASES = {  # case: (B, H, L, D)
    "per_batch_causal_colblock": (3, 2, 10, 32),
    "shared_causal": (3, 2, 24, 64),
    "fully_masked_row": (3, 2, 10, 32),
    "text_mask_77": (4, 2, 77, 64),
}


def _inputs(case, seed, dtype="float32"):
    B, H, L, D = CASES[case]
    r = np.random.RandomState(seed)
    arrs = [r.randn(B, H, L, D) for _ in range(3)]
    jx = [jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in jx]
    bias = _bias(case, B, L)
    return jx, tx, jnp.asarray(bias), torch.from_numpy(bias)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_pallas_attention(case, dtype):
    (jq, jk, jv), (tq, tk, tv), jb, tb = _inputs(case, 0, dtype)
    want = np.asarray(jpallas.pallas_attention(jq, jk, jv, jb, True).astype(jnp.float32))
    got = ma.masked_attention(tq, tk, tv, tb)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    np.testing.assert_array_equal(_np(got), _np(ma.masked_attention_reference(tq, tk, tv, tb)))


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_xla_attention(case):
    (jq, jk, jv), (tq, tk, tv), jb, tb = _inputs(case, 1)
    want = np.asarray(jattn.dot_product_attention(jq, jk, jv, jb))
    np.testing.assert_allclose(_np(ma.masked_attention(tq, tk, tv, tb)), want, **TOL["float32"])


def test_fully_masked_row_gets_uniform_weights():
    """-1e9 absorbs the score in f32, so a row whose every column is
    blocked averages v: neither NaN nor zeros."""
    _, (tq, tk, tv), _, tb = _inputs("fully_masked_row", 2)
    out = ma.masked_attention(tq, tk, tv, tb)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(_np(out[1, :, 4]), _np(tv[1].mean(dim=1)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["per_batch_causal_colblock", "shared_causal"])
def test_backward_matches_jax_grad(case):
    (jq, jk, jv), (tq, tk, tv), jb, tb = _inputs(case, 3)
    cot = np.random.RandomState(4).randn(*tq.shape).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jpallas.pallas_attention(q, k, v, jb, True) * cot), argnums=(0, 1, 2)
    )(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    bias = tb.clone().requires_grad_(True)
    (ma.masked_attention(*leaves, bias) * torch.from_numpy(cot)).sum().backward()
    for w, t in zip(want, leaves):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=1e-4, atol=1e-5)
    assert bias.grad is None  # a static mask: no gradient, as JAX's zero cotangent


GUARD_CASES = {  # name: (q (B, H, Lq, D), k length, bias shape), the guard of rpo_tpu/ops/attention.py:128-143
    "shared (1, 1, L, L)": ((3, 2, 10, 32), 10, (1, 1, 10, 10)),
    "per-batch (B, 1, L, L)": ((3, 2, 10, 32), 10, (3, 1, 10, 10)),
    "per-head (B, H, L, L)": ((3, 2, 10, 32), 10, (3, 2, 10, 10)),
    "column-broadcast (B, 1, L, 1)": ((3, 2, 10, 32), 10, (3, 1, 10, 1)),
    "row-broadcast (1, 1, 1, L)": ((3, 2, 10, 32), 10, (1, 1, 1, 10)),
    "bias batch 2 against batch 3": ((3, 2, 10, 32), 10, (2, 1, 10, 10)),
    "Lq != Lk (cached cross-attention)": ((3, 2, 4, 32), 10, (3, 1, 1, 10)),
}


def _jax_takes_kernel(q_shape, Lk, bias_shape) -> bool:
    """Whether the JAX package's dispatch, with its Pallas scope on, calls
    ``pallas_attention`` for these shapes."""

    class Called(Exception):
        pass

    def fake(*_args, **_kwargs):
        raise Called

    B, H, Lq, D = q_shape
    q = jnp.zeros(q_shape, jnp.float32)
    kv = jnp.zeros((B, H, Lk, D), jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "use_pallas_attention", lambda: True)
        mp.setattr(jpallas, "pallas_attention", fake)
        try:
            jattn.dot_product_attention(q, kv, kv, jnp.zeros(bias_shape, jnp.float32))
        except Called:
            return True
        except (TypeError, ValueError):  # XLA refuses a non-broadcastable bias
            return False
    return False


@pytest.mark.parametrize("name", list(GUARD_CASES))
def test_dispatch_predicate_is_the_jax_guard(name):
    q_shape, Lk, bias_shape = GUARD_CASES[name]
    B, H, Lq, D = q_shape
    q, kv = torch.zeros(q_shape), torch.zeros(B, H, Lk, D)
    expected = _jax_takes_kernel(q_shape, Lk, bias_shape)
    assert tattn.takes_masked_kernel(q, kv, torch.zeros(bias_shape)) == expected
    assert expected == name.startswith(("shared", "per-batch"))


@pytest.mark.parametrize("name", [n for n in GUARD_CASES if n != "bias batch 2 against batch 3"])
def test_dispatch_routes_and_plain_branch_matches_xla(name):
    """A bias that passes the guard goes to the masked function in force;
    every other bias takes the plain math, which equals the JAX package's
    XLA branch."""
    q_shape, Lk, bias_shape = GUARD_CASES[name]
    B, H, Lq, D = q_shape
    r = np.random.RandomState(5)
    q, k, v = r.randn(*q_shape), r.randn(B, H, Lk, D), r.randn(B, H, Lk, D)
    bias = np.where(r.rand(*bias_shape) < 0.3, NEG_INF, 0.0).astype(np.float32)
    calls = []

    def masked(*args):
        calls.append(args)
        return ma.masked_attention_reference(*args)

    t = [torch.from_numpy(a.astype(np.float32)) for a in (q, k, v, bias)]
    with tattn.attention_functions(masked=masked):
        got = tattn.dot_product_attention(*t)
    assert len(calls) == tattn.takes_masked_kernel(t[0], t[1], t[3])
    want = jattn.dot_product_attention(*(jnp.asarray(a, jnp.float32) for a in (q, k, v, bias)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL["float32"])


def test_wrapper_refuses_other_devices():
    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ma.masked_attention(q, q, q, torch.zeros(1, 1, 4, 4, device="meta"))


def _bad_inputs():
    z = torch.zeros
    qkv = (z(2, 3, 9, 64),) * 3
    return {
        "dtype": (TypeError, (z(2, 3, 9, 64, dtype=torch.float16),) * 3 + (z(1, 1, 9, 9),)),
        "head dim": (ValueError, (z(2, 3, 9, 48),) * 3 + (z(1, 1, 9, 9),)),
        "not square": (ValueError, (qkv[0], z(2, 3, 7, 64), z(2, 3, 7, 64), z(1, 1, 9, 7))),
        "bias not f32": (TypeError, qkv + (z(1, 1, 9, 9, dtype=torch.bfloat16),)),
        "bias last dims": (ValueError, qkv + (z(1, 1, 9, 1),)),
        "bias per head": (ValueError, qkv + (z(2, 3, 9, 9),)),
        "bias batch": (ValueError, qkv + (z(3, 1, 9, 9),)),
        "bias rank": (ValueError, qkv + (z(9, 9),)),
        "bias last dim stride": (ValueError, qkv + (z(1, 1, 9, 9).transpose(2, 3),)),
        "row alignment": (ValueError, (z(2, 3, 9, 65)[..., 1:],) + qkv[1:] + (z(1, 1, 9, 9),)),
        "L over shared memory, bf16": (ValueError, (z(1, 1, 769, 64, dtype=torch.bfloat16),) * 3
                                       + (z(1, 1, 769, 769),)),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_kernel_wrapper_checks_its_inputs(case):
    """What the CUDA launch refuses, checked before the pointers leave
    Python (the check itself needs no card)."""
    exc, args = _bad_inputs()[case]
    with pytest.raises(exc):
        ma._check(*args)


def test_kernel_wrapper_takes_the_text_towers_views():
    """The text tower's q, k, v are head views of the fused QKV output and
    the causal bias is shared: the kernel takes them as they are."""
    B, L, H, D = 5, 24, 8, 64
    qkv = torch.zeros(B, L, 3, H, D, dtype=torch.bfloat16).permute(2, 0, 3, 1, 4)
    ma._check(qkv[0], qkv[1], qkv[2], torch.zeros(1, 1, L, L))


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for case, seed in (("text_mask_77", 0), ("fully_masked_row", 1), ("shared_causal", 2)):
        _, tx, _, tb = _inputs(case, seed, "bfloat16")
        q, k, v = (t.cuda() for t in tx)
        bias = tb.cuda()
        before = ma.launches
        got = ma.masked_attention(q, k, v, bias)
        torch.cuda.synchronize()
        assert ma.launches == before + 1
        err = (got.float() - ma.masked_attention_reference(q, k, v, bias).float()).abs().max().item()
        assert err <= 2e-2, (case, err)
