"""The port's CLIP model stages and weight bridge against rpo_tpu's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpo_tpu.models.clip import model as jmodel
from rpo_tpu_torch.models.clip import bridge, model as tmodel

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# encode_text / vision_embed outputs: f32 differs only in summation order;
# bf16 compounds one-ulp rounding flips through a 2-layer tower (see
# test_torch_port_layers.py), on features of magnitude below 2.
TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=8 * 2.0 ** -8 * 2, rtol=0)}


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.fixture(scope="module", params=["TINY", "TINY_W128"])
def arch(request):
    return request.param


def _params(arch, dtype):
    jdt, _ = DTYPES[dtype]
    jp = jmodel.cast_params(jmodel.init_clip(jax.random.PRNGKey(0), jmodel.ARCHS[arch]), jdt)
    return jp, bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def test_configs_are_copies():
    for name, cfg in jmodel.ARCHS.items():
        mine = tmodel.ARCHS[name]
        assert mine.__dict__ == cfg.__dict__, name
        assert (mine.is_vit, mine.vision_heads) == (cfg.is_vit, cfg.vision_heads)
        if cfg.is_vit:
            assert mine.vision_seq_len == cfg.vision_seq_len


def test_init_clip_tree_and_distributions():
    """Same keys, shapes and dtypes as the JAX init; the same stds."""
    cfg = tmodel.ARCHS["TINY_W128"]
    jp = jmodel.init_clip(jax.random.PRNGKey(0), jmodel.ARCHS["TINY_W128"], jnp.bfloat16)
    tp = tmodel.init_clip(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert _flat(tp) == _flat(jp)
    big = tmodel.init_clip(torch.Generator().manual_seed(1), tmodel.ARCHS["TINY"])
    np.testing.assert_allclose(big["text"]["token_embedding"].std().item(), 0.02, rtol=0.01)
    np.testing.assert_allclose(
        big["text"]["blocks"]["attn"]["qkv_w"].std().item(), 64 ** -0.5, rtol=0.02
    )
    assert big["logit_scale"].item() == pytest.approx(np.log(1 / 0.07))


def test_cast_params_keeps_logit_scale_f32():
    tp = tmodel.init_clip(torch.Generator().manual_seed(0), tmodel.ARCHS["TINY"])
    cast = tmodel.cast_params(tp, torch.bfloat16)
    assert cast["logit_scale"].dtype == torch.float32
    assert cast["visual"]["blocks"]["attn"]["qkv_w"].dtype == torch.bfloat16


def test_causal_mask():
    np.testing.assert_array_equal(tmodel.causal_mask(9).numpy(), np.asarray(jmodel.causal_mask(9)))


def test_patchify_order():
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tmodel.patchify(torch.from_numpy(x), 16).numpy(), np.asarray(jmodel.patchify(jnp.asarray(x), 16))
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vision_embed(arch, dtype):
    jp, tp = _params(arch, dtype)
    cfg = jmodel.ARCHS[arch]
    x = np.random.RandomState(1).randn(3, 32, 32, 3).astype(np.float32)
    want = jmodel.vision_embed(jp["visual"], cfg, jnp.asarray(x))
    got = tmodel.vision_embed(tp["visual"], tmodel.ARCHS[arch], torch.from_numpy(x))
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_text(arch, dtype):
    from rpo_tpu.tokenizer import tokenize

    jp, tp = _params(arch, dtype)
    tokens = tokenize(["a photo of a cat.", "a photo of a glass teapot on a table."])[:, :16]
    want = jmodel.encode_text(jp, jmodel.ARCHS[arch], jnp.asarray(tokens))
    got = tmodel.encode_text(tp, tmodel.ARCHS[arch], torch.from_numpy(tokens.astype(np.int64)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[dtype])


def test_text_embed():
    jp, tp = _params("TINY", "float32")
    tokens = np.array([[49406, 320, 1125, 49407, 0]], np.int32)
    np.testing.assert_array_equal(
        tmodel.text_embed(tp["text"], torch.from_numpy(tokens.astype(np.int64))).numpy(),
        np.asarray(jmodel.text_embed(jp["text"], jnp.asarray(tokens))),
    )


def test_bridge_copies_and_keeps_bf16_exact():
    src = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "n": {"s": np.float32(2.5)}}
    out = bridge.params_from_numpy(src, "cpu")
    src["a"][0, 0] = 100.0
    assert out["a"][0, 0].item() == 0.0  # a copy, not a view
    assert out["n"]["s"].shape == () and out["n"]["s"].item() == 2.5
    jb = jax.random.normal(jax.random.PRNGKey(0), (64,), jnp.float32).astype(jnp.bfloat16)
    tb = bridge.params_from_numpy({"w": np.asarray(jb)}, "cpu")["w"]
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy(), np.asarray(jb.astype(jnp.float32)))
    cast = bridge.params_from_numpy({"w": np.ones(3, np.float32), "logit_scale": np.float32(1)},
                                    "cpu", torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["logit_scale"].dtype == torch.float32
