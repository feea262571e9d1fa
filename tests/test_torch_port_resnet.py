"""The port's ModifiedResNet tower (``rpo_tpu_torch/models/clip/resnet.py``)
against ``rpo_tpu.models.clip.resnet``.

JAX's weights are carried across with ``params_from_numpy``.  JAX's
``init_resnet_visual`` leaves every BatchNorm the identity, so each BN
leaf is first redrawn with numpy (var > 0): a port that skipped or
reordered a BN would otherwise pass.  Images and activations are made
from a seed with numpy.  Tolerances, relative to the largest feature:
float32 1e-4; bfloat16 3e-2 and a per-row cosine of at least 0.999.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpo_tpu.models.clip import ARCHS, cast_params, init_clip
from rpo_tpu.models.clip import model as jmodel
from rpo_tpu.models.clip import resnet as jres
from rpo_tpu_torch.models.clip import ARCHS as TARCHS, params_from_numpy
from rpo_tpu_torch.models.clip import model as tmodel
from rpo_tpu_torch.models.clip import resnet as tres

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REL = {"float32": 1e-4, "bfloat16": 3e-2}
MIN_COS = 0.999
# TINY_RN with two blocks in its first stage: the second has no downsample
TINY_RN2 = dataclasses.replace(ARCHS["TINY_RN"], vision_layers=(2, 1, 1, 1))


def randomise_bn(tree, seed: int = 7):
    """Every BN dict of a numpy tree redrawn: scale ~ 1 +- 0.2, bias and
    mean ~ 0 +- 0.1, var in [0.5, 2)."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                c = node["scale"].shape
                return {"scale": (1 + 0.2 * rng.randn(*c)).astype(np.float32),
                        "bias": (0.1 * rng.randn(*c)).astype(np.float32),
                        "mean": (0.1 * rng.randn(*c)).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(tree)


# jitted: eager JAX draws RN50's weights in ~20 s, its tower in ~8 s
_jinit = jax.jit(init_clip, static_argnums=1)
_jencode = jax.jit(jmodel.encode_image, static_argnums=1)


@functools.lru_cache(maxsize=1)  # the last tree: RN50's is ~0.5 GB
def _numpy_tree(cfg):
    tree = jax.tree_util.tree_map(np.asarray, _jinit(jax.random.PRNGKey(0), cfg))
    return randomise_bn(tree)


def rn_params(cfg, dtype: str):
    """(JAX params, the port's) of one random RN CLIP with randomised BN,
    cast to ``dtype`` on both sides."""
    jp = cast_params(jax.tree_util.tree_map(jnp.asarray, _numpy_tree(cfg)), JDT[dtype])
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def to_torch(x, dtype: str):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(TDT[dtype])


def assert_close(got: torch.Tensor, want, dtype: str, rows: bool = True):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.float().numpy().astype(np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 0
    err = np.abs(got - want).max()
    assert err <= REL[dtype] * scale, (err, scale)
    if dtype == "bfloat16" and rows:
        g, w = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
        cos = (g * w).sum(-1) / np.linalg.norm(g, axis=-1) / np.linalg.norm(w, axis=-1)
        assert cos.min() >= MIN_COS, cos


def nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as the port's NCHW channels_last view."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def tiny(request):
    dtype = request.param
    jp, tp = rn_params(TINY_RN2, dtype)
    return dict(dtype=dtype, jp=jp, tp=tp)


@pytest.mark.parametrize("where", ["downsample", "identity"])
def test_bottleneck(tiny, where):
    """Stage 1's first block (a downsample at stride 1, 16 -> 64 channels)
    and its second (the identity), and stage 2's first (stride 2)."""
    dtype = tiny["dtype"]
    layers = tiny["jp"]["visual"]["layers"]
    tlayers = tiny["tp"]["visual"]["layers"]
    rng = np.random.RandomState(3)
    cases = {"downsample": [(0, 0, 1, 16), (1, 0, 2, 64)], "identity": [(0, 1, 1, 64)]}[where]
    for li, bi, stride, c in cases:
        assert ("downsample" in layers[li][bi]) == (where == "downsample")
        x = jnp.asarray(rng.randn(2, 8, 8, c).astype(np.float32)).astype(JDT[dtype])
        want = jres.bottleneck(x, layers[li][bi], stride)
        got = tres.bottleneck(nchw(to_torch(x, dtype)), tlayers[li][bi], stride)
        assert got.dtype == TDT[dtype]
        assert_close(nhwc(got), want, dtype)


def test_attention_pool(tiny):
    dtype = tiny["dtype"]
    heads = TINY_RN2.vision_heads
    x = jnp.asarray(np.random.RandomState(4).randn(3, 1, 1, 512).astype(np.float32))
    x = x.astype(JDT[dtype])
    want = jres.attention_pool(x, tiny["jp"]["visual"]["attnpool"], heads)
    got = tres.attention_pool(nchw(to_torch(x, dtype)), tiny["tp"]["visual"]["attnpool"], heads)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (3, 64)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_pool_on_a_grid(dtype):
    """A 7 x 7 grid (RN50's at 224): 50 tokens, the mean token's query."""
    rng = np.random.RandomState(5)
    pool = {**_numpy_tree(TINY_RN2)["visual"]["attnpool"],
            "positional_embedding": (rng.randn(50, 512) / 512 ** 0.5).astype(np.float32)}
    jpool = cast_params(jax.tree_util.tree_map(jnp.asarray, pool), JDT[dtype])
    tpool = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpool), "cpu")
    x = jnp.asarray(rng.randn(2, 7, 7, 512).astype(np.float32)).astype(JDT[dtype])
    heads = TINY_RN2.vision_heads
    want = jres.attention_pool(x, jpool, heads)
    got = tres.attention_pool(nchw(to_torch(x, dtype)), tpool, heads)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 2])
def test_avg_pool(dtype, window):
    x = jnp.asarray((np.random.RandomState(6).randn(2, 6, 8, 5) * 3).astype(np.float32))
    x = x.astype(JDT[dtype])
    want = jres.avg_pool(x, window)
    got = nhwc(tres.avg_pool(nchw(to_torch(x, dtype)), window))
    assert got.dtype == TDT[dtype]
    # one rounding of the float32 sum, then the division: exact
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want).astype(jnp.float32)))


def test_batch_norm_reads_every_statistic(tiny):
    """The stem's first BN against JAX's on the same conv output; each of
    the four statistics moved alone moves the output."""
    dtype = tiny["dtype"]
    p = tiny["tp"]["visual"]["stem"]["bn1"]
    jp = tiny["jp"]["visual"]["stem"]["bn1"]
    x = jnp.asarray(np.random.RandomState(8).randn(2, 5, 5, 8).astype(np.float32) * 2)
    x = x.astype(JDT[dtype])
    got = tres.batch_norm(nchw(to_torch(x, dtype)), p)
    assert_close(nhwc(got), jres.batch_norm(x, jp), dtype)
    for key in p:
        moved = {**p, key: p[key] + 0.5}
        assert not torch.equal(tres.batch_norm(nchw(to_torch(x, dtype)), moved), got), key


def test_encode_image_tiny(tiny):
    dtype = tiny["dtype"]
    imgs = jnp.asarray(np.random.RandomState(1).randn(3, 32, 32, 3).astype(np.float32))
    imgs = imgs.astype(JDT[dtype])
    want = _jencode(tiny["jp"], TINY_RN2, imgs)
    got = tmodel.encode_image(tiny["tp"], TINY_RN2, to_torch(imgs, dtype))
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (3, 64)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_image_rn50_full_width(dtype):
    """RN50 at its full width and depth, 224 x 224, batch 2."""
    cfg = ARCHS["RN50"]
    jp, tp = rn_params(cfg, dtype)
    imgs = jnp.asarray(np.random.RandomState(2).randn(2, 224, 224, 3).astype(np.float32))
    imgs = imgs.astype(JDT[dtype])
    want = _jencode(jp, cfg, imgs)
    got = tmodel.encode_image(tp, TARCHS["RN50"], to_torch(imgs, dtype))
    assert tuple(got.shape) == (2, 1024)
    assert_close(got, want, dtype)
    # the kernels laid out once give the same features
    laid = {**tp, "visual": tres.conv_layout(tp["visual"])}
    assert torch.equal(tmodel.encode_image(laid, TARCHS["RN50"], to_torch(imgs, dtype)), got)


def test_conv_layout_keeps_values_and_shapes():
    _, tp = rn_params(TINY_RN2, "float32")
    v = tp["visual"]
    laid = tres.conv_layout(v)
    kernel = laid["layers"][0][0]["conv2"]
    assert torch.equal(kernel, v["layers"][0][0]["conv2"])
    assert kernel.permute(3, 2, 0, 1).is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(laid["layers"][0][0]["downsample"]["conv"],
                       v["layers"][0][0]["downsample"]["conv"])
    assert laid["attnpool"] is v["attnpool"]
    assert laid["layers"][0][0]["bn1"] is v["layers"][0][0]["bn1"]


def _structure(tree):
    """(key path, shape, dtype name) of every leaf, lists by index."""
    out = []

    def walk(path, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(path + (k,), node[k])
        elif isinstance(node, (list, tuple)):
            assert isinstance(node, list), path
            for i, v in enumerate(node):
                walk(path + (i,), v)
        else:
            out.append((path, tuple(node.shape), str(node.dtype).split(".")[-1]))

    walk((), tree)
    return out


@pytest.mark.parametrize("arch", ["TINY_RN", "RN50", "RN101", "RN50x4", "RN50x16"])
def test_init_clip_tree_matches_jax(arch, monkeypatch):
    """The port's ``init_clip`` of every RN arch has JAX's tree: the same
    keys, lists, shapes and dtypes (the draws on the meta device, so no
    weights are made; JAX's tree by ``jax.eval_shape``)."""
    want = jax.eval_shape(lambda k: init_clip(k, ARCHS[arch]), jax.random.PRNGKey(0))
    meta = torch.device("meta")
    for name in ("randn", "zeros", "ones"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *shape, _real=real, generator=None, device=None,
                            **kw: _real(*shape, device=meta, **kw))
    got = tmodel.init_clip(torch.Generator(), TARCHS[arch])
    assert _structure(got) == _structure(want)


def test_cast_params_and_bridge_carry_lists():
    jp, tp = rn_params(TINY_RN2, "float32")
    assert isinstance(tp["visual"]["layers"], list)
    assert all(isinstance(layer, list) for layer in tp["visual"]["layers"])
    cast = tmodel.cast_params(tp, torch.bfloat16)
    assert isinstance(cast["visual"]["layers"][0], list)
    assert cast["visual"]["layers"][0][0]["bn1"]["var"].dtype == torch.bfloat16
    assert cast["logit_scale"].dtype == torch.float32
    # the bridge's own cast agrees with JAX's cast_params leaf for leaf
    jb = cast_params(jp, jnp.bfloat16)
    tb = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu", torch.bfloat16)
    assert _structure(tb) == _structure(jb)
    for (path, _, _), a, b in zip(_structure(tb), jax.tree_util.tree_leaves(jb),
                                  _leaves(tb)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a.astype(jnp.float32)), err_msg=str(path))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
