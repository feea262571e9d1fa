"""The port's ``encode_image``, ``clip_forward`` and zero-shot CLIP against
rpo_tpu.

JAX weights from ``rpo_tpu.models.clip.init_clip`` at TINY and TINY_W128
are carried across with ``params_from_numpy``; images are made with numpy.
JAX's zero-shot text features come from ``ZeroshotCLIP._text_features_for``
itself, called with a namespace standing in for the trainer.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpo_tpu.data.transforms import device_normalize_fn as jax_normalize
from rpo_tpu.methods import templates as jtemplates
from rpo_tpu.methods.zsclip import ZeroshotCLIP as JaxZeroshotCLIP
from rpo_tpu.methods.zsclip import ZeroshotCLIP2 as JaxZeroshotCLIP2
from rpo_tpu.models.clip import ARCHS, cast_params, init_clip
from rpo_tpu.models.clip import model as jmodel
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from rpo_tpu_torch.methods import templates as ttemplates
from rpo_tpu_torch.methods import zsclip as tzs
from rpo_tpu_torch.models.clip import ARCHS as TARCHS, params_from_numpy
from rpo_tpu_torch.models.clip import model as tmodel

CLASSNAMES = ["cat", "dog_machine", "crimson finch", "a longer class name 7", "sea urchin"]
# f32: the same operations in the same order up to summation order.  bf16:
# rounding flips compound through the towers (see test_torch_port_rpo_eval.py);
# features are O(1); unit vectors agree to about 1%; logits are 14.3 x a
# cosine, so 0.15 is a cosine difference of 0.01.  clip_forward's logits
# are scaled and normalised in bf16 itself (the JAX quirk kept), so one
# bf16 ulp of a logit near 14 is 2^-4: allow two.
TOL = {
    "float32": dict(feat=dict(atol=1e-4, rtol=1e-4), unit=dict(atol=1e-5, rtol=0),
                    logits=dict(atol=1e-4, rtol=0)),
    "bfloat16": dict(feat=dict(atol=0.06, rtol=0), unit=dict(atol=0.01, rtol=0),
                     logits=dict(atol=0.15, rtol=0)),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", params=[(a, d) for a in ("TINY", "TINY_W128")
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    arch, dtype = request.param
    jp = cast_params(init_clip(jax.random.PRNGKey(0), ARCHS[arch]), JDT[dtype])
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return dict(arch=arch, dtype=dtype, jp=jp, tp=tp)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(jnp.asarray(j).astype(jnp.float32)), **tol)


def _images(dtype, seed=1):
    x = jnp.asarray(np.random.RandomState(seed).randn(3, 32, 32, 3).astype(np.float32))
    x = x.astype(JDT[dtype])
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(TDT[dtype])


def test_templates_are_copies():
    assert ttemplates.IMAGENET_TEMPLATES_SELECT == jtemplates.IMAGENET_TEMPLATES_SELECT
    assert ttemplates.CUSTOM_TEMPLATES == jtemplates.CUSTOM_TEMPLATES


def test_encode_image(case):
    jimgs, timgs = _images(case["dtype"])
    want = jmodel.encode_image(case["jp"], ARCHS[case["arch"]], jimgs)
    got = tmodel.encode_image(case["tp"], TARCHS[case["arch"]], timgs)
    assert got.dtype == TDT[case["dtype"]] and tuple(got.shape) == tuple(want.shape)
    _close(got, want, TOL[case["dtype"]]["feat"])


def test_clip_forward(case):
    from rpo_tpu.tokenizer import tokenize

    jimgs, timgs = _images(case["dtype"], seed=2)
    tokens = tokenize(["a photo of a cat.", "a photo of a glass teapot on a table.", "x"])[:, :16]
    want_i, want_t = jmodel.clip_forward(case["jp"], ARCHS[case["arch"]], jimgs, jnp.asarray(tokens))
    got_i, got_t = tmodel.clip_forward(case["tp"], TARCHS[case["arch"]], timgs,
                                       torch.from_numpy(tokens.astype(np.int64)))
    # exp(logit_scale) is cast to the activation dtype, as in the JAX package
    assert got_i.dtype == TDT[case["dtype"]] and tuple(got_i.shape) == (3, 3)
    tol = TOL[case["dtype"]]["logits"] if case["dtype"] == "float32" else dict(atol=2 * 2.0 ** -4)
    _close(got_i, want_i, tol)
    np.testing.assert_array_equal(got_t.float().numpy(), got_i.T.float().numpy())


def test_encode_image_refuses_resnet():
    """The ResNet tower against JAX's: TINY_RN with every BatchNorm
    statistic redrawn, float32, within 1e-4 of the largest feature
    (tests/test_torch_port_resnet.py holds the stages, bf16 and full
    RN50)."""
    from tests.test_torch_port_resnet import randomise_bn

    tree = randomise_bn(jax.tree_util.tree_map(
        np.asarray, init_clip(jax.random.PRNGKey(3), ARCHS["TINY_RN"])))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    jimgs, timgs = _images("float32", seed=3)
    want = np.asarray(jmodel.encode_image(jp, ARCHS["TINY_RN"], jimgs))
    got = tmodel.encode_image(tp, TARCHS["TINY_RN"], timgs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 64)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def _jax_self(jp, arch):
    """The attributes ``ZeroshotCLIP._text_features_for`` reads."""
    return types.SimpleNamespace(dm=types.SimpleNamespace(classnames=CLASSNAMES),
                                 clip_cfg=ARCHS[arch], clip_params=jp)


@pytest.mark.parametrize("ensemble", [False, True], ids=["one_template", "ensemble"])
def test_text_features_equal_jax(case, ensemble):
    templates = (list(jtemplates.IMAGENET_TEMPLATES_SELECT) + ["a photo of a {}."] if ensemble
                 else ["a photo of a {}, a type of pet."])
    want = JaxZeroshotCLIP._text_features_for(_jax_self(case["jp"], case["arch"]), templates)
    tokens = torch.from_numpy(tzs.template_tokens(CLASSNAMES, templates).astype(np.int64))
    assert tuple(tokens.shape[:2]) == (len(templates), len(CLASSNAMES))
    got = tzs.zeroshot_text_features(case["tp"], TARCHS[case["arch"]], tokens)
    assert got.dtype == torch.float32
    _close(got, want, TOL[case["dtype"]]["unit"])
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("dataset", ["ImageNet", "Caltech101", "OxfordPets"])
def test_template_selection_equals_jax(dataset):
    ns = types.SimpleNamespace(cfg=types.SimpleNamespace(DATASET=types.SimpleNamespace(NAME=dataset)),
                               templates=JaxZeroshotCLIP2.templates)
    for jcls, tcls in ((JaxZeroshotCLIP, tzs.ZeroshotCLIP), (JaxZeroshotCLIP2, tzs.ZeroshotCLIP2)):
        want = jcls._select_templates(ns)
        got = tcls(CLASSNAMES, dataset, backbone="TINY", device="cpu").templates
        assert got == want
    # ImageNet's own template is not appended to the ensemble
    n = len(tzs.ZeroshotCLIP2(CLASSNAMES, dataset, backbone="TINY", device="cpu").templates)
    assert n == (7 if dataset == "ImageNet" else 8)


@pytest.mark.parametrize("cls", [tzs.ZeroshotCLIP, tzs.ZeroshotCLIP2])
@pytest.mark.parametrize("arch", ["TINY", "TINY_W128"])
def test_eval_logits_equal_jax(arch, cls):
    """eval_step on uint8 images == the JAX zero-shot eval composition
    (bf16 backbone, f32 normalised features, f32 scale)."""
    jp = cast_params(init_clip(jax.random.PRNGKey(0), ARCHS[arch]), jnp.bfloat16)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    zs = cls(CLASSNAMES, "OxfordPets", backbone=arch, device="cpu", clip_params=tp)
    assert zs.clip_params["visual"]["proj"].dtype == torch.bfloat16
    text_f = JaxZeroshotCLIP._text_features_for(_jax_self(jp, arch), zs.templates)
    _close(zs.text_features(), text_f, TOL["bfloat16"]["unit"])
    images = np.random.RandomState(3).randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=jnp.bfloat16)
    imf = jmodel.encode_image(jp, ARCHS[arch], normalize(jnp.asarray(images))).astype(jnp.float32)
    imf = imf / jnp.linalg.norm(imf, axis=-1, keepdims=True)
    want = jnp.exp(jp["logit_scale"].astype(jnp.float32)) * imf @ text_f.T
    got = zs.eval_step(images)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, len(CLASSNAMES))
    _close(got, want, TOL["bfloat16"]["logits"])
    np.testing.assert_array_equal(zs.model_inference(images), got.numpy())


def test_backbone_is_bf16_whatever_the_input_dtype():
    tp = tmodel.init_clip(torch.Generator().manual_seed(0), TARCHS["TINY"])
    zs = tzs.ZeroshotCLIP(CLASSNAMES, "Caltech101", backbone="TINY", device="cpu", clip_params=tp)
    assert zs.clip_params["text"]["token_embedding"].dtype == torch.bfloat16
    assert zs.clip_params["logit_scale"].dtype == torch.float32
    assert zs.text_features() is zs.text_features()  # computed once
