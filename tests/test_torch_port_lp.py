"""The port's linear probe against rpo_tpu.methods.linear_probe.

JAX weights from ``rpo_tpu.models.clip.init_clip`` at TINY, in float32
and bfloat16, carried across with ``params_from_numpy``; the probe's
weight and bias, the images, labels and row mask are made with numpy and
are the same on both sides.  The JAX step is ``_make_train_step`` over
``lp_logits`` built on a stub with the SGD attributes it reads, as
``LP.build_method`` builds it; its train path runs XLA attention, and
the logits are also held to its eval path on the Pallas kernels in
interpret mode.  On the CPU the port runs its kernels' plain versions.

Tolerances.  float32: the same operations up to summation order, so text
features within 1e-5, the loss within 1e-5, logits within 1e-4 and the
gradient, updated tensors and momentum within 1e-5 of their largest
entry.  bfloat16: text features within 0.06 (tests/test_torch_port_
coop_eval.py's); a gradient as tests/test_torch_port_rpo_train.py holds
one (its largest error within 0.1 of its largest entry, cosine >= 0.99);
logits by that file's 0.15 taken relative to CLIP's logit scale
exp(logit_scale) = 14.3, the largest a cosine logit reaches: the probe's
logits are products of unnormalised features (up to ~30 here), so within
0.15 / 14.3 of the largest |logit|, and the loss, which moves by at most
twice the largest logit difference, within twice that.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpo_tpu.ops.attention as jattn
import rpo_tpu.ops.pallas_attention as jpallas
from rpo_tpu.data.transforms import device_normalize_fn as jax_normalize
from rpo_tpu.engine.optim import sgd_init
from rpo_tpu.methods import linear_probe as jlp
from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
from rpo_tpu.models.clip import ARCHS, cast_params, encode_text, init_clip
from rpo_tpu.tokenizer import eot_trim, tokenize
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from rpo_tpu_torch.methods import linear_probe as tlp
from rpo_tpu_torch.models.clip import ARCHS as TARCHS, params_from_numpy
from tests.test_torch_port_rpo_train import BF16_GRAD_COS, BF16_GRAD_REL, TOL

# the raw classnames go into the prompt: an underscore stays
CLASSNAMES = ["cat", "dog_machine", "crimson finch", "a longer class name 7", "sea urchin", "x"]
PROMPT = "A photo of a {cls_name}"  # TRAINER.LP.PROMPT's default
LABELS = np.array([0, 2, 4, 5])
MASK = np.array([1, 1, 1, 0], np.float32)  # the last row is padding
LR = 0.002
F32_REL = 1e-5
FEAT_TOL = {"float32": 1e-5, "bfloat16": 0.06}
BF16_LOGITS_REL = TOL["bfloat16"]["logits"] / 14.3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PREC = {"float32": "fp32", "bfloat16": "fp16"}
STUB = types.SimpleNamespace(_momentum=0.9, _weight_decay=5e-4, _nesterov=False, _dampening=0.0)


@functools.lru_cache(maxsize=None)
def _case(dtype):
    cfg = ARCHS["TINY"]
    jp = cast_params(init_clip(jax.random.PRNGKey(0), cfg), JDT[dtype])
    rng = np.random.RandomState(1)
    d = cfg.embed_dim
    probe = {"w": (np.eye(d) + rng.randn(d, d) * 0.05).astype(np.float32),
             "b": (rng.randn(d) * 0.05).astype(np.float32)}
    tokens = jnp.asarray(eot_trim(tokenize([PROMPT.format(cls_name=c) for c in CLASSNAMES])))
    tf = encode_text(jp, cfg, tokens).astype(jnp.float32)
    text_f = tf / jnp.linalg.norm(tf, axis=-1, keepdims=True)
    normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=JDT[dtype])
    images = np.random.RandomState(2).randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)

    def logits_fn(p, fr, u8):
        return jlp.lp_logits(p, fr["clip"], cfg, fr["text_f"], normalize(u8))

    def loss_fn(p, fr, u8):
        logits = logits_fn(p, fr, u8)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(LABELS)[:, None], axis=-1)[:, 0]
        return jnp.sum(nll * MASK) / jnp.sum(MASK), logits

    step = JaxTrainer._make_train_step(STUB, logits_fn)

    @jax.jit
    def run(p, fr, u8):
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, fr, u8)
        return (loss, logits, grads), step(p, sgd_init(p), fr, u8, jnp.asarray(LABELS),
                                           jnp.asarray(MASK), jnp.float32(LR))

    frozen = {"clip": jp, "text_f": text_f}
    return dict(dtype=dtype, cfg=cfg, jp=jp, probe=probe, text_f=text_f, images=images,
                normalize=normalize, frozen=frozen,
                tp=params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
                run=lambda: run(jax.tree_util.tree_map(jnp.asarray, probe), frozen,
                                jnp.asarray(images)))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def case(request):
    return _case(request.param)


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def _close_as_gradient(got, want, dtype, what):
    for key in want:
        g, w = _np(got[key]).ravel(), _np(want[key]).ravel()
        big, err = np.abs(w).max(), np.abs(g - w).max()
        assert big > 0, (what, key)
        if dtype == "float32":
            assert err <= F32_REL * big, f"{what} {key}: max err {err} at max {big}"
        else:
            cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
            assert err / big <= BF16_GRAD_REL and cos >= BF16_GRAD_COS, (
                f"{what} {key}: max err / max {err / big}, cosine {cos}")


def _logits_tol(dtype, want):
    """(logits, loss) bounds: float32's; bfloat16's relative to the largest
    |logit|."""
    if dtype == "float32":
        return TOL[dtype]["logits"], TOL[dtype]["loss"]
    atol = BF16_LOGITS_REL * float(np.abs(_np(want)).max())
    return atol, 2 * atol


def _port(case, probe=True):
    lp = tlp.LP(CLASSNAMES, PROMPT, backbone="TINY", prec=PREC[case["dtype"]], device="cpu",
                clip_params=case["tp"])
    if probe:
        lp.set_ckpt_state(lp.model_name, case["probe"])
    return lp


def test_text_features_equal_jax(case):
    """Frozen at the build: the raw classnames in TRAINER.LP.PROMPT,
    EOT-trimmed, normalised, float32."""
    lp = _port(case, probe=False)
    got = lp._frozen["text_f"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(CLASSNAMES), 64)
    np.testing.assert_allclose(_np(got), _np(case["text_f"]), atol=FEAT_TOL[case["dtype"]],
                               rtol=0)
    with_space = tlp.lp_text_features(case["tp"], TARCHS["TINY"], ["dog machine"], PROMPT)
    assert (with_space - got[1]).abs().max().item() > 1e-3  # no underscore replacement


def test_init_is_identity_and_zero(case):
    lp = _port(case, probe=False)
    assert set(lp.params) == {"w", "b"} and lp.model_name == "lp_layer"
    assert torch.equal(lp.params["w"], torch.eye(64)) and lp.params["w"].dtype == torch.float32
    assert torch.equal(lp.params["b"], torch.zeros(64))


def test_lp_logits_equal_jax(case, monkeypatch):
    """The eval step on uint8 images against ``lp_logits`` on the JAX
    eval path's Pallas rect kernel in interpret mode (the image features
    unnormalised, the probe in float32)."""
    rect = jpallas.pallas_rect_attention
    monkeypatch.setattr(jattn, "use_pallas_attention", lambda: True)
    monkeypatch.setattr(jpallas, "pallas_rect_attention",
                        lambda q, k, v, interpret=False: rect(q, k, v, True))
    want = jlp.lp_logits(jax.tree_util.tree_map(jnp.asarray, case["probe"]), case["jp"],
                         case["cfg"], case["text_f"], case["normalize"](jnp.asarray(
                             case["images"])))
    got = _port(case).eval_step(case["images"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, len(CLASSNAMES))
    np.testing.assert_allclose(_np(got), _np(want), atol=_logits_tol(case["dtype"], want)[0],
                               rtol=0)


def test_train_step_equals_jax(case):
    """Loss, logits and the probe's gradients against jax.value_and_grad
    of the step's loss; one SGD step with a padded row against the JAX
    step: loss, accuracy, the updated probe and the momentum."""
    dtype = case["dtype"]
    (jl, jlogits, jg), (new, state, jloss, jacc) = case["run"]()
    lp = _port(case)
    loss, logits, grads = lp.loss_and_grads(case["images"], LABELS, MASK)
    logits_tol, loss_tol = _logits_tol(dtype, jlogits)
    assert abs(loss.item() - float(jl)) <= loss_tol
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=logits_tol, rtol=0)
    _close_as_gradient(grads, jg, dtype, "gradient")
    got_loss, got_acc = lp.train_step(case["images"], LABELS, MASK, LR)
    assert abs(got_loss.item() - float(jloss)) <= loss_tol
    assert got_acc.item() == pytest.approx(float(jacc))
    _close_as_gradient(lp.params, new, dtype, "updated probe")
    _close_as_gradient(lp.get_optim_state(lp.model_name), state.momentum, dtype, "momentum")


def test_torch_layout_checkpoint_is_remapped():
    """A reference torch checkpoint's lp_layer {weight (out, in), bias}
    loads transposed into {w (in, out), b}, from numpy or from tensors;
    a wrong shape fails at the load and changes nothing."""
    case = _case("float32")
    lp = _port(case, probe=False)
    rng = np.random.RandomState(5)
    weight, bias = rng.randn(64, 64).astype(np.float32), rng.randn(64).astype(np.float32)
    lp.set_ckpt_state(lp.model_name, {"weight": weight, "bias": bias})
    assert np.array_equal(lp.params["w"].numpy(), weight.T)
    assert np.array_equal(lp.params["b"].numpy(), bias)
    lp.set_ckpt_state(lp.model_name, {"weight": torch.from_numpy(weight.T.copy()),
                                      "bias": torch.from_numpy(bias)})
    assert np.array_equal(lp.params["w"].numpy(), weight)
    with pytest.raises(ValueError, match="shape mismatch"):
        lp.set_ckpt_state(lp.model_name, {"weight": weight[:32], "bias": bias})
    assert np.array_equal(lp.params["w"].numpy(), weight)
