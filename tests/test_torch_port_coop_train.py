"""The port's CoOp train step against rpo_tpu's.

JAX weights from ``rpo_tpu.models.clip.init_clip`` at TINY, in float32
and bfloat16, carried across with ``params_from_numpy``; the context
vectors (shared or class-specific), the images, labels and row mask are
made with numpy and are the same on both sides.  The JAX step is
``_make_train_step`` built on a stub with the SGD attributes it reads, as
``CoOp.build_method`` builds it (the text tower as the precompute the
chunks share); its train path runs XLA attention (the Pallas scope wraps
eval only), and one case runs its masked attention on the Pallas kernel
in interpret mode, the route the port's dispatch takes on the card.  On
the CPU the port runs its kernels' plain versions.

Tolerances.  float32: the same operations up to summation order, so the
loss within 1e-5 and the gradient, the updated context and the momentum
within 1e-5 of their largest entry.  bfloat16: tests/test_torch_port_
rpo_train.py's bounds (loss 0.02, logits 0.15; a gradient's largest
error within 0.1 of its largest entry and its cosine >= 0.99).  Port
against port (microbatched against monolithic): float32 1e-5.
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
from rpo_tpu.methods import coop as jcoop
from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
from rpo_tpu.models.clip import ARCHS, cast_params, init_clip
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from rpo_tpu_torch.engine import optim
from rpo_tpu_torch.methods import coop as tcoop
from rpo_tpu_torch.models.clip import params_from_numpy
from tests.test_torch_port_rpo_train import BF16_GRAD_COS, BF16_GRAD_REL, TOL

CLASSNAMES = ["cat", "dog_machine", "crimson finch", "a longer class name 7", "sea urchin", "x"]
N_CTX = 4
LABELS = np.array([0, 2, 4, 5])
MASK = np.array([1, 1, 1, 0], np.float32)  # the last row is padding
LR = 0.002  # configs/trainers/CoOp/vit_b16_ep50.yaml's LR
F32_REL = 1e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PREC = {"float32": "fp32", "bfloat16": "fp16"}
STUB = types.SimpleNamespace(_momentum=0.9, _weight_decay=5e-4, _nesterov=False, _dampening=0.0)


@functools.lru_cache(maxsize=None)
def _backbone(dtype):
    jp = cast_params(init_clip(jax.random.PRNGKey(0), ARCHS["TINY"]), JDT[dtype])
    images = np.random.RandomState(2).randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    return dict(dtype=dtype, jp=jp, tp=params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                                         "cpu"),
                images=images, normalize=jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD,
                                                       dtype=JDT[dtype]))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def backbone(request):
    return _backbone(request.param)


def _ctx(csc, width=64, seed=1):
    shape = (len(CLASSNAMES), N_CTX, width) if csc else (N_CTX, width)
    return (np.random.RandomState(seed).randn(*shape) * 0.02).astype(np.float32)


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def _close_as_gradient(got, want, dtype, what):
    """float32: within F32_REL of the largest entry; bfloat16: the largest
    error within BF16_GRAD_REL of it and the cosine >= BF16_GRAD_COS."""
    g, w = _np(got).ravel(), _np(want).ravel()
    big, err = np.abs(w).max(), np.abs(g - w).max()
    assert big > 0, what
    if dtype == "float32":
        assert err <= F32_REL * big, f"{what}: max err {err} at max {big}"
    else:
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        assert err / big <= BF16_GRAD_REL and cos >= BF16_GRAD_COS, (
            f"{what}: max err / max {err / big}, cosine {cos}")


def _jax_side(backbone, csc, position):
    task = jcoop.make_task(ARCHS["TINY"], CLASSNAMES, N_CTX, csc, position,
                           " ".join(["X"] * N_CTX))
    frozen = {"clip": backbone["jp"]}
    normalize = backbone["normalize"]

    def logits_fn(p, fr, u8, text_f):
        return jcoop.coop_logits(p, fr["clip"], task, normalize(u8), text_f=text_f)

    def precompute(p, fr):
        return jcoop.coop_text_features(p, fr["clip"], task)

    def loss_fn(p, fr, u8):
        logits = logits_fn(p, fr, u8, precompute(p, fr))
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(LABELS)[:, None], axis=-1)[:, 0]
        return jnp.sum(nll * MASK) / jnp.sum(MASK), logits

    step = JaxTrainer._make_train_step(STUB, logits_fn, microbatch=0, precompute=precompute)

    @jax.jit
    def run(p, fr, u8):
        """(loss, logits, grads) of jax.value_and_grad, and the step's
        (params, state, loss, acc) at LR from a fresh state."""
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, fr, u8)
        return (loss, logits, grads), step(p, sgd_init(p), fr, u8, jnp.asarray(LABELS),
                                           jnp.asarray(MASK), jnp.float32(LR))

    return lambda p: run(p, frozen, jnp.asarray(backbone["images"]))


def _port(backbone, csc, position, **kw):
    coop = tcoop.CoOp(CLASSNAMES, n_ctx=N_CTX, csc=csc, position=position, backbone="TINY",
                      prec=PREC[backbone["dtype"]], device="cpu", clip_params=backbone["tp"], **kw)
    coop.set_ckpt_state(coop.model_name, {"ctx": _ctx(csc)})
    return coop


@pytest.mark.parametrize("csc", [False, True], ids=["shared", "CSC"])
@pytest.mark.parametrize("position", ["end", "middle", "front"])
def test_train_step_equals_jax(backbone, csc, position):
    """Loss, logits and the context's gradient against jax.value_and_grad
    of the step's loss; then one SGD step at LR 0.002 with a padded row
    against the JAX step: the loss, the accuracy, the updated context and
    the momentum.  The step clears the text-feature cache and logs the
    accuracy too (``log_acc``)."""
    dtype = backbone["dtype"]
    params = {"ctx": jnp.asarray(_ctx(csc))}
    (jl, jlogits, jg), (new, state, jloss, jacc) = _jax_side(backbone, csc, position)(params)
    coop = _port(backbone, csc, position)
    loss, logits, grads = coop.loss_and_grads(backbone["images"], LABELS, MASK)
    assert tuple(logits.shape) == (4, len(CLASSNAMES)) and logits.dtype == torch.float32
    assert abs(loss.item() - float(jl)) <= TOL[dtype]["loss"]
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=TOL[dtype]["logits"], rtol=0)
    assert tuple(grads["ctx"].shape) == tuple(params["ctx"].shape)
    _close_as_gradient(grads["ctx"], jg["ctx"], dtype, "ctx gradient")

    coop.text_features()
    got_loss, got_acc = coop.train_step(backbone["images"], LABELS, MASK, LR)
    assert coop._text_f_cache is None
    assert abs(got_loss.item() - float(jloss)) <= TOL[dtype]["loss"]
    assert got_acc.item() == pytest.approx(float(jacc))
    ctx0 = _ctx(csc)
    _close_as_gradient(_np(coop.params["ctx"]) - ctx0, _np(new["ctx"]) - ctx0, dtype,
                       "context update")
    _close_as_gradient(coop.get_optim_state(coop.model_name)["ctx"], state.momentum["ctx"],
                       dtype, "momentum")
    coop.current_lr = LR
    summary = coop.forward_backward({"img": backbone["images"], "label": LABELS, "mask": MASK})
    assert set(summary) == {"loss", "acc"}


def test_train_step_on_the_pallas_kernel_equals_jax(monkeypatch):
    """The JAX loss and gradient with its towers' attention on the Pallas
    kernels (interpret mode; the masked one's custom_vjp recomputes in its
    backward), the route the port's dispatch takes on the card."""
    backbone = _backbone("float32")
    masked, rect = jpallas.pallas_attention, jpallas.pallas_rect_attention
    traced = []
    monkeypatch.setattr(jattn, "use_pallas_attention", lambda: True)
    monkeypatch.setattr(jpallas, "pallas_rect_attention",
                        lambda q, k, v, interpret=False: rect(q, k, v, True))
    monkeypatch.setattr(jpallas, "pallas_attention",
                        lambda q, k, v, bias, interpret=False: traced.append(q.shape) or masked(
                            q, k, v, bias, True))
    (jl, _, jg), _ = _jax_side(backbone, False, "end")({"ctx": jnp.asarray(_ctx(False))})
    assert traced  # the text tower traced the kernel
    loss, _, grads = _port(backbone, False, "end").loss_and_grads(backbone["images"], LABELS, MASK)
    assert abs(loss.item() - float(jl)) <= TOL["float32"]["loss"]
    _close_as_gradient(grads["ctx"], jg["ctx"], "float32", "ctx gradient on the kernel")


def test_microbatched_step_equals_monolithic(backbone, monkeypatch):
    """TRAIN.MICROBATCH 2 at batch 4: the image tower on two chunks of 2,
    the text tower once, inside one loss; 3 does not divide 4 and runs
    whole.  Loss, logits and gradient are the monolithic step's."""
    towers, texts = [], []
    encode, text = tcoop.encode_image, tcoop.coop_text_features
    monkeypatch.setattr(tcoop, "encode_image",
                        lambda p, cfg, imgs, *a: towers.append(imgs.shape[0]) or encode(
                            p, cfg, imgs, *a))
    monkeypatch.setattr(tcoop, "coop_text_features",
                        lambda *a, **k: texts.append(1) or text(*a, **k))
    runs = {}
    for mb in (0, 2, 3):
        towers.clear()
        texts.clear()
        runs[mb] = _port(backbone, True, "middle", microbatch=mb).loss_and_grads(
            backbone["images"], LABELS, MASK)
        assert towers == ([2, 2] if mb == 2 else [4]) and texts == [1], (mb, towers, texts)
    dtype = backbone["dtype"]
    tol = F32_REL if dtype == "float32" else TOL[dtype]["logits"]
    for mb in (2, 3):
        assert abs(runs[mb][0].item() - runs[0][0].item()) <= tol
        np.testing.assert_allclose(_np(runs[mb][1]), _np(runs[0][1]), atol=tol, rtol=0)
        _close_as_gradient(runs[mb][2]["ctx"], runs[0][2]["ctx"], dtype, f"microbatch {mb}")


def test_csc_checkpoint_refuses_another_class_set(backbone):
    """A class-specific context is (n_cls, n_ctx, d): it does not load
    under another class set, as in the JAX package; a shared one does."""
    coop = _port(backbone, True, "end")
    other = tcoop.CoOp(CLASSNAMES[:4], n_ctx=N_CTX, csc=True, backbone="TINY", prec="fp32",
                       device="cpu", clip_params=backbone["tp"])
    with pytest.raises(ValueError, match="shape mismatch"):
        other.set_ckpt_state(other.model_name, optim.tree_map(lambda t: t.numpy(), coop.params))
    shared = tcoop.CoOp(CLASSNAMES[:4], n_ctx=N_CTX, backbone="TINY", prec="fp32", device="cpu",
                        clip_params=backbone["tp"])
    shared.set_ckpt_state(shared.model_name, {"ctx": _ctx(False)})
    assert np.array_equal(shared.params["ctx"].numpy(), _ctx(False))
