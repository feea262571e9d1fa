"""The port's CoCoOp train steps against rpo_tpu's.

JAX weights from ``rpo_tpu.models.clip.init_clip`` at TINY, in float32
and bfloat16, carried across with ``params_from_numpy``; the context
from numpy and the meta-net from ``rpo_tpu.methods.cocoop.init_meta_net``
are the same on both sides, as are the images, labels and row masks.
The JAX steps are ``_make_train_step`` over ``cocoop_logits`` (below a
batch of 16) and ``_make_grad_accum_train_step`` with the frozen image
tower as the precompute and chunks of 8 (from 16 on), built on a stub
with the SGD attributes they read, as ``CoCoOp.build_method`` builds
them; on the CPU the JAX train path runs XLA attention and the vmapped
per-image text towers, the port its kernels' plain versions with the
text towers block by block.

Tolerances.  float32: the same operations up to summation order, so the
loss within 1e-5, logits within 1e-4, and every gradient, updated tensor
and momentum within 1e-5 of its largest entry; the port's accumulated
step against its monolithic one likewise (fp32 reassociation).
bfloat16: tests/test_torch_port_rpo_train.py's bounds (loss 0.02, logits
0.15; a gradient's largest error within 0.1 of its largest entry, cosine
>= 0.99).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpo_tpu.data.transforms import device_normalize_fn as jax_normalize
from rpo_tpu.engine.optim import sgd_init
from rpo_tpu.methods import cocoop as jcocoop
from rpo_tpu.methods import coop as jcoop
from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
from rpo_tpu.models.clip import ARCHS, cast_params, encode_image, init_clip
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from rpo_tpu_torch.methods import cocoop as tcocoop
from rpo_tpu_torch.models.clip import params_from_numpy
from tests.test_torch_port_rpo_train import BF16_GRAD_COS, BF16_GRAD_REL, TOL

CLASSNAMES = ["cat", "dog_machine", "crimson finch", "a longer class name 7", "sea urchin", "x"]
N_CTX = 4
LR = 0.002  # configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml's LR
F32_REL = 1e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PREC = {"float32": "fp32", "bfloat16": "fp16"}
STUB = types.SimpleNamespace(_momentum=0.9, _weight_decay=5e-4, _nesterov=False, _dampening=0.0)


def _batch(B, n_padded, seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, len(CLASSNAMES), B)
    mask = np.array([1.0] * (B - n_padded) + [0.0] * n_padded, np.float32)
    return images, labels, mask


@functools.lru_cache(maxsize=None)
def _case(dtype):
    cfg = ARCHS["TINY"]
    jp = cast_params(init_clip(jax.random.PRNGKey(0), cfg), JDT[dtype])
    ctx = (np.random.RandomState(1).randn(N_CTX, cfg.text_width) * 0.02).astype(np.float32)
    params = {"ctx": ctx, "meta_net": jax.tree_util.tree_map(np.asarray, jcocoop.init_meta_net(
        jax.random.PRNGKey(2), cfg.embed_dim, cfg.text_width))}
    task = jcoop.make_task(cfg, CLASSNAMES, N_CTX, False, "end", " ".join(["X"] * N_CTX))
    normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=JDT[dtype])

    def logits_fn(p, fr, u8):
        return jcocoop.cocoop_logits(p, fr["clip"], task, normalize(u8))

    def precompute(fr, u8):
        return encode_image(fr["clip"], cfg, normalize(u8)).astype(jnp.float32)

    def chunk_logits(p, fr, imf):
        return jcocoop.cocoop_logits(p, fr["clip"], task, None, image_features=imf)

    def loss_fn(p, fr, u8, labels, mask):
        logits = logits_fn(p, fr, u8)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
        return jnp.sum(nll * mask) / jnp.sum(mask), logits

    steps = {"monolithic": JaxTrainer._make_train_step(STUB, logits_fn),
             "accumulated": JaxTrainer._make_grad_accum_train_step(STUB, precompute, chunk_logits,
                                                                   8)}

    @functools.partial(jax.jit, static_argnames="kind")
    def run(p, fr, u8, labels, mask, kind):
        """(loss, logits, grads) of jax.value_and_grad of the monolithic
        loss, and the step of ``kind`` at LR from a fresh state."""
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, fr, u8, labels, mask)
        return (loss, logits, grads), steps[kind](p, sgd_init(p), fr, u8, labels, mask,
                                                  jnp.float32(LR))

    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return dict(dtype=dtype, jp=jp, tp=tp, params=params,
                run=lambda u8, labels, mask, kind: run(
                    jax.tree_util.tree_map(jnp.asarray, params), {"clip": jp}, jnp.asarray(u8),
                    jnp.asarray(labels, jnp.int32), jnp.asarray(mask), kind))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def case(request):
    return _case(request.param)


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def _close_as_gradient(got, want, dtype, what):
    """Each tensor of the two trees: float32 within F32_REL of its largest
    entry; bfloat16 the largest error within BF16_GRAD_REL of it and the
    cosine >= BF16_GRAD_COS."""
    def one(path, g, w):
        g, w = _np(g).ravel(), _np(w).ravel()
        big, err = np.abs(w).max(), np.abs(g - w).max()
        assert big > 0, (what, path)
        if dtype == "float32":
            assert err <= F32_REL * big, f"{what} {path}: max err {err} at max {big}"
        else:
            cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
            assert err / big <= BF16_GRAD_REL and cos >= BF16_GRAD_COS, (
                f"{what} {path}: max err / max {err / big}, cosine {cos}")

    def walk(path, g, w):
        if isinstance(w, dict):
            assert set(g) == set(w), (what, path)
            for k in w:
                walk(f"{path}.{k}", g[k], w[k])
        else:
            one(path, g, w)

    walk("", got, want)


def _port(case):
    cocoop = tcocoop.CoCoOp(CLASSNAMES, n_ctx=N_CTX, backbone="TINY", prec=PREC[case["dtype"]],
                            device="cpu", clip_params=case["tp"])
    cocoop.set_ckpt_state(cocoop.model_name, case["params"])
    return cocoop


@pytest.mark.parametrize("B,n_padded,kind", [(4, 1, "monolithic"), (16, 3, "accumulated")])
def test_train_step_equals_jax(case, B, n_padded, kind):
    """The trainer's step at batch 4 (monolithic) and 16 (two chunks of 8,
    padded rows in the second): the loss, logits and every gradient
    against jax.value_and_grad of the monolithic loss; then one SGD step
    against the JAX step of the same kind: loss, accuracy, the updated
    context and meta-net, the momentum."""
    dtype = case["dtype"]
    images, labels, mask = _batch(B, n_padded, seed=B)
    (jl, jlogits, jg), (new, state, jloss, jacc) = case["run"](images, labels, mask, kind)
    cocoop = _port(case)
    loss, logits, grads = cocoop.loss_and_grads(images, labels, mask)
    assert tuple(logits.shape) == (B, len(CLASSNAMES)) and logits.dtype == torch.float32
    assert abs(loss.item() - float(jl)) <= TOL[dtype]["loss"]
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=TOL[dtype]["logits"], rtol=0)
    _close_as_gradient(grads, jg, dtype, "gradient")

    got_loss, got_acc = cocoop.train_step(images, labels, mask, LR)
    assert abs(got_loss.item() - float(jloss)) <= TOL[dtype]["loss"]
    assert got_acc.item() == pytest.approx(float(jacc))
    # the updated tensors themselves: an SGD step moves an entry by about
    # 1e-3 of its size, so the movement's error is float32's rounding of
    # the entry (the gradient and the momentum carry the step's content)
    _close_as_gradient(cocoop.params, new, dtype, "updated tensor")
    _close_as_gradient(cocoop.get_optim_state(cocoop.model_name), state.momentum, dtype,
                       "momentum")


def test_accumulated_step_equals_monolithic(monkeypatch):
    """At batch 16 with padded rows (float32): the dispatch takes the
    accumulation, which runs the image tower once over the batch and the
    text towers on two chunks of 8, and equals the monolithic step on the
    same batch in loss, logits and gradients (fp32 reassociation); below
    16 the dispatch takes the monolithic step."""
    case = _case("float32")
    cocoop = _port(case)
    towers, chunks = [], []
    encode, logits_of = tcocoop.encode_image, tcocoop.cocoop_logits
    monkeypatch.setattr(tcocoop, "encode_image",
                        lambda p, cfg, imgs, *a: towers.append(imgs.shape[0]) or encode(
                            p, cfg, imgs, *a))
    monkeypatch.setattr(tcocoop, "cocoop_logits", lambda *a, **k: chunks.append(
        (a[3] is None, None if k.get("image_features") is None else k["image_features"].shape[0]))
        or logits_of(*a, **k))
    images, labels, mask = _batch(16, 5, seed=3)
    acc = cocoop.loss_and_grads(images, labels, mask)
    assert towers == [16] and chunks == [(True, 8), (True, 8)], (towers, chunks)
    towers.clear()
    chunks.clear()
    mono = cocoop.loss_and_grads_of("monolithic", images, labels, mask)
    assert towers == [16] and chunks == [(False, None)], (towers, chunks)
    assert abs(acc[0].item() - mono[0].item()) <= F32_REL
    np.testing.assert_allclose(_np(acc[1]), _np(mono[1]), atol=1e-4, rtol=0)
    _close_as_gradient(acc[2], mono[2], "float32", "accumulated against monolithic")
    towers.clear()
    chunks.clear()
    cocoop.loss_and_grads(*_batch(8, 0, seed=4))
    assert towers == [8] and chunks == [(False, None)]


def test_training_runs_the_text_towers_block_by_block(monkeypatch):
    """The fused text layer is forward-only: a train step must not reach
    it, while the eval step still does."""
    from rpo_tpu_torch.ops import fused_text_layer as ftl

    calls = []
    tower = ftl.fused_text_tower
    monkeypatch.setattr("rpo_tpu_torch.models.clip.layers.fused_text_tower",
                        lambda *a, **k: calls.append(1) or tower(*a, **k))
    cocoop = _port(_case("bfloat16"))
    for B in (4, 16):
        cocoop.loss_and_grads(*_batch(B, 0, seed=B))
    assert calls == []
    cocoop.eval_step(_batch(4, 0, seed=5)[0])
    assert calls == [1]
