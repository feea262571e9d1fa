"""The port's RPO train step against rpo_tpu's.

JAX weights and prompts from ``rpo_tpu.models.clip.init_clip`` /
``rpo_tpu.methods.rpo.init_prompts`` at TINY (one vision head of 64) and
TINY_W128 (two), in float32 and bfloat16, carried across with
``params_from_numpy``; the same images, labels and row mask on both
sides.  The JAX train path runs XLA attention (its Pallas scope wraps
eval only); one case also runs it on the Pallas rect kernel in interpret
mode, the route the port's dispatch takes on the card.  On the CPU the
port runs its kernels' plain versions.

Tolerances.  float32: the same operations up to summation order, so
features and logits within 1e-4 (as tests/test_torch_port_rpo_eval.py)
and a gradient within 1e-5 + 1e-4 * max|g| (measured: 2.5e-7 / 1.7e-6
absolute, 4e-6 relative).  bfloat16: every activation rounds to bf16 and
the flips compound through the towers, and the port's backward rounds at
other points than JAX's autodiff (``_attention_bwd_math``), so a
gradient is held by its largest error relative to its largest entry,
<= 0.1 (measured 0.028-0.052), and by its cosine to JAX's, >= 0.99
(measured >= 0.9989); logits within 0.15 (measured 0.018-0.023),
features within 0.06 (as the eval test).  Port against port (split
against rect tower, chunked against whole, cached against masked text):
float32 1e-5.
"""
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
from rpo_tpu.methods import rpo as jcore
from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
from rpo_tpu.models.clip import ARCHS, cast_params, init_clip
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from rpo_tpu_torch.engine import optim
from rpo_tpu_torch.methods import rpo as tcore
from rpo_tpu_torch.methods.rpo_trainer import RPO
from rpo_tpu_torch.models.clip import ARCHS as TARCHS, params_from_numpy
from rpo_tpu_torch.ops import rect_attention as ra

CLASSNAMES = [f"a longer class name {i}" for i in range(3)] + ["cat", "dog machine", "crimson finch"]
K = 5
LABELS = np.array([0, 2, 4, 5])
MASK = np.array([1, 1, 1, 0], np.float32)  # the last row is padding
TOL = {
    "float32": dict(feat=1e-4, logits=1e-4, loss=1e-5),
    "bfloat16": dict(feat=0.06, logits=0.15, loss=0.02),
}
BF16_GRAD_REL = 0.1
BF16_GRAD_COS = 0.99
SAME_PATH_F32 = 1e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PREC = {"float32": "fp32", "bfloat16": "fp16"}


class MainOptim:
    """configs/trainers/RPO/main.yaml's OPTIM: LR 0.01, cosine over 15
    epochs after one constant warmup epoch at 1e-5."""
    LR, MAX_EPOCH, LR_SCHEDULER = 0.01, 15, "cosine"
    WARMUP_EPOCH, WARMUP_TYPE, WARMUP_CONS_LR, WARMUP_MIN_LR = 1, "constant", 1e-5, 1e-5
    STEPSIZE, GAMMA = (-1,), 0.1


N_STEPS = 6  # one step per epoch of the schedule: 1e-5, then the cosine from 0.01
LRS = [optim.lr_at_epoch(MainOptim, e) for e in range(N_STEPS)]


@pytest.fixture(scope="module", params=[(a, d) for a in ("TINY", "TINY_W128")
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    arch, dtype = request.param
    cfg = ARCHS[arch]
    jp = cast_params(init_clip(jax.random.PRNGKey(0), cfg), JDT[dtype])
    task = jcore.make_task(cfg, CLASSNAMES, "a photo of a _.", K)
    prompts = jcore.init_prompts(jax.random.PRNGKey(1), jp, cfg, K)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ttask = tcore.make_task(TARCHS[arch], CLASSNAMES, "a photo of a _.", K)
    images = np.random.RandomState(2).randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=JDT[dtype])
    jimgs = normalize(jnp.asarray(images))
    return dict(
        arch=arch, dtype=dtype, jp=jp, task=task, prompts=prompts, tp=tp, ttask=ttask,
        images=images, normalize=normalize, jimgs=jimgs,
        timgs=torch.from_numpy(np.array(jimgs.astype(jnp.float32))).to(TDT[dtype]),
        jfrozen=jcore.make_frozen(jp, task), tfrozen=tcore.make_frozen(tp, ttask))


def _tprompts(case):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, case["prompts"]), "cpu")


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0, err_msg=what)


def _grads_close(got, want, dtype, what=""):
    """Each tensor of the tree: in f32 within 1e-5 + 1e-4 * max|want|;
    in bf16 max error over max|want| <= BF16_GRAD_REL and cosine >=
    BF16_GRAD_COS."""
    def one(g, w):
        g, w = _np(g).ravel(), _np(w).ravel()
        big = np.abs(w).max()
        err = np.abs(g - w).max()
        assert big > 0, what
        if dtype == "float32":
            assert err <= 1e-5 + 1e-4 * big, f"{what}: max err {err} at max|g| {big}"
        else:
            cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
            assert err / big <= BF16_GRAD_REL and cos >= BF16_GRAD_COS, (
                f"{what}: max err / max|g| {err / big}, cosine {cos}")
    optim.tree_map(one, got, want)


def _port_loss_grads(prompts, frozen, ttask, timgs, split_vision=True, rect_attn=ra.rect_attention):
    leaves = optim.tree_map(lambda t: t.clone().requires_grad_(True), prompts)
    loss, logits = tcore.rpo_loss(leaves, frozen, ttask, timgs, torch.from_numpy(LABELS),
                                  split_vision=split_vision, rect_attn=rect_attn)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, logits, dict(zip(leaves, grads))


# (a) ------------------------------------------------------------------------

def test_encode_image_prompts_split_equals_jax(case):
    want = jcore.encode_image_prompts_split(case["prompts"], case["jfrozen"], case["task"],
                                            case["jimgs"])
    got = tcore.encode_image_prompts_split(_tprompts(case), case["tfrozen"], case["ttask"],
                                           case["timgs"])
    assert tuple(got.shape) == (4, K, TARCHS[case["arch"]].embed_dim)
    assert got.dtype == TDT[case["dtype"]]
    _close(got, want, TOL[case["dtype"]]["feat"])


# (b) ------------------------------------------------------------------------

def test_split_tower_equals_the_rect_tower(case):
    """In the port, split == encode_image_with_prompts, in features and in
    the loss's gradients, as tests/test_split_vision.py pins on the JAX
    side (f32 1e-5; bf16 within the bf16 bounds)."""
    dtype = case["dtype"]
    prompts = _tprompts(case)
    with torch.no_grad():
        split = tcore.encode_image_prompts_split(prompts, case["tfrozen"], case["ttask"],
                                                 case["timgs"])
        rect = tcore.encode_image_with_prompts(prompts, case["tfrozen"], case["ttask"],
                                               case["timgs"])
    _close(split, rect, SAME_PATH_F32 if dtype == "float32" else TOL[dtype]["feat"])
    ls, _, gs = _port_loss_grads(prompts, case["tfrozen"], case["ttask"], case["timgs"], True)
    lr_, _, gr = _port_loss_grads(prompts, case["tfrozen"], case["ttask"], case["timgs"], False)
    if dtype == "float32":
        assert abs(ls.item() - lr_.item()) <= SAME_PATH_F32
        optim.tree_map(lambda a, b: _close(a, b, SAME_PATH_F32), gs, gr)
    else:
        _grads_close(gs, gr, dtype, "split against rect")


# (c) ------------------------------------------------------------------------

def test_frozen_rows_carry_no_prompt_gradient(case, monkeypatch):
    """The frozen rows' attention runs without grad, the prompt rows' on
    k and v made without grad, and the backward asks the attention for
    dq alone; both prompts get a gradient (the split path trains)."""
    calls, needs = [], []

    def recording_rect(q, k, v):
        calls.append((q.shape[2], q.requires_grad, k.requires_grad, v.requires_grad))
        return ra.rect_attention(q, k, v)

    bwd = ra._attention_bwd_math
    monkeypatch.setattr(ra, "_attention_bwd_math",
                        lambda *a: needs.append(tuple(a[5])) or bwd(*a))
    _, _, grads = _port_loss_grads(_tprompts(case), case["tfrozen"], case["ttask"],
                                   case["timgs"], rect_attn=recording_rect)
    n_frozen = TARCHS[case["arch"]].vision_seq_len
    layers = TARCHS[case["arch"]].vision_layers
    assert calls == [(n_frozen, False, False, False), (K, True, False, False)] * layers
    assert needs == [(True, False, False)] * layers
    for key in ("img_prompt", "text_prompt"):
        assert float(grads[key].abs().max()) > 0, key


# (d) ------------------------------------------------------------------------

def test_rpo_loss_and_grads_equal_jax_value_and_grad(case):
    dtype = case["dtype"]

    def jloss(p):
        return jcore.rpo_loss(p, case["jfrozen"], case["task"], case["jimgs"],
                              jnp.asarray(LABELS))

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(case["prompts"])
    tl, tlogits, tg = _port_loss_grads(_tprompts(case), case["tfrozen"], case["ttask"],
                                       case["timgs"])
    assert tuple(tlogits.shape) == (4, len(CLASSNAMES)) and tlogits.dtype == torch.float32
    _close(tlogits, jlogits, TOL[dtype]["logits"], "logits")
    assert abs(tl.item() - float(jl)) <= TOL[dtype]["loss"]
    _grads_close(tg, jg, dtype, "rpo_loss gradients")


def test_rpo_loss_grads_equal_jax_on_the_pallas_kernel(monkeypatch):
    """The JAX path on its Pallas rect kernel (interpret mode, its
    custom_vjp's recompute backward) in every split-tower attention, the
    route the port's dispatch takes on the card; f32, TINY_W128."""
    cfg = ARCHS["TINY_W128"]
    rect = jpallas.pallas_rect_attention
    traced = []
    monkeypatch.setattr(jattn, "use_pallas_attention", lambda: True)
    monkeypatch.setattr(jpallas, "pallas_rect_attention",
                        lambda q, k, v, interpret=False: traced.append(q.shape) or rect(q, k, v,
                                                                                       True))
    jp = init_clip(jax.random.PRNGKey(0), cfg)
    task = jcore.make_task(cfg, CLASSNAMES, "a photo of a _.", K)
    prompts = jcore.init_prompts(jax.random.PRNGKey(1), jp, cfg, K)
    jimgs = jnp.asarray(np.random.RandomState(3).randn(4, 32, 32, 3).astype(np.float32))
    frozen = jcore.make_frozen(jp, task)
    (jl, jlogits), jg = jax.value_and_grad(
        lambda p: jcore.rpo_loss(p, frozen, task, jimgs, jnp.asarray(LABELS)), has_aux=True)(prompts)
    assert traced  # the scanned tower traced the kernel
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ttask = tcore.make_task(TARCHS["TINY_W128"], CLASSNAMES, "a photo of a _.", K)
    tl, tlogits, tg = _port_loss_grads(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, prompts), "cpu"),
        tcore.make_frozen(tp, ttask), ttask, torch.from_numpy(np.array(jimgs)))
    _close(tlogits, jlogits, TOL["float32"]["logits"], "logits")
    assert abs(tl.item() - float(jl)) <= TOL["float32"]["loss"]
    _grads_close(tg, jg, "float32", "rpo_loss gradients on the kernel")


# (e), (f) ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step(case):
    """The JAX step, ``_make_train_step`` built unbound on a stub holding
    the four SGD attributes it reads, jitted."""
    stub = types.SimpleNamespace(_momentum=0.9, _weight_decay=5e-4, _nesterov=False,
                                 _dampening=0.0)
    task, normalize = case["task"], case["normalize"]
    step = jax.jit(JaxTrainer._make_train_step(
        stub,
        lambda p, frozen, u8, text_f: jcore.rpo_logits(p, frozen, task, normalize(u8),
                                                      text_f=text_f, split_vision=True),
        precompute=lambda p, frozen: jcore.encode_text_with_prompts(p, frozen, task)))
    return lambda params, state, lr: step(params, state, case["jfrozen"],
                                          jnp.asarray(case["images"]), jnp.asarray(LABELS),
                                          jnp.asarray(MASK), jnp.float32(lr))


def _trainer(case, **kwargs):
    rpo = RPO(CLASSNAMES, K=K, backbone=case["arch"], prec=PREC[case["dtype"]], device="cpu",
              clip_params=case["tp"], **kwargs)
    rpo.set_ckpt_state(rpo.model_name, jax.tree_util.tree_map(np.asarray, case["prompts"]))
    return rpo


def _moved(params, prompts):
    """The prompts' movement from the initial JAX prompts."""
    if isinstance(next(iter(params.values())), torch.Tensor):
        return optim.tree_map(lambda a, b: a - torch.from_numpy(np.array(b)), params, prompts)
    return jax.tree_util.tree_map(lambda a, b: a - b, params, prompts)


def test_one_train_step_equals_jax(case, jax_step):
    """One step at LR 0.01 with a padded row: the masked loss and
    accuracy, the prompts' update and the momentum; the step clears the
    text-feature cache, and forward_backward logs only the loss."""
    dtype = case["dtype"]
    params, state, loss, acc = jax_step(case["prompts"], sgd_init(case["prompts"]), 0.01)
    rpo = _trainer(case)
    rpo.text_features()
    got_loss, got_acc = rpo.train_step(case["images"], LABELS, MASK, 0.01)
    assert rpo._text_f_cache is None
    assert abs(got_loss.item() - float(loss)) <= TOL[dtype]["loss"]
    assert got_acc.item() == pytest.approx(float(acc))
    assert round(got_acc.item() * MASK.sum(), 5) % 1 == 0  # of the 3 unpadded rows
    _grads_close(_moved(rpo.params, case["prompts"]), _moved(params, case["prompts"]), dtype,
                 "prompt update")
    _grads_close(rpo.get_optim_state(rpo.model_name), state.momentum, dtype, "momentum")
    rpo.current_lr = LRS[2]
    summary = rpo.forward_backward({"img": case["images"], "label": LABELS, "mask": MASK})
    assert set(summary) == {"loss"} and bool(torch.isfinite(summary["loss"]))


def test_prompt_trajectory_equals_jax(case, jax_step):
    """N_STEPS steps on one batch at the main config's schedule: each
    loss, and the prompts' total movement and the momentum held as a
    gradient is."""
    dtype = case["dtype"]
    params, state, want_losses = case["prompts"], sgd_init(case["prompts"]), []
    for lr in LRS:
        params, state, loss, _ = jax_step(params, state, lr)
        want_losses.append(float(loss))
    rpo = _trainer(case)
    losses = [rpo.train_step(case["images"], LABELS, MASK, lr)[0].item() for lr in LRS]
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=TOL[dtype]["loss"])
    assert losses[-1] < losses[1]  # it trains
    _grads_close(_moved(rpo.params, case["prompts"]), _moved(params, case["prompts"]), dtype,
                 "prompt trajectory")
    _grads_close(rpo.get_optim_state(rpo.model_name), state.momentum, dtype, "momentum")


# (g) ------------------------------------------------------------------------

def test_microbatched_gradients_equal_monolithic(case, monkeypatch):
    """microbatch=2 at batch 4 runs the vision tower on two chunks of 2
    (the text tower once) inside one loss; 3 does not divide 4 and runs
    whole.  The loss, logits and gradients are the monolithic ones."""
    chunks = []
    split = tcore.encode_image_prompts_split
    monkeypatch.setattr(tcore, "encode_image_prompts_split",
                        lambda p, f, t, imgs, *a: chunks.append(imgs.shape[0]) or split(
                            p, f, t, imgs, *a))
    runs = {}
    for mb in (0, 2, 3):
        chunks.clear()
        runs[mb] = _trainer(case, microbatch=mb).loss_and_grads(case["images"], LABELS, MASK)
        assert chunks == ([2, 2] if mb == 2 else [4]), (mb, chunks)
    tol = SAME_PATH_F32 if case["dtype"] == "float32" else TOL[case["dtype"]]["logits"]
    for mb in (2, 3):
        _close(runs[mb][0], runs[0][0], tol, "loss")
        _close(runs[mb][1], runs[0][1], tol, "logits")
        _grads_close(runs[mb][2], runs[0][2], case["dtype"], f"microbatch {mb}")


# (h) ------------------------------------------------------------------------

def test_cached_text_gradients_equal_masked_text_tower(case):
    """The prompt-rows-only text path against the full masked 77-token
    tower, under grad: the prompts' gradients through rpo_loss."""
    prompts = _tprompts(case)
    full = tcore.make_frozen(case["tp"], case["ttask"], cache_text_kv=False)
    lc, _, gc = _port_loss_grads(prompts, case["tfrozen"], case["ttask"], case["timgs"])
    lm, _, gm = _port_loss_grads(prompts, full, case["ttask"], case["timgs"])
    if case["dtype"] == "float32":
        assert abs(lc.item() - lm.item()) <= SAME_PATH_F32
        optim.tree_map(lambda a, b: _close(a, b, SAME_PATH_F32), gc, gm)
    else:
        _grads_close(gc, gm, case["dtype"], "cached against masked text")


# the trainer's surface ---------------------------------------------------------

def test_optimizer_state_round_trip_and_settings():
    tp = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, init_clip(jax.random.PRNGKey(0), ARCHS["TINY"])), "cpu")
    with pytest.raises(ValueError, match="zero dampening"):
        RPO(CLASSNAMES, K=K, backbone="TINY", prec="fp32", device="cpu", clip_params=tp,
            nesterov=True, dampening=0.1)
    rpo = RPO(CLASSNAMES, K=K, backbone="TINY", prec="fp32", device="cpu", clip_params=tp)
    zeros = rpo.get_optim_state(rpo.model_name)
    assert all(float(t.abs().max()) == 0 for t in zeros.values())
    with pytest.raises(RuntimeError, match="current_lr"):
        rpo.forward_backward({"img": np.zeros((1, 32, 32, 3), np.uint8), "label": [0],
                              "mask": [1.0]})
    state = {k: np.full(tuple(v.shape), 0.5, np.float32) for k, v in rpo.params.items()}
    rpo.set_optim_state(rpo.model_name, state)
    got = rpo.get_optim_state(rpo.model_name)
    assert all(np.array_equal(got[k].numpy(), state[k]) for k in state)
    rpo.set_ckpt_state(rpo.model_name, {k: v.numpy() for k, v in rpo.params.items()})
    assert all(float(t.abs().max()) == 0 for t in rpo.get_optim_state(rpo.model_name).values())
