"""The port's CoOp evaluation against rpo_tpu.methods.coop.

JAX weights from ``rpo_tpu.models.clip.init_clip`` at TINY and TINY_W128
are carried across with ``params_from_numpy``; the context vectors and the
images are made with numpy and are the same on both sides.  The JAX eval
path's Pallas kernels run in interpret mode where the eval step is
compared, as the JAX package's own tests run them on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpo_tpu.ops.attention as jattn
import rpo_tpu.ops.pallas_attention as jpallas
from rpo_tpu.data.transforms import device_normalize_fn as jax_normalize
from rpo_tpu.methods import coop as jcoop
from rpo_tpu.models.clip import ARCHS, cast_params, init_clip
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from rpo_tpu_torch.methods import coop as tcoop
from rpo_tpu_torch.models.clip import ARCHS as TARCHS, params_from_numpy

CLASSNAMES = ["cat", "dog_machine", "crimson finch", "a longer class name 7", "sea urchin", "x"]
N_CTX = 4
# f32: the same operations in the same order up to summation order.
# bf16: every activation is rounded to bf16 (2^-8 relative) and rounding
# flips compound through the two towers, so features agree to a few
# percent of their O(1) size; logits are 14.3 x a cosine, so 0.15 there is
# a cosine difference of 0.01.
TOL = {
    "float32": dict(feat=dict(atol=1e-4, rtol=1e-4), logits=dict(atol=1e-4, rtol=0)),
    "bfloat16": dict(feat=dict(atol=0.06, rtol=0), logits=dict(atol=0.15, rtol=0)),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
POSITIONS = ["end", "middle", "front"]


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX eval path's Pallas kernels, forced on in interpret mode."""
    rect, paired = jpallas.pallas_rect_attention, jpallas.pallas_rect_attention_paired
    masked = jpallas.pallas_attention
    monkeypatch.setattr(jattn, "use_pallas_attention", lambda: True)
    monkeypatch.setattr(jpallas, "pallas_rect_attention",
                        lambda q, k, v, interpret=False: rect(q, k, v, True))
    monkeypatch.setattr(jpallas, "pallas_rect_attention_paired",
                        lambda q2, k2, v2, half=64, interpret=False: paired(q2, k2, v2, half, True))
    monkeypatch.setattr(jpallas, "pallas_attention",
                        lambda q, k, v, bias, interpret=False: masked(q, k, v, bias, True))


@pytest.fixture(scope="module", params=[(a, d) for a in ("TINY", "TINY_W128")
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    arch, dtype = request.param
    cfg = ARCHS[arch]
    jp = cast_params(init_clip(jax.random.PRNGKey(0), cfg), JDT[dtype])
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return dict(arch=arch, dtype=dtype, jp=jp, tp=tp)


def _ctx(csc, width, seed=1):
    shape = (len(CLASSNAMES), N_CTX, width) if csc else (N_CTX, width)
    return (np.random.RandomState(seed).randn(*shape) * 0.02).astype(np.float32)


def _tasks(arch, position="end", csc=False):
    prefix = " ".join(["X"] * N_CTX)
    want = jcoop.make_task(ARCHS[arch], CLASSNAMES, N_CTX, csc, position, prefix)
    got = tcoop.make_task(TARCHS[arch], CLASSNAMES, N_CTX, csc, position, prefix)
    return want, got


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(jnp.asarray(j).astype(jnp.float32)), **tol)


@pytest.mark.parametrize("csc", [False, True], ids=["shared", "csc"])
@pytest.mark.parametrize("position", POSITIONS)
def test_make_task_and_position_plan_equal_jax(position, csc):
    want, got = _tasks("TINY", position, csc)
    assert (got.n_cls, got.n_ctx, got.csc, got.text_len) == (want.n_cls, want.n_ctx, want.csc,
                                                             want.text_len)
    for name in ("text_tokens", "ctx_mask", "ctx_idx", "emb_idx"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(ValueError):
        tcoop.build_position_plan(N_CTX, np.array([1, 2]), "left")


@pytest.mark.parametrize("csc", [False, True], ids=["shared", "csc"])
@pytest.mark.parametrize("position", POSITIONS)
def test_assemble_prompt_embeddings_equals_jax(position, csc):
    jtask, ttask = _tasks("TINY", position, csc)
    L, d = jtask.text_len, ARCHS["TINY"].text_width
    ctx = _ctx(csc, d)
    emb = np.random.RandomState(2).randn(len(CLASSNAMES), L, d).astype(np.float32)
    want = jcoop.assemble_prompt_embeddings(jnp.asarray(ctx), jnp.asarray(emb), jtask)
    got = tcoop.assemble_prompt_embeddings(torch.from_numpy(ctx), torch.from_numpy(emb), ttask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_ctx_from_words_equals_jax(case):
    cfg, n_cls = ARCHS[case["arch"]], len(CLASSNAMES)
    for csc in (False, True):
        want, wprefix, wn = jcoop.init_ctx(jax.random.PRNGKey(0), case["jp"], cfg, n_cls, 16, csc,
                                           "a_photo of a")
        got, gprefix, gn = tcoop.init_ctx(torch.Generator().manual_seed(0), case["tp"],
                                          TARCHS[case["arch"]], n_cls, 16, csc, "a_photo of a")
        assert (gprefix, gn) == (wprefix, wn) == ("a photo of a", 4)
        assert got["ctx"].dtype == torch.float32
        # with CTX_INIT the context stays one shared (n_ctx, d) tensor under CSC
        assert tuple(got["ctx"].shape) == tuple(want["ctx"].shape) == (4, cfg.text_width)
        np.testing.assert_array_equal(got["ctx"].numpy(), np.asarray(want["ctx"]))


def test_init_ctx_random():
    cfg = TARCHS["TINY"]
    tp = {"text": {"token_embedding": torch.zeros(10, cfg.text_width)}}
    for csc, shape in ((False, (16, 64)), (True, (len(CLASSNAMES), 16, 64))):
        got, prefix, n_ctx = tcoop.init_ctx(torch.Generator().manual_seed(0), tp, cfg,
                                            len(CLASSNAMES), 16, csc, "")
        assert tuple(got["ctx"].shape) == shape and got["ctx"].dtype == torch.float32
        assert (prefix, n_ctx) == (" ".join(["X"] * 16), 16)
    np.testing.assert_allclose(got["ctx"].std().item(), 0.02, rtol=0.05)


@pytest.mark.parametrize("csc", [False, True], ids=["shared", "csc"])
def test_text_features_and_logits_equal_jax(case, csc):
    dtype, arch = case["dtype"], case["arch"]
    jtask, ttask = _tasks(arch, "end", csc)
    ctx = _ctx(csc, ARCHS[arch].text_width)
    jparams, tparams = {"ctx": jnp.asarray(ctx)}, {"ctx": torch.from_numpy(ctx)}
    want_tf = jcoop.coop_text_features(jparams, case["jp"], jtask)
    got_tf = tcoop.coop_text_features(tparams, case["tp"], ttask)
    assert got_tf.dtype == TDT[dtype] and tuple(got_tf.shape) == (len(CLASSNAMES), ARCHS[arch].embed_dim)
    _close(got_tf, want_tf, TOL[dtype]["feat"])
    imgs = np.random.RandomState(3).randn(3, 32, 32, 3).astype(np.float32)
    jimgs = jnp.asarray(imgs).astype(JDT[dtype])
    timgs = torch.from_numpy(np.array(jimgs.astype(jnp.float32))).to(TDT[dtype])
    want = jcoop.coop_logits(jparams, case["jp"], jtask, jimgs)
    got = tcoop.coop_logits(tparams, case["tp"], ttask, timgs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, len(CLASSNAMES))
    _close(got, want, TOL[dtype]["logits"])


def test_eval_step_end_to_end(case, jax_pallas_interpret):
    """CoOp.eval_step on uint8 images == JAX coop_logits on the same
    normalised images with the same context, the JAX kernels in
    interpret mode."""
    dtype, arch = case["dtype"], case["arch"]
    prec = "fp32" if dtype == "float32" else "fp16"
    coop = tcoop.CoOp(CLASSNAMES, n_ctx=N_CTX, backbone=arch, prec=prec, device="cpu",
                      clip_params=case["tp"])
    ctx = _ctx(False, ARCHS[arch].text_width, seed=4)
    coop.set_ckpt_state(coop.model_name, {"ctx": ctx, "token_prefix": np.zeros(1)})
    jtask, _ = _tasks(arch)
    images = np.random.RandomState(5).randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=JDT[dtype])
    want = jcoop.coop_logits({"ctx": jnp.asarray(ctx)}, case["jp"], jtask,
                             normalize(jnp.asarray(images)))
    got = coop.eval_step(images)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, len(CLASSNAMES))
    _close(got, want, TOL[dtype]["logits"])
    np.testing.assert_array_equal(coop.model_inference(images), got.numpy())


def test_text_truncation_is_exact():
    """Running the text tower at ``text_len`` equals the full 77, as
    tests/test_coop_parity.py pins on the JAX side."""
    cfg = ARCHS["TINY"]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, init_clip(jax.random.PRNGKey(0), cfg)),
                           "cpu")
    for position in POSITIONS:
        _, task = _tasks("TINY", position)
        assert task.text_len < cfg.context_length
        params = {"ctx": torch.from_numpy(_ctx(False, cfg.text_width))}
        short = tcoop.coop_text_features(params, tp, task)
        full = tcoop.coop_text_features(params, tp, dataclasses.replace(task, text_len=77))
        np.testing.assert_allclose(short.numpy(), full.numpy(), atol=1e-5, rtol=0)


def test_ckpt_state_validates_the_context_shape():
    coop = tcoop.CoOp(CLASSNAMES, n_ctx=N_CTX, backbone="TINY", prec="fp32", device="cpu")
    assert tuple(coop.params["ctx"].shape) == (N_CTX, 64)
    with pytest.raises(ValueError, match="shape mismatch"):
        coop.set_ckpt_state(coop.model_name, {"ctx": np.zeros((N_CTX + 1, 64), np.float32)})
