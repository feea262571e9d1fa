"""The port's CoCoOp evaluation against rpo_tpu.methods.cocoop.

JAX weights from ``rpo_tpu.models.clip.init_clip`` at TINY are carried
across with ``params_from_numpy``, and so is the CoCoOp pytree (context and
meta-net); images are made with numpy.  The JAX side takes its flattened
fused branch with the whole-layer Pallas kernel in interpret mode, as
tests/test_fused_text_layer.py runs it; the port runs the kernel's plain
version on the CPU.

Tolerances: float32 logits max abs error <= 1e-4 (the same operations up to
summation order, through two towers).  bfloat16: max abs error <= 2e-2 of
the largest logit magnitude (the band of tests/test_fused_text_layer.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpo_tpu.data.transforms import device_normalize_fn as jax_normalize
from rpo_tpu.methods import cocoop as jcocoop
from rpo_tpu.methods import coop as jcoop
from rpo_tpu.models.clip import ARCHS, cast_params, init_clip
from rpo_tpu.ops import fused_text_layer as jftl
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from rpo_tpu_torch.methods import cocoop as tcocoop
from rpo_tpu_torch.methods import coop as tcoop
from rpo_tpu_torch.models.clip import ARCHS as TARCHS, params_from_numpy
from rpo_tpu_torch.ops import fused_text_layer as ftl

CLASSNAMES = [f"object category {i}" for i in range(5)] + ["sea urchin"]
N_CTX = 4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
F32_ATOL = 1e-4
BF16_BAND = 2e-2


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """The JAX fused text scope on, its kernel in interpret mode."""
    monkeypatch.setattr(jftl, "_INTERPRET", True)
    with jftl.fused_text_scope(True):
        yield


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def case(request):
    dtype = request.param
    cfg = ARCHS["TINY"]
    jp = cast_params(init_clip(jax.random.PRNGKey(0), cfg), JDT[dtype])
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    k_ctx, k_meta = jax.random.split(jax.random.PRNGKey(1))
    ctx = (np.random.RandomState(1).randn(N_CTX, cfg.text_width) * 0.02).astype(np.float32)
    jm = {"ctx": jnp.asarray(ctx),
          "meta_net": jcocoop.init_meta_net(k_meta, cfg.embed_dim, cfg.text_width)}
    tm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jm), "cpu")
    prefix = " ".join(["X"] * N_CTX)
    jtask = jcoop.make_task(cfg, CLASSNAMES, N_CTX, False, "end", prefix)
    ttask = tcoop.make_task(TARCHS["TINY"], CLASSNAMES, N_CTX, False, "end", prefix)
    return dict(dtype=dtype, jp=jp, tp=tp, jm=jm, tm=tm, jtask=jtask, ttask=ttask)


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    if dtype == "float32":
        assert err <= F32_ATOL, err
    else:
        assert err <= BF16_BAND * np.abs(want).max(), (err, np.abs(want).max())


def test_init_meta_net_shapes_and_bounds():
    p = tcocoop.init_meta_net(torch.Generator().manual_seed(0), 512, 512)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (512, 32), "b1": (32,), "w2": (32, 512), "b2": (512,)}
    for key, fan_in in (("w1", 512), ("b1", 512), ("w2", 32), ("b2", 32)):
        bound = 1 / np.sqrt(fan_in)
        assert p[key].dtype == torch.float32
        assert p[key].abs().max().item() <= bound
        assert p[key].abs().max().item() > 0.9 * bound  # spread over the whole interval


def test_params_from_numpy_carries_the_cocoop_pytree(case):
    tm = case["tm"]
    assert set(tm) == {"ctx", "meta_net"} and set(tm["meta_net"]) == {"w1", "b1", "w2", "b2"}
    for key, leaf in case["jm"]["meta_net"].items():
        assert tm["meta_net"][key].dtype == torch.float32
        np.testing.assert_array_equal(tm["meta_net"][key].numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(tm["ctx"].numpy(), np.asarray(case["jm"]["ctx"]))


def test_meta_net_apply_matches_jax(case):
    x = np.random.RandomState(2).randn(7, 64).astype(np.float32)
    want = jcocoop.meta_net_apply(case["jm"]["meta_net"], jnp.asarray(x))
    got = tcocoop.meta_net_apply(case["tm"]["meta_net"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("chunk", [0, 2])
def test_cocoop_logits_match_jax(case, chunk, jax_fused_interpret):
    dtype = case["dtype"]
    imgs = np.random.RandomState(3).randn(4, 32, 32, 3).astype(np.float32)
    jimgs = jnp.asarray(imgs).astype(JDT[dtype])
    timgs = params_from_numpy({"i": np.asarray(jimgs)}, "cpu")["i"]
    want = jcocoop.cocoop_logits(case["jm"], case["jp"], case["jtask"], jimgs, chunk=chunk)
    with torch.no_grad():
        got = tcocoop.cocoop_logits(case["tm"], case["tp"], case["ttask"], timgs, chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, len(CLASSNAMES))
    _close(got, want, dtype)


def test_eval_step_end_to_end(case, jax_fused_interpret):
    """CoCoOp.eval_step on uint8 images == JAX cocoop_logits on the same
    normalised images, chunked as the JAX eval step chunks them."""
    dtype = case["dtype"]
    prec = "fp32" if dtype == "float32" else "fp16"
    model = tcocoop.CoCoOp(CLASSNAMES, n_ctx=N_CTX, backbone="TINY", prec=prec, device="cpu",
                           clip_params=case["tp"])
    model.set_ckpt_state(model.model_name, jax.tree_util.tree_map(np.asarray, case["jm"]))
    images = np.random.RandomState(5).randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=JDT[dtype])
    want = jcocoop.cocoop_logits(case["jm"], case["jp"], case["jtask"],
                                 normalize(jnp.asarray(images)), chunk=tcocoop.eval_chunk(6))
    before = ftl.launches
    got = model.eval_step(images)
    assert ftl.launches == before  # the CPU runs the plain version
    _close(got, want, dtype)
    np.testing.assert_array_equal(model.model_inference(images), got.numpy())


@pytest.mark.parametrize("batch,chunk", [(100, 10), (7, 7), (12, 6), (1, 1)])
def test_eval_chunk_rule(batch, chunk):
    assert tcocoop.eval_chunk(batch) == chunk


def _model():
    return tcocoop.CoCoOp(CLASSNAMES, backbone="TINY", prec="fp32", device="cpu")


def test_ckpt_state_from_a_reference_checkpoint_is_transposed():
    model = _model()
    rng = np.random.RandomState(6)
    ref = {"ctx": rng.randn(N_CTX, 64).astype(np.float32),
           "meta_net.linear1.weight": rng.randn(4, 64).astype(np.float32),  # (out, in)
           "meta_net.linear1.bias": rng.randn(4).astype(np.float32),
           "meta_net.linear2.weight": torch.from_numpy(rng.randn(64, 4).astype(np.float32)),
           "meta_net.linear2.bias": rng.randn(64).astype(np.float32),
           "token_prefix": np.zeros(3, np.float32)}
    model.set_ckpt_state(model.model_name, ref)
    mn = model.params["meta_net"]
    np.testing.assert_array_equal(mn["w1"].numpy(), ref["meta_net.linear1.weight"].T)
    np.testing.assert_array_equal(mn["w2"].numpy(), ref["meta_net.linear2.weight"].numpy().T)
    np.testing.assert_array_equal(mn["b2"].numpy(), ref["meta_net.linear2.bias"])
    np.testing.assert_array_equal(model.params["ctx"].numpy(), ref["ctx"])


def test_ckpt_state_nested_jax_layout_and_mismatches():
    model = _model()
    nested = jax.tree_util.tree_map(np.asarray, {
        "ctx": jnp.ones((N_CTX, 64)),
        "meta_net": jcocoop.init_meta_net(jax.random.PRNGKey(3), 64, 64)})
    model.set_ckpt_state(model.model_name, nested)
    for key, leaf in nested["meta_net"].items():
        assert model.params["meta_net"][key].dtype == torch.float32
        np.testing.assert_array_equal(model.params["meta_net"][key].numpy(), leaf)
    bad = {**nested, "meta_net": {**nested["meta_net"], "w2": np.zeros((4, 65), np.float32)}}
    with pytest.raises(ValueError, match=r"shape mismatch for prompt_learner\.meta_net"):
        model.set_ckpt_state(model.model_name, bad)
    with pytest.raises(ValueError, match="structure mismatch"):
        model.set_ckpt_state(model.model_name, {"meta_net": {"w1": nested["meta_net"]["w1"]}})
    # a partial state keeps the missing top-level keys
    model.set_ckpt_state(model.model_name, {"ctx": np.zeros((N_CTX, 64), np.float32)})
    np.testing.assert_array_equal(model.params["meta_net"]["w1"].numpy(),
                                  nested["meta_net"]["w1"])


def test_build_lays_the_text_weights_out_once():
    """The build adds the fused kernel's layout of the frozen text tower's
    four weight matrices, stacked over the layers, and shares every other
    backbone tensor with ``clip_params``."""
    model = _model()
    blocks = model.clip_params["text"]["blocks"]
    frozen = model._frozen["clip"]
    laid_out = frozen["text"]["blocks"]["kernel"]
    assert set(laid_out) == {b for _, b in ftl._MATRICES}
    for a, b in ftl._MATRICES:
        torch.testing.assert_close(laid_out[b], ftl._core_matrices(blocks[a][b].bfloat16()),
                                   rtol=0, atol=0)
    assert all(frozen["text"]["blocks"][k] is v for k, v in blocks.items())
    assert frozen["visual"] is model.clip_params["visual"]
    assert all(frozen["text"][k] is v for k, v in model.clip_params["text"].items()
               if k != "blocks")
