"""The port's RPO evaluation against rpo_tpu.methods.rpo.

JAX weights from ``rpo_tpu.models.clip.init_clip`` at TINY (one vision
head of 64: the unpaired kernel) and TINY_W128 (two heads of 64: the
paired kernel) are carried across with ``params_from_numpy``; prompts
and images are the same on both sides.  The JAX eval path's Pallas
kernels run in interpret mode.
"""
import functools
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpo_tpu.ops.attention as jattn
import rpo_tpu.ops.pallas_attention as jpallas
from rpo_tpu.data.transforms import device_normalize_fn as jax_normalize
from rpo_tpu.engine.evaluator import ClassificationEvaluator as JaxEvaluator
from rpo_tpu.methods import rpo as jcore
from rpo_tpu.models.clip import ARCHS, cast_params, init_clip
from rpo_tpu.ops.fused_rect_layer import fused_rect_residual_block as jax_fused_block
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from rpo_tpu_torch.engine.evaluator import ClassificationEvaluator
from rpo_tpu_torch.methods import rpo as tcore
from rpo_tpu_torch.methods.rpo_trainer import RPO
from rpo_tpu_torch.models.clip import ARCHS as TARCHS, params_from_numpy
from rpo_tpu_torch.models.clip import init_clip as tinit
from rpo_tpu_torch.ops import fused_rect_layer as frl

CLASSNAMES = [f"a longer class name {i}" for i in range(3)] + ["cat", "dog machine", "crimson finch"]
K = 5
# f32: the same operations in the same order up to summation order.
# bf16: every activation is rounded to bf16 (2^-8 relative) and rounding
# flips compound through the towers, so features agree to a few percent
# of their O(1) size; logits are 14.3 x a cosine, so 0.15 there is a
# cosine difference of 0.01.
TOL = {
    "float32": dict(feat=dict(atol=1e-4, rtol=1e-4), logits=dict(atol=1e-4, rtol=0)),
    "bfloat16": dict(feat=dict(atol=0.06, rtol=0), logits=dict(atol=0.15, rtol=0)),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX eval path's Pallas kernels, forced on in interpret mode."""
    rect, paired = jpallas.pallas_rect_attention, jpallas.pallas_rect_attention_paired
    monkeypatch.setattr(jattn, "use_pallas_attention", lambda: True)
    monkeypatch.setattr(jpallas, "pallas_rect_attention",
                        lambda q, k, v, interpret=False: rect(q, k, v, True))
    monkeypatch.setattr(jpallas, "pallas_rect_attention_paired",
                        lambda q2, k2, v2, half=64, interpret=False: paired(q2, k2, v2, half, True))


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
    tprompts = params_from_numpy(jax.tree_util.tree_map(np.asarray, prompts), "cpu")
    ttask = tcore.make_task(TARCHS[arch], CLASSNAMES, "a photo of a _.", K)
    images = np.random.RandomState(2).randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    return dict(arch=arch, dtype=dtype, jp=jp, task=task, prompts=prompts, tp=tp,
                tprompts=tprompts, ttask=ttask, images=images)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(jnp.asarray(j).astype(jnp.float32)), **tol)


def test_make_task_equals_jax():
    for arch in ("TINY", "ViT-B/16"):
        want = jcore.make_task(ARCHS[arch], CLASSNAMES, "a photo of a _.", 24)
        got = tcore.make_task(TARCHS[arch], CLASSNAMES, "a photo of a _.", 24)
        assert (got.K, got.n_cls) == (want.K, want.n_cls)
        for name in ("text_tokens", "len_prompts", "text_mask", "visual_mask", "prompt_onehot"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(ValueError):
        tcore.make_task(TARCHS["TINY"], CLASSNAMES, "a photo of a _.", 0)


def test_precompute_text_kv(case):
    want = jcore.precompute_text_kv(case["jp"], case["task"])
    got = tcore.precompute_text_kv(case["tp"], case["ttask"])
    for key in ("k", "v"):
        assert tuple(got[key].shape) == tuple(want[key].shape)
        _close(got[key], want[key], TOL[case["dtype"]]["feat"])


def test_text_features(case):
    want = jcore.encode_text_with_prompts(
        case["prompts"], jcore.make_frozen(case["jp"], case["task"]), case["task"]
    )
    got = tcore.encode_text_with_prompts(
        case["tprompts"], tcore.make_frozen(case["tp"], case["ttask"]), case["ttask"]
    )
    _close(got, want, TOL[case["dtype"]]["feat"])


def test_encode_image_with_prompts(case, jax_pallas_interpret):
    dtype = case["dtype"]
    imgs = np.random.RandomState(3).randn(3, 32, 32, 3).astype(np.float32)
    jimgs = jnp.asarray(imgs).astype(JDT[dtype])
    timgs = torch.from_numpy(np.array(jimgs.astype(jnp.float32))).to(TDT[dtype])
    want = jcore.encode_image_with_prompts(
        case["prompts"], {"clip": case["jp"]}, case["task"], jimgs
    )
    got = tcore.encode_image_with_prompts(case["tprompts"], {"clip": case["tp"]}, case["ttask"], timgs)
    assert tuple(got.shape) == (3, K, TARCHS[case["arch"]].embed_dim)
    _close(got, want, TOL[dtype]["feat"])


def _trainer(case, vision_layer=None):
    prec = "fp32" if case["dtype"] == "float32" else "fp16"
    rpo = RPO(CLASSNAMES, K=K, backbone=case["arch"], prec=prec, device="cpu",
              clip_params=case["tp"], vision_layer=vision_layer)
    rpo.set_ckpt_state(rpo.model_name, jax.tree_util.tree_map(np.asarray, case["prompts"]))
    return rpo


def test_eval_step_end_to_end(case, jax_pallas_interpret):
    """RPO.eval_step on uint8 images == JAX rpo_logits on the same
    normalised images with the same prompts and the per-task text cache."""
    dtype = case["dtype"]
    normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=JDT[dtype])
    frozen = jcore.make_frozen(case["jp"], case["task"])
    text_f = jcore.encode_text_with_prompts(case["prompts"], frozen, case["task"])
    want = jcore.rpo_logits(case["prompts"], frozen, case["task"],
                            normalize(jnp.asarray(case["images"])), text_f=text_f)
    rpo = _trainer(case)
    got = rpo.eval_step(case["images"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, len(CLASSNAMES))
    _close(got, want, TOL[dtype]["logits"])
    np.testing.assert_array_equal(rpo.model_inference(case["images"]), got.numpy())


def test_eval_step_with_the_fused_vision_tower(case, monkeypatch):
    """RPO(vision_layer=fused_rect_residual_block).eval_step (the plain
    halves on the CPU) == JAX rpo_logits with the JAX fused block, in
    interpret mode, in every vision layer in place of rect_residual_block;
    the build lays the vision weights out once for the kernels."""
    dtype = case["dtype"]
    traced = []
    fused = functools.partial(jax_fused_block, interpret=True)
    monkeypatch.setattr(jcore, "rect_residual_block",
                        lambda *args: traced.append(args[3]) or fused(*args))
    normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=JDT[dtype])
    frozen = jcore.make_frozen(case["jp"], case["task"])
    text_f = jcore.encode_text_with_prompts(case["prompts"], frozen, case["task"])
    want = jcore.rpo_logits(case["prompts"], frozen, case["task"],
                            normalize(jnp.asarray(case["images"])), text_f=text_f)
    assert traced  # the scanned vision tower ran the fused block
    rpo = _trainer(case, frl.fused_rect_residual_block)
    assert set(rpo._frozen["clip"]["visual"]["blocks"]["kernel"]) == {
        "qkv_w", "out_w", "fc_w", "proj_w"}
    before = (frl.attn_half_launches, frl.mlp_half_launches)
    got = rpo.eval_step(case["images"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, len(CLASSNAMES))
    _close(got, want, TOL[dtype]["logits"])
    assert (frl.attn_half_launches, frl.mlp_half_launches) == before  # the plain halves here
    # the same function as the unfused tower the default trainer runs
    _close(got, np.asarray(_trainer(case).eval_step(case["images"])), TOL[dtype]["logits"])


def test_cached_text_path_equals_masked_path():
    """The prompt-rows-only text path == the full masked 77-token tower,
    as tests/test_text_kv_cache.py pins on the JAX side."""
    cfg = TARCHS["TINY"]
    tp = tinit(torch.Generator().manual_seed(0), cfg)
    task = tcore.make_task(cfg, CLASSNAMES, "a photo of a _.", K)
    prompts = tcore.init_prompts(torch.Generator().manual_seed(1), tp, cfg, K)
    for key, base in (("text_prompt", tp["text"]["token_embedding"][49407]),
                      ("img_prompt", tp["visual"]["class_embedding"])):
        noise = torch.linalg.vector_norm(prompts[key] - base, dim=-1)  # 0.1 * unit noise
        np.testing.assert_allclose(noise.numpy(), 0.1, rtol=1e-5)
    full = tcore.encode_text_with_prompts(prompts, tcore.make_frozen(tp, task, cache_text_kv=False), task)
    fast = tcore.encode_text_with_prompts(prompts, tcore.make_frozen(tp, task), task)
    assert tuple(fast.shape) == (len(CLASSNAMES), K, cfg.embed_dim)
    np.testing.assert_allclose(fast.numpy(), full.numpy(), atol=1e-5, rtol=0)


def test_set_ckpt_state_validates_shapes():
    tp = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, init_clip(jax.random.PRNGKey(0), ARCHS["TINY"])), "cpu"
    )
    rpo = RPO(CLASSNAMES, K=K, backbone="TINY", prec="fp32", device="cpu", clip_params=tp)
    with pytest.raises(ValueError, match="shape mismatch"):
        rpo.set_ckpt_state(rpo.model_name, {"text_prompt": np.zeros((K + 1, 64), np.float32)})
    rpo.text_features()
    assert rpo._text_f_cache is not None
    with redirect_stdout(io.StringIO()) as out:
        rpo.set_ckpt_state(rpo.model_name, {"img_prompt": np.ones((K, 64)), "token_prefix": 0,
                                            "stale": np.zeros(1)})
    assert "unexpected" in out.getvalue() and "missing" in out.getvalue()
    assert rpo._text_f_cache is None
    assert rpo.params["img_prompt"].dtype == torch.float32
    assert float(rpo.params["img_prompt"].sum()) == K * 64


def test_evaluator_log_contract_equals_jax():
    rng = np.random.RandomState(4)
    logits, labels = rng.randn(40, 6), rng.randint(0, 6, 40)
    outs = []
    for cls in (ClassificationEvaluator, JaxEvaluator):
        ev = cls(None, CLASSNAMES)
        ev.process(logits, labels)
        with redirect_stdout(io.StringIO()) as out:
            res = ev.evaluate()
        outs.append((out.getvalue(), res))
    assert outs[0] == outs[1]
    assert "=> result" in outs[0][0] and "* accuracy:" in outs[0][0]
