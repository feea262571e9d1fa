"""The port's tensor parallelism across gloo ranks against rpo_tpu's.

Worlds of 2 and 4 gloo ranks on the CPU, spawned once for this file
(``tests/torch_port_dist_workers.py``), run RPO on TINY_W128 (two heads
in each tower, the smallest shape whose heads split) with
TRAIN.TENSOR_PARALLEL: each rank of a ``model`` group holds its heads'
columns of q, k, v and rows of the out-projection, its quarter or half
of fc's columns and proj's rows, and sums the float32 partial products
over the group.  The parent holds them against
``rpo_tpu.parallel.tp``'s steps on a mesh of the same shape and against
JAX's single-device program, on the same numpy-seeded batches and
weights:

- (dp, tp) = (1, 2) and (2, 2): the eval logits, and one train step with
  two padded rows (loss, accuracy, prompts, momentum);
- tp 4 on the 4-rank world: the heads (2) do not divide, so attention
  stays whole on every rank, as JAX's ``shard_heads`` leaves it, while
  the MLPs split; the logits still equal JAX's;
- ZeroshotCLIP, CoCoOp and CoOp evaluation routed over the data mesh
  and the dp x tp grid, against the port's one process;
- ``resolve_tp``, ``data_axis_size`` and the mesh factoring against
  JAX's under the same counts;
- the row-parallel partial product and its gradients against JAX's
  einsum with ``preferred_element_type=float32``.

Tolerances, JAX's: float32 rtol 1e-5 / atol 1e-6 for prompts and loss,
logits 1e-5; a momentum (a gradient summed in another order) within
1e-5 + 1e-4 x its largest entry.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rpo_tpu.parallel.tp as jtp
from rpo_tpu.data.transforms import device_normalize_fn as jax_normalize
from rpo_tpu.engine.optim import sgd_init
from rpo_tpu.methods import rpo as jcore
from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
from rpo_tpu.models.clip import ARCHS, init_clip
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from rpo_tpu_torch.parallel import dp as tdp
from rpo_tpu_torch.parallel import tp as ttp
from tests import torch_port_dist_workers as workers

N_CLS, K, LR = 8, 4, 0.01
CLASSNAMES = [f"class {i}" for i in range(N_CLS)]
F32 = dict(rtol=1e-5, atol=1e-6)
F32_LOGITS = dict(rtol=1e-5, atol=1e-5)
STUB = types.SimpleNamespace(_momentum=0.9, _weight_decay=5e-4, _nesterov=False, _dampening=0.0)
# (world, tp): the (1, 2) and (2, 2) grids, and tp 4 over the 2 heads
GRIDS = ((2, 2), (4, 2), (4, 4))
JDT_TP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), tree)


class Case:
    def __init__(self):
        cfg = ARCHS["TINY_W128"]
        self.jp = init_clip(jax.random.PRNGKey(0), cfg)
        self.task = task = jcore.make_task(cfg, CLASSNAMES, "a photo of a _.", K)
        self.prompts = jcore.init_prompts(jax.random.PRNGKey(1), self.jp, cfg, K)
        self.frozen = jcore.make_frozen(self.jp, task)
        normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=jnp.float32)
        self.step = JaxTrainer._make_train_step(
            STUB, lambda p, fr, u8, text_f: jcore.rpo_logits(
                p, fr, task, normalize(u8), text_f=text_f, split_vision=True),
            precompute=lambda p, fr: jcore.encode_text_with_prompts(p, fr, task))
        self.eval = lambda p, fr, text_f, u8: jcore.rpo_logits(p, fr, task, normalize(u8),
                                                               text_f=text_f)
        rng = np.random.RandomState(0)
        self.images = rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)
        self.labels = rng.randint(0, N_CLS, 8).astype(np.int64)
        self.mask = (np.arange(8) < 6).astype(np.float32)

    def spec(self, tp):
        return {"method": "RPO", "arch": "TINY_W128", "prec": "fp32", "K": K,
                "classnames": CLASSNAMES, "prompts": _np(self.prompts), "clip": _np(self.jp),
                "kwargs": {"tensor_parallel": tp}}


_CASE = []


def case() -> Case:
    if not _CASE:
        _CASE.append(Case())
    return _CASE[0]


# the other trainers' eval routing (JAX's zsclip.py:90-118 and the base
# trainer's): (world, tp, method, kwargs) held to the port's one process
EVALS = ((2, 2, "ZeroshotCLIP", {}), (4, 0, "ZeroshotCLIP", {}),
         (2, 2, "CoCoOp", {"n_ctx": 2}), (4, 2, "CoOp", {"n_ctx": 2}))


def _eval_spec(method, kwargs, tp):
    c = case()
    return {"method": method, "arch": "TINY_W128", "prec": "fp32", "classnames": CLASSNAMES,
            "clip": _np(c.jp), "kwargs": {**kwargs, "tensor_parallel": tp}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    c = case()
    ops = [("eval", c.images), ("step", c.images, c.labels, c.mask, LR)]
    out = {}
    for world in sorted({w for w, _ in GRIDS}):
        jobs = [(f"tp{t}", "trainer", c.spec(t), ops) for w, t in GRIDS if w == world]
        jobs += [(f"{m}-{t}", "trainer", _eval_spec(m, kw, t), [("eval", c.images)])
                 for w, t, m, kw in EVALS if w == world]
        for name, result in workers.run_world(world, jobs, tmp_path_factory.mktemp(
                f"world{world}")).items():
            out[(world, int(name[2:])) if name.startswith("tp") else (world, name)] = result
    return out


@pytest.mark.parametrize("world,tp,method,kwargs", EVALS, ids=lambda v: str(v))
def test_other_trainers_eval_routing_equals_one_process(worlds, world, tp, method, kwargs):
    """ZeroshotCLIP (bf16, whatever PREC says) under dp 4 and tp 2, CoCoOp
    under tp 2 (its text towers unfused) and CoOp under dp 2 x tp 2: every
    rank's gathered logits against the port's one process on the same
    batch (fp32 1e-5; bf16 the eval gate's 5e-2, PERF.md section 2)."""
    from rpo_tpu_torch.tools.dryrun_multichip import build, execute

    single = execute(build(_eval_spec(method, kwargs, 0), "cpu"), [("eval", case().images)])
    atol = 5e-2 if method.startswith("Zeroshot") else 1e-5
    for r, results in enumerate(worlds[world, f"{method}-{tp}"]):
        np.testing.assert_allclose(results[0]["logits"], single[0]["logits"], atol=atol,
                                   rtol=1e-5, err_msg=f"rank {r}")


def _mesh(world, tp):
    return jtp.make_mesh_2d(jax.devices()[:world], dp=world // tp, tp=tp)


@pytest.mark.parametrize("world,tp", GRIDS, ids=lambda g: str(g))
def test_eval_equals_jax_tp_and_single_device(worlds, world, tp):
    c = case()
    text_f = jcore.encode_text_with_prompts(c.prompts, c.frozen, c.task)
    args = (c.prompts, c.frozen, text_f, jnp.asarray(c.images))
    want_tp = np.asarray(jtp.shard_eval_step_tp(c.eval, _mesh(world, tp))(*args))
    want = np.asarray(jax.jit(c.eval)(*args))
    for r, results in enumerate(worlds[world, tp]):
        got = results[0]["logits"]
        assert got.shape == (8, N_CLS)
        np.testing.assert_allclose(got, want_tp, err_msg=f"rank {r}", **F32_LOGITS)
        np.testing.assert_allclose(got, want, err_msg=f"rank {r}", **F32_LOGITS)


@pytest.mark.parametrize("world,tp", GRIDS[:2], ids=lambda g: str(g))
def test_train_step_equals_jax_tp(worlds, world, tp):
    """One step with two padded rows: JAX's ``shard_train_step_tp`` on the
    same grid (and its single-device step)."""
    c = case()
    args = (c.prompts, sgd_init(c.prompts), c.frozen, jnp.asarray(c.images),
            jnp.asarray(c.labels, jnp.int32), jnp.asarray(c.mask), jnp.float32(LR))
    for fn in (jtp.shard_train_step_tp(c.step, _mesh(world, tp), donate=False), jax.jit(c.step)):
        params, state, loss, acc = fn(*args)
        for r, results in enumerate(worlds[world, tp]):
            got = results[1]
            np.testing.assert_allclose(got["loss"], float(loss), err_msg=f"rank {r}", **F32)
            assert got["acc"] == pytest.approx(float(acc))
            for key, want in _np(params).items():
                np.testing.assert_allclose(got["params"][key], want, err_msg=f"{r} {key}", **F32)
            for key, want in _np(state.momentum).items():
                err, big = np.abs(got["momentum"][key] - want).max(), np.abs(want).max()
                assert err <= 1e-5 + 1e-4 * big, (r, key, err, big)


def _params_on(monkeypatch, tp, rank):
    """The port's sliced TINY_W128 blocks for ``rank`` of a tp group."""
    from rpo_tpu_torch.models.clip import ARCHS as TARCHS, params_from_numpy

    mesh = tdp.Mesh(rank=rank, world=tp, backend="gloo", dp=1, tp=tp)
    return ttp.shard_params(params_from_numpy(_np(case().jp), "cpu"), TARCHS["TINY_W128"], mesh)


@pytest.mark.parametrize("tp", [2, 4])
def test_indivisible_heads_stay_whole(monkeypatch, tp):
    """tp 2: both towers' two heads split, one a rank (q/k/v 3 x 64
    columns of 3 x 128, out-proj 64 rows); tp 4: they do not divide and
    attention stays whole on every rank, while every MLP splits (fc's 512
    and 256 hidden columns over 4)."""
    cfg = ARCHS["TINY_W128"]
    for rank in range(tp):
        p = _params_on(monkeypatch, tp, rank)
        for tower, width in (("visual", cfg.vision_width), ("text", cfg.text_width)):
            attn, mlp = p[tower]["blocks"]["attn"], p[tower]["blocks"]["mlp"]
            heads = cfg.vision_heads if tower == "visual" else cfg.text_heads
            whole = heads % tp != 0
            assert attn["qkv_w"].shape[-1] == (3 * width if whole else 3 * width // tp)
            assert attn["out_w"].shape[-2] == (width if whole else width // tp)
            assert mlp["fc_w"].shape[-1] == 4 * width // tp
            assert mlp["proj_w"].shape[-2] == 4 * width // tp
            assert attn["out_b"].shape[-1] == mlp["proj_b"].shape[-1] == width


def _cfg(tp):
    return types.SimpleNamespace(TRAIN=types.SimpleNamespace(TENSOR_PARALLEL=tp))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("tp", [0, 1, 2, 3, 4, 8])
def test_resolve_tp_and_data_axis_size_equal_jax_over_ranks(monkeypatch, n, tp):
    """Under a process group of ``n`` ranks (the port counts ranks, JAX
    devices): the same tp, the same data axis, the same error."""
    monkeypatch.setattr(tdp, "is_initialized", lambda: True)
    monkeypatch.setattr(tdp, "world_size", lambda: n)
    monkeypatch.setattr(jax, "device_count", lambda: n)
    monkeypatch.setattr(jtp, "_WARNED_SINGLE_DEVICE", set())
    monkeypatch.setattr(ttp, "_WARNED_SINGLE_DEVICE", set())

    def both(fn_j, fn_t):
        try:
            want = ("ok", fn_j(_cfg(tp)))
        except ValueError as exc:
            want = ("error", str(exc))
        try:
            got = ("ok", fn_t(_cfg(tp)))
        except ValueError as exc:
            got = ("error", str(exc))
        assert got == want

    both(jtp.resolve_tp, ttp.resolve_tp)
    both(jtp.data_axis_size, ttp.data_axis_size)


@pytest.mark.parametrize("dp,tp", [(None, None), (None, 4), (2, None), (None, 2), (4, 2),
                                   (3, 2), (None, 3), (1, 8)])
def test_make_mesh_2d_factoring_equals_jax(dp, tp):
    """The port's (dp, tp) for 8 ranks, and its error, as JAX's
    ``make_mesh_2d`` shapes the 8 virtual devices."""
    try:
        want = ("ok", tuple(jtp.make_mesh_2d(jax.devices(), dp=dp, tp=tp).shape.values()))
    except ValueError as exc:
        want = ("error", str(exc))
    try:
        got = ("ok", ttp.factor(8, dp, tp))
    except ValueError as exc:
        got = ("error", str(exc))
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_parallel_partial_product_equals_jax_preferred_float32(dtype):
    """tp's row-parallel partial product, cast to the activation dtype as
    ``row_parallel`` casts it, and its gradients against JAX's einsum with
    ``preferred_element_type=float32`` then ``astype``: the forward and
    ``jax.vjp`` on the same numpy-seeded operands and cotangent (float32
    1e-5; bfloat16 1e-2)."""
    import torch

    rng = np.random.RandomState(0)
    h = (rng.randn(2, 5, 16) * 0.5).astype(np.float32)
    w = (rng.randn(16, 32) * 0.1).astype(np.float32)
    g = rng.randn(2, 5, 32).astype(np.float32)
    jdt, tdt = JDT_TP[dtype], getattr(torch, dtype)

    def jax_fn(a, b):
        return jnp.einsum("bld,de->ble", a, b, preferred_element_type=jnp.float32).astype(jdt)

    hj, wj = jnp.asarray(h, jdt), jnp.asarray(w, jdt)
    want, vjp = jax.vjp(jax_fn, hj, wj)
    want_dh, want_dw = vjp(jnp.asarray(g, jdt))
    ht, wt = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (h, w))
    got = ttp._PartialProduct.apply(ht, wt, tdt)
    assert got.dtype == torch.float32
    got = got.to(tdt)
    got.backward(torch.from_numpy(g).to(tdt))
    tol = F32 if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    for name, a, b in (("product", got, want), ("dh", ht.grad, want_dh), ("dw", wt.grad, want_dw)):
        np.testing.assert_allclose(a.detach().float().numpy(), _np(b), err_msg=name, **tol)
