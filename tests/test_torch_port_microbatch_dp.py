"""TRAIN.MICROBATCH under the port's data mesh against rpo_tpu's.

A world of 4 gloo ranks on the CPU, spawned once for this file
(``tests/torch_port_dist_workers.py``), trains RPO (TINY) at batch 8
with 2 padded rows and TRAIN.MICROBATCH 1: each rank chunks its 2 rows
one by one inside its loss (the last rank's are both padding), then the
ranks sum the gradients and the masked sums once.  Three steps with momentum against JAX's
``shard_train_step_spmd`` of the step built with ``axis_name="data"`` on
a 4-device mesh (and JAX's monolithic single-device step), at JAX's
tolerances (float32 rtol 1e-5 / atol 1e-6; a momentum within 1e-5 + 1e-4
x its largest entry).

The topology policy's lines (``_build_microbatched_train_step``)
against the JAX package's (tests/test_microbatch.py) under the same
counts: per-device chunking on a pure data mesh, ignored under tensor
parallelism, and nothing on one device.
"""
import functools
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
from rpo_tpu.parallel.dp import make_mesh, shard_train_step_spmd
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from rpo_tpu_torch.methods.base_trainer import CLIPMethodTrainer as PortTrainer
from rpo_tpu_torch.parallel import dp as tdp
from tests import torch_port_dist_workers as workers

CLASSNAMES = [f"thing {i}" for i in range(6)]
K, LR, B, WORLD = 3, 0.05, 8, 4
F32 = dict(rtol=1e-5, atol=1e-6)
STUB = dict(_momentum=0.9, _weight_decay=5e-4, _nesterov=False, _dampening=0.0)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), tree)


@functools.lru_cache(maxsize=None)
def setup():
    cfg = ARCHS["TINY"]
    jp = init_clip(jax.random.PRNGKey(0), cfg)
    task = jcore.make_task(cfg, CLASSNAMES, "a photo of a _.", K)
    prompts = jcore.init_prompts(jax.random.PRNGKey(1), jp, cfg, K)
    frozen = jcore.make_frozen(jp, task)
    rng = np.random.RandomState(3)
    batches = [(rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8),
                rng.randint(0, 6, B).astype(np.int64),
                (np.arange(B) < 6).astype(np.float32)) for _ in range(3)]
    return jp, task, prompts, frozen, batches


def _jax_step(microbatch, axis_name=None):
    _, task, _, _, _ = setup()
    normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=jnp.float32)
    return JaxTrainer._make_train_step(
        types.SimpleNamespace(**STUB),
        lambda p, fr, u8, text_f: jcore.rpo_logits(p, fr, task, normalize(u8), text_f=text_f,
                                                  split_vision=True),
        microbatch=microbatch,
        precompute=lambda p, fr: jcore.encode_text_with_prompts(p, fr, task),
        axis_name=axis_name)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jp, _, prompts, _, batches = setup()
    spec = {"method": "RPO", "arch": "TINY", "prec": "fp32", "K": K, "classnames": CLASSNAMES,
            "prompts": _np(prompts), "clip": _np(jp), "kwargs": {"microbatch": 1}}
    jobs = [("mb", "trainer", spec, [("step", *b, LR) for b in batches])]
    return workers.run_world(WORLD, jobs, tmp_path_factory.mktemp("mb"))["mb"]


@pytest.mark.parametrize("oracle", ["shard_train_step_spmd", "single-device monolithic"])
def test_microbatch_under_dp_equals_jax(ranks, oracle):
    _, _, prompts, frozen, batches = setup()
    if oracle == "shard_train_step_spmd":
        step = shard_train_step_spmd(_jax_step(1, "data"), make_mesh(jax.devices()[:WORLD]),
                                     donate=False)
    else:
        step = jax.jit(_jax_step(0))
    params, state = prompts, sgd_init(prompts)
    for i, (images, labels, mask) in enumerate(batches):
        params, state, loss, acc = step(params, state, frozen, jnp.asarray(images),
                                        jnp.asarray(labels, jnp.int32), jnp.asarray(mask),
                                        jnp.float32(LR))
        for r, results in enumerate(ranks):
            got = results[i]
            np.testing.assert_allclose(got["loss"], float(loss), err_msg=f"rank {r} step {i}",
                                       **F32)
            assert got["acc"] == pytest.approx(float(acc))
            for key, want in _np(params).items():
                np.testing.assert_allclose(got["params"][key], want,
                                           err_msg=f"rank {r} step {i} {key}", **F32)
            for key, want in _np(state.momentum).items():
                err, big = np.abs(got["momentum"][key] - want).max(), np.abs(want).max()
                assert err <= 1e-5 + 1e-4 * big, (r, i, key, err, big)


def _port_lines(monkeypatch, capsys, mb, world, tp):
    """The port's policy on a stub holding the mesh of ``world`` ranks."""
    mesh = None if world == 1 else tdp.Mesh(rank=0, world=world, backend="gloo",
                                            dp=world // max(tp, 1), tp=max(tp, 1))
    stub = types.SimpleNamespace(_microbatch=mb, mesh=mesh, **STUB)
    stub._make_train_step = functools.partial(PortTrainer._make_train_step, stub)
    capsys.readouterr()
    PortTrainer._build_microbatched_train_step(stub, lambda *a: None)
    return capsys.readouterr().out.replace("gloo", "ICI")


def _jax_lines(monkeypatch, capsys, mb, world, tp):
    monkeypatch.setattr(jax, "device_count", lambda: world)
    monkeypatch.setattr(jtp, "_WARNED_SINGLE_DEVICE", set())
    cfg = types.SimpleNamespace(TRAIN=types.SimpleNamespace(MICROBATCH=mb, TENSOR_PARALLEL=tp))
    stub = types.SimpleNamespace(cfg=cfg, **STUB)
    stub._make_train_step = functools.partial(JaxTrainer._make_train_step, stub)
    capsys.readouterr()
    JaxTrainer._build_microbatched_train_step(stub, lambda *a: None)
    return capsys.readouterr().out


@pytest.mark.parametrize("mb,world,tp", [(1, 4, 0), (4, 2, 0), (4, 8, 2), (4, 4, 4), (0, 4, 0),
                                         (2, 1, 0), (4, 4, 2)])
def test_policy_lines_equal_jax(monkeypatch, capsys, mb, world, tp):
    """The same lines (the port names its backend where JAX says ICI):
    chunking per rank on a data mesh, ignored under dp x tp, silent on one
    device or without MICROBATCH."""
    got = _port_lines(monkeypatch, capsys, mb, world, tp)
    want = _jax_lines(monkeypatch, capsys, mb, world, tp)
    assert got == want
    if mb and world > 1:
        assert ("ignored under TRAIN.TENSOR_PARALLEL" in got) == bool(tp)
        assert ("per-device chunking via shard_map" in got) == (not tp)
