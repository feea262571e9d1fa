"""The port's device preprocessing against rpo_tpu.ops.preprocess.

The same uint8 sources, boxes and flips (numpy, from a seed) go through
the JAX functions (XLA einsums at HIGHEST precision, on the CPU) and
through ``rpo_tpu_torch.ops.preprocess`` (float32 torch products).  The
static weights are numpy in both and must be equal; the per-image
weights are float32 in both, within 1e-6 of each other and 1e-5 of the
static ones (the JAX suite's bound).  An image is compared back in
uint8 steps (the normalisation undone and rounded): the two round
between their passes and differ only where a pass lands within float32
rounding of a half step, so at most one step, on at most MAX_OFF of the
values.  The counts are printed (-s); when this was written: eval 26 of
451,584, 7 of 301,056 and 0 of 6,144; train 15 of 903,168 (up-scaling),
0 of 73,728 (down-scaling), 2 of 903,168 (224 sources), 4 of 18,432
(16 -> 32); the static resize 4 of 7,680 (48 x 80 -> 32 x 40, the
largest share, 5.2e-4).
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpo_tpu.data.transforms import sample_rrc_box
from rpo_tpu.ops import preprocess as jpre
from rpo_tpu_torch.ops import preprocess as tpre

MEAN = [0.48145466, 0.4578275, 0.40821073]
STD = [0.26862954, 0.26130258, 0.27577711]
MAX_OFF = 1e-3  # the share of uint8 values one step apart


def _u8(x, mean=MEAN, std=STD):
    """A normalised batch back in uint8 steps."""
    return np.round(np.asarray(x) * np.asarray(std) * 255.0 + np.asarray(mean) * 255.0)


def _one_step(got, want, what):
    diff = np.abs(_u8(got) - _u8(want))
    off = int((diff > 0).sum())
    print(f"{what}: {off} of {diff.size} values one uint8 step apart")
    assert diff.max() <= 1, f"{what}: {diff.max()} steps apart"
    assert off <= MAX_OFF * diff.size, f"{what}: {off} of {diff.size} apart"


@pytest.mark.parametrize("src,out", [(64, 224), (224, 64), (48, 224), (224, 224), (224, 32),
                                     (16, 32)])
def test_resize_weights_and_traced_weights(src, out):
    want = jpre.resize_weights(src, out)
    assert np.array_equal(tpre.resize_weights(src, out), want)
    full = tpre._traced_resize_weights(src, out, torch.tensor([0]), torch.tensor([src]))[0]
    np.testing.assert_allclose(full.numpy(), want, atol=1e-5)
    # a window: against the JAX traced weights at the same start and length
    start, length = src // 8, max(1, src // 2)
    got = tpre._traced_resize_weights(src, out, torch.tensor([0, start]),
                                      torch.tensor([src, length]))
    assert tuple(got.shape) == (2, out, src)
    jax_w = np.asarray(jpre._traced_resize_weights(src, out, start, length))
    np.testing.assert_allclose(got[1].numpy(), jax_w, atol=1e-6)


@pytest.mark.parametrize("shape,out", [((2, 64, 64, 3), (224, 224)), ((2, 48, 80, 3), (32, 40)),
                                       ((1, 224, 224, 3), (96, 112))])
def test_resize_bicubic_equals_jax(shape, out):
    imgs = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    got = tpre.resize_bicubic(torch.from_numpy(imgs).float(), *out)
    want = np.asarray(jpre.resize_bicubic(jnp.asarray(imgs, jnp.float32), *out))
    assert tuple(got.shape) == want.shape
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= MAX_OFF
    raw = tpre.resize_bicubic(torch.from_numpy(imgs).float(), *out, quantize=False)
    np.testing.assert_allclose(raw.numpy(), np.asarray(jpre.resize_bicubic(
        jnp.asarray(imgs, jnp.float32), *out, quantize=False)), atol=1e-3)


@pytest.mark.parametrize("shape,size", [((3, 64, 64, 3), 224), ((2, 64, 48, 3), 224),
                                        ((2, 40, 72, 3), 32)])
def test_device_eval_preprocess_equals_jax(shape, size):
    imgs = np.random.RandomState(2).randint(0, 256, shape).astype(np.uint8)
    got = tpre.device_eval_preprocess(torch.from_numpy(imgs), size, MEAN, STD)
    want = np.asarray(jpre.device_eval_preprocess(jnp.asarray(imgs), size, MEAN, STD))
    assert tuple(got.shape) == want.shape == (shape[0], size, size, 3)
    assert got.dtype == torch.float32
    _one_step(got.numpy(), want, f"eval {shape} -> {size}")


def _boxes(S, n, seed):
    random.seed(seed)
    return [(0, 0, S, S)] + [sample_rrc_box(S, S) for _ in range(n - 1)]


@pytest.mark.parametrize("S,out,what", [(64, 224, "up-scaling boxes"),
                                        (224, 64, "down-scaling boxes"),
                                        (224, 224, "the protocol's 224 sources"),
                                        (16, 32, "TINY's 16 -> 32")])
def test_device_train_preprocess_equals_jax(S, out, what):
    """Full-frame and random crop boxes, flips on and off."""
    rng = np.random.RandomState(3)
    n = 6
    imgs = rng.randint(0, 256, (n, S, S, 3)).astype(np.uint8)
    boxes = np.asarray(_boxes(S, n, S), np.int32)
    flips = np.asarray([0, 1, 0, 1, 1, 0], np.int32)
    got = tpre.device_train_preprocess(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                       torch.from_numpy(flips), out, MEAN, STD)
    want = np.asarray(jpre.device_train_preprocess(
        jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(flips), out, MEAN, STD))
    assert tuple(got.shape) == want.shape == (n, out, out, 3)
    _one_step(got.numpy(), want, f"train {S} -> {out}, {what}")
    # the flip is the mirror of the unflipped resize
    unflipped = tpre.device_train_preprocess(
        torch.from_numpy(imgs), torch.from_numpy(boxes), torch.zeros(n, dtype=torch.int32), out,
        MEAN, STD)
    assert torch.equal(got[1], unflipped[1].flip(1))
    assert torch.equal(got[0], unflipped[0])


def test_constants_given_as_tensors_pass_through():
    mean, std = tpre._mean_std_u8(MEAN, STD, "cpu")
    again = tpre._mean_std_u8(mean, std, "cpu")
    assert again[0] is mean and again[1] is std
    np.testing.assert_allclose(mean.numpy(), np.asarray(MEAN) * 255.0, rtol=1e-6)
