"""INPUT.DEVICE_RESIZE through the port against the JAX package.

The data side must be equal, byte for byte: with the synthetic fixture
of tests/test_torch_port_data.py and INPUT.DEVICE_RESIZE set, the port's
``DataManager`` yields over two epochs train batches whose ``img`` (the
raw sources), ``box``, ``flip``, ``label``, ``mask`` and ``n`` equal
``rpo_tpu``'s, and test batches of raw sources equal too: the plans come
from the same seeded draws and the port's numpy resample equals Pillow's.
At S = 224 the synthetic sources are exact and their boxes go to the
device; at S = 16 they are not, and the crops are applied on the host.
The transform's own device-resize branches (``raw_source``, the eval and
train calls) equal the JAX package's on image files.

The device side, ``make_image_prep``, routes as the JAX one does
(tests/test_device_resize_path.py): a dict to the train augmentation, a
full-size batch to the normalisation, any other size to the eval resize;
the values within one uint8 step of JAX's (tests/test_torch_port_
preprocess.py says why), the normalisation within float32 rounding.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rpo_tpu.data.transforms import TransformPipeline as JaxPipeline
from rpo_tpu.engine import get_cfg_default as jax_cfg
from rpo_tpu.methods.base_trainer import make_image_prep as jax_prep
from rpo_tpu_torch.data.datum import Datum
from rpo_tpu_torch.data.loader import BatchLoader
from rpo_tpu_torch.data.manager import DataManager
from rpo_tpu_torch.data.transforms import TransformPipeline
from rpo_tpu_torch.engine.config import get_cfg_default
from rpo_tpu_torch.methods.base_trainer import make_image_prep
from rpo_tpu_torch.ops import preprocess as tpre
from tests.test_torch_port_data import OPTS, JaxDataManager, _epochs
from tests.test_torch_port_preprocess import MEAN, STD, _one_step

TRAIN_KEYS = ("img", "box", "flip", "label", "mask")


@pytest.mark.parametrize("S", [224, 16], ids=["exact sources", "host-applied crops"])
def test_device_augment_batches_equal_jax_over_two_epochs(S):
    opts = OPTS + ["INPUT.DEVICE_RESIZE", str(S)]
    want = _epochs(jax_cfg, JaxDataManager, opts)
    got = _epochs(get_cfg_default, DataManager, opts)
    assert got.keys() == want.keys()
    for key in want:
        if key == "classnames":
            continue
        assert len(got[key]) == len(want[key]) > 0, key
        names = TRAIN_KEYS if key[1] == "train_loader_x" else ("img", "label", "mask")
        for g, w in zip(got[key], want[key]):
            assert g["n"] == w["n"], key
            assert set(g) == set(w), key
            for name in names:
                assert g[name].dtype == w[name].dtype, (key, name)
                np.testing.assert_array_equal(g[name], w[name], err_msg=f"{key} {name}")
            assert g["img"].shape[1:] == (S, S, 3)
    boxes = np.concatenate([b["box"] for b in got[0, "train_loader_x"]])
    if S == 224:  # real crops on the device; padding rows full frame
        assert (boxes[:, 2] < S).any() and (boxes[:, 2:] <= S).all()
    else:  # crops applied on the host: the device sees the full frame
        assert (boxes == [0, 0, S, S]).all()
    flips = np.concatenate([b["flip"] for b in got[0, "train_loader_x"]])
    assert 0 < flips.sum() < len(flips)


def _cfg_input(device_resize=64, interpolation="bicubic"):
    cfg = get_cfg_default()
    cfg.INPUT.SIZE = (224, 224)
    cfg.INPUT.INTERPOLATION = interpolation
    cfg.INPUT.DEVICE_RESIZE = device_resize
    cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
    return cfg.INPUT


def _jax_cfg(device_resize=64, interpolation="bicubic"):
    cfg = jax_cfg()
    cfg.INPUT.SIZE = (224, 224)
    cfg.INPUT.INTERPOLATION = interpolation
    cfg.INPUT.DEVICE_RESIZE = device_resize
    cfg.INPUT.PIXEL_MEAN = MEAN
    cfg.INPUT.PIXEL_STD = STD
    cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
    return cfg


@pytest.fixture()
def img_files(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate([(64, 64), (64, 64), (48, 48), (80, 60)]):
        p = tmp_path / f"im{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(str(p), quality=95)
        paths.append(str(p))
    return paths


def test_transform_branches_equal_jax(img_files):
    """raw_source (exact, resized, box applied), the eval call and the
    train call with a plan, on files and a synthetic source."""
    tp, jp = TransformPipeline(_cfg_input()), JaxPipeline(_jax_cfg().INPUT)
    assert tp.device_resize == jp.device_resize == 64
    for path in img_files + ["synthetic://train/3/7"]:
        np.testing.assert_array_equal(tp.raw_source(path), jp.raw_source(path), err_msg=path)
        np.testing.assert_array_equal(tp.raw_source(path, box=(4, 6, 30, 25)),
                                      jp.raw_source(path, box=(4, 6, 30, 25)), err_msg=path)
        out = tp(path, train=False)
        assert out.shape == (64, 64, 3) and out.dtype == np.uint8
        np.testing.assert_array_equal(out, jp(path, train=False), err_msg=path)
        for plan in [((8, 4, 30, 40), True), ((0, 0, 48, 48), False), (None, True)]:
            got = tp(path, train=True, plan=plan)
            assert got.shape == (224, 224, 3)
            np.testing.assert_array_equal(got, jp(path, train=True, plan=plan),
                                          err_msg=f"{path} {plan}")


def test_device_resize_requires_bicubic():
    for make in (lambda: TransformPipeline(_cfg_input(interpolation="bilinear")),
                 lambda: JaxPipeline(_jax_cfg(interpolation="bilinear").INPUT)):
        with pytest.raises(ValueError, match="DEVICE_RESIZE requires"):
            make()
    assert TransformPipeline(_cfg_input(0, "bilinear")).device_resize == 0


def test_loader_device_augment_batch_layout(img_files):
    """Files of (64, 64) keep their boxes, the others are cropped on the
    host and get the full frame, as do padding rows; the host call for
    the same plan is the device path's result within the JAX suite's two
    uint8 steps (Pillow's fixed point against float32 weights)."""
    tp = TransformPipeline(_cfg_input())
    items = [Datum(impath=p, label=i) for i, p in enumerate(img_files)]
    loader = BatchLoader(items, tp, batch_size=6, train=True, shuffle=False, num_workers=2)
    random.seed(5)
    batch = next(iter(loader))
    assert batch["img"].shape == (6, 64, 64, 3) and batch["n"] == 4
    assert batch["box"].dtype == batch["flip"].dtype == np.int32
    for i in range(2):
        left, top, cw, ch = batch["box"][i]
        assert 0 < cw <= 64 and 0 < ch <= 64 and left + cw <= 64 and top + ch <= 64
    assert (batch["box"][2:] == [0, 0, 64, 64]).all()
    assert (batch["mask"] == [1, 1, 1, 1, 0, 0]).all()
    plan = ((8, 4, 40, 48), True)
    host = tp(img_files[0], train=True, plan=plan)
    dev = tpre.device_train_preprocess(
        torch.from_numpy(tp.raw_source(img_files[0])[None].copy()),
        torch.tensor([[8, 4, 40, 48]], dtype=torch.int32), torch.tensor([1], dtype=torch.int32),
        224, MEAN, STD)[0]
    mean, std = np.asarray(MEAN) * 255.0, np.asarray(STD) * 255.0
    back = np.round(dev.numpy() * std + mean)
    assert np.abs(back - host).max() <= 2


def test_make_image_prep_routes_by_shape_and_dict():
    rng = np.random.RandomState(1)
    small = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    full = rng.randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    train = {"img": small, "box": np.asarray([[0, 0, 64, 64], [8, 8, 32, 40]], np.int32),
             "flip": np.asarray([0, 1], np.int32)}
    prep = make_image_prep(224, MEAN, STD, torch.float32, device_resize=64)
    jprep = jax_prep(_jax_cfg(), jnp.float32)

    out = prep(torch.from_numpy(small))
    assert tuple(out.shape) == (2, 224, 224, 3)
    _one_step(out.numpy(), np.asarray(jprep(jnp.asarray(small))), "eval route")
    out = prep({k: torch.from_numpy(v) for k, v in train.items()})
    assert tuple(out.shape) == (2, 224, 224, 3)
    _one_step(out.numpy(), np.asarray(jprep({k: jnp.asarray(v) for k, v in train.items()})),
              "train route")
    want = (full.astype(np.float32) - np.asarray(MEAN, np.float32) * 255.0) / (
        np.asarray(STD, np.float32) * 255.0)
    np.testing.assert_allclose(prep(torch.from_numpy(full)).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jprep(jnp.asarray(full))), want, rtol=1e-6)
    plain = make_image_prep(224, MEAN, STD, torch.float32)
    np.testing.assert_allclose(plain(torch.from_numpy(full)).numpy(), want, rtol=1e-6)
    bf16 = make_image_prep(224, MEAN, STD, torch.bfloat16, device_resize=64)
    assert bf16(torch.from_numpy(small)).dtype == torch.bfloat16
