"""The port's data path against the JAX package's.

With the JAX engine tests' fixture opts (synthetic, 4 shots, base
classes, TINY at INPUT.SIZE (32, 32), train batch 8, test batch 16, seed
1) the port's ``DataManager`` must yield, over two epochs, train, val
and test batches whose ``img``, ``label``, ``mask`` and ``n`` equal
``rpo_tpu.data.manager.DataManager``'s exactly: the same few-shot draw,
shuffles and crop and flip plans from the seeded global ``random``, and
the same pixels from the port's numpy resample, which must equal
Pillow's ``Image.resize`` (integer arithmetic, no tolerance).
"""
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from rpo_tpu.engine import get_cfg_default as jax_cfg  # before the manager: a cycle
from rpo_tpu.data.manager import DataManager as JaxDataManager
import rpo_tpu.data.datasets  # noqa: F401  registers the JAX datasets
from rpo_tpu.data import transforms as jax_T
from rpo_tpu_torch.data import transforms as T
from rpo_tpu_torch.data.datum import Datum
from rpo_tpu_torch.data.loader import BatchLoader
from rpo_tpu_torch.data.manager import DataManager
from rpo_tpu_torch.engine.config import get_cfg_default
from rpo_tpu_torch.engine.trainer import MetricMeter, device_prefetch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = ["DATASET.NUM_SHOTS", "4", "DATASET.SUBSAMPLE_CLASSES", "base",
        "MODEL.BACKBONE.NAME", "TINY", "INPUT.SIZE", "(32, 32)",
        "DATALOADER.TRAIN_X.BATCH_SIZE", "8", "DATALOADER.TEST.BATCH_SIZE", "16",
        "DATALOADER.NUM_WORKERS", "3"]
PIL_FILTER = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}


def _epochs(get_cfg, manager_cls, opts):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs/datasets/synthetic.yaml"))
    cfg.merge_from_file(os.path.join(REPO, "configs/trainers/RPO/main.yaml"))
    cfg.merge_from_list(opts)
    cfg.freeze()
    random.seed(1)
    np.random.seed(1)
    dm = manager_cls(cfg)
    out = {"classnames": dm.classnames}
    for epoch in range(2):
        for split in ("train_loader_x", "val_loader", "test_loader"):
            out[epoch, split] = [dict(b) for b in getattr(dm, split)]
    return out


@pytest.mark.parametrize("extra", [[], ["INPUT.INTERPOLATION", "bilinear"]],
                         ids=["bicubic", "bilinear"])
def test_batches_equal_jax_over_two_epochs(extra):
    want = _epochs(jax_cfg, JaxDataManager, OPTS + extra)
    got = _epochs(get_cfg_default, DataManager, OPTS + extra)
    assert got.keys() == want.keys() and got["classnames"] == want["classnames"]
    n_batches = {"train_loader_x": 2, "val_loader": 2, "test_loader": 4}  # 20, 20, 50 items
    for key in want:
        if key == "classnames":
            continue
        assert len(got[key]) == len(want[key]) == n_batches[key[1]], key
        for g, w in zip(got[key], want[key]):
            assert g["n"] == w["n"], key
            for name in ("img", "label", "mask"):
                assert g[name].dtype == w[name].dtype, (key, name)
                np.testing.assert_array_equal(g[name], w[name], err_msg=f"{key} {name}")
    # an epoch reshuffles and redraws the crops; padding rows are zero
    assert not np.array_equal(got[0, "train_loader_x"][0]["img"], got[1, "train_loader_x"][0]["img"])
    last = got[0, "test_loader"][-1]
    assert last["n"] == 2 and last["mask"].sum() == 2 and not last["img"][2:].any()


def _rrc_boxes(n, seed):
    rng = random.Random(seed)
    return [T.sample_rrc_box(224, 224, (0.08, 1.0), rng=rng) for _ in range(n)]


@pytest.mark.parametrize("interpolation", ["bicubic", "bilinear"])
def test_resample_equals_pillow(interpolation):
    """The train path's random resized crops of a 224 x 224 synthetic
    source to 224 and to 32, and whole-image resizes 224 -> 224, 32, 63
    and to odd shapes, including a non-square source."""
    src = T.synth_image("synthetic://train/3/7")
    img = Image.fromarray(src)
    f = PIL_FILTER[interpolation]
    cases = [((s, s), None) for s in (224, 32, 63)] + [((300, 17), None), ((1, 1), None)]
    cases += [((out, out), (l, t, l + w, t + h)) for l, t, w, h in _rrc_boxes(40, 5)
              for out in (224, 32)]
    for size, box in cases:
        want = np.asarray(img.resize(size, f, box=box))
        got = T.resample(src, size, interpolation, box=box)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{size} {box}")
    rect = np.random.RandomState(0).randint(0, 256, (150, 97, 3)).astype(np.uint8)
    for size in ((224, 224), (40, 90), (97, 150)):
        np.testing.assert_array_equal(T.resample(rect, size, interpolation),
                                      np.asarray(Image.fromarray(rect).resize(size, f)))


@pytest.mark.parametrize("shape", [(120, 90), (90, 120), (64, 64), (5, 7), (30, 100)])
def test_eval_resize_and_crop_equal_jax(shape):
    """resize-shorter then center-crop to 64 (black padding, as
    torchvision, for a side below 64): the eval path of a file image,
    against rpo_tpu's Pillow functions."""
    arr = np.random.RandomState(1).randint(0, 256, shape + (3,)).astype(np.uint8)
    want = jax_T.center_crop(jax_T.resize_shorter(Image.fromarray(arr), 64), 64)
    got = T.center_crop(T.resize_shorter(arr, 64), 64)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_file_image_loads_through_pillow(tmp_path):
    arr = np.random.RandomState(2).randint(0, 256, (40, 50, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(T.load_image(path), arr)
    pipeline = T.TransformPipeline(get_cfg_default().INPUT)
    assert pipeline.image_size(path) == (50, 40)


def test_loader_pads_drops_and_forwards_errors():
    items = [Datum(impath=f"synthetic://t/{i % 3}/{i}", label=i % 3) for i in range(10)]
    fixed = lambda impath, train: np.full((4, 4, 3), int(impath.rsplit("/", 1)[1]), np.uint8)
    loader = BatchLoader(items, fixed, batch_size=4, train=False, shuffle=False, num_workers=2)
    batches = list(loader)
    assert len(loader) == len(batches) == 3 and [b["n"] for b in batches] == [4, 4, 2]
    assert batches[2]["mask"].tolist() == [1, 1, 0, 0] and batches[2]["img"][2:].sum() == 0
    assert batches[1]["label"].tolist() == [1, 2, 0, 1]
    train = BatchLoader(items, fixed, batch_size=4, train=True, shuffle=True, drop_last=True)
    assert len(train) == len(list(train)) == 2

    def broken(impath, train):
        raise OSError("cannot decode")

    with pytest.raises(OSError, match="cannot decode"):
        list(BatchLoader(items, broken, batch_size=4, train=False, shuffle=False))


def test_device_prefetch_and_metric_meter():
    batches = [{"img": np.full((2, 4, 4, 3), i, np.uint8), "label": np.array([i, i], np.int32),
                "mask": np.ones(2, np.float32), "n": 2} for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu", depth=2))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["img"], torch.Tensor) and int(b["label"][0]) == i and b["n"] == 2
    only_img = next(device_prefetch(iter(batches), torch.device("cpu"), keys=("img",)))
    assert isinstance(only_img["img"], torch.Tensor) and isinstance(only_img["label"], np.ndarray)
    meter = MetricMeter()
    for v in (1.0, 2.0, 4.0):
        meter.update({"loss": torch.tensor(v)})
    assert str(meter) == "loss 4.0000 (2.3333)"


def test_fewshot_cache_is_shared_with_jax(tmp_path):
    """The few-shot cache (shot_{N}-seed_{S}.pkl, Dassl's pickle format)
    written by the port loads in rpo_tpu and gives the same subset, which
    is also the one rpo_tpu draws itself from the same seed."""
    from rpo_tpu.data.datum import Datum as JaxDatum, DatasetBase as JaxBase
    from rpo_tpu.data.splits import load_or_create_fewshot as jax_fewshot
    from rpo_tpu_torch.data.datum import DatasetBase
    from rpo_tpu_torch.data.splits import load_or_create_fewshot

    def items(cls):
        return [cls(impath=f"img/{i}.jpg", label=i % 3, classname=f"c{i % 3}") for i in range(30)]

    def paths(*lists):
        return [[d.impath for d in lst] for lst in lists]

    shared, own = str(tmp_path / "shared"), str(tmp_path / "jax_own")
    random.seed(3)
    mine = load_or_create_fewshot(DatasetBase(train_x=items(Datum)), items(Datum), items(Datum),
                                  shared, 2, 3)
    assert os.path.exists(os.path.join(shared, "shot_2-seed_3.pkl"))
    random.seed(99)  # a cache hit draws nothing
    loaded = jax_fewshot(JaxBase(train_x=items(JaxDatum)), items(JaxDatum), items(JaxDatum),
                         shared, 2, 3)
    random.seed(3)
    drawn = jax_fewshot(JaxBase(train_x=items(JaxDatum)), items(JaxDatum), items(JaxDatum),
                        own, 2, 3)
    assert paths(*mine) == paths(*loaded) == paths(*drawn)
    assert [len(x) for x in mine] == [6, 6]
