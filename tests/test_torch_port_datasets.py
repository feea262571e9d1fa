"""The port's file-backed dataset readers against the JAX package's.

Every registry name's tree is written once by
``rpo_tpu_torch.tools.fake_datasets`` (the layouts of
tests/test_datasets.py and DATASETS.md, at four classes), its image
files copies of one 8 x 8 JPEG written with Pillow.  Under each
NUM_SHOTS (-1, 16) and SUBSAMPLE_CLASSES (all, base, new), with the
generated files (split JSON, few-shot cache, ImageNet's item cache)
removed and ``random`` seeded alike before each, ``rpo_tpu``'s reader and
the port's must return equal (impath, label, classname) lists for
train_x, val and test, equal classnames and lab2cname, and equal bytes in
every file they write; both must return the counts that the tree defines
(``fake_datasets.expected``, which chip_smoke.py holds the readers to on
the card's machine).  Then caches written by either package load in the
other, and the port's ``DataManager`` builds every name.  No tolerance:
lists of strings and integers.
"""
import glob
import os
import random
import shutil

import numpy as np
import pytest
from PIL import Image

from rpo_tpu.engine import get_cfg_default as jax_cfg
from rpo_tpu.engine.registry import DATASET_REGISTRY as JAX_REGISTRY
import rpo_tpu.data.datasets  # noqa: F401  registers the JAX datasets
from rpo_tpu_torch.data import datasets as port_datasets
from rpo_tpu_torch.data.manager import DataManager
from rpo_tpu_torch.engine.config import get_cfg_default
from rpo_tpu_torch.engine.registry import DATASET_REGISTRY
from rpo_tpu_torch.tools import fake_datasets

NAMES = sorted(fake_datasets.WRITERS)
# the files a reader writes into its tree
GENERATED = ("split_zhou_*.json", "split_fewshot", "preprocessed*.pkl")


def test_registry_has_every_name():
    assert port_datasets is not None
    assert len(NAMES) == 15
    assert DATASET_REGISTRY.registered_names() == sorted(NAMES + ["Synthetic"]) == \
        sorted(set(JAX_REGISTRY.registered_names()) & set(NAMES + ["Synthetic"]))


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("src") / "src.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)  # as tests/test_datasets.py
    return path


@pytest.fixture(scope="module")
def trees(tmp_path_factory, source):
    """name -> (DATASET.ROOT, Layout), each tree written on first use."""
    made = {}

    def get(name):
        if name not in made:
            root = str(tmp_path_factory.mktemp(name))
            made[name] = (root, fake_datasets.write_tree(name, root, [source]))
        return made[name]

    return get


def _cfg(get, root, name, shots=-1, subsample="all", seed=1):
    cfg = get()
    cfg.DATASET.ROOT = root
    cfg.DATASET.NAME = name
    cfg.DATASET.NUM_SHOTS = shots
    cfg.DATASET.SUBSAMPLE_CLASSES = subsample
    cfg.SEED = seed
    return cfg


def _clean(root):
    for pattern in GENERATED:
        for path in glob.glob(os.path.join(root, "*", pattern)):
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)


def _written(root):
    """relative path -> bytes of every file a reader generated."""
    out = {}
    for pattern in GENERATED:
        for path in glob.glob(os.path.join(root, "*", pattern)):
            files = glob.glob(os.path.join(path, "*")) if os.path.isdir(path) else [path]
            for f in files:
                with open(f, "rb") as fh:
                    out[os.path.relpath(f, root)] = fh.read()
    return out


def _items(ds):
    return {split: [(d.impath, d.label, d.classname) for d in getattr(ds, split)]
            for split in ("train_x", "val", "test")}


def _build(registry, get, root, name, shots, subsample, seed=1):
    random.seed(seed)
    return registry.get(name)(_cfg(get, root, name, shots, subsample))


@pytest.mark.parametrize("subsample", ["all", "base", "new"])
@pytest.mark.parametrize("shots", [-1, 16])
@pytest.mark.parametrize("name", NAMES)
def test_reader_equals_jax(trees, name, shots, subsample):
    root, layout = trees(name)
    _clean(root)
    want = _build(JAX_REGISTRY, jax_cfg, root, name, shots, subsample)
    want_files = _written(root)
    _clean(root)
    got = _build(DATASET_REGISTRY, get_cfg_default, root, name, shots, subsample)
    got_files = _written(root)
    assert _items(got) == _items(want)
    assert got.classnames == want.classnames and got.lab2cname == want.lab2cname
    assert got.num_classes == want.num_classes
    # the split JSON, the few-shot cache, ImageNet's item cache: the same bytes
    assert got_files.keys() == want_files.keys()
    for path in want_files:
        assert got_files[path] == want_files[path], path
    counts = fake_datasets.expected(layout, shots, subsample)
    assert {k: len(v) for k, v in _items(got).items()} == {
        k: counts[k] for k in ("train_x", "val", "test")}
    assert got.classnames == counts["classnames"]
    for split in ("train_x", "val", "test"):
        assert all(os.path.isfile(p) for p, _, _ in _items(got)[split]), split


def test_split_json_matches_jax_byte_for_byte(trees):
    """The split JSON the port writes where none exists, for every reader
    that writes one, equals the JAX package's under the same seed, and a
    second build of either reads it back (random state no longer matters)."""
    seen = 0
    for name in NAMES:
        root, _ = trees(name)
        _clean(root)
        _build(JAX_REGISTRY, jax_cfg, root, name, -1, "all", seed=3)
        want = {k: v for k, v in _written(root).items() if k.endswith(".json")}
        _clean(root)
        port = _build(DATASET_REGISTRY, get_cfg_default, root, name, -1, "all", seed=3)
        got = {k: v for k, v in _written(root).items() if k.endswith(".json")}
        assert got == want, name
        seen += len(got)
        again = _build(DATASET_REGISTRY, get_cfg_default, root, name, -1, "all", seed=99)
        assert _items(again) == _items(port), name
    assert seen == 9  # all but FGVCAircraft, ImageNet and its four shift sets


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["Caltech101", "OxfordPets", "ImageNet"])
def test_fewshot_cache_loads_across_packages(trees, name, writer):
    """A few-shot cache written by either package, read by the other under
    another random state, gives the writer's draw."""
    root, _ = trees(name)
    _clean(root)
    first, second = ((JAX_REGISTRY, jax_cfg), (DATASET_REGISTRY, get_cfg_default))
    if writer == "port":
        first, second = second, first
    want = _build(*first, root, name, 16, "base", seed=5)
    cache = os.path.join(root, want.dataset_dir, "split_fewshot", "shot_16-seed_1.pkl")
    assert os.path.exists(cache)
    got = _build(*second, root, name, 16, "base", seed=1234)
    assert _items(got) == _items(want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_imagenet_item_cache_loads_across_packages(tmp_path, source, writer):
    """ImageNet's preprocessed.pkl written by either package loads in the
    other with the image tree gone; a cache that does not load is left
    alone and the rescan goes to preprocessed_rpo_tpu.pkl, as in JAX."""
    root = str(tmp_path)
    fake_datasets.write_tree("ImageNet", root, [source])
    first, second = ((JAX_REGISTRY, jax_cfg), (DATASET_REGISTRY, get_cfg_default))
    if writer == "port":
        first, second = second, first
    want = _build(*first, root, "ImageNet", -1, "all")
    inet = os.path.join(root, "imagenet")
    assert os.path.exists(os.path.join(inet, "preprocessed.pkl"))
    images = os.path.join(inet, "images")
    os.rename(images, images + ".away")
    got = _build(*second, root, "ImageNet", -1, "all")
    assert _items(got) == _items(want) and got.classnames == want.classnames
    os.rename(images + ".away", images)
    # a foreign cache: kept byte for byte, the rescan saved beside it
    with open(os.path.join(inet, "preprocessed.pkl"), "wb") as f:
        f.write(b"not a pickle")
    rescanned = _build(*second, root, "ImageNet", -1, "all")
    assert _items(rescanned) == _items(want)
    with open(os.path.join(inet, "preprocessed.pkl"), "rb") as f:
        assert f.read() == b"not a pickle"
    assert os.path.exists(os.path.join(inet, "preprocessed_rpo_tpu.pkl"))
    again = _build(*first, root, "ImageNet", -1, "all")  # the other package reads the second
    assert _items(again) == _items(want)


def test_imagenet_classnames_split_on_single_spaces(tmp_path):
    from rpo_tpu.data.datasets.imagenet import ImageNet as JaxImageNet
    from rpo_tpu_torch.data.datasets.imagenet import ImageNet

    path = tmp_path / "classnames.txt"
    path.write_text("n01  two  spaces\nn02 crane\n\nn03 a b\n")
    got = ImageNet.read_classnames(str(path))
    assert got == JaxImageNet.read_classnames(str(path))
    assert list(got.items()) == [("n01", " two  spaces"), ("n02", "crane"), ("n03", "a b")]


@pytest.mark.parametrize("name", NAMES + ["Synthetic"])
def test_data_manager_builds_every_name(trees, name):
    cfg = get_cfg_default()
    if name != "Synthetic":
        root, layout = trees(name)
        _clean(root)
        cfg.DATASET.ROOT = root
    cfg.DATASET.NAME = name
    cfg.DATASET.NUM_SHOTS = 16
    cfg.DATASET.SUBSAMPLE_CLASSES = "base"
    cfg.SEED = 1
    cfg.DATALOADER.NUM_WORKERS = 1
    random.seed(1)
    dm = DataManager(cfg)
    if name != "Synthetic":
        counts = fake_datasets.expected(layout, 16, "base")
        assert dm.classnames == counts["classnames"]
        assert dm.train_loader_x.items and len(dm.test_loader.items) == counts["test"]
    assert dm.num_classes == len(dm.classnames)
