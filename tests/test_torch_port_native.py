"""The port's native JPEG pipeline against the JAX package's.

``rpo_tpu_torch/_native`` is the port's own copy of ``rpo_tpu/_native``
(the C++ source, built with g++ at first use).  On Pillow-written JPEGs of
tests/test_native_pipeline.py's sizes and 64 x 64:

- the two libraries give equal bytes for ``rpo_image_size``, the eval and
  train (box and flip) entry points and both batch entry points;
- ``TransformPipeline`` outputs and ``BatchLoader`` batches equal
  ``rpo_tpu``'s, seeded, over two epochs: train, eval, and
  INPUT.DEVICE_RESIZE on exact and on other sources; once with the native
  libraries and once under ``RPO_TPU_NO_NATIVE=1`` (Pillow's decode, and
  Pillow's resize against the port's numpy copy of it);
- a ``.jpg`` that libjpeg refuses (a PNG) falls back alone, alike;
- a stale library, or one older than its source, is rebuilt;
- the port's CLI on a fake Caltech101 tree of JPEGs (the committed
  fixtures, tests/torch_port_data) against ``rpo_tpu.cli``'s at TINY:
  step losses within 1e-5, the prompts' movement and momentum as
  tests/test_torch_port_engine_run.py holds them in float32, equal
  accuracy.

Where both sides run the same backend the bytes must be equal: no
tolerance.
"""
import ctypes
import glob
import os
import random
import shutil
import subprocess

import jax
import numpy as np
import pytest
from PIL import Image

import rpo_tpu._native as jax_native
import rpo_tpu_torch._native as native
from rpo_tpu.data import transforms as jax_T
from rpo_tpu.data.datum import Datum as JaxDatum
from rpo_tpu.data.loader import BatchLoader as JaxLoader
from rpo_tpu_torch.data import transforms as T
from rpo_tpu_torch.data.datum import Datum
from rpo_tpu_torch.data.loader import BatchLoader
from rpo_tpu_torch.tools import fake_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(REPO, "tests", "torch_port_data", "*.jpg")))
SIZES = [(640, 480), (300, 500), (224, 224), (100, 80), (64, 64)]
U8 = ctypes.POINTER(ctypes.c_uint8)


class _Input:
    SIZE = (224, 224)
    INTERPOLATION = "bicubic"
    RRCROP_SCALE = (0.08, 1.0)
    TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
    PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
    PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
    DEVICE_RESIZE = 0


def _input(**kw):
    return type("Input", (_Input,), kw)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both libraries; the JAX package's built from its source into this
    module's own directory, since tests/test_native_pipeline.py, which
    may run beside this file in another worker, plants a stale library at
    that package's path for a while."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", str(tmp_path_factory.mktemp("jax_lib") / "librpo_image.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_failed", False)
        port, ref = native.get_lib(), jax_native.get_lib()
        assert port is not None and ref is not None, native.build_log  # needs g++ and jpeglib.h
        yield port, ref


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate(SIZES + [(64, 64), (64, 64)]):
        arr = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
        arr = (arr.astype(np.float32) * 0.3 + 128 * 0.7).astype(np.uint8)
        path = str(d / f"img_{i}.jpg")
        Image.fromarray(arr).save(path, quality=95)
        paths.append(path)
    return paths


@pytest.fixture
def no_native(monkeypatch):
    """RPO_TPU_NO_NATIVE=1 in both packages, the libraries forgotten for
    the test (each is loaded again on its next use)."""
    monkeypatch.setenv("RPO_TPU_NO_NATIVE", "1")
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_lib", None)


def test_fixtures_are_small_and_of_the_sizes_asked():
    sizes = sorted(Image.open(p).size for p in FIXTURES)
    assert sizes == sorted([(224, 224), (500, 375), (300, 500), (64, 64)] * 2)
    assert sum(os.path.getsize(p) for p in FIXTURES) <= 200_000


def test_library_entry_points_equal_jax(libs, jpegs):
    port, ref = libs
    plans = [((50, 40, 200, 180), 1), ((10, 10, 150, 150), 0), ((0, 0, 64, 64), 1),
             ((3, 5, 40, 30), 0)]
    for path in jpegs + FIXTURES:
        p = path.encode()
        sizes = []
        for lib in libs:
            w, h = ctypes.c_int(), ctypes.c_int()
            assert lib.rpo_image_size(p, ctypes.byref(w), ctypes.byref(h)) == 0
            sizes.append((w.value, h.value))
        assert sizes[0] == sizes[1] == Image.open(path).size
        for size in (224, 64):
            outs = [np.empty((size, size, 3), np.uint8) for _ in libs]
            for lib, out in zip(libs, outs):
                assert lib.rpo_eval_preprocess(p, size, out.ctypes.data_as(U8)) == 0
            np.testing.assert_array_equal(outs[0], outs[1])
        W, H = sizes[0]
        for (x0, y0, cw, ch), flip in plans:
            if x0 + cw > W or y0 + ch > H:
                continue
            outs = [np.empty((224, 224, 3), np.uint8) for _ in libs]
            for lib, out in zip(libs, outs):
                assert lib.rpo_train_preprocess(p, x0, y0, cw, ch, flip, 224,
                                                out.ctypes.data_as(U8)) == 0
            np.testing.assert_array_equal(outs[0], outs[1])


def _batch(lib, paths, size, boxes=None, flips=None, threads=3):
    n = len(paths)
    out, ok = np.empty((n, size, size, 3), np.uint8), np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if boxes is None:
        good = lib.rpo_eval_preprocess_batch(arr, n, size, out.ctypes.data_as(U8),
                                             ok.ctypes.data_as(U8), threads)
    else:
        good = lib.rpo_train_preprocess_batch(
            arr, boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), flips.ctypes.data_as(U8),
            n, size, out.ctypes.data_as(U8), ok.ctypes.data_as(U8), threads)
    return good, out, ok


def test_batch_entry_points_equal_jax(libs, jpegs, tmp_path):
    bad = str(tmp_path / "not_a_jpeg.jpg")
    with open(bad, "wb") as f:
        f.write(b"not a jpeg")
    paths = jpegs + [bad] + FIXTURES
    n = len(paths)
    boxes = np.full((n, 4), -1, np.int32)
    boxes[0] = (50, 40, 200, 180)
    boxes[1] = (10, 10, 150, 150)
    boxes[3] = (0, 0, 100, 80)
    flips = (np.arange(n) % 3 == 0).astype(np.uint8)
    for size in (224, 64):
        got, want = _batch(libs[0], paths, size), _batch(libs[1], paths, size)
        assert got[0] == want[0] == n - 1
        np.testing.assert_array_equal(got[2], want[2])
        assert not got[2][len(jpegs)]
        np.testing.assert_array_equal(got[1][got[2] == 1], want[1][want[2] == 1])
        got, want = (_batch(lib, paths, size, boxes, flips) for lib in libs)
        assert got[0] == want[0] == n - 1
        np.testing.assert_array_equal(got[1][got[2] == 1], want[1][want[2] == 1])


def _pipelines(**kw):
    cfg = _input(**kw)
    return T.TransformPipeline(cfg), jax_T.TransformPipeline(cfg)


def test_transform_pipeline_equals_jax(libs, jpegs):
    tp, jp = _pipelines()
    for path in jpegs:
        assert tp.image_size(path) == jp.image_size(path) == Image.open(path).size
        np.testing.assert_array_equal(tp(path, False), jp(path, False))
        for seed in range(3):
            random.seed(seed)
            got = tp(path, True)
            random.seed(seed)
            np.testing.assert_array_equal(got, jp(path, True))


def test_transform_pipeline_equals_jax_without_native(no_native, jpegs):
    assert native.get_lib() is None and jax_native.get_lib() is None
    test_transform_pipeline_equals_jax(None, jpegs)


def _loader_epochs(loader_cls, datum_cls, tp, paths, train, **kw):
    items = [datum_cls(impath=p, label=i % 3, classname=f"c{i % 3}") for i, p in enumerate(paths)]
    loader = loader_cls(items, tp, batch_size=3, train=train, shuffle=train, num_workers=2, **kw)
    return [[dict(b) for b in loader] for _ in range(2)]


CASES = {
    "train": (dict(), True, slice(None)),
    "eval": (dict(), False, slice(None)),
    "device resize 64, exact sources": (dict(DEVICE_RESIZE=64), True, slice(4, None)),
    "device resize 64, other sources": (dict(DEVICE_RESIZE=64), True, slice(None)),
    "device resize 64, eval": (dict(DEVICE_RESIZE=64), False, slice(None)),
    "flip only": (dict(TRANSFORMS=("random_flip", "normalize")), True, slice(None)),
}


def _loaders_equal(jpegs, case):
    kw, train, which = CASES[case]
    tp, jp = _pipelines(**kw)
    paths = jpegs[which]
    random.seed(7)
    got = _loader_epochs(BatchLoader, Datum, tp, paths, train)
    random.seed(7)
    want = _loader_epochs(JaxLoader, JaxDatum, jp, paths, train, prefetch=1)
    assert len(got) == len(want) == 2
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) == (len(paths) + 2) // 3
        for g, w in zip(g_epoch, w_epoch):
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{case} {key}")
    if train and case != "flip only":  # the second epoch redraws the crops
        assert not np.array_equal(got[0][0]["img"], got[1][0]["img"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_batches_equal_jax(libs, jpegs, case):
    _loaders_equal(jpegs, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_batches_equal_jax_without_native(no_native, jpegs, case):
    _loaders_equal(jpegs, case)


def test_loader_takes_the_native_paths(libs, jpegs, monkeypatch):
    """With the library, an all-JPEG batch goes to the C++ pool whole
    (train, eval and the exact-source device batch), never to the
    per-item transform."""
    tp, _ = _pipelines()
    calls = []
    monkeypatch.setattr(T.TransformPipeline, "__call__",
                        lambda self, *a, **k: calls.append(a))
    for train in (True, False):
        _loader_epochs(BatchLoader, Datum, tp, jpegs, train)
    tp64, _ = _pipelines(DEVICE_RESIZE=64)
    monkeypatch.setattr(T.TransformPipeline, "raw_source",
                        lambda self, *a, **k: calls.append(a))
    _loader_epochs(BatchLoader, Datum, tp64, jpegs[4:], True)
    assert calls == []


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_refused_jpeg_falls_back_alone(libs, jpegs, tmp_path, train):
    """A PNG named .jpg: libjpeg refuses it and that item alone goes to
    Pillow, in both packages alike."""
    png = str(tmp_path / "really_a_png.jpg")
    Image.fromarray(np.full((90, 120, 3), 77, np.uint8)).save(png, format="PNG")
    paths = jpegs[:2] + [png] + jpegs[2:4]
    tp, jp = _pipelines()
    random.seed(3)
    got = _loader_epochs(BatchLoader, Datum, tp, paths, train)
    random.seed(3)
    want = _loader_epochs(JaxLoader, JaxDatum, jp, paths, train, prefetch=1)
    for g_epoch, w_epoch in zip(got, want):
        for g, w in zip(g_epoch, w_epoch):
            np.testing.assert_array_equal(g["img"], w["img"])
    assert np.asarray(tp(png, False)).mean() == pytest.approx(77, abs=1)


def _stub(tmp_path):
    src = tmp_path / "stub.c"
    src.write_text("int rpo_stub(void) { return 0; }\n")
    out = tmp_path / "stub.so"
    res = subprocess.run(["g++", "-shared", "-fPIC", str(src), "-o", str(out)],
                         capture_output=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return out


@pytest.mark.parametrize("how", ["newer stub", "older than the source"])
def test_stale_library_is_rebuilt(libs, tmp_path, monkeypatch, how):
    """A library without the newest symbol (a copied file whose mtime beats
    the source) is rebuilt and loaded in the same process; one older than
    its source is rebuilt before it is loaded."""
    so = tmp_path / "build" / "librpo_torch_image.so"
    so.parent.mkdir()
    so.write_bytes(_stub(tmp_path).read_bytes())
    src_mtime = os.path.getmtime(native._SRC)
    when = src_mtime + 10 if how == "newer stub" else src_mtime - 10
    os.utime(so, (when, when))
    inode = os.stat(so).st_ino
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    lib = native.get_lib()
    assert lib is not None and hasattr(lib, "rpo_train_preprocess_batch")
    assert os.stat(so).st_ino != inode and os.path.getmtime(so) >= src_mtime


def test_failed_build_falls_back(tmp_path, monkeypatch, jpegs):
    """No compiler (or no libjpeg): get_lib is None, the log says why, and
    the pipeline decodes with Pillow."""
    monkeypatch.setattr(native, "_SO", str(tmp_path / "missing" / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    assert native.get_lib() is None and native.build_log
    tp, jp = _pipelines()
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_build_failed", True)
    np.testing.assert_array_equal(tp(jpegs[0], False), jp(jpegs[0], False))


# -- the CLI on a fake Caltech101 tree of JPEGs --------------------------------

@pytest.fixture(scope="module")
def caltech_runs(tmp_path_factory, libs):
    import pickle

    from rpo_tpu.methods import rpo as jcore
    from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
    from rpo_tpu.models.clip import ARCHS, init_clip
    from rpo_tpu_torch import cli as tcli
    from rpo_tpu_torch.methods.base_trainer import CLIPMethodTrainer as PortTrainer
    from rpo_tpu_torch.models.clip import params_from_numpy
    from tests.test_torch_port_engine_run import run

    tmp = tmp_path_factory.mktemp("caltech_cli")
    root = str(tmp / "data")
    fake_datasets.write_tree("Caltech101", root, FIXTURES, n_classes=4, per_class=20)
    jclip = init_clip(jax.random.PRNGKey(1), ARCHS["TINY"])
    prompts = jax.tree_util.tree_map(
        np.asarray, jcore.init_prompts(jax.random.PRNGKey(0), jclip, ARCHS["TINY"], 4))
    init = str(tmp / "init_prompts.pkl")
    with open(init, "wb") as f:
        pickle.dump({"state_dict": prompts, "epoch": 0}, f)

    def argv(out):
        return ["--seed", "1", "--trainer", "RPO",
                "--dataset-config-file", os.path.join(REPO, "configs/datasets/caltech101.yaml"),
                "--config-file", os.path.join(REPO, "configs/trainers/RPO/main.yaml"),
                "--output-dir", out, "DATASET.ROOT", root,
                "DATASET.NUM_SHOTS", "4", "DATASET.SUBSAMPLE_CLASSES", "base",
                "OPTIM.MAX_EPOCH", "2", "MODEL.BACKBONE.NAME", "TINY", "INPUT.SIZE", "(32, 32)",
                "DATALOADER.TRAIN_X.BATCH_SIZE", "4", "DATALOADER.TEST.BATCH_SIZE", "16",
                "TRAINER.RPO.PREC", "fp32", "MODEL.INIT_WEIGHTS", init,
                "TRAIN.PREWARM_COMPILE", "False", "DATALOADER.NUM_WORKERS", "2"]

    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("RPO_TPU_XLA_CACHE", "0")
        from rpo_tpu import cli as jcli

        jax_out, port_out = str(tmp / "jax"), str(tmp / "port")
        j_losses, j_log = run(jcli, JaxTrainer, argv(jax_out), mp)
        # the port splits and draws the shots from the same pristine tree
        # (a split file left by the first run would leave its draws undone)
        tree = os.path.join(root, "caltech-101")
        os.remove(os.path.join(tree, "split_zhou_Caltech101.json"))
        shutil.rmtree(os.path.join(tree, "split_fewshot"))
        mp.setenv("RPO_TPU_FORCE_CPU", "1")
        t_clip = params_from_numpy(jax.tree_util.tree_map(np.asarray, jclip), "cpu")
        p_losses, p_log = run(tcli, PortTrainer, argv(port_out), mp, clip_params=t_clip)
    finally:
        mp.undo()
    return dict(prompts=prompts, jax_out=jax_out, port_out=port_out, j_losses=j_losses,
                p_losses=p_losses, j_log=j_log, p_log=p_log)


def test_cli_on_a_caltech101_tree_equals_jax(caltech_runs):
    from tests.test_torch_port_engine_run import _close_as_gradient, accuracy, load_ckpt
    from tests.test_torch_port_rpo_train import TOL

    r = caltech_runs
    # 2 base classes x 4 shots at batch 4: two steps an epoch
    assert len(r["p_losses"]) == len(r["j_losses"]) == 4
    np.testing.assert_allclose(r["p_losses"], r["j_losses"], rtol=0,
                               atol=TOL["float32"]["loss"])
    assert "Dataset: Caltech101" in r["p_log"] and "# classes: 2" in r["p_log"]
    j, p = load_ckpt(r["jax_out"]), load_ckpt(r["port_out"])
    moved = {k: p["state_dict"][k] - r["prompts"][k] for k in r["prompts"]}
    want = {k: j["state_dict"][k] - r["prompts"][k] for k in r["prompts"]}
    _close_as_gradient(moved, want, "float32", "prompt movement")
    _close_as_gradient(p["optimizer"], j["optimizer"], "float32", "momentum")
    assert accuracy(r["p_log"]) == accuracy(r["j_log"]) and len(accuracy(r["p_log"])) == 1
