"""Small dataset trees in the on-disk layouts of the paper's fifteen datasets.

Each writer lays out one registry name's files under ``root`` as the
reader of ``rpo_tpu_torch/data/datasets`` expects them (the layouts of
DATASETS.md, at a few classes), copying the bytes of the given source
images into every image file in turn, so that no image encoder is needed.
It returns the tree's ``Layout``: the classnames in label order and the
images of each class in each split before the few-shot draw, from which
``expected`` gives what a reader must return under a NUM_SHOTS and a
SUBSAMPLE_CLASSES.

    python -m rpo_tpu_torch.tools.fake_datasets ROOT --images a.jpg b.jpg [--names Caltech101 ...]

writes the trees under ROOT (every name when --names is not given), to
point DATASET.ROOT at.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class Layout:
    """What a tree holds, by label: ``train``, ``val`` and ``test`` are
    the images of each class before the few-shot draw (for a folder split
    or a trainval split, the counts that split gives)."""

    classnames: List[str]
    train: List[int]
    val: List[int]
    test: List[int]
    val_is_test: bool = False  # ImageNet: the val folder is val and test, no few-shot val
    test_only: bool = False  # the ImageNet shift sets: train_x is the test list
    files: int = 0  # image files written


class _Writer:
    """Copies the source images' bytes into image files, in turn."""

    def __init__(self, sources: Sequence[str]):
        if not sources:
            raise ValueError("at least one source image is needed")
        self.data = []
        for path in sources:
            with open(path, "rb") as f:
                self.data.append(f.read())
        self.count = 0

    def image(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(self.data[self.count % len(self.data)])
        self.count += 1


def _text(path: str, lines: Sequence[str]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _folder_counts(n: int) -> Tuple[int, int, int]:
    """``splits.read_and_split_data``'s 50/20/30 of a class of n images."""
    n_train, n_val = round(n * 0.5), round(n * 0.2)
    return n_train, n_val, n - n_train - n_val


def _trainval_counts(n: int) -> Tuple[int, int]:
    """``splits.split_trainval``'s 80/20 of a class of n trainval images."""
    n_val = round(n * 0.2)
    return n - n_val, n_val


def _folder_split(w: _Writer, image_dir: str, folders: Sequence[str], per_class: int,
                  names: Dict[str, str], ignored: Sequence[str] = ()) -> Layout:
    for folder in list(folders) + list(ignored):
        for i in range(per_class):
            w.image(os.path.join(image_dir, folder, f"image_{i:04d}.jpg"))
    counts = [_folder_counts(per_class)] * len(folders)
    return Layout([names.get(f, f) for f in sorted(folders)], *map(list, zip(*counts)))


# 101_ObjectCategories' class folders in sorted order (the two ignored ones
# aside)
CALTECH_CLASSES = [
    "Faces", "Leopards", "Motorbikes", "accordion", "airplanes", "anchor", "ant", "barrel",
    "bass", "beaver", "binocular", "bonsai", "brain", "brontosaurus", "buddha", "butterfly",
    "camera", "cannon", "car_side", "ceiling_fan", "cellphone", "chair", "chandelier",
    "cougar_body", "cougar_face", "crab", "crayfish", "crocodile", "crocodile_head", "cup",
    "dalmatian", "dollar_bill", "dolphin", "dragonfly", "electric_guitar", "elephant", "emu",
    "euphonium", "ewer", "ferry", "flamingo", "flamingo_head", "garfield", "gerenuk",
    "gramophone", "grand_piano", "hawksbill", "headphone", "hedgehog", "helicopter", "ibis",
    "inline_skate", "joshua_tree", "kangaroo", "ketch", "lamp", "laptop", "llama", "lobster",
    "lotus", "mandolin", "mayfly", "menorah", "metronome", "minaret", "nautilus", "octopus",
    "okapi", "pagoda", "panda", "pigeon", "pizza", "platypus", "pyramid", "revolver", "rhino",
    "rooster", "saxophone", "schooner", "scissors", "scorpion", "sea_horse", "snoopy",
    "soccer_ball", "stapler", "starfish", "stegosaurus", "stop_sign", "strawberry", "sunflower",
    "tick", "trilobite", "umbrella", "watch", "water_lilly", "wheelchair", "wild_cat",
    "windsor_chair", "wrench", "yin_yang"]


def caltech101(root: str, w: _Writer, n_classes: int = 4, per_class: int = 40) -> Layout:
    from ..data.datasets.caltech101 import IGNORED, NEW_CNAMES

    return _folder_split(w, os.path.join(root, "caltech-101", "101_ObjectCategories"),
                         CALTECH_CLASSES[:n_classes], per_class, NEW_CNAMES, ignored=IGNORED)


def describable_textures(root: str, w: _Writer, n_classes: int = 4,
                         per_class: int = 40) -> Layout:
    classes = ["banded", "blotchy", "braided", "bubbly", "bumpy", "chequered"][:n_classes]
    return _folder_split(w, os.path.join(root, "dtd", "images"), classes, per_class, {})


def eurosat(root: str, w: _Writer, n_classes: int = 4, per_class: int = 40) -> Layout:
    from ..data.datasets.eurosat import NEW_CNAMES

    classes = sorted(NEW_CNAMES)[:n_classes]
    return _folder_split(w, os.path.join(root, "eurosat", "2750"), classes, per_class,
                         NEW_CNAMES)


def food101(root: str, w: _Writer, n_classes: int = 4, per_class: int = 40) -> Layout:
    classes = ["apple_pie", "baby_back_ribs", "baklava", "beef_carpaccio", "beignets"]
    return _folder_split(w, os.path.join(root, "food-101", "images"), classes[:n_classes],
                         per_class, {})


def oxford_pets(root: str, w: _Writer, n_classes: int = 4, trainval: int = 25,
                test: int = 5) -> Layout:
    base = os.path.join(root, "oxford_pets")
    breeds = ["Abyssinian", "Bengal", "english_setter", "pug", "samoyed"][:n_classes]
    lines = {"trainval.txt": [], "test.txt": []}
    for label, breed in enumerate(breeds):
        for i in range(trainval + test):
            name = f"{breed}_{i + 1}"
            w.image(os.path.join(base, "images", f"{name}.jpg"))
            species = 1 if breed[0].isupper() else 2
            lines["trainval.txt" if i < trainval else "test.txt"].append(
                f"{name} {label + 1} {species} {label + 1}")
    for fname, rows in lines.items():
        _text(os.path.join(base, "annotations", fname), rows)
    n_train, n_val = _trainval_counts(trainval)
    k = len(breeds)
    return Layout([b.lower() for b in breeds], [n_train] * k, [n_val] * k, [test] * k)


FLOWERS = ["pink primrose", "hard-leaved pocket orchid", "canterbury bells", "sweet pea",
           "english marigold"]


def oxford_flowers(root: str, w: _Writer, n_classes: int = 4, per_class: int = 40) -> Layout:
    import numpy as np
    from scipy.io import savemat

    base = os.path.join(root, "oxford_flowers")
    # the images of the classes interleaved, as in imagelabels.mat
    labels = [1 + i % n_classes for i in range(n_classes * per_class)]
    for i in range(len(labels)):
        w.image(os.path.join(base, "jpg", f"image_{str(i + 1).zfill(5)}.jpg"))
    os.makedirs(base, exist_ok=True)
    savemat(os.path.join(base, "imagelabels.mat"), {"labels": np.asarray([labels])})
    with open(os.path.join(base, "cat_to_name.json"), "w") as f:
        json.dump({str(i + 1): FLOWERS[i] for i in range(n_classes)}, f)
    counts = [_folder_counts(per_class)] * n_classes
    return Layout(FLOWERS[:n_classes], *map(list, zip(*counts)))


CARS = ["AM General Hummer SUV 2000", "Acura RL Sedan 2012", "Acura TL Sedan 2012",
        "Acura TL Type-S 2008", "Acura TSX Sedan 2012"]


def stanford_cars(root: str, w: _Writer, n_classes: int = 4, trainval: int = 25,
                  test: int = 5) -> Layout:
    import numpy as np
    from scipy.io import savemat

    base = os.path.join(root, "stanford_cars")

    def annos(folder: str, per_class: int, path: str) -> None:
        records = np.zeros((1, n_classes * per_class), dtype=[("fname", "O"), ("class", "O")])
        for i in range(n_classes * per_class):
            fname = f"{i + 1:05d}.jpg"
            w.image(os.path.join(base, folder, fname))
            records[0, i]["fname"] = fname
            records[0, i]["class"] = np.array([[1 + i % n_classes]], dtype=np.uint8)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        savemat(path, {"annotations": records})

    annos("cars_train", trainval, os.path.join(base, "devkit", "cars_train_annos.mat"))
    annos("cars_test", test, os.path.join(base, "cars_test_annos_withlabels.mat"))
    meta = np.empty((1, n_classes), dtype=object)
    for i in range(n_classes):
        meta[0, i] = CARS[i]
    savemat(os.path.join(base, "devkit", "cars_meta.mat"), {"class_names": meta})
    names = []
    for full in CARS[:n_classes]:
        words = full.split(" ")
        names.append(" ".join([words[-1]] + words[:-1]))  # the year first
    n_train, n_val = _trainval_counts(trainval)
    return Layout(names, [n_train] * n_classes, [n_val] * n_classes, [test] * n_classes)


AIRCRAFT = ["707-320", "727-200", "A300B4", "Boeing 717", "Cessna 172"]


def fgvc_aircraft(root: str, w: _Writer, n_classes: int = 4, per_split=(20, 8, 10)) -> Layout:
    base = os.path.join(root, "fgvc_aircraft")
    variants = AIRCRAFT[:n_classes]
    _text(os.path.join(base, "variants.txt"), variants)
    for split, per_class in zip(("train", "val", "test"), per_split):
        rows = []
        for i in range(per_class * n_classes):
            image_id = f"{split[:2]}{i:05d}"
            w.image(os.path.join(base, "images", f"{image_id}.jpg"))
            rows.append(f"{image_id} {variants[i % n_classes]}")
        _text(os.path.join(base, f"images_variant_{split}.txt"), rows)
    return Layout(list(variants), *[[n] * n_classes for n in per_split])


SUN_CLASSES = ["/a/abbey", "/a/apartment_building/outdoor", "/b/bedroom", "/c/campsite",
               "/o/office"]


def sun397(root: str, w: _Writer, n_classes: int = 4, trainval: int = 25,
           test: int = 5) -> Layout:
    base = os.path.join(root, "sun397")
    classes = SUN_CLASSES[:n_classes]
    _text(os.path.join(base, "ClassName.txt"), classes)
    rows = {"Training_01.txt": [], "Testing_01.txt": []}
    for cls in classes:
        for i in range(trainval + test):
            rel = f"{cls}/sun_{i:06d}.jpg"
            w.image(os.path.join(base, "SUN397", rel[1:]))
            rows["Training_01.txt" if i < trainval else "Testing_01.txt"].append(rel)
    for fname, lines in rows.items():
        _text(os.path.join(base, fname), lines)
    names = [" ".join(c[1:].split("/")[1:][::-1]) for c in classes]
    n_train, n_val = _trainval_counts(trainval)
    return Layout(names, [n_train] * n_classes, [n_val] * n_classes, [test] * n_classes)


UCF_ACTIONS = ["ApplyEyeMakeup", "BabyCrawling", "YoYo", "PlayingDaf", "Surfing"]


def ucf101(root: str, w: _Writer, n_classes: int = 4, trainval: int = 25,
           test: int = 5) -> Layout:
    base = os.path.join(root, "ucf101")
    actions = UCF_ACTIONS[:n_classes]
    lists = os.path.join(base, "ucfTrainTestlist")
    _text(os.path.join(lists, "classInd.txt"),
          [f"{i + 1} {action}" for i, action in enumerate(actions)])
    rows = {"trainlist01.txt": [], "testlist01.txt": []}
    names = []
    for label, action in enumerate(actions):
        renamed = "_".join(re.findall("[A-Z][^A-Z]*", action))
        names.append(renamed)
        for i in range(trainval + test):
            fname = f"v_{action}_g{i:02d}_c01.avi"
            w.image(os.path.join(base, "UCF-101-midframes", renamed,
                                 fname.replace(".avi", ".jpg")))
            if i < trainval:
                rows["trainlist01.txt"].append(f"{action}/{fname} {label + 1}")
            else:
                rows["testlist01.txt"].append(f"{action}/{fname}")
    for fname, lines in rows.items():
        _text(os.path.join(lists, fname), lines)
    n_train, n_val = _trainval_counts(trainval)
    return Layout(names, [n_train] * n_classes, [n_val] * n_classes, [test] * n_classes)


IMAGENET_NAMES = ["tench", "goldfish", "great white shark", "tiger shark", "hammerhead shark",
                  "electric ray", "stingray", "rooster", "hen", "ostrich", "brambling",
                  "goldfinch"]


def _wnids(n: int) -> List[str]:
    # listed in classnames.txt out of sorted order: the labels follow the
    # sorted wnids, not the file's order
    return [f"n{(7 * i + 3) % n:08d}" for i in range(n)]


def _classnames_txt(path: str, wnids: Sequence[str], names: Sequence[str]) -> None:
    _text(path, [f"{wnid} {name}" for wnid, name in zip(wnids, names)])


def imagenet(root: str, w: _Writer, n_classes: int = 4, train: int = 20,
             val: int = 6) -> Layout:
    base = os.path.join(root, "imagenet")
    wnids, names = _wnids(n_classes), IMAGENET_NAMES[:n_classes]
    _classnames_txt(os.path.join(base, "classnames.txt"), wnids, names)
    for split, per_class in (("train", train), ("val", val)):
        for wnid in wnids:
            for i in range(per_class):
                w.image(os.path.join(base, "images", split, wnid, f"{wnid}_{i:05d}.JPEG"
                                     if split == "train" else f"ILSVRC_val_{wnid}_{i:03d}.jpg"))
    by_wnid = dict(zip(wnids, names))
    k = n_classes
    return Layout([by_wnid[x] for x in sorted(wnids)], [train] * k, [val] * k, [val] * k,
                  val_is_test=True)


def _folder_enumerated(dataset_dir: str, image_subdir: str):
    def write(root: str, w: _Writer, n_classes: int = 4, per_class: int = 3) -> Layout:
        base = os.path.join(root, dataset_dir)
        wnids, names = _wnids(n_classes), IMAGENET_NAMES[:n_classes]
        _classnames_txt(os.path.join(base, "classnames.txt"), wnids, names)
        for wnid in wnids:
            for i in range(per_class):
                w.image(os.path.join(base, image_subdir, wnid, f"{i}.jpg"))
        _text(os.path.join(base, image_subdir, "README.txt"), ["not a class"])
        by_wnid = dict(zip(wnids, names))
        return Layout([by_wnid[x] for x in sorted(wnids)], [], [], [per_class] * n_classes,
                      test_only=True)

    return write


def imagenet_v2(root: str, w: _Writer, n_classes: int = 4, per_class: int = 3) -> Layout:
    """All 1000 label folders exist (the reader lists each); the first
    ``n_classes`` hold images."""
    base = os.path.join(root, "imagenetv2")
    wnids = [f"n{i:08d}" for i in range(1000)]
    names = IMAGENET_NAMES + [f"class {i}" for i in range(len(IMAGENET_NAMES), 1000)]
    _classnames_txt(os.path.join(base, "classnames.txt"), wnids, names)
    image_dir = os.path.join(base, "imagenetv2-matched-frequency-format-val")
    for label in range(1000):
        os.makedirs(os.path.join(image_dir, str(label)), exist_ok=True)
        for i in range(per_class if label < n_classes else 0):
            w.image(os.path.join(image_dir, str(label), f"{i}.jpeg"))
    return Layout(names[:n_classes], [], [], [per_class] * n_classes, test_only=True)


WRITERS: Dict[str, Callable[..., Layout]] = {
    "Caltech101": caltech101,
    "DescribableTextures": describable_textures,
    "EuroSAT": eurosat,
    "FGVCAircraft": fgvc_aircraft,
    "Food101": food101,
    "ImageNet": imagenet,
    "ImageNetA": _folder_enumerated("imagenet-adversarial", "imagenet-a"),
    "ImageNetR": _folder_enumerated("imagenet-rendition", "imagenet-r"),
    "ImageNetSketch": _folder_enumerated("imagenet-sketch", "images"),
    "ImageNetV2": imagenet_v2,
    "OxfordFlowers": oxford_flowers,
    "OxfordPets": oxford_pets,
    "StanfordCars": stanford_cars,
    "SUN397": sun397,
    "UCF101": ucf101,
}


def write_tree(name: str, root: str, sources: Sequence[str], **sizes) -> Layout:
    """Writes registry name ``name``'s tree under ``root`` from the bytes of
    ``sources`` (the writer's keyword sizes in ``sizes``)."""
    w = _Writer(sources)
    layout = WRITERS[name](root, w, **sizes)
    layout.files = w.count
    return layout


def expected(layout: Layout, num_shots: int, subsample: str) -> Dict[str, object]:
    """The item counts of train_x, val and test and the classnames that a
    reader must return from ``layout``'s tree under DATASET.NUM_SHOTS
    ``num_shots`` and SUBSAMPLE_CLASSES ``subsample``."""
    if layout.test_only:  # neither the few-shot draw nor the subsample applies
        n = sum(layout.test)
        return {"train_x": n, "val": 0, "test": n, "classnames": list(layout.classnames)}
    train, val, test = list(layout.train), list(layout.val), list(layout.test)
    if num_shots >= 1:
        train = [min(c, num_shots) for c in train]
        if not layout.val_is_test:
            val = [min(c, min(num_shots, 4)) for c in val]
    labels = list(range(len(layout.classnames)))
    if subsample != "all":
        m = math.ceil(len(labels) / 2)
        labels = labels[:m] if subsample == "base" else labels[m:]
    out = {"train_x": sum(train[y] for y in labels), "test": sum(test[y] for y in labels),
           "classnames": [layout.classnames[y] for y in labels]}
    out["val"] = out["test"] if layout.val_is_test else sum(val[y] for y in labels)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root")
    parser.add_argument("--images", nargs="+", required=True,
                        help="source images whose bytes fill the trees' image files")
    parser.add_argument("--names", nargs="+", default=sorted(WRITERS), choices=sorted(WRITERS))
    args = parser.parse_args(argv)
    for name in args.names:
        layout = write_tree(name, args.root, args.images)
        print(f"{name}: {len(layout.classnames)} classes, {layout.files} image files")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
