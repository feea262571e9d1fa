"""Shared split utilities: canonical JSON splits, trainval splitting,
base/new class subsampling, few-shot caching.

A copy of ``rpo_tpu/data/splits.py``.

Behavioral mirrors of the static methods every reference dataset reuses
from OxfordPets (the reference's datasets/oxford_pets.py:76-186) and the
DTD-style folder splitter (the reference's datasets/dtd.py:53-95).
"""
from __future__ import annotations

import json
import math
import os
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from .datum import Datum


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def write_json(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, separators=(",", ": "))


def mkdir_if_missing(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def listdir_nohidden(path: str, sort: bool = False) -> List[str]:
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    if sort:
        items.sort()
    return items


# -- canonical split JSON I/O (oxford_pets.py:99-138) -----------------------

def read_split(filepath: str, path_prefix: str):
    def _convert(items):
        return [
            Datum(impath=os.path.join(path_prefix, impath), label=int(label), classname=classname)
            for impath, label, classname in items
        ]

    print(f"Reading split from {filepath}")
    split = read_json(filepath)
    return _convert(split["train"]), _convert(split["val"]), _convert(split["test"])


def save_split(train, val, test, filepath: str, path_prefix: str) -> None:
    def _extract(items):
        out = []
        for item in items:
            impath = item.impath.replace(path_prefix, "")
            if impath.startswith("/"):
                impath = impath[1:]
            out.append((impath, item.label, item.classname))
        return out

    write_json(
        {"train": _extract(train), "val": _extract(val), "test": _extract(test)},
        filepath,
    )
    print(f"Saved split to {filepath}")


# -- trainval split (oxford_pets.py:76-97) ----------------------------------

def split_trainval(trainval: Sequence[Datum], p_val: float = 0.2):
    p_trn = 1 - p_val
    print(f"Splitting trainval into {p_trn:.0%} train and {p_val:.0%} val")
    tracker = defaultdict(list)
    for idx, item in enumerate(trainval):
        tracker[item.label].append(idx)

    train, val = [], []
    for label, idxs in tracker.items():
        n_val = round(len(idxs) * p_val)
        assert n_val > 0
        random.shuffle(idxs)
        for n, idx in enumerate(idxs):
            item = trainval[idx]
            (val if n < n_val else train).append(item)
    return train, val


# -- folder-per-class split (dtd.py:53-95) ----------------------------------

def read_and_split_data(
    image_dir: str,
    p_trn: float = 0.5,
    p_val: float = 0.2,
    ignored: Optional[List[str]] = None,
    new_cnames: Optional[Dict[str, str]] = None,
):
    """50/20/30 split of a folder-per-class image tree, shuffled with the
    host RNG (seeded) exactly like the reference."""
    categories = listdir_nohidden(image_dir)
    categories = [c for c in categories if c not in (ignored or [])]
    categories.sort()

    p_tst = 1 - p_trn - p_val
    print(f"Splitting into {p_trn:.0%} train, {p_val:.0%} val, and {p_tst:.0%} test")

    def _collate(ims, y, c):
        return [Datum(impath=im, label=y, classname=c) for im in ims]

    train, val, test = [], [], []
    for label, category in enumerate(categories):
        category_dir = os.path.join(image_dir, category)
        images = listdir_nohidden(category_dir)
        images = [os.path.join(category_dir, im) for im in images]
        random.shuffle(images)
        n_total = len(images)
        n_train = round(n_total * p_trn)
        n_val = round(n_total * p_val)
        n_test = n_total - n_train - n_val
        assert n_train > 0 and n_val > 0 and n_test > 0

        if new_cnames is not None and category in new_cnames:
            category = new_cnames[category]

        train.extend(_collate(images[:n_train], label, category))
        val.extend(_collate(images[n_train : n_train + n_val], label, category))
        test.extend(_collate(images[n_train + n_val :], label, category))
    return train, val, test


# -- base/new subsampling (oxford_pets.py:140-186) --------------------------

def subsample_classes(*args: List[Datum], subsample: str = "all"):
    """base = first ceil(n/2) sorted labels, new = rest; relabel
    contiguously.  The core of the base-to-new protocol."""
    assert subsample in ["all", "base", "new"]
    if subsample == "all":
        return args

    labels = sorted({item.label for item in args[0]})
    m = math.ceil(len(labels) / 2)
    print(f"SUBSAMPLE {subsample.upper()} CLASSES!")
    selected = labels[:m] if subsample == "base" else labels[m:]
    relabeler = {y: y_new for y_new, y in enumerate(selected)}

    output = []
    for dataset in args:
        output.append(
            [
                Datum(
                    impath=item.impath,
                    label=relabeler[item.label],
                    classname=item.classname,
                )
                for item in dataset
                if item.label in relabeler
            ]
        )
    return output


# -- few-shot cache (oxford_pets.py:33-49) ----------------------------------

def load_or_create_fewshot(
    dataset, train, val, split_fewshot_dir: str, num_shots: int, seed: int
):
    """pkl-cached few-shot subset keyed by (shots, seed) — cache format and
    path compatible with the reference (shot_{N}-seed_{S}.pkl).

    ``val=None`` marks a dataset without a few-shot val split (ImageNet,
    whose val folder doubles as the test set): the payload then contains
    only the train list, matching the reference's ImageNet cache format
    (the reference's datasets/imagenet.py:40-56)."""
    if num_shots < 1:
        return train, val

    def sample():
        t = dataset.generate_fewshot_dataset(train, num_shots=num_shots)
        v = (
            None
            if val is None
            else dataset.generate_fewshot_dataset(val, num_shots=min(num_shots, 4))
        )
        return t, v

    mkdir_if_missing(split_fewshot_dir)
    preprocessed = os.path.join(split_fewshot_dir, f"shot_{num_shots}-seed_{seed}.pkl")
    if os.path.exists(preprocessed):
        print(f"Loading preprocessed few-shot data from {preprocessed}")
        try:
            from .interop import load_datum_pickle

            with open(preprocessed, "rb") as f:
                data = load_datum_pickle(f)
            if val is not None and data.get("val") is None:
                # a train-only cache (the ImageNet format) under a dataset
                # that expects a few-shot val split: wrong format, not
                # corruption — regenerate, keep the foreign file intact
                print(
                    f"(!) few-shot cache {preprocessed} has no val split; "
                    "regenerating without overwriting"
                )
                return sample()
            return data["train"], data.get("val")
        except Exception as exc:
            # a corrupt/truncated cache, or a foreign format interop.py
            # doesn't cover.  Regenerate in memory but do NOT overwrite.
            print(
                f"(!) Could not load few-shot cache {preprocessed} ({exc}); "
                "regenerating without overwriting"
            )
            return sample()
    train, val = sample()
    payload = {"train": train} if val is None else {"train": train, "val": val}
    print(f"Saving preprocessed few-shot data to {preprocessed}")
    # Dassl-format pickle (interop.py): a torch reference run sharing this
    # data root can load the cache — and then trains on the SAME few-shot
    # subset, making seed-level accuracy comparisons meaningful.
    from .interop import dump_datum_pickle

    with open(preprocessed, "wb") as f:
        dump_datum_pickle(payload, f)
    return train, val
