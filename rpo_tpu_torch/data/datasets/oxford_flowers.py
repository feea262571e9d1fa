"""OxfordFlowers.  A copy of ``rpo_tpu/data/datasets/oxford_flowers.py``
(the reference's datasets/oxford_flowers.py): labels from
imagelabels.mat, names from cat_to_name.json, 50/20/30 per class."""
from __future__ import annotations

import os
import random
from collections import defaultdict

from ...engine.registry import DATASET_REGISTRY
from ..datum import Datum
from ..splits import read_json, read_split, save_split
from .common import FewShotDataset


@DATASET_REGISTRY.register()
class OxfordFlowers(FewShotDataset):
    dataset_dir = "oxford_flowers"

    def __init__(self, cfg):
        self.resolve_root(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "jpg")
        self.label_file = os.path.join(self.dataset_dir, "imagelabels.mat")
        self.lab2cname_file = os.path.join(self.dataset_dir, "cat_to_name.json")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_OxfordFlowers.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            train, val, test = self.read_data()
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)

    def read_data(self):
        from scipy.io import loadmat  # only to build the split once

        tracker = defaultdict(list)
        labels = loadmat(self.label_file)["labels"][0]
        for i, label in enumerate(labels):
            imname = f"image_{str(i + 1).zfill(5)}.jpg"
            tracker[int(label)].append(os.path.join(self.image_dir, imname))

        print("Splitting data into 50% train, 20% val, and 30% test")
        lab2cname = read_json(self.lab2cname_file)
        train, val, test = [], [], []
        for label, impaths in tracker.items():
            random.shuffle(impaths)
            n_total = len(impaths)
            n_train = round(n_total * 0.5)
            n_val = round(n_total * 0.2)
            assert n_train > 0 and n_val > 0 and (n_total - n_train - n_val) > 0
            cname = lab2cname[str(label)]

            def _collate(ims):
                return [Datum(impath=im, label=label - 1, classname=cname) for im in ims]

            train.extend(_collate(impaths[:n_train]))
            val.extend(_collate(impaths[n_train:n_train + n_val]))
            test.extend(_collate(impaths[n_train + n_val:]))
        return train, val, test
