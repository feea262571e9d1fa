"""StanfordCars.  A copy of ``rpo_tpu/data/datasets/stanford_cars.py``
(the reference's datasets/stanford_cars.py): .mat annotations, the model
year moved to the front of the classname."""
from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..datum import Datum
from ..splits import read_split, save_split, split_trainval
from .common import FewShotDataset


@DATASET_REGISTRY.register()
class StanfordCars(FewShotDataset):
    dataset_dir = "stanford_cars"

    def __init__(self, cfg):
        self.resolve_root(cfg)
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_StanfordCars.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.dataset_dir)
        else:
            trainval_file = os.path.join(self.dataset_dir, "devkit", "cars_train_annos.mat")
            test_file = os.path.join(self.dataset_dir, "cars_test_annos_withlabels.mat")
            meta_file = os.path.join(self.dataset_dir, "devkit", "cars_meta.mat")
            trainval = self.read_data("cars_train", trainval_file, meta_file)
            test = self.read_data("cars_test", test_file, meta_file)
            train, val = split_trainval(trainval)
            save_split(train, val, test, self.split_path, self.dataset_dir)

        self.finalize(cfg, train, val, test)

    def read_data(self, image_dir, anno_file, meta_file):
        from scipy.io import loadmat  # only to build the split once

        annos = loadmat(anno_file)["annotations"][0]
        meta = loadmat(meta_file)["class_names"][0]
        items = []
        for anno in annos:
            imname = anno["fname"][0]
            label = int(anno["class"][0, 0]) - 1
            names = meta[label][0].split(" ")
            year = names.pop(-1)
            names.insert(0, year)
            items.append(Datum(impath=os.path.join(self.dataset_dir, image_dir, imname),
                               label=label, classname=" ".join(names)))
        return items
