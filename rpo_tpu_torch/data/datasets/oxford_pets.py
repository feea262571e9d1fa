"""OxfordPets.  A copy of ``rpo_tpu/data/datasets/oxford_pets.py`` (the
reference's datasets/oxford_pets.py): the annotation files, trainval
split into train and val."""
from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..datum import Datum
from ..splits import read_split, save_split, split_trainval
from .common import FewShotDataset


@DATASET_REGISTRY.register()
class OxfordPets(FewShotDataset):
    dataset_dir = "oxford_pets"

    def __init__(self, cfg):
        self.resolve_root(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.anno_dir = os.path.join(self.dataset_dir, "annotations")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_OxfordPets.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            trainval = self.read_data(split_file="trainval.txt")
            test = self.read_data(split_file="test.txt")
            train, val = split_trainval(trainval)
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)

    def read_data(self, split_file):
        """Annotation lines '<imname> <label> <species> <breed_id>'; the
        breed (the classname) is the file name without its trailing index
        (the reference's oxford_pets.py:56-74)."""
        filepath = os.path.join(self.anno_dir, split_file)
        items = []
        with open(filepath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                imname, label, _species, _ = line.split(" ")
                breed = "_".join(imname.split("_")[:-1]).lower()
                impath = os.path.join(self.image_dir, imname + ".jpg")
                items.append(Datum(impath=impath, label=int(label) - 1, classname=breed))
        return items
