"""Caltech101.  A copy of ``rpo_tpu/data/datasets/caltech101.py`` (the
reference's datasets/caltech101.py): the folder split, without two
classes and with four renamed."""
from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..splits import read_and_split_data, read_split, save_split
from .common import FewShotDataset

IGNORED = ["BACKGROUND_Google", "Faces_easy"]
NEW_CNAMES = {
    "airplanes": "airplane",
    "Faces": "face",
    "Leopards": "leopard",
    "Motorbikes": "motorbike",
}


@DATASET_REGISTRY.register()
class Caltech101(FewShotDataset):
    dataset_dir = "caltech-101"

    def __init__(self, cfg):
        self.resolve_root(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "101_ObjectCategories")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_Caltech101.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            train, val, test = read_and_split_data(
                self.image_dir, ignored=IGNORED, new_cnames=NEW_CNAMES)
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)
