"""Food101.  A copy of ``rpo_tpu/data/datasets/food101.py`` (the
reference's datasets/food101.py): the folder split."""
from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..splits import read_and_split_data, read_split, save_split
from .common import FewShotDataset


@DATASET_REGISTRY.register()
class Food101(FewShotDataset):
    dataset_dir = "food-101"

    def __init__(self, cfg):
        self.resolve_root(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_Food101.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            train, val, test = read_and_split_data(self.image_dir)
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)
