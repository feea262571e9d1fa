"""Shared skeleton of the few-shot image-classification datasets.

A copy of ``rpo_tpu/data/datasets/common.py``.  Every reference dataset
repeats the same tail (few-shot pickle cache, then base/new subsample,
then DatasetBase; the reference's datasets/oxford_pets.py:33-54);
``FewShotDataset.finalize`` does it once, with the same cache paths.
"""
from __future__ import annotations

import os

from ..datum import DatasetBase
from ..splits import load_or_create_fewshot, mkdir_if_missing, subsample_classes


class FewShotDataset(DatasetBase):
    dataset_dir = ""

    def resolve_root(self, cfg) -> str:
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.split_fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")
        mkdir_if_missing(self.split_fewshot_dir)
        return self.dataset_dir

    def finalize(self, cfg, train, val, test) -> None:
        train, val = load_or_create_fewshot(
            self, train, val, self.split_fewshot_dir,
            int(cfg.DATASET.NUM_SHOTS), int(cfg.SEED),
        )
        subsample = cfg.DATASET.SUBSAMPLE_CLASSES
        train, val, test = subsample_classes(train, val, test, subsample=subsample)
        super().__init__(train_x=train, val=val, test=test)
