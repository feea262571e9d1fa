"""DataManager: dataset construction and the train, val and test loaders.

Port of ``rpo_tpu/data/manager.py`` (the role of Dassl's DataManager):
resolves cfg.DATASET.NAME in the registry, builds the transform pipeline
from cfg.INPUT, and gives the trainer its loaders and class metadata.
On one card a batch is padded to the batch size; padding to a multiple
of the devices waits for the multi-GPU port.
"""
from __future__ import annotations

from ..engine.registry import DATASET_REGISTRY
from . import datasets
from .loader import BatchLoader
from .transforms import TransformPipeline


class DataManager:
    def __init__(self, cfg):
        self.cfg = cfg
        name = cfg.DATASET.NAME
        if name in datasets.NOT_PORTED:
            raise KeyError(f"dataset {name!r} is not ported yet; ported: "
                           f"{DATASET_REGISTRY.registered_names()}")
        self.dataset = DATASET_REGISTRY.get(name)(cfg)
        transform = TransformPipeline(cfg.INPUT)
        self.transform = transform

        num_workers = int(cfg.DATALOADER.NUM_WORKERS)
        train_bs = int(cfg.DATALOADER.TRAIN_X.BATCH_SIZE)
        test_bs = int(cfg.DATALOADER.TEST.BATCH_SIZE)
        self.train_loader_x = BatchLoader(
            self.dataset.train_x, transform, batch_size=train_bs, train=True, shuffle=True,
            num_workers=num_workers,
            drop_last=True,  # Dassl train-loader semantics
        )
        self.val_loader = (
            BatchLoader(self.dataset.val, transform, batch_size=test_bs, train=False,
                        shuffle=False, num_workers=num_workers)
            if self.dataset.val
            else None
        )
        self.test_loader = BatchLoader(
            self.dataset.test, transform, batch_size=test_bs, train=False, shuffle=False,
            num_workers=num_workers,
        )

    @property
    def num_classes(self) -> int:
        return self.dataset.num_classes

    @property
    def classnames(self):
        return self.dataset.classnames

    def show_dataset_summary(self) -> None:
        cfg = self.cfg
        print("***** Dataset statistics *****")
        print(f"  Dataset: {cfg.DATASET.NAME}")
        print(f"  # classes: {self.num_classes:,}")
        print(f"  # train_x: {len(self.dataset.train_x):,}")
        if self.dataset.val:
            print(f"  # val: {len(self.dataset.val):,}")
        print(f"  # test: {len(self.dataset.test):,}")
