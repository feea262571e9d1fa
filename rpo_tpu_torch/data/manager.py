"""DataManager: dataset construction and the train, val and test loaders.

Port of ``rpo_tpu/data/manager.py`` (the role of Dassl's DataManager):
resolves cfg.DATASET.NAME in the registry, builds the transform pipeline
from cfg.INPUT, and gives the trainer its loaders and class metadata.
On one card a batch is padded to the batch size; padding to a multiple
of the devices waits for the multi-GPU port.  TRAIN.TENSOR_PARALLEL is
checked here, where the JAX package checks it (``parallel.tp.resolve_tp``).
"""
from __future__ import annotations

from ..engine.registry import DATASET_REGISTRY
from ..parallel.tp import resolve_tp
from . import datasets  # noqa: F401  registers the datasets
from .loader import BatchLoader
from .transforms import TransformPipeline


class DataManager:
    def __init__(self, cfg):
        self.cfg = cfg
        tp = resolve_tp(cfg)
        if tp:
            print(f"(!) TRAIN.TENSOR_PARALLEL={tp}: this package runs on one device; the "
                  "tensor-parallel mesh is not ported yet")
        self.dataset = DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg)
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
