"""DataManager: dataset construction and the train, val and test loaders.

Port of ``rpo_tpu/data/manager.py`` (the role of Dassl's DataManager):
resolves cfg.DATASET.NAME in the registry, builds the transform pipeline
from cfg.INPUT, and gives the trainer its loaders and class metadata.

Under a process group a batch is padded to a multiple of the data ranks,
``pad_multiple(bs, data_axis_size(cfg))`` as in the JAX package, and
each rank's loaders decode only its rows of it (``parallel/dp.py``; row
r // tp of the dp x tp grid).  A lone process pads to the batch size;
TRAIN.TENSOR_PARALLEL is checked there too (``parallel.tp.resolve_tp``),
and a value that would split over several visible cards says that one
process drives one card.
"""
from __future__ import annotations

import torch.distributed as dist

from ..engine.registry import DATASET_REGISTRY
from ..parallel import dp
from ..parallel.tp import data_axis_size, resolve_tp
from . import datasets  # noqa: F401  registers the datasets
from .loader import BatchLoader
from .transforms import TransformPipeline


class DataManager:
    def __init__(self, cfg):
        self.cfg = cfg
        tp = resolve_tp(cfg)
        if dp.is_initialized():
            n_data, data_rank = data_axis_size(cfg), dist.get_rank() // (tp or 1)
        else:
            n_data, data_rank = 1, 0
            if tp:
                print(f"(!) TRAIN.TENSOR_PARALLEL={tp}: one process drives one device; launch "
                      "one rank a card with torchrun for the tensor-parallel mesh")
        self.dataset = DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg)
        transform = TransformPipeline(cfg.INPUT)
        self.transform = transform

        num_workers = int(cfg.DATALOADER.NUM_WORKERS)

        def loader(items, bs, train, **kw):
            pad_to = dp.pad_multiple(bs, n_data)
            per = pad_to // n_data
            return BatchLoader(items, transform, batch_size=bs, train=train, shuffle=train,
                               num_workers=num_workers, pad_to=pad_to,
                               rows=(data_rank * per, (data_rank + 1) * per), **kw)

        train_bs = int(cfg.DATALOADER.TRAIN_X.BATCH_SIZE)
        test_bs = int(cfg.DATALOADER.TEST.BATCH_SIZE)
        self.train_loader_x = loader(self.dataset.train_x, train_bs, True,
                                     drop_last=True)  # Dassl train-loader semantics
        self.val_loader = (loader(self.dataset.val, test_bs, False) if self.dataset.val
                           else None)
        self.test_loader = loader(self.dataset.test, test_bs, False)

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
