"""Synthetic in-memory dataset for tests, smoke runs and benchmarks.

A copy of ``rpo_tpu/data/datasets/synthetic.py``: deterministic
pseudo-images keyed by ``synthetic://<split>/<label>/<idx>`` URIs, which
exercise the whole data path (few-shot sampling, base/new subsampling,
loaders) with no files.
"""
from __future__ import annotations

from ...engine.registry import DATASET_REGISTRY
from ..datum import Datum, DatasetBase
from ..splits import subsample_classes

_CLASSNAMES = [
    "crimson finch", "glass teapot", "paper lantern", "granite cliff",
    "velvet chair", "copper kettle", "neon sign", "willow tree",
    "marble statue", "cotton cloud",
]


@DATASET_REGISTRY.register()
class Synthetic(DatasetBase):
    dataset_dir = "synthetic"

    n_train_per_class = 20
    n_val_per_class = 4
    n_test_per_class = 10

    def __init__(self, cfg):
        names = _CLASSNAMES

        def make(split: str, per_class: int):
            return [
                Datum(impath=f"synthetic://{split}/{label}/{i}", label=label, classname=name)
                for label, name in enumerate(names)
                for i in range(per_class)
            ]

        train = make("train", self.n_train_per_class)
        val = make("val", self.n_val_per_class)
        test = make("test", self.n_test_per_class)

        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots >= 1:
            train = self.generate_fewshot_dataset(train, num_shots=num_shots)
            val = self.generate_fewshot_dataset(val, num_shots=min(num_shots, 4))

        subsample = cfg.DATASET.SUBSAMPLE_CLASSES
        train, val, test = subsample_classes(train, val, test, subsample=subsample)
        super().__init__(train_x=train, val=val, test=test)
