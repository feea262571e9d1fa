"""SUN397.  A copy of ``rpo_tpu/data/datasets/sun397.py`` (the
reference's datasets/sun397.py): hierarchical names reversed and joined,
the official Training_01/Testing_01 lists."""
from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..datum import Datum
from ..splits import read_split, save_split, split_trainval
from .common import FewShotDataset


@DATASET_REGISTRY.register()
class SUN397(FewShotDataset):
    dataset_dir = "sun397"

    def __init__(self, cfg):
        self.resolve_root(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "SUN397")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_SUN397.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            with open(os.path.join(self.dataset_dir, "ClassName.txt")) as f:
                classnames = [line.strip()[1:] for line in f if line.strip()]
            cname2lab = {c: i for i, c in enumerate(classnames)}
            trainval = self.read_data(cname2lab, "Training_01.txt")
            test = self.read_data(cname2lab, "Testing_01.txt")
            train, val = split_trainval(trainval)
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)

    def read_data(self, cname2lab, text_file):
        text_file = os.path.join(self.dataset_dir, text_file)
        items = []
        with open(text_file) as f:
            for line in f:
                imname = line.strip()[1:]  # strip the leading /
                if not imname:
                    continue
                classname = os.path.dirname(imname)
                label = cname2lab[classname]
                # drop the first-letter directory, reverse (indoor/outdoor first)
                names = classname.split("/")[1:][::-1]
                items.append(Datum(impath=os.path.join(self.image_dir, imname), label=label,
                                   classname=" ".join(names)))
        return items
