"""UCF101 (mid-frame images).  A copy of ``rpo_tpu/data/datasets/ucf101.py``
(the reference's datasets/ucf101.py): CamelCase action names split into
underscore-joined classnames."""
from __future__ import annotations

import os
import re

from ...engine.registry import DATASET_REGISTRY
from ..datum import Datum
from ..splits import read_split, save_split, split_trainval
from .common import FewShotDataset


@DATASET_REGISTRY.register()
class UCF101(FewShotDataset):
    dataset_dir = "ucf101"

    def __init__(self, cfg):
        self.resolve_root(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "UCF-101-midframes")
        self.split_path = os.path.join(self.dataset_dir, "split_zhou_UCF101.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            cname2lab = {}
            filepath = os.path.join(self.dataset_dir, "ucfTrainTestlist/classInd.txt")
            with open(filepath) as f:
                for line in f:
                    label, classname = line.strip().split(" ")
                    cname2lab[classname] = int(label) - 1
            trainval = self.read_data(cname2lab, "ucfTrainTestlist/trainlist01.txt")
            test = self.read_data(cname2lab, "ucfTrainTestlist/testlist01.txt")
            train, val = split_trainval(trainval)
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)

    def read_data(self, cname2lab, text_file):
        text_file = os.path.join(self.dataset_dir, text_file)
        items = []
        with open(text_file) as f:
            for line in f:
                line = line.strip().split(" ")[0]  # trainlist rows carry a label too
                if not line:
                    continue
                action, filename = line.split("/")
                label = cname2lab[action]
                renamed = "_".join(re.findall("[A-Z][^A-Z]*", action))
                filename = filename.replace(".avi", ".jpg")
                items.append(Datum(impath=os.path.join(self.image_dir, renamed, filename),
                                   label=label, classname=renamed))
        return items
