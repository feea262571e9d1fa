"""FGVCAircraft.  A copy of ``rpo_tpu/data/datasets/fgvc_aircraft.py``
(the reference's datasets/fgvc_aircraft.py): the official
images_variant_{train,val,test}.txt splits over variants.txt."""
from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..datum import Datum
from .common import FewShotDataset


@DATASET_REGISTRY.register()
class FGVCAircraft(FewShotDataset):
    dataset_dir = "fgvc_aircraft"

    def __init__(self, cfg):
        self.resolve_root(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "images")

        with open(os.path.join(self.dataset_dir, "variants.txt")) as f:
            classnames = [line.strip() for line in f if line.strip()]
        cname2lab = {c: i for i, c in enumerate(classnames)}

        train = self.read_data(cname2lab, "images_variant_train.txt")
        val = self.read_data(cname2lab, "images_variant_val.txt")
        test = self.read_data(cname2lab, "images_variant_test.txt")

        self.finalize(cfg, train, val, test)

    def read_data(self, cname2lab, split_file):
        filepath = os.path.join(self.dataset_dir, split_file)
        items = []
        with open(filepath) as f:
            for line in f:
                parts = line.strip().split(" ")
                if not parts or not parts[0]:
                    continue
                imname = parts[0] + ".jpg"
                classname = " ".join(parts[1:])
                items.append(Datum(impath=os.path.join(self.image_dir, imname),
                                   label=cname2lab[classname], classname=classname))
        return items
