"""The test-only ImageNet shift datasets: V2, Sketch, A and R.

A copy of ``rpo_tpu/data/datasets/imagenet_variants.py`` (the reference's
datasets/{imagenetv2,imagenet_sketch,imagenet_a,imagenet_r}.py).  A and R
hold a 200-class subset whose labels are the order of the folders present
(the reference's imagenet_a.py:32-44).
"""
from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..datum import Datum, DatasetBase
from ..splits import listdir_nohidden
from .imagenet import ImageNet

TO_BE_IGNORED = ["README.txt"]


class _FolderEnumerated(DatasetBase):
    """The folders (wnids), in sorted order, define the labels."""

    image_subdir = ""

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, self.image_subdir)
        classnames = ImageNet.read_classnames(os.path.join(self.dataset_dir, "classnames.txt"))
        data = self.read_data(classnames)
        super().__init__(train_x=data, test=data)

    def read_data(self, classnames):
        folders = listdir_nohidden(self.image_dir, sort=True)
        folders = [f for f in folders if f not in TO_BE_IGNORED]
        items = []
        for label, folder in enumerate(folders):
            imnames = listdir_nohidden(os.path.join(self.image_dir, folder))
            classname = classnames[folder]
            for imname in imnames:
                items.append(Datum(impath=os.path.join(self.image_dir, folder, imname),
                                   label=label, classname=classname))
        return items


@DATASET_REGISTRY.register()
class ImageNetV2(DatasetBase):
    """The folders are the numeric labels 0..999 (the reference's
    imagenetv2.py:31-46)."""

    dataset_dir = "imagenetv2"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, self.dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir,
                                      "imagenetv2-matched-frequency-format-val")
        classnames = ImageNet.read_classnames(os.path.join(self.dataset_dir, "classnames.txt"))
        data = self.read_data(classnames)
        super().__init__(train_x=data, test=data)

    def read_data(self, classnames):
        folders = list(classnames.keys())
        items = []
        for label in range(1000):
            class_dir = os.path.join(self.image_dir, str(label))
            imnames = listdir_nohidden(class_dir)
            classname = classnames[folders[label]]
            for imname in imnames:
                items.append(Datum(impath=os.path.join(class_dir, imname), label=label,
                                   classname=classname))
        return items


@DATASET_REGISTRY.register()
class ImageNetSketch(_FolderEnumerated):
    dataset_dir = "imagenet-sketch"
    image_subdir = "images"


@DATASET_REGISTRY.register()
class ImageNetA(_FolderEnumerated):
    dataset_dir = "imagenet-adversarial"
    image_subdir = "imagenet-a"


@DATASET_REGISTRY.register()
class ImageNetR(_FolderEnumerated):
    dataset_dir = "imagenet-rendition"
    image_subdir = "imagenet-r"
