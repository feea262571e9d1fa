"""ImageNet: train on the train folder, evaluate on the val folder.

A copy of ``rpo_tpu/data/datasets/imagenet.py``; the on-disk formats are
the reference's (datasets/imagenet.py): ``preprocessed.pkl`` keeps the
whole item lists under {train, test} in Dassl's pickle format
(``interop.dump_datum_pickle``), so that a cache written by either
package or by the reference loads in the others; the few-shot cache
``split_fewshot/shot_{N}-seed_{S}.pkl`` holds the train list only (there
is no few-shot val); ``classnames.txt`` lines are ``<wnid> <classname
words...>``; the val folder is both val and test.
"""
from __future__ import annotations

import os
from collections import OrderedDict

from ...engine.registry import DATASET_REGISTRY
from ..datum import Datum, DatasetBase
from ..interop import dump_datum_pickle, load_datum_pickle
from ..splits import listdir_nohidden, load_or_create_fewshot, subsample_classes
from .common import FewShotDataset


@DATASET_REGISTRY.register()
class ImageNet(FewShotDataset):
    dataset_dir = "imagenet"

    def __init__(self, cfg):
        dataset_dir = self.resolve_root(cfg)
        self.image_dir = os.path.join(dataset_dir, "images")

        train, test = self._item_lists(dataset_dir)
        train, _ = load_or_create_fewshot(
            self, train, None, self.split_fewshot_dir,
            int(cfg.DATASET.NUM_SHOTS), int(cfg.SEED),
        )
        train, test = subsample_classes(train, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES)
        # the val split is the test split (the reference's imagenet.py:61)
        DatasetBase.__init__(self, train_x=train, val=test, test=test)

    def _item_lists(self, dataset_dir: str):
        """The whole (train, test) Datum lists, kept in preprocessed.pkl:
        listing the 1.28M-image tree is the expensive part."""
        cache = os.path.join(dataset_dir, "preprocessed.pkl")
        # where preprocessed.pkl exists but does not load here (a foreign
        # cache), a rescan is kept under this name, the JAX package's, so
        # that the listing is paid once and both packages share it
        cache_rpo = os.path.join(dataset_dir, "preprocessed_rpo_tpu.pkl")
        for cand in (cache, cache_rpo):
            if os.path.exists(cand):
                try:
                    with open(cand, "rb") as f:
                        data = load_datum_pickle(f)  # Dassl's caches load too
                    return data["train"], data["test"]
                except Exception as exc:
                    # a file truncated by a killed writer, or a format
                    # interop.py does not cover: rescan, and leave the
                    # file as it is (splits.py's policy)
                    print(f"(!) Could not load {cand} ({exc}); rescanning the "
                          "image tree without overwriting")
        wnid_to_name = self.read_classnames(os.path.join(dataset_dir, "classnames.txt"))
        train = self._scan_split("train", wnid_to_name)
        # accuracy is reported on the val images
        test = self._scan_split("val", wnid_to_name)
        # the shared name if it is free, else the second one: a foreign
        # cache is never overwritten, and the tree never listed again
        dest = cache if not os.path.exists(cache) else cache_rpo
        tmp = f"{dest}.tmp.{os.getpid()}"
        try:
            # write, then rename: a killed job leaves no truncated cache
            with open(tmp, "wb") as f:
                dump_datum_pickle({"train": train, "test": test}, f)
            os.replace(tmp, dest)
        except OSError as exc:  # a read-only dataset mount
            print(f"(!) Could not save {dest} ({exc})")
        return train, test

    @staticmethod
    def read_classnames(text_file: str) -> "OrderedDict[str, str]":
        """classnames.txt, each line '<wnid> <name words...>'.

        Split on single spaces, not on any whitespace, as the reference
        (datasets/imagenet.py:72) does with ``strip().split(" ")``: a name
        with two spaces in a row keeps them (the prompt string goes to the
        tokenizer, and its spacing moves the logits)."""
        mapping = OrderedDict()
        with open(text_file) as f:
            for line in f:
                fields = line.strip().split(" ")
                if fields and fields[0]:
                    mapping[fields[0]] = " ".join(fields[1:])
        return mapping

    def _scan_split(self, split: str, wnid_to_name) -> list:
        """One Datum per image under images/<split>/<wnid>/, the labels in
        sorted-wnid order (the reference's class indexing)."""
        base = os.path.join(self.image_dir, split)
        wnids = sorted(e.name for e in os.scandir(base) if e.is_dir())
        return [
            Datum(impath=os.path.join(base, wnid, fname), label=label,
                  classname=wnid_to_name[wnid])
            for label, wnid in enumerate(wnids)
            for fname in listdir_nohidden(os.path.join(base, wnid))
        ]
