"""Dataset record types: Datum / DatasetBase.

A copy of ``rpo_tpu/data/datum.py``.

Equivalent surface to Dassl's dassl.data.datasets (consumed at
the reference's datasets/oxford_pets.py:7): Datum(impath, label,
classname), DatasetBase with lab2cname/classnames/num_classes and the
seeded few-shot sampler ``generate_fewshot_dataset``.
"""
from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


class Datum:
    """One example: image path + integer label + readable classname.

    ``impath`` may be a real file path or a ``synthetic://`` URI (used by
    the in-memory test/bench dataset).
    """

    __slots__ = ("impath", "label", "classname", "domain")

    def __init__(self, impath: str = "", label: int = 0, classname: str = "", domain: int = 0):
        self.impath = impath
        self.label = label
        self.classname = classname
        self.domain = domain

    def __repr__(self) -> str:
        return f"Datum(impath={self.impath!r}, label={self.label}, classname={self.classname!r})"

    def __setstate__(self, state):
        """Accept both pickle state layouts: ours ((None, slots_dict) for
        this __slots__ class) and Dassl's (__dict__ with private
        ``_impath``/``_label``/``_domain``/``_classname`` keys) — see
        data/interop.py for why Dassl-format pickles reach this class."""
        if isinstance(state, tuple):  # (dict_state, slots_state)
            d, s = state
            merged = {**(d or {}), **(s or {})}
        else:
            merged = dict(state)
        self.impath = merged.get("impath", merged.get("_impath", ""))
        self.label = merged.get("label", merged.get("_label", 0))
        self.classname = merged.get("classname", merged.get("_classname", ""))
        self.domain = merged.get("domain", merged.get("_domain", 0))


class DatasetBase:
    """Holds train_x/val/test item lists and derived class metadata."""

    dataset_dir = ""

    def __init__(
        self,
        train_x: Optional[List[Datum]] = None,
        val: Optional[List[Datum]] = None,
        test: Optional[List[Datum]] = None,
    ):
        self.train_x = train_x or []
        self.val = val or []
        self.test = test or []
        self._num_classes = self.get_num_classes(self.train_x or self.test)
        self._lab2cname, self._classnames = self.get_lab2cname(
            self.train_x or self.test
        )

    @property
    def num_classes(self) -> int:
        return self._num_classes

    @property
    def lab2cname(self) -> Dict[int, str]:
        return self._lab2cname

    @property
    def classnames(self) -> List[str]:
        return self._classnames

    @staticmethod
    def get_num_classes(data_source: Sequence[Datum]) -> int:
        return max((item.label for item in data_source), default=-1) + 1

    @staticmethod
    def get_lab2cname(data_source: Sequence[Datum]):
        mapping = {item.label: item.classname for item in data_source}
        labels = sorted(mapping)
        return mapping, [mapping[l] for l in labels]

    def generate_fewshot_dataset(
        self, *data_sources: List[Datum], num_shots: int = -1, repeat: bool = False
    ):
        """Sample num_shots items per class with the host ``random`` module
        (Dassl semantics: seeded by cfg.SEED at process start, so cached
        few-shot subsets are reproducible per (shots, seed))."""
        if num_shots < 1:
            return data_sources[0] if len(data_sources) == 1 else data_sources
        print(f"Creating a {num_shots}-shot dataset")
        outputs = []
        for source in data_sources:
            tracker = self.split_dataset_by_label(source)
            sampled: List[Datum] = []
            for label, items in tracker.items():
                if len(items) >= num_shots:
                    sampled.extend(random.sample(items, num_shots))
                elif repeat:
                    sampled.extend(random.choices(items, k=num_shots))
                else:
                    sampled.extend(items)
            outputs.append(sampled)
        return outputs[0] if len(outputs) == 1 else outputs

    @staticmethod
    def split_dataset_by_label(data_source: Sequence[Datum]) -> Dict[int, List[Datum]]:
        tracker = defaultdict(list)
        for item in data_source:
            tracker[item.label].append(item)
        return tracker
