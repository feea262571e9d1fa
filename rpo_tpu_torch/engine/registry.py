"""Name -> class registries for trainers and datasets.

A copy of ``rpo_tpu/engine/registry.py`` (the role of Dassl's
TRAINER_REGISTRY / DATASET_REGISTRY).
"""
from __future__ import annotations

from typing import Callable, Dict, Type


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Type] = {}

    def register(self, obj: Type | None = None) -> Callable:
        def deco(cls: Type) -> Type:
            name = cls.__name__
            if name in self._obj_map:
                raise KeyError(f"{name} already registered in {self._name}")
            self._obj_map[name] = cls
            return cls

        if obj is not None:
            return deco(obj)
        return deco

    def get(self, name: str) -> Type:
        if name not in self._obj_map:
            raise KeyError(
                f"Unknown {self._name}: {name!r}. Registered: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def registered_names(self):
        return sorted(self._obj_map)


TRAINER_REGISTRY = Registry("trainer")
DATASET_REGISTRY = Registry("dataset")
