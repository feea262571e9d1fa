"""Bidirectional pickle interop with Dassl-format dataset caches.

A copy of ``rpo_tpu/data/interop.py``.

The reference shares its data root across runs via pickle caches at
canonical paths (few-shot subsets ``split_fewshot/shot_{N}-seed_{S}.pkl``,
the reference's datasets/oxford_pets.py:36-49; the ImageNet item list
``preprocessed.pkl``, the reference's datasets/imagenet.py:24-39).  Those
pickles contain ``dassl.data.datasets.base_dataset.Datum`` objects, and a
bare ``pickle.load`` resolves classes by module path — so naive sharing
breaks in BOTH directions: a Dassl cache is unloadable here (no dassl
installed) and a cache of ours referencing our ``Datum`` class
would crash a later reference run on the same root.

This module makes the canonical caches genuinely shared:

- ``dump_datum_pickle`` converts our Datum objects to instances of a
  class registered under Dassl's module path (the real class when dassl
  is importable, a stub with Dassl's exact state layout ``_impath`` /
  ``_label`` / ``_domain`` / ``_classname`` otherwise), so the written
  pickle's GLOBAL reference resolves to the real Dassl Datum inside a
  reference environment.
- ``load_datum_pickle`` resolves ANY class named ``Datum`` (Dassl's,
  ours, the stub) to our Datum, whose ``__setstate__`` absorbs both
  state layouts.

Sharing the cache is not just hygiene: the few-shot cache pins WHICH
examples each (shots, seed) subset contains, so a shared cache gives the
two frameworks identical few-shot subsets — seed-level comparability.
"""
from __future__ import annotations

import pickle
import sys
import types
from typing import Any

from .datum import Datum

DASSL_DATUM_MODULE = "dassl.data.datasets.base_dataset"


def _dassl_datum_class():
    """The class to pickle datums as.

    Prefer the real Dassl class when importable (then the write path is
    trivially compatible).  Otherwise register a minimal stub under the
    same module path: pickle's save_global verifies the class by
    importing its module and comparing identity, and resolves the name
    through sys.modules — so the stub satisfies the writer here while the
    stream's global reference still points at the real class in a Dassl
    environment.
    """
    try:
        mod = __import__(DASSL_DATUM_MODULE, fromlist=["Datum"])
        return mod.Datum
    except Exception:
        pass
    mod = sys.modules.get(DASSL_DATUM_MODULE)
    if mod is None or not hasattr(mod, "Datum"):
        parts = DASSL_DATUM_MODULE.split(".")
        for i in range(1, len(parts) + 1):
            name = ".".join(parts[:i])
            if name not in sys.modules:
                m = types.ModuleType(name)
                sys.modules[name] = m
                if i > 1:
                    setattr(sys.modules[".".join(parts[: i - 1])], parts[i - 1], m)

        class _StubDatum:
            pass

        _StubDatum.__module__ = DASSL_DATUM_MODULE
        _StubDatum.__qualname__ = "Datum"
        _StubDatum.__name__ = "Datum"
        sys.modules[DASSL_DATUM_MODULE].Datum = _StubDatum
    return sys.modules[DASSL_DATUM_MODULE].Datum


def _to_dassl(obj: Any, cls) -> Any:
    if isinstance(obj, Datum):
        d = cls.__new__(cls)
        d.__dict__.update(
            _impath=obj.impath,
            _label=int(obj.label),
            _domain=int(obj.domain),
            _classname=obj.classname,
        )
        return d
    if isinstance(obj, dict):
        return {k: _to_dassl(v, cls) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_dassl(v, cls) for v in obj)
    return obj


def dump_datum_pickle(payload: Any, f) -> None:
    """pickle.dump ``payload`` with every Datum written in Dassl's format
    (class path + state layout), loadable by a bare pickle.load in a
    reference environment AND by load_datum_pickle here."""
    cls = _dassl_datum_class()
    pickle.dump(_to_dassl(payload, cls), f, protocol=pickle.HIGHEST_PROTOCOL)


class _DatumUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "Datum":
            return Datum
        return super().find_class(module, name)


def load_datum_pickle(f) -> Any:
    """pickle.load that resolves any pickled ``Datum`` class — Dassl's,
    the stub, or ours — to this package's Datum (whose __setstate__ accepts
    both state layouts)."""
    return _DatumUnpickler(f).load()
