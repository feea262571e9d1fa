"""The method trainers.  Importing this package registers all six with
the engine's ``TRAINER_REGISTRY``: RPO, CoOp, CoCoOp, LP, ZeroshotCLIP
and ZeroshotCLIP2 (the names of ``rpo_tpu/methods/__init__.py``)."""
from . import cocoop  # noqa: F401
from . import coop  # noqa: F401
from . import linear_probe  # noqa: F401
from . import rpo_trainer  # noqa: F401
from . import zsclip  # noqa: F401

__all__ = ["cocoop", "coop", "linear_probe", "rpo_trainer", "zsclip"]
