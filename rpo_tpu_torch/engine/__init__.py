from .config import CfgNode, get_cfg_default
from .evaluator import ClassificationEvaluator
from .logger import setup_logger
from .optim import lr_at_epoch
from .registry import DATASET_REGISTRY, TRAINER_REGISTRY, Registry
from .trainer import TrainerBase, build_trainer

__all__ = [
    "CfgNode",
    "ClassificationEvaluator",
    "DATASET_REGISTRY",
    "Registry",
    "TRAINER_REGISTRY",
    "TrainerBase",
    "build_trainer",
    "get_cfg_default",
    "lr_at_epoch",
    "setup_logger",
]
