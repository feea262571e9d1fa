"""What the method modules share: the port's CLIPConfig of a configuration
file, the weights through the port's converter, and the work of a step."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from .. import inputs, yardstick

CLIP_FIELDS = ("embed_dim", "image_resolution", "vision_layers", "vision_width",
               "vision_patch_size", "context_length", "vocab_size", "text_width", "text_heads",
               "text_layers")


@dataclasses.dataclass
class Work:
    """A step's (or an eval batch's) operations, and each kernel group's
    calls in it as (bytes, FLOPs) a call."""
    flops: float
    kernels: Dict[str, List[Tuple[float, float]]]


def port_clip(config: dict, sd_host: dict, device):
    """(clip_params, CLIPConfig) for the port: the configuration's widths
    and the benchmark's state dict through ``models/clip/convert.py``."""
    from rpo_tpu_torch.models.clip.convert import convert_state_dict
    from rpo_tpu_torch.models.clip.model import CLIPConfig

    cfg = CLIPConfig(**{k: config["clip"][k] for k in CLIP_FIELDS})
    return convert_state_dict(sd_host, cfg=cfg, device=device), cfg


@dataclasses.dataclass
class Program:
    """What a run's set-up made: the state dict (host, bfloat16), the class
    names, the trainable state (device, float32), the port's trainer with
    that state installed, and the data and sample seeds."""
    sd: dict
    classnames: List[str]
    state: dict
    trainer: object
    data_seed: int
    sample_seed: int


def set_up(cell, phases) -> Program:
    """The weights, class names and trainable state from the cell's seed,
    and the port's trainer built on them (the weights through
    ``convert.py``, the state through ``set_ckpt_state``)."""
    config, device = cell.config, cell.device
    s_weights, s_state, s_data, s_sample = inputs.seeds(cell.seed)
    sd = inputs.state_dict(config["clip"], s_weights, device)
    classnames = inputs.classnames(cell.traffic["n_cls"], s_data)
    state = cell.method.make_state(config, sd, s_state, device)
    sd = inputs.to_host(sd)
    phases("weights")
    clip_params, clip_cfg = port_clip(config, sd, device)
    phases("convert")
    trainer = cell.method.build_trainer(config, classnames, clip_params, clip_cfg, device)
    del clip_params
    trainer.set_ckpt_state(cell.method.MODEL, state)
    phases("trainer")
    return Program(sd, classnames, state, trainer, s_data, s_sample)


def vision_shape(clip: dict) -> Tuple[int, int, int]:
    """(heads, frozen rows S, head dim) of the vision tower."""
    S = (clip["image_resolution"] // clip["vision_patch_size"]) ** 2 + 1
    return clip["vision_heads"], S, clip["vision_width"] // clip["vision_heads"]


def rect_calls(clip: dict, shapes) -> List[Tuple[float, float]]:
    """Each vision layer's rect attention call at each (B, Lq, Lk)."""
    H, _, D = vision_shape(clip)
    return [yardstick.rect_attention_work(B, H, Lq, Lk, D)
            for B, Lq, Lk in shapes for _ in range(clip["vision_layers"])]
