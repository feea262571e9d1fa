"""Convert OpenAI CLIP checkpoints into the port's parameter trees.

Port of ``rpo_tpu/models/clip/convert.py``: the same shape inference and
the same loader fallbacks.  A checkpoint file may be a TorchScript
archive, a plain state dict, an open_clip training envelope
(``{"state_dict": ...}`` with ``module.`` prefixes) or a HuggingFace
``CLIPModel`` state dict (``.bin``, or ``.safetensors`` through the
``safetensors`` package, imported only for such a file).  Layout
transforms, done in numpy:

  - Linear weights (out, in) -> (in, out), so a projection is ``x @ w``;
  - the ViT's conv1 patch kernel (width, 3, P, P) -> (P*P*3, width), in
    ``patchify``'s (py, px, c) order;
  - a transformer's per-layer block params stacked on a leading
    [n_layers] axis;
  - a ResNet's conv kernels OIHW -> HWIO (``resnet.convert_resnet_visual``).

The tree comes back as float32 tensors on the device asked for.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from .model import CLIPConfig, Params
from .resnet import convert_resnet_visual


def _np(x) -> np.ndarray:
    if isinstance(x, (np.ndarray, np.generic)):
        return np.asarray(x)
    return x.detach().cpu().float().numpy()  # a torch tensor


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A CLIP checkpoint file (TorchScript archive, state dict, open_clip
    training checkpoint or HF safetensors) -> numpy arrays by key."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.numpy import load_file
        except ImportError as e:
            raise ImportError(f"{path}: reading a .safetensors checkpoint needs the "
                              "'safetensors' package, which is not installed") from e
        return normalize_state_dict(load_file(path))
    try:
        with warnings.catch_warnings():  # newer PyTorch deprecates TorchScript
            warnings.simplefilter("ignore", DeprecationWarning)
            state_dict = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        state_dict = torch.load(path, map_location="cpu")
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    # an open_clip envelope's metadata is dropped before the tensors convert
    return normalize_state_dict(state_dict)


def normalize_state_dict(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Any locally present CLIP checkpoint variant -> the OpenAI layout:

      - open_clip / torch training checkpoints: the ``state_dict`` (or
        ``model``) envelope unwrapped and ``module.`` / ``_orig_mod.``
        prefixes stripped;
      - HuggingFace ``transformers.CLIPModel`` state dicts: remapped by
        :func:`remap_hf_state_dict`.
    """
    for envelope in ("state_dict", "model"):
        inner = sd.get(envelope)
        if isinstance(inner, dict) and any(hasattr(v, "shape") for v in inner.values()):
            sd = inner
            break
    out = {}
    for k, v in sd.items():
        for prefix in ("module.", "_orig_mod."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if not hasattr(v, "shape"):
            continue  # scalar metadata (epoch counters and the like)
        out[k] = _np(v)
    if any(k.startswith(("text_model.", "vision_model.")) for k in out):
        try:
            out = remap_hf_state_dict(out)
        except KeyError as e:
            raise ValueError(
                "checkpoint looks like a HuggingFace CLIP export but is missing required key "
                f"{e}. Partial exports (e.g. CLIPVisionModel / CLIPTextModel) are not loadable: "
                "a full transformers.CLIPModel state dict with both towers and the projection "
                "heads is required.") from e
    return out


def remap_hf_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HuggingFace ``CLIPModel`` state dict -> the OpenAI key layout: q/k/v
    concatenated back into ``in_proj`` (order q; k; v), and the two output
    projections, ``nn.Linear`` weights (out, in), transposed."""
    out: Dict[str, np.ndarray] = {}

    def block(src: str, dst: str, n: int) -> None:
        for i in range(n):
            s, d = f"{src}.{i}", f"{dst}.{i}"
            out[f"{d}.ln_1.weight"] = sd[f"{s}.layer_norm1.weight"]
            out[f"{d}.ln_1.bias"] = sd[f"{s}.layer_norm1.bias"]
            out[f"{d}.ln_2.weight"] = sd[f"{s}.layer_norm2.weight"]
            out[f"{d}.ln_2.bias"] = sd[f"{s}.layer_norm2.bias"]
            out[f"{d}.attn.in_proj_weight"] = np.concatenate(
                [sd[f"{s}.self_attn.{p}_proj.weight"] for p in "qkv"], axis=0)
            out[f"{d}.attn.in_proj_bias"] = np.concatenate(
                [sd[f"{s}.self_attn.{p}_proj.bias"] for p in "qkv"], axis=0)
            out[f"{d}.attn.out_proj.weight"] = sd[f"{s}.self_attn.out_proj.weight"]
            out[f"{d}.attn.out_proj.bias"] = sd[f"{s}.self_attn.out_proj.bias"]
            out[f"{d}.mlp.c_fc.weight"] = sd[f"{s}.mlp.fc1.weight"]
            out[f"{d}.mlp.c_fc.bias"] = sd[f"{s}.mlp.fc1.bias"]
            out[f"{d}.mlp.c_proj.weight"] = sd[f"{s}.mlp.fc2.weight"]
            out[f"{d}.mlp.c_proj.bias"] = sd[f"{s}.mlp.fc2.bias"]

    def n_layers(prefix: str) -> int:
        return len({k.split(".")[3] for k in sd if k.startswith(f"{prefix}.encoder.layers.")})

    out["token_embedding.weight"] = sd["text_model.embeddings.token_embedding.weight"]
    out["positional_embedding"] = sd["text_model.embeddings.position_embedding.weight"]
    block("text_model.encoder.layers", "transformer.resblocks", n_layers("text_model"))
    out["ln_final.weight"] = sd["text_model.final_layer_norm.weight"]
    out["ln_final.bias"] = sd["text_model.final_layer_norm.bias"]
    out["text_projection"] = sd["text_projection.weight"].T

    # the vision tower (HF's CLIPModel is ViT-only)
    out["visual.class_embedding"] = sd["vision_model.embeddings.class_embedding"]
    out["visual.conv1.weight"] = sd["vision_model.embeddings.patch_embedding.weight"]
    out["visual.positional_embedding"] = sd["vision_model.embeddings.position_embedding.weight"]
    # HF's attribute is "pre_layrnorm" (sic); accept the corrected spelling too
    pre = ("vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd
           else "vision_model.pre_layernorm")
    out["visual.ln_pre.weight"] = sd[f"{pre}.weight"]
    out["visual.ln_pre.bias"] = sd[f"{pre}.bias"]
    block("vision_model.encoder.layers", "visual.transformer.resblocks",
          n_layers("vision_model"))
    out["visual.ln_post.weight"] = sd["vision_model.post_layernorm.weight"]
    out["visual.ln_post.bias"] = sd["vision_model.post_layernorm.bias"]
    out["visual.proj"] = sd["visual_projection.weight"].T
    out["logit_scale"] = sd["logit_scale"]
    return out


def _text_layers(sd) -> int:
    return len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")})


def infer_config(sd: Dict[str, np.ndarray]) -> CLIPConfig:
    """Architecture hyperparameters from the state dict's shapes (a
    ModifiedResNet where there is no ``visual.proj``)."""
    if "ln_final.weight" not in sd:
        raise ValueError(
            "not a recognizable CLIP checkpoint (no 'ln_final.weight' after layout "
            "normalization). Supported variants: the OpenAI TorchScript/state-dict pickle, "
            "open_clip/torch training envelopes, full HF transformers.CLIPModel state dicts, "
            f"and HF safetensors. Sample keys: {sorted(sd)[:5]}")
    text_width = sd["ln_final.weight"].shape[0]
    text = dict(
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=_text_layers(sd),
    )
    if "visual.proj" not in sd:  # a ModifiedResNet
        counts = tuple(
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
            for b in (1, 2, 3, 4))
        out_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        return CLIPConfig(image_resolution=out_width * 32, vision_layers=counts,
                          vision_width=sd["visual.layer1.0.conv1.weight"].shape[0],
                          vision_patch_size=0, **text)
    vision_layers = len([k for k in sd if k.startswith("visual.")
                         and k.endswith(".attn.in_proj_weight")])
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    return CLIPConfig(image_resolution=patch * grid, vision_layers=vision_layers,
                      vision_width=sd["visual.conv1.weight"].shape[0],
                      vision_patch_size=patch, **text)


def _ln(sd, prefix) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _stack_blocks(sd: Dict[str, np.ndarray], prefix: str, n_layers: int) -> Params:
    def per_layer(fn):
        return np.stack([fn(f"{prefix}.{i}") for i in range(n_layers)])

    return {
        "ln_1": {"scale": per_layer(lambda p: sd[f"{p}.ln_1.weight"]),
                 "bias": per_layer(lambda p: sd[f"{p}.ln_1.bias"])},
        "attn": {
            "qkv_w": per_layer(lambda p: sd[f"{p}.attn.in_proj_weight"].T),
            "qkv_b": per_layer(lambda p: sd[f"{p}.attn.in_proj_bias"]),
            "out_w": per_layer(lambda p: sd[f"{p}.attn.out_proj.weight"].T),
            "out_b": per_layer(lambda p: sd[f"{p}.attn.out_proj.bias"]),
        },
        "ln_2": {"scale": per_layer(lambda p: sd[f"{p}.ln_2.weight"]),
                 "bias": per_layer(lambda p: sd[f"{p}.ln_2.bias"])},
        "mlp": {
            "fc_w": per_layer(lambda p: sd[f"{p}.mlp.c_fc.weight"].T),
            "fc_b": per_layer(lambda p: sd[f"{p}.mlp.c_fc.bias"]),
            "proj_w": per_layer(lambda p: sd[f"{p}.mlp.c_proj.weight"].T),
            "proj_b": per_layer(lambda p: sd[f"{p}.mlp.c_proj.bias"]),
        },
    }


def convert_state_dict(sd: Dict[str, Any], cfg: Optional[CLIPConfig] = None,
                       device: DeviceLike = None) -> Params:
    """A torch CLIP state dict (numpy or torch leaves) -> the port's tree of
    float32 tensors on ``device`` (None: the CUDA card)."""
    sd = {k: _np(v) for k, v in sd.items()}
    if cfg is None:
        cfg = infer_config(sd)
    if not cfg.is_vit:
        return _finish_convert(sd, convert_resnet_visual(sd, cfg.vision_layers), cfg, device)
    conv1 = sd["visual.conv1.weight"]  # (width, 3, P, P)
    visual = {
        # (P, P, 3, width) -> (P*P*3, width), patchify's (py, px, c)
        "patch_embed": conv1.transpose(2, 3, 1, 0).reshape(-1, conv1.shape[0]),
        "class_embedding": sd["visual.class_embedding"],
        "positional_embedding": sd["visual.positional_embedding"],
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": _stack_blocks(sd, "visual.transformer.resblocks", cfg.vision_layers),
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": sd["visual.proj"],
    }
    return _finish_convert(sd, visual, cfg, device)


def _tensors(node, device: torch.device):
    if isinstance(node, dict):
        return {k: _tensors(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_tensors(v, device) for v in node]
    return torch.from_numpy(np.array(node, dtype=np.float32)).to(device)


def _finish_convert(sd: Dict[str, np.ndarray], visual: Params, cfg: CLIPConfig,
                    device: DeviceLike = None) -> Params:
    text = {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "blocks": _stack_blocks(sd, "transformer.resblocks", cfg.text_layers),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"],
    }
    params = {"visual": visual, "text": text, "logit_scale": sd["logit_scale"].reshape(())}
    return _tensors(params, resolve_device(device))


def state_dict_shapes(cfg: CLIPConfig) -> Dict[str, Tuple[int, ...]]:
    """The OpenAI state dict of ``cfg``'s architecture, key by key: each
    tensor's shape (BatchNorm's ``num_batches_tracked`` included), the
    layout that :func:`convert_state_dict` reads and :func:`infer_config`
    reads ``cfg`` back from."""
    tw, ed = cfg.text_width, cfg.embed_dim
    shapes: Dict[str, Tuple[int, ...]] = {}

    def bn(prefix, c):
        for name in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{name}"] = (c,)
        shapes[f"{prefix}.num_batches_tracked"] = ()

    def blocks(prefix, n, w):
        for i in range(n):
            p = f"{prefix}.{i}"
            for ln in ("ln_1", "ln_2"):
                shapes[f"{p}.{ln}.weight"] = shapes[f"{p}.{ln}.bias"] = (w,)
            shapes[f"{p}.attn.in_proj_weight"] = (3 * w, w)
            shapes[f"{p}.attn.in_proj_bias"] = (3 * w,)
            shapes[f"{p}.attn.out_proj.weight"] = (w, w)
            shapes[f"{p}.attn.out_proj.bias"] = (w,)
            shapes[f"{p}.mlp.c_fc.weight"] = (4 * w, w)
            shapes[f"{p}.mlp.c_fc.bias"] = (4 * w,)
            shapes[f"{p}.mlp.c_proj.weight"] = (w, 4 * w)
            shapes[f"{p}.mlp.c_proj.bias"] = (w,)

    vw = cfg.vision_width
    if cfg.is_vit:
        P = cfg.vision_patch_size
        shapes["visual.class_embedding"] = (vw,)
        shapes["visual.positional_embedding"] = (cfg.vision_seq_len, vw)
        shapes["visual.proj"] = (vw, ed)
        shapes["visual.conv1.weight"] = (vw, 3, P, P)
        shapes["visual.ln_pre.weight"] = shapes["visual.ln_pre.bias"] = (vw,)
        blocks("visual.transformer.resblocks", cfg.vision_layers, vw)
        shapes["visual.ln_post.weight"] = shapes["visual.ln_post.bias"] = (vw,)
    else:
        for i, (cin, cout) in enumerate(((3, vw // 2), (vw // 2, vw // 2), (vw // 2, vw)), 1):
            shapes[f"visual.conv{i}.weight"] = (cout, cin, 3, 3)
            bn(f"visual.bn{i}", cout)
        inplanes = vw
        for li, n_blocks in enumerate(cfg.vision_layers):
            planes = vw * 2 ** li
            for bi in range(n_blocks):
                p = f"visual.layer{li + 1}.{bi}"
                shapes[f"{p}.conv1.weight"] = (planes, inplanes, 1, 1)
                bn(f"{p}.bn1", planes)
                shapes[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
                bn(f"{p}.bn2", planes)
                shapes[f"{p}.conv3.weight"] = (planes * 4, planes, 1, 1)
                bn(f"{p}.bn3", planes * 4)
                if bi == 0 and (li > 0 or inplanes != planes * 4):
                    shapes[f"{p}.downsample.0.weight"] = (planes * 4, inplanes, 1, 1)
                    bn(f"{p}.downsample.1", planes * 4)
                inplanes = planes * 4
        feat = vw * 32
        shapes["visual.attnpool.positional_embedding"] = (
            (cfg.image_resolution // 32) ** 2 + 1, feat)
        for name in ("q", "k", "v"):
            shapes[f"visual.attnpool.{name}_proj.weight"] = (feat, feat)
            shapes[f"visual.attnpool.{name}_proj.bias"] = (feat,)
        shapes["visual.attnpool.c_proj.weight"] = (ed, feat)
        shapes["visual.attnpool.c_proj.bias"] = (ed,)
    shapes["token_embedding.weight"] = (cfg.vocab_size, tw)
    shapes["positional_embedding"] = (cfg.context_length, tw)
    blocks("transformer.resblocks", cfg.text_layers, tw)
    shapes["ln_final.weight"] = shapes["ln_final.bias"] = (tw,)
    shapes["text_projection"] = (tw, ed)
    shapes["logit_scale"] = ()
    return shapes


def load_clip(path: str, device: DeviceLike = None) -> Tuple[Params, CLIPConfig]:
    """A checkpoint file -> (float32 params on ``device``, CLIPConfig)."""
    sd = load_torch_state_dict(path)
    for key in ("input_resolution", "context_length", "vocab_size"):
        sd.pop(key, None)
    cfg = infer_config(sd)
    return convert_state_dict(sd, cfg=cfg, device=device), cfg
