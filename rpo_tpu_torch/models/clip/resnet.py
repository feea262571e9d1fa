"""ModifiedResNet visual tower (the RN50, RN101, RN50x4 and RN50x16 CLIP
backbones).

Port of ``rpo_tpu/models/clip/resnet.py``, with the same parameter tree
(``stem``, ``layers`` as a list of lists of block dicts, ``attnpool``)
and the same numerics:

  - a 3-conv stem, bottlenecks that average-pool before their stride, and
    a QKV attention pool in place of global average pooling;
  - inference-mode BatchNorm in float32 from the statistics as stored
    (bfloat16 ones in a bfloat16 tree), cast back to the activation dtype
    (``F.batch_norm``'s inference path, one pass);
  - ``avg_pool`` sums in float32, casts, and only then divides;
  - the attention pool's mean token is a float32 mean, cast; only its
    query is formed; the projections accumulate in float32 and round once
    before the bias is added in the activation dtype; the logits and the
    softmax are float32 and the probabilities are cast to v's dtype.

Images are HWC and kernels HWIO, as in the JAX package.  The convs are
``F.conv2d`` on NCHW tensors in ``channels_last`` memory: an HWC batch
permuted to NCHW is already that layout, so it is not copied.
``conv_layout`` lays each kernel out once (OHWI memory under its HWIO
shape), so that its OIHW view is ``channels_last`` too; a kernel that
was not laid out is copied into that layout by the conv on every call.
The stages call no attention kernel: the tower has no transformer.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]

# the conv kernels of a block and of the stem (the others are BN dicts)
_CONVS = ("conv1", "conv2", "conv3")


def conv2d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NCHW (channels_last) conv with an HWIO kernel, cast to x's dtype."""
    weight = kernel.to(x.dtype).permute(3, 2, 0, 1)  # OIHW view
    return F.conv2d(x, weight, stride=stride, padding=padding)


def batch_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BN over NCHW from the frozen running statistics as
    stored: ``F.batch_norm`` computes in float32 and writes x's dtype, one
    pass."""
    return F.batch_norm(x, p["mean"], p["var"], p["scale"], p["bias"], False, 0.0, eps)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """``window`` x ``window`` average pool with stride ``window``: the sum,
    accumulated in float32 and written in x's dtype, then divided."""
    if window == 1:
        return x
    return F.avg_pool2d(x, window, window, divisor_override=1) / (window * window)


def bottleneck(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    """conv1x1-bn-relu, conv3x3-bn-relu, avgpool(stride), conv1x1-bn; the
    downsample is avgpool, conv1x1 and bn."""
    out = F.relu(batch_norm(conv2d(x, p["conv1"]), p["bn1"]), inplace=True)
    out = F.relu(batch_norm(conv2d(out, p["conv2"], padding=1), p["bn2"]), inplace=True)
    out = avg_pool(out, stride)
    out = batch_norm(conv2d(out, p["conv3"]), p["bn3"])
    if "downsample" in p:
        identity = avg_pool(x, stride)
        identity = batch_norm(conv2d(identity, p["downsample"]["conv"]), p["downsample"]["bn"])
    else:
        identity = x
    return F.relu(out + identity, inplace=True)


def attention_pool(x: torch.Tensor, p: Params, n_heads: int) -> torch.Tensor:
    """Prepend the mean token, add the positional embedding, attend with
    the mean token's query alone: (B, C, H, W) -> (B, output_dim)."""
    B, C, H, W = x.shape
    dtype = x.dtype
    tokens = x.permute(0, 2, 3, 1).reshape(B, H * W, C)  # a view of channels_last
    mean = tokens.mean(dim=1, keepdim=True, dtype=torch.float32).to(dtype)
    tokens = torch.cat([mean, tokens], dim=1) + p["positional_embedding"].to(dtype)

    def proj(name, t):
        return torch.matmul(t, p[f"{name}_w"].to(dtype)) + p[f"{name}_b"].to(dtype)

    L = H * W + 1
    head_dim = C // n_heads
    q = proj("q", tokens[:, :1]).reshape(B, 1, n_heads, head_dim).transpose(1, 2)
    k = proj("k", tokens).reshape(B, L, n_heads, head_dim).transpose(1, 2)
    v = proj("v", tokens).reshape(B, L, n_heads, head_dim).transpose(1, 2)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (head_dim ** -0.5)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(w, v).reshape(B, C)  # (B, heads, 1, head_dim) in head order
    return proj("c", out)


def resnet_encode_image(params: Params, cfg, images: torch.Tensor) -> torch.Tensor:
    """The whole ModifiedResNet: images (B, H, W, 3) -> (B, embed_dim)."""
    v = params["visual"]
    dtype = v["stem"]["conv1"].dtype
    x = images.to(dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    stem = v["stem"]
    for i, stride in ((1, 2), (2, 1), (3, 1)):
        x = conv2d(x, stem[f"conv{i}"], stride=stride, padding=1)
        x = F.relu(batch_norm(x, stem[f"bn{i}"]), inplace=True)
    x = avg_pool(x, 2)
    for li, layer in enumerate(v["layers"]):
        stride = 1 if li == 0 else 2
        for bi, block in enumerate(layer):
            x = bottleneck(x, block, stride if bi == 0 else 1)
    return attention_pool(x, v["attnpool"], cfg.vision_heads)


# ---------------------------------------------------------------------------
# the kernels' layout
# ---------------------------------------------------------------------------

def _laid_out(kernel: torch.Tensor) -> torch.Tensor:
    """The same HWIO kernel in OHWI memory: its OIHW view is channels_last."""
    return kernel.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def conv_layout(visual: Params) -> Params:
    """The visual tree with every conv kernel laid out for ``conv2d`` once
    (the same values and shapes; BN and the attention pool untouched)."""
    def convs(d):
        out = {k: _laid_out(d[k]) if k in _CONVS else d[k] for k in d}
        if "downsample" in d:
            out["downsample"] = {**d["downsample"], "conv": _laid_out(d["downsample"]["conv"])}
        return out

    return {**visual, "stem": convs(visual["stem"]),
            "layers": [[convs(b) for b in layer] for layer in visual["layers"]]}


# ---------------------------------------------------------------------------
# conversion from a torch state dict (numpy only)
# ---------------------------------------------------------------------------

def _conv(w: np.ndarray) -> np.ndarray:
    """torch OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def _bn(sd, prefix) -> Params:
    return {
        "scale": sd[f"{prefix}.weight"],
        "bias": sd[f"{prefix}.bias"],
        "mean": sd[f"{prefix}.running_mean"],
        "var": sd[f"{prefix}.running_var"],
    }


def convert_resnet_visual(sd: Dict[str, np.ndarray], layers: Tuple[int, ...]) -> Params:
    """The visual.* keys of an RN CLIP state dict -> the port's tree."""
    stem = {
        "conv1": _conv(sd["visual.conv1.weight"]),
        "bn1": _bn(sd, "visual.bn1"),
        "conv2": _conv(sd["visual.conv2.weight"]),
        "bn2": _bn(sd, "visual.bn2"),
        "conv3": _conv(sd["visual.conv3.weight"]),
        "bn3": _bn(sd, "visual.bn3"),
    }
    layer_params = []
    for li, n_blocks in enumerate(layers, start=1):
        blocks = []
        for bi in range(n_blocks):
            pfx = f"visual.layer{li}.{bi}"
            block = {
                "conv1": _conv(sd[f"{pfx}.conv1.weight"]),
                "bn1": _bn(sd, f"{pfx}.bn1"),
                "conv2": _conv(sd[f"{pfx}.conv2.weight"]),
                "bn2": _bn(sd, f"{pfx}.bn2"),
                "conv3": _conv(sd[f"{pfx}.conv3.weight"]),
                "bn3": _bn(sd, f"{pfx}.bn3"),
            }
            if f"{pfx}.downsample.0.weight" in sd:
                block["downsample"] = {
                    "conv": _conv(sd[f"{pfx}.downsample.0.weight"]),
                    "bn": _bn(sd, f"{pfx}.downsample.1"),
                }
            blocks.append(block)
        layer_params.append(blocks)
    attnpool = {"positional_embedding": sd["visual.attnpool.positional_embedding"]}
    for name in ("q", "k", "v", "c"):
        attnpool[f"{name}_w"] = sd[f"visual.attnpool.{name}_proj.weight"].T
        attnpool[f"{name}_b"] = sd[f"visual.attnpool.{name}_proj.bias"]
    return {"stem": stem, "layers": layer_params, "attnpool": attnpool}


# ---------------------------------------------------------------------------
# random init
# ---------------------------------------------------------------------------

def init_resnet_visual(gen: torch.Generator, cfg, dtype=torch.float32) -> Params:
    """A random RN visual tower of JAX's structure and distributions, drawn
    from ``gen`` on ``gen.device``; BatchNorm the identity."""
    width = cfg.vision_width
    dev = gen.device

    def conv(shape, fan_in):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x * fan_in ** -0.5).to(dtype)

    def bn(c):
        return {
            "scale": torch.ones(c, dtype=dtype, device=dev),
            "bias": torch.zeros(c, dtype=dtype, device=dev),
            "mean": torch.zeros(c, dtype=dtype, device=dev),
            "var": torch.ones(c, dtype=dtype, device=dev),
        }

    stem = {
        "conv1": conv((3, 3, 3, width // 2), 27),
        "bn1": bn(width // 2),
        "conv2": conv((3, 3, width // 2, width // 2), 9 * width // 2),
        "bn2": bn(width // 2),
        "conv3": conv((3, 3, width // 2, width), 9 * width // 2),
        "bn3": bn(width),
    }
    layer_params = []
    inplanes = width
    for li, n_blocks in enumerate(cfg.vision_layers):
        planes = width * (2 ** li)
        blocks = []
        for bi in range(n_blocks):
            block = {
                "conv1": conv((1, 1, inplanes, planes), inplanes),
                "bn1": bn(planes),
                "conv2": conv((3, 3, planes, planes), 9 * planes),
                "bn2": bn(planes),
                "conv3": conv((1, 1, planes, planes * 4), planes),
                "bn3": bn(planes * 4),
            }
            stride = (1 if li == 0 else 2) if bi == 0 else 1
            if stride > 1 or inplanes != planes * 4:
                block["downsample"] = {
                    "conv": conv((1, 1, inplanes, planes * 4), inplanes),
                    "bn": bn(planes * 4),
                }
            blocks.append(block)
            inplanes = planes * 4
        layer_params.append(blocks)

    feat = width * 32
    spacial = cfg.image_resolution // 32
    attnpool = {"positional_embedding": conv((spacial ** 2 + 1, feat), feat)}
    for name in ("q", "k", "v"):
        attnpool[f"{name}_w"] = conv((feat, feat), feat)
        attnpool[f"{name}_b"] = torch.zeros(feat, dtype=dtype, device=dev)
    attnpool["c_w"] = conv((feat, cfg.embed_dim), feat)
    attnpool["c_b"] = torch.zeros(cfg.embed_dim, dtype=dtype, device=dev)
    return {"stem": stem, "layers": layer_params, "attnpool": attnpool}
