"""The port's checkpoint intake (``models/clip/convert.py``,
``pretrained.py``) and user API (``rpo_tpu_torch/clip.py``) against the
JAX package's.

OpenAI-layout state dicts are made in numpy for TINY_RN and TINY from a
seed (BatchNorm statistics included, var > 0) and saved with
``torch.save``: as they are, inside an open_clip ``{"state_dict": ...}``
envelope with ``module.`` prefixes, and, for the ViT, in HuggingFace's
``CLIPModel`` layout.  Both packages load each file; the trees must be
equal leaf for leaf and the configs equal.  ``infer_config`` is held to
JAX's on shape-only dicts of the full architectures (zero-stride numpy
arrays, no memory).  ``clip.load`` of a checkpoint: features and logits
within float32's 1e-4 (bfloat16: 3e-2 and a cosine of 0.999) of the
largest entry.  No test downloads anything: ``RPO_TPU_ALLOW_DOWNLOAD``
is removed from the environment of each.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpo_tpu import clip as jclip
from rpo_tpu.models.clip import convert as jconvert
from rpo_tpu.models.clip import pretrained as jpretrained
from rpo_tpu_torch import clip as tclip
from rpo_tpu_torch.models.clip import ARCHS
from rpo_tpu_torch.models.clip import convert as tconvert
from rpo_tpu_torch.models.clip import pretrained as tpretrained

REL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    """No download, no checkpoint from the environment, an empty cache."""
    for var in ("RPO_TPU_ALLOW_DOWNLOAD", "CLIP_CHECKPOINT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("CLIP_CACHE_DIR", str(tmp_path / "empty_cache"))


def random_state_dict(cfg, seed: int = 0, dtype=np.float32):
    """An OpenAI-layout CLIP state dict of ``cfg`` with random values:
    weights ~ N(0, 1/fan_in), embeddings ~ N(0, 0.02), LayerNorm and BN
    scales ~ 1 +- 0.2, BN means ~ 0 +- 0.1, variances in [0.5, 2), and
    OpenAI's three integer entries."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, shape in tconvert.state_dict_shapes(cfg).items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(0)
            continue
        if key.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif key == "logit_scale":
            a = np.array(np.log(1 / 0.07))
        elif key.endswith(("bias", "running_mean")):
            a = 0.1 * rng.randn(*shape)
        elif len(shape) == 1 and ("ln" in key or "bn" in key or "downsample.1" in key):
            a = 1 + 0.2 * rng.randn(*shape)
        elif "embedding" in key:
            a = 0.02 * rng.randn(*shape)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            a = rng.randn(*shape) / np.sqrt(fan_in)
        sd[key] = torch.from_numpy(np.asarray(a, dtype))
    sd["input_resolution"] = torch.tensor(cfg.image_resolution)
    sd["context_length"] = torch.tensor(cfg.context_length)
    sd["vocab_size"] = torch.tensor(cfg.vocab_size)
    return sd


def to_hf(sd, cfg):
    """The OpenAI-layout ViT dict in HuggingFace ``CLIPModel``'s layout."""
    out = {}

    def blocks(src, dst, n, w):
        for i in range(n):
            s, d = f"{src}.{i}", f"{dst}.{i}"
            out[f"{d}.layer_norm1.weight"] = sd[f"{s}.ln_1.weight"]
            out[f"{d}.layer_norm1.bias"] = sd[f"{s}.ln_1.bias"]
            out[f"{d}.layer_norm2.weight"] = sd[f"{s}.ln_2.weight"]
            out[f"{d}.layer_norm2.bias"] = sd[f"{s}.ln_2.bias"]
            for j, p in enumerate("qkv"):
                out[f"{d}.self_attn.{p}_proj.weight"] = sd[f"{s}.attn.in_proj_weight"][
                    j * w:(j + 1) * w]
                out[f"{d}.self_attn.{p}_proj.bias"] = sd[f"{s}.attn.in_proj_bias"][
                    j * w:(j + 1) * w]
            out[f"{d}.self_attn.out_proj.weight"] = sd[f"{s}.attn.out_proj.weight"]
            out[f"{d}.self_attn.out_proj.bias"] = sd[f"{s}.attn.out_proj.bias"]
            out[f"{d}.mlp.fc1.weight"] = sd[f"{s}.mlp.c_fc.weight"]
            out[f"{d}.mlp.fc1.bias"] = sd[f"{s}.mlp.c_fc.bias"]
            out[f"{d}.mlp.fc2.weight"] = sd[f"{s}.mlp.c_proj.weight"]
            out[f"{d}.mlp.fc2.bias"] = sd[f"{s}.mlp.c_proj.bias"]

    out["text_model.embeddings.token_embedding.weight"] = sd["token_embedding.weight"]
    out["text_model.embeddings.position_embedding.weight"] = sd["positional_embedding"]
    blocks("transformer.resblocks", "text_model.encoder.layers", cfg.text_layers,
           cfg.text_width)
    out["text_model.final_layer_norm.weight"] = sd["ln_final.weight"]
    out["text_model.final_layer_norm.bias"] = sd["ln_final.bias"]
    out["text_projection.weight"] = sd["text_projection"].T.contiguous()
    out["vision_model.embeddings.class_embedding"] = sd["visual.class_embedding"]
    out["vision_model.embeddings.patch_embedding.weight"] = sd["visual.conv1.weight"]
    out["vision_model.embeddings.position_embedding.weight"] = sd[
        "visual.positional_embedding"]
    out["vision_model.pre_layrnorm.weight"] = sd["visual.ln_pre.weight"]
    out["vision_model.pre_layrnorm.bias"] = sd["visual.ln_pre.bias"]
    blocks("visual.transformer.resblocks", "vision_model.encoder.layers", cfg.vision_layers,
           cfg.vision_width)
    out["vision_model.post_layernorm.weight"] = sd["visual.ln_post.weight"]
    out["vision_model.post_layernorm.bias"] = sd["visual.ln_post.bias"]
    out["visual_projection.weight"] = sd["visual.proj"].T.contiguous()
    out["logit_scale"] = sd["logit_scale"]
    return out


def save_checkpoint(path, arch: str, variant: str = "openai", seed: int = 0,
                    dtype=np.float32) -> str:
    """A random ``arch`` checkpoint written with ``torch.save``: the plain
    OpenAI state dict, the open_clip envelope or (ViT) HF's layout."""
    cfg = ARCHS[arch]
    sd = random_state_dict(cfg, seed, dtype)
    if variant == "open_clip":
        sd = {"epoch": 3, "name": "run",
              "state_dict": {f"module.{k}": v for k, v in sd.items()}}
    elif variant == "hf":
        sd = to_hf(sd, cfg)
    torch.save(sd, str(path))
    return str(path)


def _pairs(t_tree, j_tree, path=()):
    """(path, port tensor, JAX array) for every leaf; lists stay lists."""
    if isinstance(j_tree, dict):
        assert isinstance(t_tree, dict) and set(t_tree) == set(j_tree), path
        for k in sorted(j_tree):
            yield from _pairs(t_tree[k], j_tree[k], path + (k,))
    elif isinstance(j_tree, list):
        assert isinstance(t_tree, list) and len(t_tree) == len(j_tree), path
        for i, (t, j) in enumerate(zip(t_tree, j_tree)):
            yield from _pairs(t, j, path + (i,))
    else:
        yield path, t_tree, j_tree


CASES = [("TINY_RN", "openai"), ("TINY_RN", "open_clip"), ("TINY", "openai"),
         ("TINY", "open_clip"), ("TINY", "hf")]


@pytest.mark.parametrize("arch,variant", CASES)
def test_load_clip_equals_jax(tmp_path, arch, variant):
    path = save_checkpoint(tmp_path / f"{arch}.pt", arch, variant)
    t_params, t_cfg = tconvert.load_clip(path, device="cpu")
    j_params, j_cfg = jconvert.load_clip(path)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.is_vit == (arch == "TINY")
    n = 0
    for path_, t, j in _pairs(t_params, j_params):
        assert t.dtype == torch.float32 and t.device.type == "cpu", path_
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=str(path_))
        n += 1
    assert n > 30


def test_convert_state_dict_of_tensors_equals_jax():
    """``convert_state_dict`` on torch tensors (fp16, as OpenAI ships them)."""
    sd = random_state_dict(ARCHS["TINY_RN"], 1, np.float16)
    for key in ("input_resolution", "context_length", "vocab_size"):
        sd.pop(key)
    t = tconvert.convert_state_dict(sd, device="cpu")
    j = jconvert.convert_state_dict(sd)
    for path_, a, b in _pairs(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(path_))


@pytest.mark.parametrize("arch", ["RN50", "RN101", "RN50x4", "RN50x16", "ViT-B/16", "ViT-B/32"])
def test_infer_config_equals_jax(arch):
    shapes = tconvert.state_dict_shapes(ARCHS[arch])
    sd = {k: np.broadcast_to(np.float32(0), s) for k, s in shapes.items()}
    got = tconvert.infer_config(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(jconvert.infer_config(sd))
    assert got == ARCHS[arch]


def test_infer_config_refuses_what_is_not_clip():
    for convert in (tconvert, jconvert):
        with pytest.raises(ValueError, match="not a recognizable CLIP checkpoint"):
            convert.infer_config({"foo.weight": np.zeros(3)})


def _resolve(module, name):
    try:
        return ("path", module.find_checkpoint(name))
    except FileNotFoundError as e:
        return ("FileNotFoundError", str(e).split(" does not exist")[0])


def test_find_checkpoint_order_equals_jax(tmp_path, monkeypatch, capsys):
    """Explicit file, missing explicit file, the canonical cache name, each
    alternate name, nothing: the same answer and the same warning."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("CLIP_CACHE_DIR", str(cache))
    both = lambda name: (_resolve(tpretrained, name), _resolve(jpretrained, name))  # noqa: E731

    for name in ("RN50", "ViT-B/16", "TINY"):
        t, j = both(name)
        assert t == j == ("path", None)
    for alt, name in (("RN50.bin", "RN50"), ("RN50.safetensors", "RN50"),
                      ("clip-vit-base-patch16.bin", "ViT-B/16"),
                      ("ViT-B-16.safetensors", "ViT-B/16")):
        (cache / alt).write_bytes(b"x")
        t, j = both(name)
        assert t == j == ("path", str(cache / alt)), alt
        (cache / alt).unlink()
    (cache / "RN50.pt").write_bytes(b"custom weights")
    (cache / "RN50.bin").write_bytes(b"x")
    capsys.readouterr()
    t, j = both("RN50")
    assert t == j == ("path", str(cache / "RN50.pt"))  # the canonical name first
    out = capsys.readouterr().out
    assert out.count("does not match the published SHA256") == 2
    explicit = tmp_path / "mine.pt"
    explicit.write_bytes(b"x")
    monkeypatch.setenv("CLIP_CHECKPOINT", str(explicit))
    t, j = both("RN50")
    assert t == j == ("path", str(explicit))
    monkeypatch.setenv("CLIP_CHECKPOINT", str(tmp_path / "missing.pt"))
    t, j = both("RN50")
    assert t == j and t[0] == "FileNotFoundError"


def test_load_backbone_from_checkpoint(tmp_path, monkeypatch, capsys):
    """``$CLIP_CHECKPOINT`` wins over the backbone's name, as in JAX; its
    config comes from the file; ``dtype`` casts all but logit_scale."""
    path = save_checkpoint(tmp_path / "rn.pt", "TINY_RN")
    monkeypatch.setenv("CLIP_CHECKPOINT", path)
    params, cfg = tpretrained.load_backbone("ViT-B/16", dtype=torch.bfloat16, device="cpu")
    assert not cfg.is_vit and f"from {path}" in capsys.readouterr().out
    assert params["visual"]["layers"][0][0]["bn1"]["var"].dtype == torch.bfloat16
    assert params["logit_scale"].dtype == torch.float32
    j_params, j_cfg = jpretrained.load_backbone("ViT-B/16")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)


# -- the user API ------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clip_api")
    return {arch: save_checkpoint(tmp / f"{arch}.pt", arch, seed=2)
            for arch in ("TINY_RN", "TINY")}


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.float().cpu().numpy().astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, big = np.abs(got - want).max(), np.abs(want).max()
    assert err <= REL[dtype] * big, (err, big)
    if dtype == "bfloat16":
        g, w = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
        cos = (g * w).sum(-1) / np.linalg.norm(g, axis=-1) / np.linalg.norm(w, axis=-1)
        assert cos.min() >= 0.999, cos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["TINY_RN", "TINY"])
def test_clip_load_equals_jax(checkpoints, monkeypatch, arch, dtype):
    monkeypatch.setenv("CLIP_CHECKPOINT", checkpoints[arch])
    tdt = {"float32": None, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    t_model, t_pre = tclip.load("RN50", dtype=tdt, require_weights=True, device="cpu")
    j_model, j_pre = jclip.load("RN50", dtype=jdt, require_weights=True)
    assert t_model.visual_input_resolution == j_model.visual_input_resolution == 32
    rng = np.random.RandomState(3)
    raw = [rng.randint(0, 256, (40 + 8 * i, 48, 3)).astype(np.uint8) for i in range(3)]
    from PIL import Image

    t_imgs = np.stack([t_pre(a) for a in raw])
    j_imgs = np.stack([j_pre(Image.fromarray(a)) for a in raw])
    np.testing.assert_allclose(t_imgs, j_imgs, rtol=0, atol=1e-6)
    tokens = tclip.tokenize(["a photo of a cat.", "a diagram", "a dog on a red sofa"])
    np.testing.assert_array_equal(tokens, jclip.tokenize(
        ["a photo of a cat.", "a diagram", "a dog on a red sofa"]))
    _close(t_model.encode_image(t_imgs), j_model.encode_image(j_imgs), dtype)
    _close(t_model.encode_text(tokens), j_model.encode_text(tokens), dtype)
    t_lpi, t_lpt = t_model(t_imgs, tokens)
    j_lpi, _ = j_model(j_imgs, tokens)
    if dtype == "float32":
        _close(t_lpi, j_lpi, dtype)
    else:  # scaled and normalised in bf16 itself: two bf16 ulps of a logit near 14
        np.testing.assert_allclose(t_lpi.float().numpy(), np.asarray(
            j_lpi.astype(jnp.float32)), rtol=0, atol=2 * 2.0 ** -4)
    assert torch.equal(t_lpt, t_lpi.T)


def test_clip_api_surface(tmp_path, monkeypatch, capsys):
    assert tclip.available_models() == jclip.available_models()
    with pytest.raises(FileNotFoundError, match="No checkpoint for 'RN50'"):
        tclip.load("RN50", require_weights=True, device="cpu")
    with pytest.raises(TypeError):
        tclip.load("RN50", "cpu")  # noqa  (the reference's positional device)
    model, pre = tclip.load("TINY_RN", seed=4, device="cpu")
    assert "RANDOM weights" in capsys.readouterr().out
    # a path, a synthetic URI: the same bytes as the array
    from PIL import Image

    arr = np.random.RandomState(5).randint(0, 256, (36, 50, 3)).astype(np.uint8)
    Image.fromarray(arr).save(str(tmp_path / "x.png"))
    np.testing.assert_array_equal(pre(str(tmp_path / "x.png")), pre(arr))
    np.testing.assert_array_equal(pre(Image.fromarray(arr)), pre(arr))
    from rpo_tpu_torch.data.transforms import synth_image

    np.testing.assert_array_equal(pre("synthetic://cat/0"), pre(synth_image("synthetic://cat/0")))
    feats = model.encode_image(pre(arr))  # one HWC image
    assert tuple(feats.shape) == (1, 64) and bool(torch.isfinite(feats).all())
    # the conv kernels are laid out for the convolution once, at load
    kernel = model.params["visual"]["layers"][0][0]["conv2"]
    assert kernel.permute(3, 2, 0, 1).is_contiguous(memory_format=torch.channels_last)


def test_safetensors_checkpoint_equals_jax(tmp_path):
    """A HuggingFace safetensors file (the package is a lazy import)."""
    from safetensors.numpy import save_file

    sd = to_hf(random_state_dict(ARCHS["TINY"], 4), ARCHS["TINY"])
    path = str(tmp_path / "clip-vit-base-patch16.safetensors")
    save_file({k: np.ascontiguousarray(v.numpy()) for k, v in sd.items()}, path)
    t, t_cfg = tconvert.load_clip(path, device="cpu")
    j, j_cfg = jconvert.load_clip(path)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    for path_, a, b in _pairs(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(path_))
