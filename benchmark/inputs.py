"""What a run feeds the program and the reference, all made from ``--seed``.

- ``seeds``: four independent 32-bit streams of the run's seed (weights,
  trainable state, data, the sample of answers checked).
- ``classnames``: the first n_cls names of a fixed list (English
  adjectives and nouns, one to three words), in an order drawn from the
  seed.  The set, and so every tokenized length, is the same for every
  seed: only which class sits where changes.
- ``state_dict``: a CLIP in OpenAI's layout, drawn on the card by one
  generator in one call and cut into its tensors, in the type served
  (bfloat16; ``logit_scale`` float32).  CLIP's init distributions, with
  LayerNorm scales of 1 + N(0, 0.05) and every bias N(0, 0.02), so that
  the check covers the biases and norms too.
- ``image_pool``: uint8 (n, B, H, W, 3) batches drawn on the card and
  copied to the host once, as a loader hands them over.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

ADJECTIVES = (
    "red green blue yellow black white brown grey golden silver small large tiny giant "
    "wild common spotted striped northern southern eastern western little great royal "
    "mountain desert river forest garden sea snow sand rock marsh swamp prairie arctic "
    "tropical crested horned long short broad narrow painted dusky pale dark bright "
    "hairy smooth curly silky rough sharp round flat hollow lesser greater"
).split()
NOUNS = (
    "fox owl hawk eagle heron crane finch sparrow robin crow raven dove swan goose duck "
    "frog toad newt lizard snake turtle tortoise gecko shark whale dolphin seal otter "
    "beaver badger weasel ferret rabbit hare mouse rat squirrel deer moose elk bison "
    "horse donkey zebra camel goat sheep pig boar bear wolf lion tiger leopard lynx cat "
    "dog hound terrier spaniel poodle beetle moth butterfly bee wasp ant spider crab "
    "lobster shrimp snail clam oyster squid octopus rose tulip lily orchid daisy poppy "
    "violet iris fern moss oak pine maple willow birch cedar palm cactus mushroom "
    "truck car bus train boat ship plane kite drum guitar piano violin lamp chair "
    "table clock bottle cup bowl kettle hammer saw"
).split()


def seeds(seed: int, n: int = 4) -> List[int]:
    """``n`` independent 32-bit seeds of ``seed`` (any whole number; a
    negative one is taken modulo 2**64)."""
    return [int(s) for s in np.random.SeedSequence(int(seed) % 2 ** 64).generate_state(n)]


def name_list(n: int) -> List[str]:
    """The first ``n`` names of the fixed list (a fixed generator)."""
    rng = np.random.default_rng(0)
    names: List[str] = []
    seen = set()
    while len(names) < n:
        words = int(rng.choice([1, 2, 2, 3]))
        name = " ".join([str(rng.choice(ADJECTIVES)) for _ in range(words - 1)]
                        + [str(rng.choice(NOUNS))])
        if name not in seen:
            seen.add(name)
            names.append(name)
    return names


def classnames(n_cls: int, seed: int) -> List[str]:
    names = name_list(n_cls)
    order = np.random.default_rng(seed).permutation(n_cls)
    return [names[i] for i in order]


def vit_layout(clip: dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(key, shape, std, mean) of each tensor of an OpenAI ViT CLIP state
    dict, ``logit_scale`` aside."""
    vw, tw, E = clip["vision_width"], clip["text_width"], clip["embed_dim"]
    P = clip["vision_patch_size"]
    S = (clip["image_resolution"] // P) ** 2 + 1
    out = []

    def ln(prefix, w):
        out.append((f"{prefix}.weight", (w,), 0.05, 1.0))
        out.append((f"{prefix}.bias", (w,), 0.02, 0.0))

    def blocks(prefix, n, w):
        proj_std = w ** -0.5 * (2 * n) ** -0.5
        for i in range(n):
            p = f"{prefix}.{i}"
            ln(f"{p}.ln_1", w)
            out.append((f"{p}.attn.in_proj_weight", (3 * w, w), w ** -0.5, 0.0))
            out.append((f"{p}.attn.in_proj_bias", (3 * w,), 0.02, 0.0))
            out.append((f"{p}.attn.out_proj.weight", (w, w), proj_std, 0.0))
            out.append((f"{p}.attn.out_proj.bias", (w,), 0.02, 0.0))
            ln(f"{p}.ln_2", w)
            out.append((f"{p}.mlp.c_fc.weight", (4 * w, w), (2 * w) ** -0.5, 0.0))
            out.append((f"{p}.mlp.c_fc.bias", (4 * w,), 0.02, 0.0))
            out.append((f"{p}.mlp.c_proj.weight", (w, 4 * w), proj_std, 0.0))
            out.append((f"{p}.mlp.c_proj.bias", (w,), 0.02, 0.0))

    out.append(("visual.conv1.weight", (vw, 3, P, P), vw ** -0.5, 0.0))
    out.append(("visual.class_embedding", (vw,), vw ** -0.5, 0.0))
    out.append(("visual.positional_embedding", (S, vw), vw ** -0.5, 0.0))
    ln("visual.ln_pre", vw)
    blocks("visual.transformer.resblocks", clip["vision_layers"], vw)
    ln("visual.ln_post", vw)
    out.append(("visual.proj", (vw, E), vw ** -0.5, 0.0))
    out.append(("token_embedding.weight", (clip["vocab_size"], tw), 0.02, 0.0))
    out.append(("positional_embedding", (clip["context_length"], tw), 0.01, 0.0))
    blocks("transformer.resblocks", clip["text_layers"], tw)
    ln("ln_final", tw)
    out.append(("text_projection", (tw, E), tw ** -0.5, 0.0))
    return out


def state_dict(clip: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The weights, drawn on ``device`` in one call: OpenAI's layout."""
    layout = vit_layout(clip)
    total = sum(math.prod(shape) for _, shape, _, _ in layout)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    sd, offset = {}, 0
    for key, shape, std, mean in layout:
        n = math.prod(shape)
        sd[key] = (flat[offset:offset + n].view(shape) * std + mean).to(dtype)
        offset += n
    del flat
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=device)
    return sd


def to_host(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.cpu() for k, v in sd.items()}


def as_float32(sd: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device, torch.float32) for k, v in sd.items()}


def image_pool(n: int, B: int, side: int, seed: int, device) -> np.ndarray:
    """(n, B, side, side, 3) uint8 on the host, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, B, side, side, 3), generator=gen, device=device,
                         dtype=torch.uint8).cpu().numpy()


def labels_pool(n: int, B: int, n_cls: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, n_cls, (n, B)).astype(np.int64)


def unit_rows(gen: torch.Generator, n: int, width: int) -> torch.Tensor:
    x = torch.randn(n, width, generator=gen, device=gen.device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def pick(seed: int, population: Sequence[int], k: int) -> List[int]:
    """``k`` items of ``population`` drawn from ``seed``, in order."""
    rng = np.random.default_rng(seed)
    k = min(k, len(population))
    return sorted(int(population[i]) for i in rng.choice(len(population), k, replace=False))


class Phases:
    """Seconds of each phase of a set-up, each ended by ``sync()``:
    ``phases("name")`` closes the phase that ran since the last call."""

    def __init__(self, sync: Callable[[], None]):
        self.sync, self.seen, self.last = sync, [], time.perf_counter()

    def __call__(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.seen.append((name, now - self.last))
        self.last = now
