"""Writes the JPEG fixtures beside this file with Pillow, from a seed.

    python tests/torch_port_data/make_fixtures.py

Eight images, two each at 224x224, 500x375, 300x500 and 64x64 (width x
height): smooth seeded patterns (a few sinusoids and a coarse noise field
upsampled), so that they compress to a few kilobytes and still differ
pixel by pixel.  chip_smoke.py copies them into its dataset trees, since
the machine with the card may have no JPEG encoder; the CPU tests read
them too.
"""
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
SIZES = [(224, 224), (500, 375), (300, 500), (64, 64)]  # (width, height)
SEED = 0
QUALITY = 85


def pattern(rng: np.random.RandomState, w: int, h: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(3):
            fx, fy = rng.uniform(0.5, 6.0, 2) * 2 * np.pi
            phase = rng.uniform(0, 2 * np.pi)
            img[..., c] += np.sin(fx * x / w + fy * y / h + phase)
    coarse = rng.uniform(-1, 1, (8, 8, 3))
    ys = (np.arange(h) * 8 // h)[:, None]
    xs = (np.arange(w) * 8 // w)[None, :]
    img += 1.5 * coarse[ys, xs]
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).round().astype(np.uint8)


def main() -> None:
    rng = np.random.RandomState(SEED)
    for w, h in SIZES:
        for i in range(2):
            path = os.path.join(HERE, f"img_{w}x{h}_{i}.jpg")
            Image.fromarray(pattern(rng, w, h)).save(path, quality=QUALITY)
            print(path, os.path.getsize(path))


if __name__ == "__main__":
    main()
