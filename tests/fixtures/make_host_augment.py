"""Writes ``tests/fixtures/host_augment.npz``: a few seeded images under
200 px and what ``cnn_tpu``'s ``ImageAugmentor`` (through cv2's
``warpAffine``) makes of each, for the generators the loader would give
positions 0, 1, 6 and 9 of epoch 0 (``np.random.default_rng((212, 0, pos))``).

    JAX_PLATFORMS=cpu python tests/fixtures/make_host_augment.py

Keys: ``img<i>`` the images, ``out<i>_<pos>`` the augmented ones. Run
again, it writes the same arrays (cv2 5.0.0, where cv2 runs its AVX-512
build: ``cnn_tpu_torch/data/augment.py``). ``tests/test_torch_host_augment.py``
recomputes them with cv2 and holds the port to the file, and
``chip_smoke.py`` phase 22 holds the port to it on the card's machine,
which has no cv2.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "host_augment.npz")
SHAPES = ((120, 160), (97, 131), (64, 64), (181, 150))
SEED = 212      # the loader's default seed
POSITIONS = (0, 1, 6, 9)   # rotate+hflip, hflip+crop, and all four ops twice


def images() -> list:
    """Blocks of colour plus noise, seeded."""
    rng = np.random.default_rng(0)
    out = []
    for h, w in SHAPES:
        lo = rng.integers(0, 200, (-(-h // 8), -(-w // 8), 3))
        img = np.kron(lo, np.ones((8, 8, 1)))[:h, :w]
        img = img + rng.integers(0, 56, (h, w, 3))
        out.append(img.clip(0, 255).astype(np.uint8))
    return out


def augmented(augmentor, imgs) -> dict:
    """``{"img<i>": image, "out<i>_<pos>": augmentor(image, rng(pos))}``."""
    arrays = {}
    for i, img in enumerate(imgs):
        arrays[f"img{i}"] = img
        for pos in POSITIONS:
            rng = np.random.default_rng((SEED, 0, pos))
            arrays[f"out{i}_{pos}"] = np.ascontiguousarray(augmentor(img, rng))
    return arrays


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from cnn_tpu.data.augment import ImageAugmentor
    np.savez_compressed(OUT, **augmented(ImageAugmentor(), images()))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
