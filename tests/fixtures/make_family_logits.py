"""Writes ``tests/fixtures/family_logits.npz``: ``cnn_tpu``'s float32
logits for the six 224 px photos of ``reference_parity.npz`` (dog, panda,
bird, twice) from each committed family checkpoint, the newest of each of
``checkpoints/{resnet10,resnet18,mobilenet,pipecnn,moecnn}``. MoECNN's
expert capacity depends on the batch: its logits are those of the six
photos as one batch of 6.

    JAX_PLATFORMS=cpu python tests/fixtures/make_family_logits.py

The images go through ``cnn_tpu``'s ``uint8_to_float`` (true division by
255) and ``model.apply(train=False)`` at ``Precision.HIGHEST``, on the CPU.
``tests/test_torch_family_fixture.py`` recomputes them and holds the file
to them; ``chip_smoke.py`` holds the port on the card to the file (phase
17), which chains the card to JAX with no JAX on the card.
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
FAMILIES = ("resnet10", "resnet18", "mobilenet", "pipecnn", "moecnn")
OUT = os.path.join(HERE, "family_logits.npz")


def newest_checkpoint(name: str) -> str:
    """The committed ``.ckpt`` of ``name`` with the highest iteration, as a
    path relative to the repo."""
    paths = glob.glob(os.path.join(REPO, "checkpoints", name, "iter_*.ckpt"))
    best = max(paths, key=lambda p: int(os.path.basename(p).split("_")[1]))
    return os.path.relpath(best, REPO)


def photos() -> np.ndarray:
    fx = np.load(os.path.join(HERE, "reference_parity.npz"))
    return np.stack([fx[f"image_u8_{i}"] for i in range(6)])


def family_logits(name: str) -> np.ndarray:
    """``cnn_tpu``'s float32 logits [6, 3] for the photos from ``name``'s
    newest committed checkpoint."""
    import jax.numpy as jnp
    from cnn_tpu.models import get_model
    from cnn_tpu.ops.preprocess import uint8_to_float
    from cnn_tpu.utils.checkpoint import load_checkpoint

    ts = load_checkpoint(os.path.join(REPO, newest_checkpoint(name)))
    model = get_model(name, num_classes=3, image_size=224, batch_norm=True)
    logits, _, _ = model.apply(ts.params, ts.state,
                               uint8_to_float(jnp.asarray(photos())),
                               train=False)
    return np.asarray(logits, np.float32)


def main() -> int:
    sys.path.insert(0, REPO)
    out = {}
    for name in FAMILIES:
        out[f"{name}_logits"] = family_logits(name)
        out[f"{name}_checkpoint"] = np.array(newest_checkpoint(name))
    fx = np.load(os.path.join(HERE, "reference_parity.npz"))
    out["labels"] = np.array([int(fx[f"label_{i}"]) for i in range(6)])
    if os.path.exists(OUT):
        # the arrays already written stay as they are, bit for bit
        old = np.load(OUT)
        changed = [k for k in old.files if not np.array_equal(old[k], out[k])]
        if changed:
            print(f"refusing to rewrite {OUT}: {changed} differ from the "
                  "file", file=sys.stderr)
            return 1
    np.savez_compressed(OUT, **out)
    for name in FAMILIES:
        print(name, out[f"{name}_checkpoint"], out[f"{name}_logits"].argmax(1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
