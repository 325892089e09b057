"""Writes ``tests/fixtures/serving_logits.npz``: ``cnn_tpu``'s serving
transforms on the six 224 px photos of ``reference_parity.npz`` (dog,
panda, bird, twice) for the five models that ``chip_smoke.py`` serves
folded and in int8: the BN AlexNet from the committed
``alexnet_bn_device/iter_12000`` ``.model``, and the newest committed
``.ckpt`` of resnet10, mobilenet, pipecnn and moecnn.

    JAX_PLATFORMS=cpu python tests/fixtures/make_serving_logits.py

Per model: ``<name>_folded_logits``, the float32 logits of
``cnn_tpu.quant.fold_batchnorm``'s model (``apply``, ``Precision.HIGHEST``);
``<name>_int8_probs``, the softmax probabilities of
``cnn_tpu.quant.make_int8_forward`` calibrated on the same six photos;
``<name>_checkpoint``, the file read. The images go through true division
by 255, as ``cnn_tpu``'s serving does. MoECNN's expert capacity depends on
the batch: its values are those of the six photos as one batch of 6.
``tests/test_torch_serving_fixture.py`` recomputes them and holds the port
on the CPU to the file; ``chip_smoke.py`` holds the port on the card to it
(phase 21), with no JAX on the card.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
MODELS = ("alexnet", "resnet10", "mobilenet", "pipecnn", "moecnn")
ALEXNET = os.path.join("checkpoints", "alexnet_bn_device",
                       "iter_12000_train_0.997_valid_0.937.model")
OUT = os.path.join(HERE, "serving_logits.npz")


def checkpoint(name: str) -> str:
    """The file ``name``'s weights come from, relative to the repo."""
    if name == "alexnet":
        return ALEXNET
    sys.path.insert(0, HERE)
    import make_family_logits
    return make_family_logits.newest_checkpoint(name)


def photos() -> np.ndarray:
    fx = np.load(os.path.join(HERE, "reference_parity.npz"))
    return np.stack([fx[f"image_u8_{i}"] for i in range(6)])


def weights(name: str):
    """``cnn_tpu``'s model at 224 px and its (params, state)."""
    from cnn_tpu.models import get_model
    from cnn_tpu.utils.checkpoint import (import_reference_model,
                                          load_checkpoint)

    model = get_model(name, num_classes=3, image_size=224, batch_norm=True)
    path = os.path.join(REPO, checkpoint(name))
    if name == "alexnet":
        return (model, *import_reference_model(path, model.net))
    ts = load_checkpoint(path)
    return model, ts.params, ts.state


def serving_values(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(folded float32 logits [6, 3], int8 probabilities [6, 3])."""
    import jax
    import jax.numpy as jnp
    from cnn_tpu.quant import fold_batchnorm, make_int8_forward

    model, params, state = weights(name)
    imgs = photos()
    folded, fparams = fold_batchnorm(model, params, state)
    x = jnp.asarray(imgs).astype(jnp.float32) / 255.0
    logits = jax.jit(lambda p, x: folded.apply(p, {}, x)[0])(fparams, x)
    probs = make_int8_forward(model, params, state, imgs)(jnp.asarray(imgs))
    return np.asarray(logits, np.float32), np.asarray(probs, np.float32)


def main() -> int:
    sys.path.insert(0, REPO)
    out = {}
    for name in MODELS:
        logits, probs = serving_values(name)
        out[f"{name}_folded_logits"] = logits
        out[f"{name}_int8_probs"] = probs
        out[f"{name}_checkpoint"] = np.array(checkpoint(name))
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
    for name in MODELS:
        print(name, out[f"{name}_checkpoint"],
              out[f"{name}_folded_logits"].argmax(1),
              out[f"{name}_int8_probs"].argmax(1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
