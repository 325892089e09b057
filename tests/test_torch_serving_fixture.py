"""``tests/fixtures/serving_logits.npz`` holds ``cnn_tpu``'s folded float32
logits and int8 probabilities (calibrated on the six photos) at 224 px for
the five models ``chip_smoke.py`` serves folded and in int8 on the card,
which holds the port to the file. Here JAX recomputes the file
(``make_serving_logits.py``) and the port on the CPU is held to it, on the
bars the card uses."""

import os
import sys

import numpy as np
import pytest
import torch

from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.quant import fold_batchnorm, make_int8_forward
from cnn_tpu_torch.utils import checkpoint as ckpt

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, FIXTURES)
import make_serving_logits as maker  # noqa: E402

FIXTURE = np.load(os.path.join(FIXTURES, "serving_logits.npz"))
FOLD_TOL = 1e-4      # times max(1, max|ref|): the float32 logit bar
# int8 probabilities, absolute: each side calibrates from its own float32
# activations, whose absmaxes can sit an ulp apart and flip a level that
# a deep trunk carries on (test_torch_quant.py); measured here at most
# 1.24e-4 (pipecnn), the other models below 3e-7
INT8_PROB_TOL = 1e-2


@pytest.mark.parametrize("name", maker.MODELS)
def test_fixture_is_what_cnn_tpu_computes(name):
    """The file against ``cnn_tpu`` recomputed now: the same checkpoint,
    folded logits within 1e-6 x max(1, max|ref|), int8 probabilities
    within 1e-6 (XLA's CPU sums, run again)."""
    assert str(FIXTURE[f"{name}_checkpoint"]) == maker.checkpoint(name)
    logits, probs = maker.serving_values(name)
    got = FIXTURE[f"{name}_folded_logits"]
    assert got.shape == (6, 3)
    assert np.abs(got - logits).max() <= 1e-6 * max(1.0,
                                                    np.abs(logits).max())
    assert np.abs(FIXTURE[f"{name}_int8_probs"] - probs).max() <= 1e-6


def _model(name):
    model = get_model(name, num_classes=3, image_size=224, batch_norm=True,
                      device="cpu")
    path = os.path.join(maker.REPO, str(FIXTURE[f"{name}_checkpoint"]))
    if name == "alexnet":
        ckpt.load_reference_model(model, path)
    else:
        payload = ckpt.read_checkpoint(path)
        ckpt.load_jax_params(model, payload["params"], payload["state"])
    return model.eval()


@pytest.mark.parametrize("name", maker.MODELS)
def test_port_on_the_cpu_matches_the_fixture(name):
    """The port's folded model on the photos (one batch of 6, divided by
    255): logits within 1e-4 x max(1, max|ref|) of the file, the same
    classes; its int8 forward calibrated on the same photos: probabilities
    within 1e-2 of the file, the same classes."""
    model = _model(name)
    imgs = maker.photos()
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        logits = fold_batchnorm(model)(x.float() / 255.0).numpy()
    want = FIXTURE[f"{name}_folded_logits"]
    assert np.abs(logits - want).max() <= FOLD_TOL * max(
        1.0, np.abs(want).max())
    assert (logits.argmax(1) == want.argmax(1)).all()
    probs = make_int8_forward(model, imgs)(x).numpy()
    want = FIXTURE[f"{name}_int8_probs"]
    assert np.abs(probs - want).max() <= INT8_PROB_TOL
    assert (probs.argmax(1) == want.argmax(1)).all()
