"""``tests/fixtures/family_logits.npz`` holds ``cnn_tpu``'s float32 logits
for the six photos of ``reference_parity.npz`` at 224 px from each
committed family checkpoint; ``chip_smoke.py`` holds the port on the card
to it. Here JAX recomputes them (``make_family_logits.py``) and the file
is held to them, and the port on the CPU is held to the file."""

import os
import sys

import numpy as np
import pytest
import torch

from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.parallel.train_step import prep
from cnn_tpu_torch.utils import checkpoint as ckpt

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, FIXTURES)
import make_family_logits as maker  # noqa: E402

FIXTURE = np.load(os.path.join(FIXTURES, "family_logits.npz"))
LOGIT_TOL = 1e-4     # times max(1, max|ref|)


@pytest.mark.parametrize("name", maker.FAMILIES)
def test_fixture_is_what_cnn_tpu_computes(name):
    """The file against ``cnn_tpu`` recomputed now: the same checkpoint,
    logits within 1e-6 x max(1, max|ref|) (XLA's CPU sums, run again)."""
    assert str(FIXTURE[f"{name}_checkpoint"]) == maker.newest_checkpoint(name)
    want = maker.family_logits(name)
    got = FIXTURE[f"{name}_logits"]
    assert got.shape == (6, 3)
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


def test_port_on_the_cpu_matches_the_fixture():
    """resnet10's plain versions from the same checkpoint on the uint8
    photos (divided by 255, as ``make_forward`` does): logits within 1e-4 x
    max(1, max|ref|) of the file, the six photos classified as it says.
    The other families are held to the file on the card."""
    model = get_model("resnet10", num_classes=3, image_size=224,
                      batch_norm=True, device="cpu")
    payload = ckpt.read_checkpoint(os.path.join(
        maker.REPO, str(FIXTURE["resnet10_checkpoint"])))
    ckpt.load_jax_params(model, payload["params"], payload["state"])
    model.eval()
    with torch.no_grad():
        logits = model(prep(torch.from_numpy(maker.photos()))).numpy()
    want = FIXTURE["resnet10_logits"]
    assert np.abs(logits - want).max() <= LOGIT_TOL * max(
        1.0, np.abs(want).max())
    assert (logits.argmax(1) == want.argmax(1)).all()


def test_port_on_the_cpu_matches_the_moecnn_fixture():
    """MoECNN's plain versions from the committed checkpoint on the six
    photos as one batch (its expert capacity is that batch's): logits
    within 1e-4 x max(1, max|ref|) of the file, the same classes, and
    every photo's top-2 router probabilities more than 1e-4 apart, so that
    no route can flip under another sum order."""
    model = get_model("moecnn", num_classes=3, image_size=224,
                      batch_norm=True, device="cpu")
    payload = ckpt.read_checkpoint(os.path.join(
        maker.REPO, str(FIXTURE["moecnn_checkpoint"])))
    ckpt.load_jax_params(model, payload["params"], payload["state"])
    model.eval()
    with torch.no_grad():
        logits, feats = model(prep(torch.from_numpy(maker.photos())),
                              capture=("gap",))
        probs = torch.softmax(feats["gap"] @ model.net["moe"].router, -1)
    top2 = probs.sort(dim=-1).values[:, -2:]
    assert float((top2[:, 1] - top2[:, 0]).min()) > 1e-4
    want = FIXTURE["moecnn_logits"]
    assert np.abs(logits.numpy() - want).max() <= LOGIT_TOL * max(
        1.0, np.abs(want).max())
    assert (logits.numpy().argmax(1) == want.argmax(1)).all()
