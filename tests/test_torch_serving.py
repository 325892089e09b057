"""cnn_tpu_torch serving against cnn_tpu's, on the CPU, with the committed
BatchNorm AlexNet checkpoint at full width (224 px)."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.serving import InferenceEngine as JInferenceEngine
from cnn_tpu.utils.checkpoint import import_reference_model as j_import
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.ops.preprocess import uint8_to_float
from cnn_tpu_torch.serving import BatchingServer, InferenceEngine
from cnn_tpu_torch.utils.checkpoint import load_reference_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BN_MODEL = os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                        "iter_12000_train_0.997_valid_0.937.model")
BUCKETS = (1, 8)


def _images(rng, n):
    # 7x7 colour blocks plus pixel noise: uniform noise alone saturates the
    # checkpoint's softmax to exact one-hots, which would compare nothing
    lo = rng.integers(0, 256, (n, 7, 7, 3)).astype(np.float32)
    img = np.kron(lo, np.ones((1, 32, 32, 1), np.float32))
    return (0.75 * img + 0.25 * rng.integers(0, 256, (n, 224, 224, 3))
            ).astype(np.uint8)


@pytest.fixture(scope="module")
def engines():
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=True)
    params, state = j_import(BN_MODEL, jmodel.net)
    jeng = JInferenceEngine(jmodel, params, state, buckets=BUCKETS)
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="cpu")
    load_reference_model(model, BN_MODEL)
    return jeng, InferenceEngine(model, buckets=BUCKETS, device="cpu"), \
        (jmodel, params, state)


@pytest.mark.parametrize("n", [3, 10])
def test_predict_matches_jax(engines, n):
    """3 images pad into bucket 8; 10 stream one top-bucket chunk of 8 and
    pad the remaining 2 into bucket 8."""
    jeng, eng, _ = engines
    imgs = _images(np.random.default_rng(n), n)
    want_labels, want_probs = jeng.predict(imgs)
    labels, probs = eng.predict(imgs)
    assert labels.shape == (n,) and probs.shape == (n, 3)
    assert probs.dtype == np.float32
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(probs, want_probs, atol=1e-5, rtol=0)
    assert 0.01 < probs.max(-1).min() < 0.999    # the softmax is not saturated


def test_full_width_logits_match_jax(engines):
    _, eng, (jmodel, params, state) = engines
    imgs = _images(np.random.default_rng(7), 4)
    x = imgs.astype(np.float32) / np.float32(255.0)
    want, _, _ = jmodel.apply(params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = eng.model(uint8_to_float(torch.from_numpy(imgs))).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_predict_rejects_bad_input(engines):
    _, eng, _ = engines
    for bad in (np.zeros((2, 64, 64, 3), np.uint8),
                np.zeros((2, 224, 224, 3), np.float32),
                np.zeros((0, 224, 224, 3), np.uint8)):
        with pytest.raises(ValueError):
            eng.predict(bad)


def test_batching_server_matches_predict(engines):
    _, eng, _ = engines
    imgs = _images(np.random.default_rng(11), 6)
    labels, probs = eng.predict(imgs)
    with BatchingServer(eng, batch_timeout_ms=20.0) as srv, \
            ThreadPoolExecutor(6) as pool:
        futs = list(pool.map(srv.submit, imgs))
        answers = [f.result(timeout=60) for f in futs]
        bad = srv.submit(np.zeros((3, 3), np.uint8))
        with pytest.raises(ValueError):
            bad.result(timeout=60)
    for i, (label, p) in enumerate(answers):
        assert label == labels[i]
        np.testing.assert_allclose(p, probs[i], atol=1e-5, rtol=0)
    assert srv._worker is None
