"""The serving engine's int8 mode, folded models and ``predict_stream``
against ``cnn_tpu``'s engine on the CPU, with the committed ResNet10 at 64
px (its global average pool runs the full-width weights at any size)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.quant import fold_batchnorm as j_fold
from cnn_tpu.serving import InferenceEngine as JInferenceEngine
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.quant import QuantizedModel, fold_batchnorm
from cnn_tpu_torch.serving import InferenceEngine
from cnn_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = sorted(glob.glob(os.path.join(REPO, "checkpoints", "resnet10",
                                     "iter_*.ckpt")),
              key=lambda p: int(os.path.basename(p).split("_")[1]))[-1]
SIZE = 64
BUCKETS = (1, 8)
FOLD_TOL = 1e-5        # times max(1, max|ref|): the folding re-associates


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def weights():
    payload = ckpt.read_checkpoint(CKPT)
    jm = j_get_model("resnet10", num_classes=3, image_size=SIZE,
                     batch_norm=True)
    model = get_model("resnet10", num_classes=3, image_size=SIZE,
                      batch_norm=True, device="cpu")
    ckpt.load_jax_params(model, payload["params"], payload["state"])
    return jm, payload["params"], payload["state"], model.eval()


def test_int8_engine_matches_cnn_tpu(weights):
    """``InferenceEngine(int8_calib=)`` against ``cnn_tpu``'s int8 engine,
    both calibrated on the same 8 images: the same labels, probabilities
    within 1e-5 (on these images every quantized activation of the two
    sides is the same level), at both buckets and past the top one."""
    jm, params, state, model = weights
    calib = _images(8, seed=1)
    jeng = JInferenceEngine(jm, params, state, buckets=BUCKETS,
                            int8_calib=calib)
    eng = InferenceEngine(model, buckets=BUCKETS, device="cpu",
                          int8_calib=calib)
    assert isinstance(eng.model, QuantizedModel)
    assert eng.model.folded.net["block_2"].proj is not None
    imgs = _images(11, seed=2)
    for n in (1, 5, 11):
        jl, jp = jeng.predict(imgs[:n])
        labels, probs = eng.predict(imgs[:n])
        assert np.array_equal(labels, np.asarray(jl))
        assert np.abs(probs - np.asarray(jp)).max() <= 1e-5


def test_int8_engine_stays_near_float32(weights):
    """``cnn_tpu``'s task bar for int8: probabilities within 0.1 of the
    float32 engine's."""
    *_, model = weights
    calib = _images(8, seed=1)
    imgs = _images(8, seed=3)
    f32 = InferenceEngine(model, buckets=BUCKETS, device="cpu")
    int8 = InferenceEngine(model, buckets=BUCKETS, device="cpu",
                           int8_calib=calib)
    assert np.abs(int8.predict(imgs)[1] - f32.predict(imgs)[1]).max() < 0.1


def test_folded_model_is_served_as_a_model(weights):
    """A ``FoldedModel`` passed to the engine: its probabilities within
    1e-5 x max(1, max|ref|) of ``cnn_tpu``'s engine on its folded model,
    and of the unfolded engine, the same labels."""
    jm, params, state, model = weights
    jfold, jparams = j_fold(jm, params, state)
    jeng = JInferenceEngine(jfold, jparams, {}, buckets=BUCKETS)
    eng = InferenceEngine(fold_batchnorm(model), buckets=BUCKETS,
                          device="cpu")
    plain = InferenceEngine(model, buckets=BUCKETS, device="cpu")
    imgs = _images(6, seed=4)
    labels, probs = eng.predict(imgs)
    jl, jp = jeng.predict(imgs)
    pl, pp = plain.predict(imgs)
    assert np.array_equal(labels, np.asarray(jl))
    assert np.array_equal(labels, pl)
    assert np.abs(probs - np.asarray(jp)).max() <= FOLD_TOL
    assert np.abs(probs - pp).max() <= FOLD_TOL


@pytest.mark.parametrize("int8", [False, True])
def test_predict_stream_is_predict_bit_for_bit(weights, int8):
    """``predict_stream`` yields, in submission order, what ``predict``
    gives each image alone, bit for bit; with ``depth`` 3 over 7 images,
    as ``cnn_tpu``'s does (its labels equal)."""
    jm, params, state, model = weights
    calib = _images(8, seed=1) if int8 else None
    eng = InferenceEngine(model, buckets=BUCKETS, device="cpu",
                          int8_calib=calib)
    jeng = JInferenceEngine(jm, params, state, buckets=BUCKETS,
                            int8_calib=calib)
    imgs = _images(7, seed=5)
    eng.warmup()
    got = list(eng.predict_stream(iter(imgs), depth=3))
    assert len(got) == len(imgs)
    jgot = list(jeng.predict_stream(iter(imgs), depth=3))
    for img, (label, probs), (jlabel, _) in zip(imgs, got, jgot):
        want_l, want_p = eng.predict(img[None])
        assert isinstance(label, int) and label == int(want_l[0]) == jlabel
        assert np.array_equal(probs, want_p[0])


def test_predict_stream_takes_the_smallest_configured_bucket(weights):
    """With buckets (4, 8) each streamed image runs padded in bucket 4, as
    ``predict`` runs a single image: bit-equal."""
    *_, model = weights
    eng = InferenceEngine(model, buckets=(8, 4), device="cpu")
    imgs = _images(3, seed=6)
    for img, (label, probs) in zip(imgs, eng.predict_stream(imgs, depth=2)):
        want_l, want_p = eng.predict(img[None])
        assert label == int(want_l[0])
        assert np.array_equal(probs, want_p[0])
