"""cnn_tpu_torch serving against cnn_tpu's, on the CPU, with the committed
BatchNorm AlexNet checkpoint at full width (224 px)."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.serving import BatchingServer as JBatchingServer
from cnn_tpu.serving import InferenceEngine as JInferenceEngine
from cnn_tpu.utils.checkpoint import import_reference_model as j_import
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.ops.hopper import (add_counters, conv2d_bias_relu,
                                      counted_capture, max_pool2d_fwd,
                                      read_counters, reset_launches,
                                      uint8_normalize)
from cnn_tpu_torch.ops.hopper import conv as hconv
from cnn_tpu_torch.ops.hopper import normalize as hnorm
from cnn_tpu_torch.ops.hopper import pool as hpool
from cnn_tpu_torch.ops.preprocess import uint8_to_float
from cnn_tpu_torch.serving import BatchingServer, BucketGraph, InferenceEngine
from cnn_tpu_torch.utils.checkpoint import load_reference_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BN_MODEL = os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                        "iter_12000_train_0.997_valid_0.937.model")
BUCKETS = (1, 8)
CARD_BUCKETS = (1, 8, 64)   # the buckets chip_smoke.py serves on the card


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


@pytest.fixture(scope="module")
def card_bucket_engines():
    """Both engines at the card's buckets, not yet warmed up."""
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=True)
    params, state = j_import(BN_MODEL, jmodel.net)
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="cpu")
    load_reference_model(model, BN_MODEL)
    return (JInferenceEngine(jmodel, params, state, buckets=CARD_BUCKETS),
            InferenceEngine(model, buckets=CARD_BUCKETS, device="cpu"))


def test_warmup_makes_every_bucket_ready_as_jax(card_bucket_engines):
    """JAX's warmup compiles every bucket; the port's runs each once on the
    CPU (on the card it captures each one's graph)."""
    jeng, eng = card_bucket_engines
    assert eng.ready_buckets == ()
    jeng.warmup()
    eng.warmup()
    assert eng.ready_buckets == tuple(sorted(jeng._compiled)) == CARD_BUCKETS
    eng.warmup()                       # nothing left to make ready
    assert eng.ready_buckets == CARD_BUCKETS


@pytest.mark.parametrize("n", [1, 5, 8, 64, 100])
def test_predict_at_the_card_buckets_matches_jax(card_bucket_engines, n):
    """100 images stream one 64-chunk and pad 36 into bucket 64."""
    jeng, eng = card_bucket_engines
    eng.warmup()
    imgs = _images(np.random.default_rng(100 + n), n)
    want_labels, want_probs = jeng.predict(imgs)
    labels, probs = eng.predict(imgs)
    assert labels.shape == (n,) and probs.shape == (n, 3)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(probs, want_probs, atol=1e-5, rtol=0)


def _count_on_meta(monkeypatch):
    """Wrappers on meta tensors take their CUDA branch; launches are dropped
    and counted as on the card."""
    for mod in (hnorm, hconv, hpool):
        monkeypatch.setattr(mod, "cuda_args", lambda *a, **k: 0)
        monkeypatch.setattr(mod, "launch", lambda *a: None)


def test_capture_counts_nothing_and_replays_add_its_launches(monkeypatch):
    """The bookkeeping of a captured bucket, without a graph: the capture's
    wrapper calls are taken back, per counter and variant, and each replay
    adds them."""
    _count_on_meta(monkeypatch)
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="meta")
    eng = InferenceEngine(model, buckets=(8,), device="meta")
    images = torch.empty((8, 224, 224, 3), dtype=torch.uint8, device="meta")
    reset_launches()
    add_counters({"uint8_normalize.launches": 5,
                  "conv2d_bias_relu.launches_direct": 2})
    before = read_counters()
    with torch.no_grad():
        (probs, labels), delta = counted_capture(lambda: eng._forward(images))
    assert probs.shape == (8, 3) and labels.shape == (8,)
    assert read_counters() == before   # the capture counted nothing
    assert delta == {"uint8_normalize.launches": 1,
                     "uint8_normalize.launches_wide": 1,
                     "max_pool2d_fwd.launches": 1,
                     "max_pool2d_fwd.launches_window": 1,
                     "conv2d_bias_relu.launches": 4,
                     "conv2d_bias_relu.launches_strip": 1,
                     "conv2d_bias_relu.launches_tiled": 3}
    for _ in range(3):
        add_counters(delta)
    assert (uint8_normalize.launches, uint8_normalize.launches_wide,
            uint8_normalize.launches_bytes) == (8, 3, 0)
    assert max_pool2d_fwd.launches == 3
    assert (conv2d_bias_relu.launches, conv2d_bias_relu.launches_strip,
            conv2d_bias_relu.launches_tiled,
            conv2d_bias_relu.launches_direct) == (12, 3, 9, 2)
    reset_launches()


class _StubGraph:
    """Stands in for a CUDA graph: a replay writes each row's pixel sum."""

    def __init__(self, images, probs, labels):
        self.images, self.probs, self.labels = images, probs, labels
        self.replays = 0

    def replay(self):
        self.replays += 1
        sums = self.images.reshape(self.images.shape[0], -1).sum(1)
        self.labels.copy_(sums % 3)
        self.probs.copy_(sums.float()[:, None].expand_as(self.probs))


def test_bucket_call_stages_replays_and_counts(engines):
    """``_run``'s card branch on CPU tensors and a stub graph: the chunk is
    staged and its padding zeroed (also rows an earlier, larger request
    left), one replay per call adds the capture's launches, and the first
    rows come back."""
    _, cpu_eng, _ = engines
    eng = InferenceEngine(cpu_eng.model, buckets=(8,), device="cpu")
    eng.device = torch.device("cuda")       # take the graph branch
    shape = (8, *eng.image_shape)
    images = torch.zeros(shape, dtype=torch.uint8)
    probs = torch.zeros((8, 3))
    labels = torch.zeros((8,), dtype=torch.int64)
    graph = _StubGraph(images, probs, labels)
    launches = {"uint8_normalize.launches": 1,
                "uint8_normalize.launches_wide": 1}
    eng._ready[8] = BucketGraph(graph, torch.zeros(shape, dtype=torch.uint8),
                                images, probs, labels, launches)
    with pytest.raises(RuntimeError):
        eng._run(1, np.zeros((1, *eng.image_shape), np.uint8))
    reset_launches()
    rng = np.random.default_rng(3)
    for n in (6, 2, 8, 1):
        chunk = rng.integers(0, 256, (n, *eng.image_shape), dtype=np.uint8)
        got_labels, got_probs = eng.predict(chunk)
        sums = chunk.reshape(n, -1).sum(1, dtype=np.int64)
        np.testing.assert_array_equal(got_labels, sums % 3)
        np.testing.assert_array_equal(got_probs[:, 0], sums.astype(np.float32))
        assert not images[n:].any()          # padding rows are zero
    assert graph.replays == 4
    assert (uint8_normalize.launches, uint8_normalize.launches_wide) == (4, 4)
    reset_launches()


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


def test_labels_carry_cnn_tpu_dtype(engines):
    """5 images in bucket 8: ``predict``'s labels are numpy int32, the
    dtype of ``cnn_tpu``'s ``jnp.argmax``, with its values; through each
    package's ``BatchingServer`` every future's label is the same Python
    int."""
    jeng, eng, _ = engines
    imgs = _images(np.random.default_rng(27), 5)
    want, _ = jeng.predict(imgs)
    labels, _ = eng.predict(imgs)
    assert labels.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(labels, want)
    served = []
    for server, engine in ((JBatchingServer, jeng), (BatchingServer, eng)):
        with server(engine, batch_timeout_ms=20.0) as srv, \
                ThreadPoolExecutor(5) as pool:
            futs = list(pool.map(srv.submit, imgs))
            served.append([f.result(timeout=60)[0] for f in futs])
    assert all(type(label) is int for label in served[1])
    assert served[1] == served[0] == want.tolist()


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
