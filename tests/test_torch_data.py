"""The port's host data path against cnn_tpu's, on the CPU: the config
dataclasses and their flags, dataset discovery and split, decode and resize
against cv2, the DataLoader's batches and DeviceDataset.epoch_batches."""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from cnn_tpu.core import config as j_config
from cnn_tpu.data.dataset import discover_dataset as j_discover
from cnn_tpu.data.dataset import split_dataset as j_split
from cnn_tpu.data.device_dataset import DeviceDataset as JDeviceDataset
from cnn_tpu.data.loader import DataLoader as JDataLoader
from cnn_tpu_torch.core import config
from cnn_tpu_torch.data import (DataLoader, DeviceDataset, discover_dataset,
                                split_dataset)
from cnn_tpu_torch.data.image import imread, resize

CATEGORIES = ("dog", "panda", "bird")
# (height, width) of the written images: downscales to 64 px, upscales,
# an exact 2x, and a non-square one
SHAPES = [(80, 72), (48, 56), (128, 128), (64, 64), (90, 100), (33, 47)]
EXTS = (".png", ".jpg", ".ppm")

FLAGSHIP = ["--device-dataset", "true", "--augment-mode", "full",
            "--compute-dtype", "bfloat16", "--batch-norm", "true",
            "--optimizer", "momentum", "--learning-rate", "1.5e-2",
            "--lr-schedule", "cosine", "--train-batch-size", "256",
            "--total-iters", "60000", "--checkpoint-dir", "ck"]
# the argvs of tests/test_cli.py's train runs
CLI_ARGVS = [
    ["--total-iters", "4", "--valid-iters", "2", "--save-iters", "2",
     "--train-batch-size", "4", "--valid-batch-size", "32",
     "--checkpoint-dir", "ck", "--augment", "false", "--cache", "true",
     "--num-workers", "2"],
    ["--name", "resnet10", "--total-iters", "4", "--valid-iters", "4",
     "--save-iters", "4", "--train-batch-size", "8",
     "--valid-batch-size", "64", "--image-size", "64", "--num-workers", "2",
     "--checkpoint-dir", "ck"],
    ["--total-iters", "4", "--valid-iters", "4", "--save-iters", "4",
     "--train-batch-size", "8", "--valid-batch-size", "64",
     "--checkpoint-dir", "ck", "--device-dataset", "true",
     "--canvas-size", "64", "--image-size", "61", "--steps-per-call", "2",
     "--num-workers", "2"],
    ["--name", "pipecnn", "--batch-norm", "true", "--image-size", "32",
     "--total-iters", "4", "--valid-iters", "4", "--save-iters", "4",
     "--train-batch-size", "8", "--valid-batch-size", "64",
     "--pipeline-stages", "4", "--microbatches", "2",
     "--data-parallel", "2", "--pipeline-schedule", "1f1b",
     "--checkpoint-dir", "ck", "--augment", "false", "--cache", "true",
     "--num-workers", "2"],
    ["--categories", "dog,bird", "--split-seed", "3", "--ema", "0.99",
     "--multihost", "yes", "--donate", "0", "--resume", "auto"],
]


def write_dataset(root, per_class: int = 10, seed: int = 0):
    """``root/<category>/<i><ext>`` written by cv2: 8x8 blocks of colour
    with the label's channel raised, plus noise; PNG, JPEG and PPM at the
    sizes of ``SHAPES``."""
    rng = np.random.default_rng(seed)
    for c, cat in enumerate(CATEGORIES):
        os.makedirs(os.path.join(root, cat), exist_ok=True)
        for i in range(per_class):
            h, w = SHAPES[i % len(SHAPES)]
            lo = rng.integers(0, 160, (-(-h // 8), -(-w // 8), 3))
            lo[..., c] += 90
            img = np.kron(lo, np.ones((8, 8, 1)))[:h, :w]
            img = img * 0.75 + rng.integers(0, 64, (h, w, 3))
            cv2.imwrite(os.path.join(root, cat, f"{i}{EXTS[i % 3]}"),
                        img.clip(0, 255).astype(np.uint8))
    return str(root)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("animals"))


@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig", "TrainConfig"])
def test_config_fields_match_cnn_tpu(name):
    got = dataclasses.fields(getattr(config, name))
    want = dataclasses.fields(getattr(j_config, name))
    assert [(f.name, f.default, str(f.type)) for f in got] == \
        [(f.name, f.default, str(f.type)) for f in want]


@pytest.mark.parametrize("argv", [[], FLAGSHIP] + CLI_ARGVS)
def test_argv_parses_to_equal_configs(argv):
    got = config.parse_configs(argv)[:3]
    want = j_config.parse_configs(argv)[:3]
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_split_matches_cnn_tpu(dataset):
    samples = discover_dataset(dataset, CATEGORIES)
    assert samples == j_discover(dataset, CATEGORIES)
    for seed in (212, 3):
        assert split_dataset(samples, 0.8, 0.1, seed) == \
            j_split(samples, 0.8, 0.1, seed)


@pytest.mark.parametrize("ext", EXTS)
def test_imread_matches_cv2(dataset, ext):
    paths = [p for p, _ in discover_dataset(dataset, CATEGORIES)
             if p.endswith(ext)]
    assert paths
    for p in paths:
        got, want = imread(p), cv2.imread(p)
        assert got.dtype == np.uint8 and got.shape == want.shape, p
        assert np.array_equal(got, want), p


def test_imread_ppm_with_comment_and_unreadable_files(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (5, 7, 3), np.uint8)
    body = img[:, :, ::-1].tobytes()
    p = tmp_path / "c.ppm"
    p.write_bytes(b"P6\n# a comment\n7 5\n255\n" + body)
    assert np.array_equal(imread(str(p)), cv2.imread(str(p)))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    assert cv2.imread(str(bad)) is None
    with pytest.raises(IOError, match="unreadable image"):
        imread(str(bad))
    with pytest.raises(IOError, match="unreadable image"):
        imread(str(tmp_path / "missing.png"))


def test_imread_names_the_missing_decoder(dataset, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "PIL", None)
    png = [p for p, _ in discover_dataset(dataset, CATEGORIES)
           if p.endswith(".png")][0]
    with pytest.raises(ImportError, match="PIL") as e:
        imread(png)
    assert png in str(e.value)
    ppm = [p for p, _ in discover_dataset(dataset, CATEGORIES)
           if p.endswith(".ppm")][0]
    assert np.array_equal(imread(ppm), cv2.imread(ppm))


# (src h, src w, dst h, dst w): downscales, an exact 2x, upscales, mixed
RESIZES = [(300, 280, 256, 256), (256, 256, 224, 224), (375, 500, 224, 224),
           (448, 448, 224, 224), (128, 128, 64, 64), (300, 257, 256, 256),
           (77, 61, 224, 224), (64, 64, 128, 128), (40, 30, 64, 64),
           (50, 100, 64, 64), (1, 1, 8, 8), (5, 3, 64, 64), (63, 65, 64, 64)]


@pytest.mark.parametrize("sh,sw,dh,dw", RESIZES)
def test_resize_is_bit_equal_to_cv2(sh, sw, dh, dw):
    """Bit-equal on downscales and upscales: cv2 clamps the rows of an
    upscale's edge but keeps their weights, and so does the port."""
    rng = np.random.default_rng(sh * 1000 + sw)
    for shape in ((sh, sw, 3), (sh, sw)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        got, want = resize(img, (dw, dh)), cv2.resize(img, (dw, dh))
        assert got.shape == want.shape and got.flags["C_CONTIGUOUS"]
        assert np.array_equal(got, want), (shape, dw, dh)


def test_resize_random_shapes_bit_equal_to_cv2():
    rng = np.random.default_rng(7)
    for _ in range(60):
        sh, sw = rng.integers(1, 160, 2)
        dh, dw = rng.integers(1, 260, 2)
        img = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        assert np.array_equal(resize(img, (int(dw), int(dh))),
                              cv2.resize(img, (int(dw), int(dh)))), \
            (sh, sw, dh, dw)


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("workers", [1, 2])
def test_loader_batches_equal_cnn_tpu(dataset, cache, workers):
    samples = discover_dataset(dataset, CATEGORIES)
    kw = dict(batch_size=8, image_size=64, seed=5, num_workers=workers,
              prefetch=2, cache=cache, backend="python")
    ours, ref = DataLoader(samples, **kw), JDataLoader(samples, **kw)
    try:
        # 8 batches of 8 cross two epochs of 30 samples
        for _ in range(8):
            (gi, gl), (wi, wl) = ours.generate_batch(), ref.generate_batch()
            assert gi.dtype == np.uint8 and gl.dtype == np.int32
            assert gi.flags["C_CONTIGUOUS"]   # the kernels take C order
            assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
    finally:
        ours.close()
        ref.close()
    for fixed in (False, True):
        kw.update(shuffle=True, compat_fixed_epoch_shuffle=fixed)
        a, b = DataLoader(samples, **kw), JDataLoader(samples, **kw)
        assert all(np.array_equal(a._epoch_order(e), b._epoch_order(e))
                   for e in range(3))
        for (gi, gl), (wi, wl) in zip(a, b):
            assert np.array_equal(gi, wi) and np.array_equal(gl, wl)


def test_loader_refuses_what_is_not_ported(dataset):
    """Nothing is refused any more: augment=True augments on the host
    (against cnn_tpu's loader: tests/test_torch_host_augment.py);
    backend='native' loads, its batches those of the Python path (against
    cnn_tpu's engine: tests/test_torch_native.py); 'auto' follows the
    device, the Python path on the CPU."""
    samples = discover_dataset(dataset, CATEGORIES)
    images, labels = DataLoader(samples, batch_size=2, augment=True,
                                image_size=32).generate_batch()
    assert images.shape == (2, 32, 32, 3) and images.dtype == np.uint8
    kw = dict(batch_size=4, image_size=48, shuffle=False)
    native = DataLoader(samples, backend="native", device="cpu", **kw)
    assert native._native is not None
    for (ni, nl), (pi, pl) in zip(native, DataLoader(samples, **kw)):
        assert np.array_equal(ni, pi) and np.array_equal(nl, pl)
    auto = DataLoader(samples, backend="auto", device="cpu")
    assert auto._native is None
    assert auto.generate_batch()[0].shape == (4, 224, 224, 3)
    auto.close()


@pytest.mark.parametrize("bs", [4, 7, 30])
def test_epoch_batches_equal_cnn_tpu(dataset, bs):
    samples = discover_dataset(dataset, CATEGORIES)
    ours = DeviceDataset(samples, 64, 2, device="cpu")
    ref = JDeviceDataset(samples, 64, 2)
    got, want = list(ours.epoch_batches(bs)), list(ref.epoch_batches(bs))
    assert len(got) == len(want) == -(-len(samples) // bs)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == torch.uint8
        assert np.array_equal(gi.numpy(), np.asarray(wi))
        assert np.array_equal(gl.numpy(), np.asarray(wl))


def test_device_dataset_needs_cuda_or_an_explicit_cpu(dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    samples = discover_dataset(dataset, CATEGORIES)[:4]
    with pytest.raises(RuntimeError):
        DeviceDataset(samples, 64, 1)
    assert DeviceDataset(samples, 64, 1, device="cpu").images.shape == \
        (4, 64, 64, 3)
