"""The port's native loader (``cnn_tpu_torch/data/native.py``) and its
batched resize (``ops/hopper/resize.py``) against cv2 and ``cnn_tpu``'s C++
engine (``cnn_tpu/data/native.py``) on the CPU, where the resize kernel's
plain version runs.

Every comparison is bit for bit: the resize is cv2's fixed-point
INTER_LINEAR in integers, the decode ``data/image.py:imread``. The kernel
itself (``csrc/resize.cu``) is held bit for bit to the plain version on the
card by ``chip_smoke.py`` (phase 26).
"""

import sys
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from cnn_tpu.data.loader import DataLoader as JDataLoader
from cnn_tpu_torch.data import DataLoader, discover_dataset
from cnn_tpu_torch.data.image import resize, tap_tables
from cnn_tpu_torch.data.native import NativeLoader
from cnn_tpu_torch.ops.hopper.resize import (pack, pack_into, pack_layout,
                                             resize_batch_plain,
                                             resize_linear_u8, unpack)

REPO = Path(__file__).resolve().parents[1]
NATIVE_LIB = REPO / "build" / "libcnn_data.so"
needs_native_lib = pytest.mark.skipif(not NATIVE_LIB.exists(),
                                      reason="native loader not built")
CATEGORIES = ("dog", "panda", "bird")
# (H, W) of the sources: downscales, the exact 2x that cv2 runs as
# INTER_AREA, 1-pixel rows and columns, upscales, non-square, the output's
# own size
SHAPES = [(304, 280), (75, 100), (1, 1), (1, 37), (41, 1), (128, 128),
          (64, 64), (20, 30), (100, 13), (9, 50), (32, 32)]


@pytest.mark.parametrize("size", [32, 64])
def test_resize_batch_plain_bit_equal_to_cv2(size):
    rng = np.random.default_rng(size)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in SHAPES]
    out = resize_linear_u8(pack(imgs, size))
    assert out.dtype == torch.uint8 and out.shape == (len(imgs), size, size,
                                                      3)
    for img, got in zip(imgs, out.numpy()):
        want = cv2.resize(img, (size, size))
        assert np.array_equal(got, want), img.shape
        assert np.array_equal(resize(img, (size, size)), want), img.shape


def test_packing_layout_and_taps():
    """The sections are 16-byte aligned, each image's bytes land at its
    offset, the taps are data/image.py's, and a copy of the whole buffer,
    unpacked, resizes alike (the loader copies its buffer whole)."""
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in SHAPES[:4]]
    layout = pack_layout([im.shape for im in imgs], 24)
    assert all(v % 16 == 0 for v in (layout.xtab_at, layout.ytab_at,
                                     layout.src_at))
    buf = torch.zeros(layout.nbytes + 5, dtype=torch.uint8)
    p = pack_into(buf, imgs, layout)
    for b, img in enumerate(imgs):
        off, h, w = p.meta[b].tolist()
        assert (off, h, w) == (layout.offsets[b], *img.shape[:2])
        assert np.array_equal(p.src[off:off + img.size].numpy(),
                              img.reshape(-1))
        xt, yt = tap_tables(h, w, 24, 24)
        assert np.array_equal(p.xtab[b].numpy(), xt)
        assert np.array_equal(p.ytab[b].numpy(), yt)
    copy = unpack(buf.clone(), layout)
    assert torch.equal(resize_batch_plain(copy), resize_linear_u8(p))
    assert torch.equal(resize_linear_u8(p), resize_linear_u8(pack(imgs, 24)))
    with pytest.raises(ValueError, match="3 channels"):
        pack_layout([(4, 4)], 8)


def _write_images(root: Path, rng) -> dict:
    """JPEG, PNG and binary PPM files that cv2 writes, an undecodable file
    and a missing path."""
    paths = {}
    for i, (h, w) in enumerate([(75, 100), (41, 57), (64, 64)]):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img[: h // 2] //= 3          # some structure for the JPEG coder
        for ext in ("jpg", "png", "ppm"):
            p = str(root / f"img{i}.{ext}")
            assert cv2.imwrite(p, img)
            paths[f"{ext}{i}"] = p
    (root / "junk.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    paths["junk"] = str(root / "junk.jpg")
    paths["missing"] = str(root / "missing.png")
    return paths


@needs_native_lib
def test_native_loader_bit_equal_to_cnn_tpu(tmp_path):
    from cnn_tpu.data.native import NativeLoader as JNativeLoader
    paths = _write_images(tmp_path, np.random.default_rng(3))
    good = [p for k, p in paths.items() if k not in ("junk", "missing")]
    for size in (48, 64):
        ours, ref = NativeLoader(size, device="cpu"), JNativeLoader(size)
        for key, p in paths.items():
            got, want = ours.load(p), ref.load(p)
            if want is None:
                assert got is None, key
                continue
            assert got.dtype == np.uint8 and got.shape == (size, size, 3)
            assert np.array_equal(got, want), key
        got, want = ours.load_batch(good), ref.load_batch(good)
        assert got.shape == (len(good), size, size, 3)
        assert np.array_equal(got, want)
        assert ours.load_batch(good + [paths["junk"]]) is None
        assert ref.load_batch(good + [paths["junk"]]) is None
        assert ours.load_batch([paths["missing"]], num_threads=1) is None


@needs_native_lib
def test_native_loader_concurrent_threads(tmp_path):
    """load_batch from 4 threads at once, each batch bit-equal to cnn_tpu's
    engine's (the counterpart of the C++ engine's thread stress)."""
    from cnn_tpu.data.native import NativeLoader as JNativeLoader
    paths = _write_images(tmp_path, np.random.default_rng(4))
    good = [p for k, p in paths.items() if k not in ("junk", "missing")]
    want = JNativeLoader(40).load_batch(good, num_threads=4)
    loader = NativeLoader(40, device="cpu")
    results, start = [None] * 4, threading.Barrier(4)

    def work(i):
        start.wait()
        results[i] = [loader.load_batch(good[i:] + good[:i], num_threads=3)
                      for _ in range(3)]

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)     # switch threads as often as it can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i, batches in enumerate(results):
        for got in batches:
            assert np.array_equal(got, np.roll(want, -i, axis=0))


def _dataset(root: Path, rng) -> str:
    for i in range(14):
        d = root / CATEGORIES[i % 3]
        d.mkdir(parents=True, exist_ok=True)
        h, w = 30 + 7 * i, 40 + 5 * (i % 4)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(d / f"{i:03d}.{('png', 'ppm', 'jpg')[i % 3]}"), img)
    return str(root)


@needs_native_lib
def test_loader_native_epoch_bit_equal_to_cnn_tpu(tmp_path):
    samples = discover_dataset(_dataset(tmp_path, np.random.default_rng(5)),
                               CATEGORIES)
    kw = dict(batch_size=4, image_size=32, seed=9, num_workers=2,
              prefetch=2, backend="native")
    ours = DataLoader(samples, **kw, device="cpu")
    ref = JDataLoader(samples, **kw)
    assert ours._native is not None and ours._native_batch
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == 4          # 14 samples: the last of 2
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.uint8 and gi.flags["C_CONTIGUOUS"]
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
    try:
        for _ in range(5):      # the stream, across an epoch boundary
            (gi, gl), (wi, wl) = ours.generate_batch(), ref.generate_batch()
            assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
    finally:
        ours.close()
        ref.close()


def test_loader_backend_follows_the_device(tmp_path):
    """'auto' takes the native engine on a CUDA device and the Python path
    on the CPU; 'native' applies only without augment and cache, as in
    cnn_tpu; an unreadable file raises as on the Python path."""
    samples = discover_dataset(_dataset(tmp_path, np.random.default_rng(6)),
                               CATEGORIES)
    assert DataLoader(samples, backend="auto", device="cpu")._native is None
    cuda = DataLoader(samples, backend="auto", device="cuda")
    assert cuda._native.device.type == "cuda" and cuda._native_batch
    for kw in (dict(cache=True), dict(augment=True)):
        assert not DataLoader(samples, backend="native", device="cpu",
                              **kw)._native_batch
    a = DataLoader(samples, batch_size=14, shuffle=False, image_size=24,
                   backend="native", device="cpu")
    b = DataLoader(samples, batch_size=14, shuffle=False, image_size=24,
                   backend="python")
    (ai, al), = list(a)
    (bi, bl), = list(b)
    assert np.array_equal(ai, bi) and np.array_equal(al, bl)
    bad = DataLoader(samples[:3] + [(str(tmp_path / "gone.png"), 0)],
                     batch_size=4, shuffle=False, backend="native",
                     device="cpu")
    with pytest.raises(IOError, match="unreadable image"):
        list(bad)
    with pytest.raises(ValueError, match="unknown loader backend"):
        DataLoader(samples, backend="opencv")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NativeLoader(32)
