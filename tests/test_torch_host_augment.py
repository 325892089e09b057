"""The host augmentation (``cnn_tpu_torch/data/augment.py``) against cv2 and
``cnn_tpu``'s, and the host sides of a captured device-dataset call, on
the CPU:

- ``get_rotation_matrix_2d`` bit-equal to ``cv2.getRotationMatrix2D``;
  ``warp_affine`` and ``rotate_expand`` to ``cv2.warpAffine`` on seeded
  shapes, angles and matrices, a vertically flipped input among them;
- ``ImageAugmentor`` against ``cnn_tpu``'s on the same ``(seed, epoch,
  pos)`` generators (the same draws: the generators end in the same
  state) and against ``tests/fixtures/host_augment.npz``;
- ``DataLoader(augment=True)`` batches, cached and not, against
  ``cnn_tpu``'s;
- the train CLI with host augmentation against ``cnn_tpu``'s, resuming one
  checkpoint;
- the optimizer's per-update scalars as device tensors bit-equal to the
  host floats they replace, and a ``ScalarFeed`` filled for later calls
  giving the values those updates read;
- ``call_indices`` equal to ``epoch_indices`` step for step.

The warped pixels are bit-equal where cv2 runs its AVX-512 build (the
last ``w % 16`` columns of a row take its scalar tail, module docstring).
Elsewhere cv2's tail is another width, and the bar is at most one grey
level on at most 1e-5 of the values, only in the last 32 columns of a
row; op order, crops, angles, flips and shapes are exact either way.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from cnn_tpu.data.augment import ImageAugmentor as JImageAugmentor
from cnn_tpu.data.augment import rotate_expand as j_rotate_expand
from cnn_tpu.data.loader import DataLoader as JDataLoader
from cnn_tpu.tools import train as j_train
from cnn_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from cnn_tpu_torch import optim
from cnn_tpu_torch.data import DataLoader, ImageAugmentor, discover_dataset
from cnn_tpu_torch.data.augment import (get_rotation_matrix_2d,
                                        rotate_expand, warp_affine)
from cnn_tpu_torch.data.device_dataset import call_indices, epoch_indices
from cnn_tpu_torch.tools import train
from cnn_tpu_torch.utils.checkpoint import read_checkpoint
from test_torch_data import CATEGORIES, write_dataset
from test_torch_train_cli import BASE, _one

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "host_augment.npz")
CLI_TOL = 1e-4

sys.path.insert(0, os.path.join(HERE, "fixtures"))
import make_host_augment as mk  # noqa: E402


CV_CPU_AVX512_SKX = 256     # OpenCV's feature id (cvdef.h)


def _bit_equal_build() -> bool:
    return cv2.checkHardwareSupport(CV_CPU_AVX512_SKX)


def assert_pixels(got: np.ndarray, want: np.ndarray) -> None:
    """The bar of the module docstring."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    if _bit_equal_build():
        assert np.array_equal(got, want)
        return
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    rows, cols = np.nonzero(diff.max(axis=-1))
    assert diff.max(initial=0) <= 1
    assert np.count_nonzero(diff) <= 1e-5 * diff.size
    assert (cols >= want.shape[1] - 32).all()


def _images(n: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = rng.integers(8, 129, 2)
        yield rng.integers(0, 256, (h, w, 3), dtype=np.uint8), rng


def test_rotation_matrix_bit_equal_to_cv2():
    rng = np.random.default_rng(0)
    for _ in range(200):
        center = (rng.uniform(0, 128), rng.uniform(0, 128))
        angle, scale = rng.uniform(-180, 180), rng.uniform(0.5, 2.0)
        assert np.array_equal(get_rotation_matrix_2d(center, angle, scale),
                              cv2.getRotationMatrix2D(center, angle, scale))
    # the half-pixel centres rotate_expand uses
    for w, h in ((31, 17), (128, 96), (7, 120)):
        c = ((w - 1) / 2.0, (h - 1) / 2.0)
        assert np.array_equal(get_rotation_matrix_2d(c, -37.25, 1.0),
                              cv2.getRotationMatrix2D(c, -37.25, 1.0))


def test_warp_affine_matches_cv2():
    """Random affine matrices and output sizes, a vertically flipped view
    made contiguous (as ``ImageAugmentor`` passes it) among them."""
    for i, (img, rng) in enumerate(_images(40, 1)):
        if i % 4 == 0:
            img = np.ascontiguousarray(img[::-1])
        m = np.array([[rng.uniform(0.5, 1.5), rng.uniform(-0.5, 0.5),
                       rng.uniform(-20, 20)],
                      [rng.uniform(-0.5, 0.5), rng.uniform(0.5, 1.5),
                       rng.uniform(-20, 20)]])
        size = tuple(int(v) for v in rng.integers(8, 150, 2))
        assert_pixels(warp_affine(img, m, size), cv2.warpAffine(img, m, size))


def test_rotate_expand_matches_cv2():
    for img, rng in _images(40, 2):
        angle = rng.uniform(15.0, 75.0) * (1 if rng.integers(2) else -1)
        assert_pixels(rotate_expand(img, angle), j_rotate_expand(img, angle))


def test_warp_affine_refuses_other_images():
    with pytest.raises(ValueError, match="uint8 HxWxC"):
        warp_affine(np.zeros((4, 4), np.uint8), np.eye(2, 3), (4, 4))


def test_image_augmentor_matches_cnn_tpu():
    """The same generator through both: the same draws (the generators end
    in the same state) and the same image."""
    got_aug, want_aug = ImageAugmentor(), JImageAugmentor()
    for pos, (img, _) in enumerate(_images(24, 3)):
        g = np.random.default_rng((212, 1, pos))
        w = np.random.default_rng((212, 1, pos))
        assert_pixels(np.ascontiguousarray(got_aug(img, g)),
                      np.ascontiguousarray(want_aug(img, w)))
        assert g.bit_generator.state == w.bit_generator.state
    # the augmentor's own generator when none is passed
    img = next(_images(1, 4))[0]
    for _ in range(3):
        assert_pixels(np.ascontiguousarray(got_aug(img)),
                      np.ascontiguousarray(want_aug(img)))


def test_image_augmentor_matches_fixture():
    """``tests/fixtures/host_augment.npz`` (``make_host_augment.py``): the
    port against the stored cv2 outputs, and the file against cv2 now."""
    fx = np.load(FIXTURE)
    ours = mk.augmented(ImageAugmentor(), [fx[f"img{i}"]
                                          for i in range(len(mk.SHAPES))])
    assert sorted(ours) == sorted(fx.files)
    for key, want in ours.items():
        assert_pixels(want, fx[key])
    imgs = mk.images()
    assert all(np.array_equal(a, fx[f"img{i}"]) for i, a in enumerate(imgs))
    for key, want in mk.augmented(JImageAugmentor(), imgs).items():
        assert_pixels(want, fx[key])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("animals"))


@pytest.mark.parametrize("cache", [False, True])
def test_loader_augment_matches_cnn_tpu(dataset, cache):
    """Batches of the epoch walk and of the producer's stream, the second
    epoch of a cache that holds the decoded originals included."""
    samples = discover_dataset(dataset, CATEGORIES)
    kw = dict(batch_size=8, augment=True, image_size=48, seed=5,
              num_workers=2, cache=cache)
    got, want = DataLoader(samples, **kw), JDataLoader(samples, **kw)
    try:
        for (gi, gl), (wi, wl) in zip(got, want):
            assert_pixels(gi, wi)
            assert np.array_equal(gl, wl)
        for _ in range(5):      # 30 samples: the stream crosses an epoch
            (gi, gl), (wi, wl) = got.generate_batch(), want.generate_batch()
            assert_pixels(gi, wi)
            assert np.array_equal(gl, wl)
        if cache:
            assert len(got._cached) == len(samples)
            assert all(got._cached[p].shape == want._cached[p].shape
                       for p in want._cached)
    finally:
        got.close()
        want.close()


def test_train_cli_host_augment_matches_cnn_tpu(dataset, tmp_path, capsys):
    """cnn_tpu's CLI trains iterations 1-2 with host augmentation (its
    default) and saves; each CLI resumes that checkpoint to iteration 4
    on the same augmented stream: the iter_4 params and BN statistics
    within 1e-4 x max(1, max|ref|). 64 px: AlexNet's four VALID stride-2
    convs and its pool need at least 47."""
    argv = [*BASE, "--augment", "true"]

    def args(ck, *more):
        return ["--dataset-path", dataset, "--checkpoint-dir", str(ck),
                *argv, *more]

    assert j_train.main(args(tmp_path / "j0", "--total-iters", "2")) == 0
    start = _one(str(tmp_path / "j0" / "iter_2_*.ckpt"))
    more = ("--total-iters", "4", "--resume", start)
    assert j_train.main(args(tmp_path / "j", *more)) == 0
    capsys.readouterr()
    assert train.main(args(tmp_path / "t", *more), device="cpu") == 0
    assert "training done!" in capsys.readouterr().out
    want = j_load_checkpoint(_one(str(tmp_path / "j" / "iter_4_*.ckpt")))
    got = read_checkpoint(_one(str(tmp_path / "t" / "iter_4_*.ckpt")))
    assert got["step"] == int(want.step) == 4
    for tree, ref in (("params", want.params), ("state", want.state)):
        for layer, leaves in ref.items():
            for key, w in leaves.items():
                w = np.asarray(w, np.float64)
                d = np.abs(np.asarray(got[tree][layer][key], np.float64)
                           - w).max()
                assert d <= CLI_TOL * max(1.0, np.abs(w).max()), \
                    (tree, layer, key, d)


OPTIMIZERS = {
    "sgd": dict(name="sgd"),
    "momentum_cosine": dict(name="momentum", schedule="cosine"),
    "momentum_warmup": dict(name="momentum", schedule="cosine",
                            warmup_steps=5),
    "sgd_step_decay_clip": dict(name="sgd", schedule="step",
                                weight_decay=1e-3, grad_clip=0.5),
    "adam": dict(name="adam"),
    "adamw_cosine_clip": dict(name="adam", schedule="cosine",
                              weight_decay=1e-2, grad_clip=1.0),
    "constant_warmup": dict(name="momentum", warmup_steps=4),
}


def _make(spec: dict, ema: bool):
    opt = optim.make_optimizer(spec["name"], 0.1, 0.0,
                               schedule=spec.get("schedule", "constant"),
                               total_steps=20,
                               warmup_steps=spec.get("warmup_steps", 0),
                               weight_decay=spec.get("weight_decay", 0.0),
                               grad_clip=spec.get("grad_clip", 0.0))
    return optim.with_ema(opt, 0.9) if ema else opt


def _run(opt, steps: int):
    """``steps`` updates from one seeded start; returns the params and
    the state's tensors."""
    g = torch.Generator().manual_seed(0)
    params = {"a.w": torch.randn(6, 5, generator=g),
              "b.b": torch.randn(5, generator=g)}
    state = opt.init(params)
    mstate = {"bn.mean": torch.zeros(5)}
    state = optim.ema_update_state(state, mstate)
    for _ in range(steps):
        grads = {k: torch.randn(p.shape, generator=g)
                 for k, p in params.items()}
        opt.update(grads, state, params)
        mstate["bn.mean"].add_(0.25)
        state = optim.ema_update_state(state, mstate)
    return params, state


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


@pytest.mark.parametrize("ema", [False, True], ids=["plain", "ema"])
@pytest.mark.parametrize("spec", list(OPTIMIZERS))
def test_device_scalars_bit_equal_to_host_scalars(monkeypatch, spec, ema):
    """20 updates of every ``make_optimizer`` branch, with and without
    ``with_ema``: the scalars as 0-d tensors (``step_scalar``) against
    the host floats the optimizer multiplied by before."""
    got = _run(_make(OPTIMIZERS[spec], ema), 20)
    monkeypatch.setattr(optim, "step_scalar",
                        lambda count, fn, device: fn(int(count)))
    want = _run(_make(OPTIMIZERS[spec], ema), 20)
    for a, b in zip(_tensors(got), _tensors(want), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("spec", ["momentum_warmup", "adamw_cosine_clip"])
def test_scalar_feed_gives_each_call_its_updates_scalars(monkeypatch, spec):
    """A feed made with the counts, read through one call of K = 4 updates
    (a capture's host side), then, for each later call, with the counts
    put back and advanced as a replay advances them: its values are
    those the eager updates of that call read, in order."""
    k, calls = 4, 3
    eager = []
    real = optim.step_scalar

    def logged(count, fn, device):
        eager.append(fn(int(count)))
        return real(count, fn, device)

    monkeypatch.setattr(optim, "step_scalar", logged)
    _run(_make(OPTIMIZERS[spec], True), k * calls)
    monkeypatch.setattr(optim, "step_scalar", real)
    per_call = len(eager) // calls

    opt = _make(OPTIMIZERS[spec], True)
    params = {"a.w": torch.zeros(6, 5), "b.b": torch.zeros(5)}
    state = optim.ema_update_state(opt.init(params),
                                   {"bn.mean": torch.zeros(5)})
    counts = optim.counts(state)
    # the schedule's and the EMA's (and Adam's)
    assert len(counts) == {"momentum_warmup": 2, "adamw_cosine_clip": 3}[spec]
    start = [int(c) for c in counts]
    feed = optim.ScalarFeed(counts, "cpu")
    with optim.feeding(feed):
        for _ in range(k):
            opt.update({k_: torch.ones_like(p) for k_, p in params.items()},
                       state, params)
            optim.ema_update_state(state, {"bn.mean": torch.zeros(5)})
    advance = [int(c) - s for c, s in zip(counts, start)]
    for c, s in zip(counts, start):
        c.fill_(s)
    assert len(feed.entries) == per_call
    for call in range(calls):
        want = eager[call * per_call:(call + 1) * per_call]
        assert feed.values() == want
        feed.fill()
        assert feed.buf[:per_call].tolist() == \
            torch.tensor(want, dtype=torch.float32).tolist()
        for c, n in zip(counts, advance):
            c.add_(n)


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("n,batch,steps", [(30, 8, 4), (8, 8, 16),
                                           (13, 5, 1), (64, 7, 16)])
def test_call_indices_equal_epoch_indices(n, batch, steps, fixed):
    for step in (0, 3, 11):
        want = torch.stack([epoch_indices(9, step + s, batch, n, fixed,
                                          "cpu") for s in range(steps)])
        assert torch.equal(call_indices(9, step, steps, batch, n, fixed,
                                        "cpu"), want)
