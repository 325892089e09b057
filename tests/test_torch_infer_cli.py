"""The inference CLI and ``make_forward`` against cnn_tpu's on the CPU: the
six fixture photos written as PNG and as PPM, through the committed BN
checkpoint as ``.model`` and as ``.ckpt``."""

import os
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.parallel import make_forward as j_make_forward
from cnn_tpu.tools import infer as j_infer
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.parallel import make_forward
from cnn_tpu_torch.tools import infer
from cnn_tpu_torch.utils.checkpoint import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                    "iter_12000_train_0.997_valid_0.937")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "reference_parity.npz")
LINE = re.compile(r"^(.*)===> \[classification: (\w+)\] \[prob: ([\d.]+)\]$")


@pytest.fixture(scope="module")
def photo_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("photos")
    fx = np.load(FIXTURE)
    paths = []
    for ext in (".png", ".ppm"):
        for i in range(6):
            paths.append(str(root / f"{i}{ext}"))
            cv2.imwrite(paths[-1], fx[f"image_u8_{i}"])
    return paths


def _parse(out: str):
    rows, other = [], []
    for line in out.splitlines():
        m = LINE.match(line)
        if m:
            rows.append((m.group(1), m.group(2), float(m.group(3))))
        elif not line.startswith("[ WARN"):
            other.append(line)
    return rows, other


@pytest.mark.parametrize("ckpt", [".model", ".ckpt"])
def test_infer_cli_matches_cnn_tpu(photo_paths, capsys, ckpt):
    """The same argv through both CLIs (and a path that does not decode):
    the same paths, the classes dog, panda, bird twice per format, the
    probabilities within 1e-5, the same other lines."""
    argv = ["--checkpoint", CKPT + ckpt, "--batch-norm", *photo_paths,
            "/nonexistent/dog.jpg"]
    capsys.readouterr()
    assert j_infer.main(argv) == 0
    want, want_other = _parse(capsys.readouterr().out)
    assert infer.main(argv, device="cpu") == 0
    got, got_other = _parse(capsys.readouterr().out)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert [r[1] for r in got] == ["dog", "panda", "bird"] * 4
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) <= 1e-5
    assert got_other == want_other == [
        "Failed to read image file  /nonexistent/dog.jpg"]


def test_infer_cli_bench_prints_latency(photo_paths, capsys):
    assert infer.main(["--checkpoint", CKPT + ".model", "--batch-norm",
                       "--bench", photo_paths[0]], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert LINE.match(out[0])
    assert re.match(r"^  p50 latency: [\d.]+ ms \(p90 [\d.]+ ms\)$", out[1])


def test_infer_use_ema_raises_naming_itself(photo_paths, capsys):
    """``--use-ema``, once refused, now serves an EMA checkpoint's averaged
    weights (against cnn_tpu's: tests/test_torch_toolbox_cli.py); on a
    checkpoint without EMA it raises cnn_tpu's ValueError."""
    with pytest.raises(ValueError, match="has no EMA state"):
        infer.main(["--checkpoint", CKPT + ".ckpt", "--use-ema",
                    photo_paths[0]], device="cpu")
    ema = os.path.join(REPO, "checkpoints", "alexnet_distill",
                       "iter_17000_train_0.992_valid_0.930.ckpt")
    capsys.readouterr()
    assert infer.main(["--checkpoint", ema, "--batch-norm", "--use-ema",
                       *photo_paths[:3]], device="cpu") == 0
    rows, _ = _parse(capsys.readouterr().out)
    assert [r[1] for r in rows] == ["dog", "panda", "bird"]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_make_forward_matches_cnn_tpu(rng, dtype):
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=True,
                         image_size=64)
    params, state = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.key(8)))
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    if dtype == "float32":
        images = images.astype(np.float32) / 255.0
    want = np.asarray(j_make_forward(jmodel)(params, state,
                                             jnp.asarray(images)))
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=64, device="cpu").train()
    load_jax_params(model, params, state)
    got = make_forward(model)(torch.from_numpy(images))
    assert got.dtype == torch.float32 and not model.training
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
