"""Grad-CAM at every family and inside a scanned trunk against ``cnn_tpu``
on the CPU: ``compute_cam`` on a narrow PipeCNN (width 8, 3 blocks, 32 px,
weights and BN statistics drawn by numpy with seed 29) at a top-level
layer, at ``trunk/block_<i>`` and at ``trunk/block_<i>/<body_layer>``, in
both modes; the trunk-path errors; resnet10's ``block_4`` from its
committed checkpoint; and the CLI with ``--model pipecnn --layer
trunk/block_1/b_conv1`` on the committed PipeCNN against ``cnn_tpu``'s."""

import glob
import os
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.tools import gradcam as j_gradcam
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.tools import gradcam
from cnn_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 29
CAM_TOL = 1e-4        # CAM and probabilities, absolute
NARROW = dict(num_classes=3, width=8, n_blocks=3, image_size=32,
              batch_norm=True)


def _newest(name):
    return max(glob.glob(os.path.join(REPO, "checkpoints", name,
                                      "iter_*.ckpt")),
               key=lambda p: int(os.path.basename(p).split("_")[1]))


@pytest.fixture(scope="module")
def narrow():
    """``cnn_tpu``'s narrow PipeCNN with numpy-drawn trees, the port's
    with the same, and a seeded image."""
    rng = np.random.default_rng(SEED)
    jm = j_get_model("pipecnn", **NARROW)
    params, state = jax.eval_shape(jm.init, jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        params)
    state = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state)
    model = get_model("pipecnn", device="cpu", **NARROW)
    ckpt.load_jax_params(model, params, state)
    x = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    return jm, params, state, model, x


@pytest.mark.parametrize("mode", ["gradcam", "reference"])
@pytest.mark.parametrize("path", [
    "stem_relu2", "trunk", "trunk/block_0", "trunk/block_1",
    "trunk/block_2", "trunk/block_1/b_conv1", "trunk/block_1/b_bn1",
    "trunk/block_0/b_relu", "trunk/block_2/b_conv2", "trunk/block_2/b_bn2"])
def test_compute_cam_in_a_trunk_matches_cnn_tpu(narrow, path, mode):
    jm, params, state, model, x = narrow
    want_cam, want_p = j_gradcam.compute_cam(jm, params, state,
                                             jnp.asarray(x), path, mode)
    cam, probs = gradcam.compute_cam(model, torch.from_numpy(x), path, mode)
    assert cam.shape == want_cam.shape
    assert np.abs(cam - want_cam).max() <= CAM_TOL
    assert np.abs(probs - want_p).max() <= CAM_TOL
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("path", [
    "trunk/block_3", "trunk/block_-1", "trunk/blk_1", "trunk/block_1/x/y",
    "trunk/block_1/b_conv9", "stem_conv1/block_0", "gap/x", "nope"])
def test_trunk_path_errors_match_cnn_tpu(narrow, path):
    jm, _, _, model, _ = narrow
    with pytest.raises(ValueError) as want:
        j_gradcam.parse_layer_path(jm, path)
    with pytest.raises(ValueError) as got:
        gradcam.parse_layer_path(model, path)
    assert str(got.value) == str(want.value)


def test_every_trunk_path_parses_as_cnn_tpu(narrow):
    jm, _, _, model, _ = narrow
    paths = [l.name for l in model.net] + [
        f"trunk/block_{i}" + sub for i in range(3)
        for sub in ("", *(f"/{l.name}" for l in model.net["trunk"].block.body))]
    for path in paths:
        assert gradcam.parse_layer_path(model, path) == \
            j_gradcam.parse_layer_path(jm, path)


def test_resnet10_block_4_matches_cnn_tpu():
    """``--model resnet10``'s layer, ``block_4``, from the committed
    checkpoint on a fixture photo resized to 64 px, in gradcam mode."""
    payload = ckpt.read_checkpoint(_newest("resnet10"))
    jm = j_get_model("resnet10", num_classes=3, image_size=64,
                     batch_norm=True)
    model = get_model("resnet10", num_classes=3, image_size=64,
                      batch_norm=True, device="cpu")
    ckpt.load_jax_params(model, payload["params"], payload["state"])
    fx = np.load(os.path.join(REPO, "tests", "fixtures",
                              "reference_parity.npz"))
    x = cv2.resize(fx["image_u8_2"], (64, 64),
                   interpolation=cv2.INTER_AREA)[None].astype(
                       np.float32) / 255.0
    want_cam, want_p = j_gradcam.compute_cam(
        jm, payload["params"], payload["state"], jnp.asarray(x), "block_4")
    cam, probs = gradcam.compute_cam(model, torch.from_numpy(x), "block_4")
    assert np.abs(cam - want_cam).max() <= CAM_TOL
    assert np.abs(probs - want_p).max() <= CAM_TOL


def test_gradcam_cli_on_a_trunk_matches_cnn_tpu(tmp_path, capsys):
    """``--model pipecnn --layer trunk/block_1/b_conv1`` on the committed
    PipeCNN (64 wide, 8 blocks) at 64 px, two fixture photos through both
    CLIs: the same lines but for the output directory and the sixth place
    of a probability, PNGs within one level."""
    fx = np.load(os.path.join(REPO, "tests", "fixtures",
                              "reference_parity.npz"))
    paths = []
    for i in (0, 1):
        paths.append(str(tmp_path / f"{i}.ppm"))
        cv2.imwrite(paths[-1], fx[f"image_u8_{i}"])
    argv = ["--checkpoint", _newest("pipecnn"), "--model", "pipecnn",
            "--batch-norm", "--layer", "trunk/block_1/b_conv1",
            "--image-size", "64", *paths]
    capsys.readouterr()
    assert j_gradcam.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    want = capsys.readouterr().out.replace(str(tmp_path / "j"), "<out>")
    assert gradcam.main(argv + ["--output-dir", str(tmp_path / "t")],
                        device="cpu") == 0
    got = capsys.readouterr().out.replace(str(tmp_path / "t"), "<out>")
    assert len(re.findall("classification", got)) == 2

    def strip(text):
        return re.sub(r"prob: [\d.]+", "prob", text)
    assert strip(got) == strip(want)
    for g, w in zip(re.findall(r"prob: ([\d.]+)", got),
                    re.findall(r"prob: ([\d.]+)", want)):
        assert abs(float(g) - float(w)) <= 1e-5
    for i in (0, 1):
        a = cv2.imread(str(tmp_path / "t" / f"{i}.png")).astype(int)
        b = cv2.imread(str(tmp_path / "j" / f"{i}.png")).astype(int)
        assert a.shape == (64, 64, 3) and np.abs(a - b).max() <= 1
