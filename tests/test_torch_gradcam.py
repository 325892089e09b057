"""Grad-CAM against cnn_tpu's on the CPU: ``compute_cam`` in both modes on
the six fixture photos and the committed BN checkpoint at 224 px, the layer
path errors, ``render_heatmap`` with the JET table and the PNG writer
against cv2, and the two CLIs on one argv."""

import os
import re

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.tools import gradcam as j_gradcam
from cnn_tpu.utils.checkpoint import import_reference_model as j_import
from cnn_tpu_torch.data.image import apply_colormap_jet, imread, imwrite
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.ops.preprocess import uint8_to_float
from cnn_tpu_torch.tools import gradcam
from cnn_tpu_torch.utils.checkpoint import load_reference_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                    "iter_12000_train_0.997_valid_0.937")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "reference_parity.npz")
LABELS = [0, 1, 2, 0, 1, 2]
CAM_TOL = 1e-4


@pytest.fixture(scope="module")
def photos():
    fx = np.load(FIXTURE)
    return [fx[f"image_u8_{i}"] for i in range(6)]


@pytest.fixture(scope="module")
def models():
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=True)
    params, state = j_import(CKPT + ".model", jmodel.net)
    model = get_model("alexnet", num_classes=3, batch_norm=True, device="cpu")
    load_reference_model(model, CKPT + ".model")
    return jmodel, params, state, model


@pytest.mark.parametrize("layer,mode,image", [
    ("conv_layer_1", "gradcam", 0), ("conv_layer_2", "gradcam", 1),
    ("conv_layer_3", "gradcam", 2), ("conv_layer_4", "gradcam", 3),
    ("relu_layer_1", "gradcam", 4), ("bn_layer_3", "gradcam", 5),
    ("conv_layer_3", "reference", 0), ("relu_layer_1", "reference", 1),
    ("bn_layer_2", "reference", 2), ("conv_layer_4", "reference", 3)])
def test_compute_cam_matches_cnn_tpu(models, photos, layer, mode, image):
    jmodel, params, state, model = models
    img = photos[image][None]
    want_cam, want_p = j_gradcam.compute_cam(
        jmodel, params, state, jnp.asarray(img).astype(jnp.float32) / 255.0,
        layer, mode)
    cam, probs = gradcam.compute_cam(model, uint8_to_float(
        torch.from_numpy(img)), layer, mode)
    assert cam.shape == want_cam.shape and cam.dtype == np.float32
    assert np.abs(cam - want_cam).max() <= CAM_TOL
    assert int(probs.argmax()) == int(want_p.argmax()) == LABELS[image]
    np.testing.assert_allclose(probs, want_p, atol=1e-5, rtol=0)
    # the gradient left the parameters as they were: trainable
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("path", ["conv_layer_9", "trunk/block_1",
                                  "conv_layer_3/block_1",
                                  "relu_layer_1/x/y/z"])
def test_parse_layer_path_errors_match_cnn_tpu(models, path):
    jmodel, _, _, model = models
    with pytest.raises(ValueError) as want:
        j_gradcam.parse_layer_path(jmodel, path)
    with pytest.raises(ValueError) as got:
        gradcam.parse_layer_path(model, path)
    assert str(got.value) == str(want.value)


def test_every_top_level_layer_name_parses(models):
    jmodel, _, _, model = models
    for layer in model.net:
        assert gradcam.parse_layer_path(model, layer.name) == \
            j_gradcam.parse_layer_path(jmodel, layer.name)


def test_unknown_cam_mode_raises(models, photos):
    model = models[3]
    with pytest.raises(ValueError, match="unknown CAM mode"):
        gradcam.compute_cam(model, torch.zeros(1, 224, 224, 3),
                            "conv_layer_3", "guided")


def test_jet_table_is_cv2s_on_every_value():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(apply_colormap_jet(u8),
                                  cv2.applyColorMap(u8, cv2.COLORMAP_JET))
    with pytest.raises(TypeError):
        apply_colormap_jet(np.zeros((2, 2, 3), np.uint8))


@pytest.mark.parametrize("shape", [(13, 13), (111, 111), (6, 6), (1, 1)])
def test_render_heatmap_bit_equal_to_cnn_tpu(rng, photos, shape):
    cam = rng.uniform(0, 1, shape).astype(np.float32)
    if shape == (1, 1):
        cam[:] = 0.0            # a constant CAM, as minmax gives it
    for img in photos[:2]:
        np.testing.assert_array_equal(gradcam.render_heatmap(img, cam),
                                      j_gradcam.render_heatmap(img, cam))


@pytest.mark.parametrize("shape", [(7, 9, 3), (224, 224, 3), (1, 1, 3)])
def test_png_round_trip_through_cv2(rng, tmp_path, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    imwrite(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(imread(path), img)
    first = open(path, "rb").read()
    imwrite(path, img)
    assert open(path, "rb").read() == first
    for bad in (img.astype(np.float32), img[..., 0]):
        with pytest.raises(TypeError):
            imwrite(path, bad)


def _write_photos(photos, root, ext):
    os.makedirs(root, exist_ok=True)
    paths = []
    for i, img in enumerate(photos):
        paths.append(os.path.join(root, f"{i}{ext}"))
        cv2.imwrite(paths[-1], img)
    return paths


def _lines(out: str, outdir: str) -> list:
    return [l.replace(outdir, "<out>") for l in out.splitlines()
            if not l.startswith("[ WARN")]


@pytest.mark.parametrize("layer,mode", [("conv_layer_3", "gradcam"),
                                        ("relu_layer_1", "reference")])
def test_gradcam_cli_matches_cnn_tpu(photos, tmp_path, capsys, layer, mode):
    """One argv through both CLIs (six PPM photos and one that does not
    decode): the same printed lines but for the output directory, and
    PNGs whose pixels differ by at most one level."""
    paths = _write_photos(photos, str(tmp_path / "in"), ".ppm")
    paths.append(str(tmp_path / "missing.jpg"))
    argv = ["--checkpoint", CKPT + ".model", "--batch-norm",
            "--layer", layer, "--mode", mode, *paths]
    capsys.readouterr()
    assert j_gradcam.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    want = _lines(capsys.readouterr().out, str(tmp_path / "j"))
    assert gradcam.main(argv + ["--output-dir", str(tmp_path / "t")],
                        device="cpu") == 0
    got = _lines(capsys.readouterr().out, str(tmp_path / "t"))
    assert [l for l in got if "saved" not in l and "Failed" not in l] and \
        got[-1].startswith("Failed to read image file  ")
    classes = re.findall(r"classification: (\w+)", "\n".join(got))
    assert classes == ["dog", "panda", "bird"] * 2
    # probabilities printed to 6 places may differ in the last one
    strip = [re.sub(r"prob: [\d.]+", "prob", l) for l in got]
    assert strip == [re.sub(r"prob: [\d.]+", "prob", l) for l in want]
    for g, w in zip(re.findall(r"prob: ([\d.]+)", "\n".join(got)),
                    re.findall(r"prob: ([\d.]+)", "\n".join(want))):
        assert abs(float(g) - float(w)) <= 1e-5
    for i in range(6):
        a = cv2.imread(str(tmp_path / "t" / f"{i}.png")).astype(int)
        b = cv2.imread(str(tmp_path / "j" / f"{i}.png")).astype(int)
        assert a.shape == (224, 224, 3) and np.abs(a - b).max() <= 1


def test_gradcam_cli_refuses_a_trunk_path(tmp_path, capsys):
    argv = ["--checkpoint", CKPT + ".model", "--layer", "trunk/block_1",
            "--output-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as want:
        j_gradcam.main(argv)
    j_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        gradcam.main(argv, device="cpu")
    assert got.value.code == want.value.code == 2
    assert capsys.readouterr().err.splitlines()[-1] == j_err
    assert "--layer 'trunk/block_1': layer 'trunk' not in model" in j_err
