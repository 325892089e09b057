"""cnn_tpu_torch stands alone: it imports none of JAX, optax, cv2 or cnn_tpu,
runs on the CPU only when asked, and chip_smoke.py refuses to run without a
CUDA device."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cnn_tpu_torch
from cnn_tpu_torch.data import DeviceDataset, make_device_train_step
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.optim import make_optimizer
from cnn_tpu_torch.parallel import create_train_state
from cnn_tpu_torch.serving import InferenceEngine
from cnn_tpu_torch.tools import (convert, evaluate, export_artifact,
                                 gradcam, infer, serve, train)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = r"""
import sys

BLOCKED = ("jax", "jaxlib", "optax", "cv2", "cnn_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Blocker())
import cnn_tpu_torch, cnn_tpu_torch.serving, cnn_tpu_torch.models
import cnn_tpu_torch.utils.checkpoint, cnn_tpu_torch.ops.hopper
import cnn_tpu_torch.data, cnn_tpu_torch.parallel, cnn_tpu_torch.optim
import cnn_tpu_torch.ops.augment, cnn_tpu_torch.ops.losses
import cnn_tpu_torch.ops.hopper.augment, cnn_tpu_torch.tools.rotate_phases
import cnn_tpu_torch.tools.train, cnn_tpu_torch.core.config
import cnn_tpu_torch.data.image, cnn_tpu_torch.data.loader
import cnn_tpu_torch.utils.metrics, cnn_tpu_torch.utils.history
import cnn_tpu_torch.utils.profiling
import cnn_tpu_torch.tools.infer, cnn_tpu_torch.tools.gradcam
import cnn_tpu_torch.tools.evaluate, cnn_tpu_torch.ops.dropout
import cnn_tpu_torch.ops.tensor
import cnn_tpu_torch.models.resnet, cnn_tpu_torch.models.vgg
import cnn_tpu_torch.models.mobilenet, cnn_tpu_torch.models.pipecnn
import cnn_tpu_torch.models.base, cnn_tpu_torch.ops.pool, cnn_tpu_torch.ops.conv
import cnn_tpu_torch.nn.module, cnn_tpu_torch.nn.sequential
import cnn_tpu_torch.quant, cnn_tpu_torch.export, cnn_tpu_torch.tools.serve
import cnn_tpu_torch.tools.export_artifact, cnn_tpu_torch.tools.convert
import cnn_tpu_torch.tools.plot, cnn_tpu_torch.tools.make_gif
import importlib, pkgutil
# and every module of the package, those the list above does not name
walked = [m.name for m in pkgutil.walk_packages(cnn_tpu_torch.__path__,
                                                "cnn_tpu_torch.")]
for name in walked:
    importlib.import_module(name)
assert {"cnn_tpu_torch.optim", "cnn_tpu_torch.tools.train"} <= set(walked)
import chip_smoke
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("clean")
"""


def _no_cuda_env():
    return {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def test_port_imports_nothing_of_jax_optax_cv2_or_cnn_tpu():
    out = subprocess.run([sys.executable, "-c", BLOCKER], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_no_cuda_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in _no_cuda_env().items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cnn_tpu_torch.default_device()
    with pytest.raises(RuntimeError):
        get_model("alexnet", image_size=64)
    model = get_model("alexnet", image_size=64, device="cpu")
    with pytest.raises(RuntimeError):
        InferenceEngine(model, buckets=(1,))
    assert cnn_tpu_torch.default_device("cpu") == torch.device("cpu")
    labels, probs = InferenceEngine(model, buckets=(1,), device="cpu").predict(
        np.zeros((2, 64, 64, 3), np.uint8))
    assert labels.shape == (2,) and probs.shape == (2, 3)
    # the train CLI asks for the card before it reads the dataset
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--dataset-path", "/nonexistent", "--total-iters", "1"])


def test_training_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    """The training slice's entry points take the card by default too: the
    device dataset uploads to CUDA unless asked for the CPU, and the train
    state's generator lives on the model's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    images = np.zeros((4, 64, 64, 3), np.uint8)
    labels = np.zeros(4, np.int64)
    with pytest.raises(RuntimeError):
        DeviceDataset.from_arrays(images, labels)
    ds = DeviceDataset.from_arrays(images, labels, device="cpu")
    assert ds.images.device.type == "cpu" and ds.images.dtype == torch.uint8
    model = get_model("alexnet", image_size=64, device="cpu")
    opt = make_optimizer("momentum", 0.01)
    ts = create_train_state(model, opt)
    assert ts.rng.device.type == "cpu"
    ts, m = make_device_train_step(model, opt, ds, 2)(ts)
    assert torch.isfinite(m["loss"])


def test_inference_tools_need_cuda_or_an_explicit_cpu(monkeypatch, tmp_path):
    """infer, gradcam and evaluate take the card by default: without one
    they raise before reading a checkpoint or an image, and run when asked
    for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                        "iter_12000_train_0.997_valid_0.937.ckpt")
    img = tmp_path / "grey.ppm"
    img.write_bytes(b"P6\n32 32\n255\n" + bytes(32 * 32 * 3))
    tools = {
        infer: ["--checkpoint", ckpt, "--batch-norm", str(img)],
        gradcam: ["--checkpoint", ckpt, "--batch-norm",
                  "--layer", "conv_layer_2", "--output-dir",
                  str(tmp_path / "cam"), str(img)],
        evaluate: ["--resume", ckpt, "--dataset-path", "/nonexistent"],
    }
    for tool, argv in tools.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main(argv)
    assert infer.main(tools[infer], device="cpu") == 0
    assert gradcam.main(tools[gradcam], device="cpu") == 0
    assert (tmp_path / "cam" / "0.png").exists()


@pytest.mark.parametrize("name", ["resnet10", "vgg8", "mobilenet", "pipecnn"])
def test_family_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch, name):
    """The families build on the card by default, and on the CPU when asked
    for it, where the serving engine runs them eagerly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = {"width": 8, "n_blocks": 2} if name == "pipecnn" else {}
    with pytest.raises(RuntimeError):
        get_model(name, image_size=32, **small)
    model = get_model(name, image_size=32, device="cpu", **small)
    with pytest.raises(RuntimeError):
        InferenceEngine(model, buckets=(1,))
    engine = InferenceEngine(model, buckets=(1, 4), device="cpu")
    engine.warmup()
    labels, probs = engine.predict(np.zeros((5, 32, 32, 3), np.uint8))
    assert labels.shape == (5,) and probs.shape == (5, 3)
    assert np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)


def test_serving_tools_need_cuda_or_an_explicit_cpu(monkeypatch, tmp_path):
    """serve, export_artifact and convert, ``fold_batchnorm``'s model, the
    int8 engine and ``ServingArtifact.load`` take the card by default:
    without one they raise before reading a checkpoint or an image, and
    run when asked for the CPU."""
    from cnn_tpu_torch.export import ServingArtifact
    from cnn_tpu_torch.quant import fold_batchnorm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model_file = os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                              "iter_12000_train_0.997_valid_0.937.model")
    img = tmp_path / "grey.ppm"
    img.write_bytes(b"P6\n32 32\n255\n" + bytes(32 * 32 * 3))
    art = str(tmp_path / "a.ctsa")
    tools = {
        serve: ["--checkpoint", model_file, "--batch-norm", str(img)],
        export_artifact: [model_file, art, "--batch-norm", "true"],
        convert: [model_file, str(tmp_path / "a.ckpt"), "--batch-norm",
                  "true"],
    }
    for tool, argv in tools.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main(argv)
        assert tool.main(argv, device="cpu") == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingArtifact.load(art)
    assert ServingArtifact.load(art, device="cpu").image_size == 224
    model = get_model("alexnet", batch_norm=True, image_size=64,
                      device="cpu")
    folded = fold_batchnorm(model)
    assert next(folded.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError):
        InferenceEngine(folded, buckets=(1,))
    with pytest.raises(RuntimeError):
        InferenceEngine(model, buckets=(1,),
                        int8_calib=np.zeros((2, 64, 64, 3), np.uint8))
    engine = InferenceEngine(model, buckets=(1,), device="cpu",
                             int8_calib=np.zeros((2, 64, 64, 3), np.uint8))
    assert engine.predict(np.zeros((1, 64, 64, 3), np.uint8))[1].shape == (
        1, 3)
