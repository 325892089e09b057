"""Serving artifacts (``cnn_tpu_torch/export.py``) on the CPU: the float32,
folded and int8 programs of the committed ResNet10 at 64 px round-trip
through a file and give the engine's results bit for bit at two batch
sizes and through ``InferenceEngine.from_artifact``; the file keeps
``cnn_tpu``'s container and header keys; a file without the magic, a
``cnn_tpu`` StableHLO artifact, an MoE model and a device outside the
header's platforms are refused."""

import glob
import json
import os
import struct

import numpy as np
import pytest
import torch

from cnn_tpu.export import export_serving_artifact as j_export
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu_torch.export import (ServingArtifact, export_serving_artifact)
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.quant import fold_batchnorm
from cnn_tpu_torch.serving import InferenceEngine
from cnn_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = sorted(glob.glob(os.path.join(REPO, "checkpoints", "resnet10",
                                     "iter_*.ckpt")),
              key=lambda p: int(os.path.basename(p).split("_")[1]))[-1]
SIZE = 64


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def model():
    payload = ckpt.read_checkpoint(CKPT)
    m = get_model("resnet10", num_classes=3, image_size=SIZE,
                  batch_norm=True, device="cpu")
    ckpt.load_jax_params(m, payload["params"], payload["state"])
    return m.eval()


def _header(path):
    with open(path, "rb") as f:
        assert f.read(4) == b"CTSA"
        (n,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(n).decode())


@pytest.mark.parametrize("kind", ["float32", "folded", "int8"])
def test_artifact_round_trip(tmp_path, model, kind):
    """Each kind exported, loaded and run at batches 3 and 8: labels and
    probabilities bit-equal to the engine of the same model (``int8``:
    calibrated on the same images); through ``from_artifact`` too."""
    calib = _images(8, seed=1) if kind == "int8" else None
    served = fold_batchnorm(model) if kind == "folded" else model
    path = str(tmp_path / f"{kind}.ctsa")
    meta = export_serving_artifact(served, path, int8_calib=calib,
                                   class_names=["dog", "panda", "bird"])
    assert meta == _header(path)
    assert meta["int8"] == (kind == "int8")
    art = ServingArtifact.load(path, device="cpu")
    assert art.image_size == SIZE and art.device == torch.device("cpu")
    eng = InferenceEngine(served, buckets=(1, 8), device="cpu",
                          int8_calib=calib)
    from_art = InferenceEngine.from_artifact(art, buckets=(1, 8))
    imgs = _images(8, seed=2)
    for n in (3, 8):
        labels, probs = art.predict(imgs[:n])
        want_l, want_p = eng.predict(imgs[:n])
        assert labels.shape == (n,) and probs.shape == (n, 3)
        assert np.array_equal(labels, want_l)
        assert np.array_equal(probs, want_p)
        fl, fp = from_art.predict(imgs[:n])
        assert np.array_equal(fl, want_l) and np.array_equal(fp, want_p)


def test_header_has_cnn_tpus_keys(tmp_path, model):
    """The same header keys as ``cnn_tpu``'s artifact, with the port's
    format name and platforms."""
    jm = j_get_model("alexnet", num_classes=3, image_size=SIZE)
    jparams, jstate = jm.init(__import__("jax").random.key(0))
    jpath = str(tmp_path / "jax.ctsa")
    j_export(jm, jparams, jstate, jpath, platforms=("cpu",))
    path = str(tmp_path / "port.ctsa")
    export_serving_artifact(fold_batchnorm(model), path,
                            compute_dtype=torch.bfloat16)
    mine, theirs = _header(path), _header(jpath)
    assert sorted(mine) == sorted(theirs)
    assert mine["format"] == "cnn_tpu_torch-serving-artifact"
    assert theirs["format"] == "cnn_tpu-serving-artifact"
    assert mine["platforms"] == ["cuda", "cpu"]
    assert mine["compute_dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="StableHLO artifact of the JAX "
                                         "package"):
        ServingArtifact.load(jpath, device="cpu")


def test_artifact_refuses_other_files(tmp_path):
    """A file without the magic: ``cnn_tpu``'s message."""
    bad = tmp_path / "x.ctsa"
    bad.write_bytes(b"NOPE" + b"\0" * 16)
    with pytest.raises(ValueError, match=r"not a cnn_tpu serving artifact "
                                         r"\(magic b'NOPE'\)"):
        ServingArtifact.load(str(bad), device="cpu")


def test_artifact_refuses_a_device_outside_its_platforms(tmp_path, model):
    path = str(tmp_path / "cpu_only.ctsa")
    export_serving_artifact(fold_batchnorm(model), path, platforms=("cpu",))
    with pytest.raises(ValueError, match=r"exported for \['cpu'\], not "
                                         "cuda"):
        ServingArtifact.load(path, device="cuda")


def test_moecnn_export_raises_with_the_reason(tmp_path):
    """MoECNN's capacity is a float floor of the batch, which one program
    with a symbolic batch cannot hold: refused, no file written."""
    m = get_model("moecnn", num_classes=3, image_size=32, width=8,
                  n_experts=2, expert_hidden=8, device="cpu")
    path = tmp_path / "moe.ctsa"
    with pytest.raises(ValueError, match="expert capacity"):
        export_serving_artifact(m, str(path))
    assert not path.exists()


def test_exported_program_calls_the_kernels_by_name(tmp_path, model):
    """The program records the normalize and conv kernels as operators (and
    AlexNet's pool): a CUDA load launches the kernels, a CPU load runs the
    plain versions."""
    path = str(tmp_path / "f.ctsa")
    export_serving_artifact(fold_batchnorm(model), path)
    with open(path, "rb") as f:
        data = f.read()
    for op in (b"cnn_tpu_torch.uint8_normalize",
               b"cnn_tpu_torch.conv2d_bias_relu"):
        assert op in data
    alex = get_model("alexnet", num_classes=3, image_size=SIZE,
                     device="cpu").eval()
    export_serving_artifact(alex, str(tmp_path / "a.ctsa"))
    with open(tmp_path / "a.ctsa", "rb") as f:
        assert b"cnn_tpu_torch.max_pool2d_fwd" in f.read()
