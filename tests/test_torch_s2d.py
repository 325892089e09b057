"""Space-to-depth convs against ``cnn_tpu`` on the CPU (numpy seed 23).
The port keeps ``cnn_tpu``'s ``s2d`` flag but runs a flagged conv as the
stride-2 conv it computes (``nn/module.py:Conv2D``), so ``cnn_tpu``'s
``conv2d_s2d`` is the reference here: on the cases of
``tests/test_s2d.py`` with its gradients; the flagged layer the same as
the unflagged one; the shapes an s2d AlexNet gives the conv kernels and
the kernels their plans pick there; AlexNet with ``space_to_depth=True``
against ``cnn_tpu``'s on the fixture photos; and the train CLI's
``--space-to-depth``."""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu import ops as j_ops
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.tools import train as j_train
from cnn_tpu.utils.checkpoint import import_reference_model as j_import
import cnn_tpu_torch.nn.module as nn_module
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.nn import Conv2D
from cnn_tpu_torch.ops.hopper.conv import conv_bf16_plan, conv_tile_plan
from cnn_tpu_torch.ops.preprocess import uint8_to_float
from cnn_tpu_torch.tools import train
from cnn_tpu_torch.utils.checkpoint import load_reference_model
from test_torch_data import write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                     "iter_12000_train_0.997_valid_0.937.model")
SEED = 23
TOL = 1e-5            # the conv and its gradients, times max(1, max|ref|)
LOGIT_TOL = 1e-4      # the model's logits, times max(1, max|ref|)


def _scaled(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, np.abs(want).max()))


# tests/test_s2d.py's cases: (H, k, padding), odd and even extents, k 1-5
@pytest.mark.parametrize("h,k,pad", [(224, 3, 0), (55, 3, 0), (64, 3, 1),
                                     (57, 1, 0), (33, 5, 2), (65, 2, 0),
                                     (64, 2, 0), (31, 4, 1)])
def test_conv2d_s2d_matches_cnn_tpu(h, k, pad):
    """The s2d layer (the stride-2 conv, on the kernels' plain versions
    here) against ``cnn_tpu``'s ``conv2d_s2d`` and direct conv; the loss
    ``sum(y * r)``'s gradients for x, w and b against ``jax.grad``; all
    within 1e-5 x max(1, max|ref|)."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((2, h, h, 3)).astype(np.float32)
    params = {"w": (rng.standard_normal((k, k, 3, 16)) * 0.1).astype(
                  np.float32),
              "b": (rng.standard_normal((16,)) * 0.1).astype(np.float32)}
    want = j_ops.conv2d_s2d(params, jnp.asarray(x), stride=2, padding=pad)
    direct = j_ops.conv2d(params, jnp.asarray(x), stride=2, padding=pad)
    r = rng.standard_normal(want.shape).astype(np.float32)
    jg = jax.grad(lambda p, xx: jnp.sum(j_ops.conv2d_s2d(
        p, xx, stride=2, padding=pad) * r), argnums=(0, 1))(
            params, jnp.asarray(x))

    layer = Conv2D("conv", 3, 16, k, 2, padding=pad, s2d=True, device="cpu")
    with torch.no_grad():
        layer.w.copy_(torch.from_numpy(params["w"]))
        layer.b.copy_(torch.from_numpy(params["b"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt)
    assert y.shape == want.shape
    assert _scaled(y.detach(), want) <= TOL
    assert _scaled(y.detach(), direct) <= TOL
    gx, gw, gb = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                     (xt, layer.w, layer.b))
    assert _scaled(gx, jg[1]) <= TOL
    assert _scaled(gw, jg[0]["w"]) <= TOL
    assert _scaled(gb, jg[0]["b"]) <= TOL


def test_s2d_layer_is_the_stride_two_conv():
    """A layer flagged ``s2d`` keeps the [k, k, Cin, Cout] parameters and
    gives, with ReLU fused and without, the same output and gradients as
    the unflagged layer, bit for bit; the flag needs stride 2."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((2, 17, 17, 3)).astype(
        np.float32))
    layers = {s2d: Conv2D("conv", 3, 8, 3, 2, padding=1, s2d=s2d,
                          device="cpu",
                          generator=torch.Generator().manual_seed(SEED))
              for s2d in (True, False)}
    assert layers[True].w.shape == (3, 3, 3, 8)
    for relu in (False, True):
        got = {}
        for s2d, layer in layers.items():
            xt = x.clone().requires_grad_(True)
            y = layer(xt, relu=relu)
            got[s2d] = (y, *torch.autograd.grad(y.square().sum(),
                                                (xt, layer.w, layer.b)))
        for a, b in zip(got[True], got[False]):
            assert torch.equal(a, b)
    with pytest.raises(AssertionError, match="stride-2"):
        Conv2D("conv", 3, 8, 3, 1, s2d=True, device="cpu")


def test_s2d_alexnet_reaches_the_fast_kernels():
    """AlexNet with ``space_to_depth`` at 224 px hands the conv wrapper the
    same convs as without: conv1 [B,224,224,3] x [3,3,3,16] and conv2
    [B,55,55,16] x [3,3,16,32], both at stride 2; at batch 64 and 256
    their plans take the strip and the tiled kernel in float32 and the
    strip and wgmma in bf16, never the direct kernel or the gather."""
    seen = {}
    real = nn_module.conv2d_bias_relu
    for s2d in (True, False):
        model = get_model("alexnet", num_classes=3, batch_norm=True,
                          space_to_depth=s2d, device="cpu").eval()
        calls = seen[s2d] = []

        def rec(x, w, b, stride, relu, *pad):
            calls.append((tuple(x.shape[1:]), tuple(w.shape), stride, pad))
            return real(x, w, b, stride, relu, *pad)

        with mock.patch.object(nn_module, "conv2d_bias_relu", rec), \
                torch.no_grad():
            model(torch.zeros(1, 224, 224, 3))
    assert seen[True] == seen[False]
    assert seen[True][:2] == [((224, 224, 3), (3, 3, 3, 16), 2, ()),
                              ((55, 55, 16), (3, 3, 16, 32), 2, ())]
    want = {3: ("strip", "strip"), 16: ("tiled", "wgmma")}
    for (h, _, cin), (k, _, _, cout), stride, _ in seen[True][:2]:
        for bsz in (64, 256):
            plan = conv_tile_plan(bsz, h, h, cin, cout, k, stride, True)
            plan16 = conv_bf16_plan(bsz, h, h, cin, cout, k, stride, True)
            assert (plan.variant, plan16.variant) == want[cin]


def test_s2d_alexnet_matches_cnn_tpu():
    """The committed BN AlexNet with ``space_to_depth=True`` on the six
    fixture photos: logits within 1e-4 x max(1, max|ref|) of ``cnn_tpu``'s
    s2d model, the same classes, and bit-equal to the port's model without
    s2d."""
    fx = np.load(os.path.join(REPO, "tests", "fixtures",
                              "reference_parity.npz"))
    imgs = np.stack([fx[f"image_u8_{i}"] for i in range(6)])
    jm = j_get_model("alexnet", num_classes=3, batch_norm=True,
                     space_to_depth=True)
    params, state = j_import(MODEL, jm.net)
    want, _, _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False))(
        params, state, jnp.asarray(imgs, jnp.float32) / 255.0)
    x = uint8_to_float(torch.from_numpy(imgs))
    got = {}
    for s2d in (True, False):
        model = get_model("alexnet", num_classes=3, batch_norm=True,
                          space_to_depth=s2d, device="cpu")
        load_reference_model(model, MODEL)
        with torch.no_grad():
            got[s2d] = model.eval()(x).numpy()
    assert _scaled(got[True], want) <= LOGIT_TOL
    assert np.array_equal(got[True], got[False])
    assert (got[True].argmax(1) == np.asarray(want).argmax(1)).all()


def test_train_cli_space_to_depth(tmp_path, capsys):
    """``--space-to-depth true`` trains AlexNet for 2 iterations; with
    ``--name resnet10`` both CLIs exit with ``cnn_tpu``'s message."""
    data = write_dataset(tmp_path / "data", per_class=6)
    argv = ["--dataset-path", data, "--image-size", "64",
            "--train-batch-size", "8", "--valid-batch-size", "8",
            "--valid-iters", "2", "--save-iters", "2", "--augment", "false",
            "--batch-norm", "true", "--backend", "python", "--num-workers",
            "2", "--total-iters", "2", "--space-to-depth", "true"]
    assert train.main(argv + ["--checkpoint-dir", str(tmp_path / "t")],
                      device="cpu") == 0
    assert "training done!" in capsys.readouterr().out
    bad = argv + ["--name", "resnet10"]
    with pytest.raises(SystemExit) as want:
        j_train.main(bad + ["--checkpoint-dir", str(tmp_path / "j")])
    with pytest.raises(SystemExit) as got:
        train.main(bad + ["--checkpoint-dir", str(tmp_path / "r")],
                   device="cpu")
    assert str(got.value) == str(want.value)
    assert "--space-to-depth applies to the AlexNet family only" in \
        str(got.value)
