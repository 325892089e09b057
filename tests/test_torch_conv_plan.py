"""The conv kernels' tile plan (``cnn_tpu_torch/ops/hopper/conv.py``) and the
dispatch between the tiled and the direct kernel, on the CPU; the plain conv
against cnn_tpu's Pallas ``_forward`` (interpret mode) and XLA conv on the
geometries of AlexNet's conv2-4, the shapes the tiled kernel takes."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu import ops as jops
from cnn_tpu.ops.pallas.conv import _forward as pallas_conv_forward
from cnn_tpu_torch.ops.conv import conv2d, conv_out_size
from cnn_tpu_torch.ops.hopper import conv as hconv
from cnn_tpu_torch.ops.hopper import reset_launches
from cnn_tpu_torch.ops.hopper._build import SIGNATURES
from cnn_tpu_torch.ops.hopper.conv import (H100_SMS, STATIC_SMEM_LIMIT, TILES,
                                           conv2d_bias_relu, conv_tile_plan)

# float32 sums in another order than XLA's: 1e-5 absolute and relative, the
# bar of tests/test_torch_ops.py's CONV_CASES
CONV_TOL = dict(atol=1e-5, rtol=1e-5)
CONV_CU = (Path(__file__).resolve().parents[1] / "cnn_tpu_torch" / "csrc"
           / "conv.cu")

# (H, Cin, Cout) of the BN AlexNet's convs at 224 px, all 3x3 stride 2
ALEXNET = {"conv1": (224, 3, 16), "conv2": (55, 16, 32),
           "conv3": (27, 32, 64), "conv4": (13, 64, 128)}


def _m(b, h, w, k, s):
    return b * conv_out_size(h, k, s) * conv_out_size(w, k, s)


@pytest.mark.parametrize("batch", [1, 64, 256])
@pytest.mark.parametrize("layer", ["conv2", "conv3", "conv4"])
def test_plan_sends_conv2_to_4_to_the_tiled_kernel(layer, batch):
    h, cin, cout = ALEXNET[layer]
    plan = conv_tile_plan(batch, h, h, cin, cout, 3, 2, aligned=True)
    assert plan.variant == "tiled"
    tile = TILES[plan.tile]
    assert tile.bn in (cout, cout // 2)
    m = _m(batch, h, h, 3, 2)
    blocks = plan.grid[0] * plan.grid[1]
    # two waves of 132 SMs where M allows; else the most blocks it can get
    if blocks < 2 * H100_SMS:
        assert all(-(-m // t.bm) * -(-cout // t.bn) <= blocks for t in TILES
                   if t.bn in (cout, cout // 2))


@pytest.mark.parametrize("case", [
    # (B, H, W, Cin, Cout, k, stride, aligned)
    ("conv1 (Cin 3)", (64, 224, 224, 3, 16, 3, 2, True)),
    ("Cout 7", (4, 33, 20, 5, 7, 3, 1, True)),
    ("Cout 7, Cin 8", (4, 33, 20, 8, 7, 3, 1, True)),
    ("Cin 4", (2, 27, 27, 4, 32, 3, 2, True)),
    ("misaligned weights", (4, 27, 27, 32, 64, 3, 2, False)),
], ids=lambda c: c[0])
def test_plan_sends_the_rest_to_the_direct_kernel(case):
    plan = conv_tile_plan(*case[1])
    assert plan.variant == "direct" and plan.tile is None and plan.grid is None


@pytest.mark.parametrize("shape", [
    (3, 13, 13, 32, 64, 3, 2),      # 6x6 output, M = 108: a tail of 44 rows
    (1, 9, 12, 8, 12, 3, 1),        # stride 1, Cout 12: an N tail
    (2, 11, 11, 8, 8, 5, 2),        # k = 5
    (1, 13, 13, 16, 132, 3, 2),     # Cout above 128
    (256, 13, 13, 64, 128, 3, 2),
    (256, 55, 55, 16, 32, 3, 2),
])
def test_plan_grid_covers_m_and_n_exactly(shape):
    b, h, w, cin, cout, k, s = shape
    plan = conv_tile_plan(b, h, w, cin, cout, k, s, aligned=True)
    tile = TILES[plan.tile]
    m = _m(b, h, w, k, s)
    gx, gy = plan.grid
    assert (gx - 1) * tile.bm < m <= gx * tile.bm
    assert (gy - 1) * tile.bn < cout <= gy * tile.bn


@pytest.mark.parametrize("tile", range(len(TILES)))
def test_every_tile_fits_static_shared_memory_and_its_block(tile):
    t = TILES[tile]
    assert t.smem_bytes <= STATIC_SMEM_LIMIT
    assert t.bm % t.tm == 0 and t.bn % t.tn == 0 and t.tn % 4 == 0
    assert 32 <= t.threads <= 1024 and t.threads % 32 == 0


def test_tiles_match_the_cuda_source():
    """The plan's tile ids index the kernel's switch in ``csrc/conv.cu``."""
    src = CONV_CU.read_text()
    cases = re.findall(r"case (\d+): return \(int\)launch_tiled<(\d+), (\d+), "
                       r"(\d+), (\d+)>", src)
    assert [(int(c), *map(int, rest)) for c, *rest in cases] == [
        (i, *t) for i, t in enumerate(TILES)]
    assert re.search(r"constexpr int kBK = (\d+);", src).group(1) == str(
        hconv.TILED_BK)
    assert re.search(r"constexpr int kBKPad = (\d+);", src).group(1) == str(
        hconv.TILED_BK_PAD)
    assert re.search(r"constexpr int kStages = (\d+);", src).group(1) == str(
        hconv.TILED_STAGES)
    assert len(SIGNATURES["cnn_conv2d_bias_relu_tiled"]) == len(
        SIGNATURES["cnn_conv2d_bias_relu"]) + 1


@pytest.mark.parametrize("layer", ["conv1", "conv2", "conv3", "conv4"])
def test_wrapper_launches_the_plans_kernel_and_counts_it(monkeypatch, layer):
    """Off the CPU the wrapper calls the entry point the plan names, with its
    tile id, and counts the launch under its variant (meta tensors stand in
    for the card; the launch is recorded, not made)."""
    calls = []
    monkeypatch.setattr(hconv, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hconv, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    h, cin, cout = ALEXNET[layer]
    x = torch.empty((2, h, h, cin), device="meta")
    w = torch.empty((3, 3, cin, cout), device="meta")
    b = torch.empty((cout,), device="meta")
    reset_launches()
    y = conv2d_bias_relu(x, w, b, 2, True)
    assert y.shape == (2, conv_out_size(h, 3, 2), conv_out_size(h, 3, 2), cout)
    plan = conv_tile_plan(2, h, h, cin, cout, 3, 2, aligned=True)
    (name, args), = calls
    if layer == "conv1":
        assert name == "cnn_conv2d_bias_relu" and plan.variant == "direct"
        assert len(args) == len(SIGNATURES[name])
    else:
        assert name == "cnn_conv2d_bias_relu_tiled" and args[-1] == plan.tile
        assert len(args) == len(SIGNATURES[name])
    tiled = int(layer != "conv1")
    assert (conv2d_bias_relu.launches, conv2d_bias_relu.launches_tiled,
            conv2d_bias_relu.launches_direct) == (1, tiled, 1 - tiled)
    reset_launches()
    assert (conv2d_bias_relu.launches, conv2d_bias_relu.launches_tiled,
            conv2d_bias_relu.launches_direct) == (0, 0, 0)


@pytest.mark.parametrize("relu_on", [False, True])
@pytest.mark.parametrize("geometry", [
    # (B, H, Cin, Cout): conv2-4 of the AlexNet at small B, and conv3's
    # output geometry at B = 3 (108 rows, an M tail for every tile)
    (2, 55, 16, 32), (2, 27, 32, 64), (2, 13, 64, 128), (3, 13, 32, 64),
], ids=lambda g: "x".join(map(str, g)))
def test_plain_conv_vs_pallas_interpret_and_xla_on_tiled_shapes(
        rng, geometry, relu_on):
    b, h, cin, cout = geometry
    x = np.maximum(rng.standard_normal((b, h, h, cin)), 0).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    pallas = np.asarray(pallas_conv_forward(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), 2, relu_on,
        interpret=True))
    xla = jops.conv2d({"w": jnp.asarray(wt), "b": jnp.asarray(bias)},
                      jnp.asarray(x), 2)
    if relu_on:
        xla = jops.relu(xla)
    got = conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                 torch.from_numpy(bias), 2, relu_on).numpy()
    assert got.shape == pallas.shape == (b, conv_out_size(h, 3, 2),
                                         conv_out_size(h, 3, 2), cout)
    np.testing.assert_allclose(got, pallas, **CONV_TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **CONV_TOL)
