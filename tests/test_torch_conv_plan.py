"""The conv kernels' plan (``cnn_tpu_torch/ops/hopper/conv.py``) and the
dispatch between the strip, the tiled and the direct kernel, on the CPU; the
plain conv against cnn_tpu's Pallas ``_forward`` (interpret mode) and XLA
conv on the geometries of AlexNet's conv2-4, the shapes the tiled kernel
takes; a torch emulation of the strip kernel's walk (what each block
stages, which lane and slot write each output) against the plain conv and
the Pallas ``_forward`` on conv1's geometry."""

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
from cnn_tpu_torch.ops.hopper.conv import (H100_SMS, STATIC_SMEM_LIMIT,
                                           STRIP_ROWS, TILES,
                                           conv2d_bias_relu, conv_tile_plan,
                                           strip_input_rows, strip_smem_bytes)

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


# the kernel's lane walk: pixels l, l+32, l+64, l+96 of a 128-pixel chunk,
# 16 output channels at a time (csrc/conv.cu kStripSlots, kStripCo)
STRIP_SLOTS, STRIP_CO = 4, 16


@pytest.mark.parametrize("batch", [1, 64, 256])
@pytest.mark.parametrize("case", [
    # (H, W, Cin, Cout, k, stride)
    ("conv1 (Cin 3)", (224, 224, 3, 16, 3, 2)),
    ("Cin 1, stride 1", (40, 300, 1, 8, 3, 1)),
    ("Cin 4, Cout 32", (27, 27, 4, 32, 3, 2)),
    ("k 5", (33, 36, 2, 12, 5, 2)),
], ids=lambda c: c[0])
def test_plan_sends_conv1_to_the_strip_kernel(case, batch):
    h, w, cin, cout, k, s = case[1]
    plan = conv_tile_plan(batch, h, w, cin, cout, k, s, aligned=True)
    assert plan.variant == "strip" and plan.tile is None
    ho = conv_out_size(h, k, s)

    def blocks(r):
        return -(-ho // r) * batch

    fits = [r for r in STRIP_ROWS
            if strip_smem_bytes(min(r, ho), w, cin, cout, k, s)
            <= STATIC_SMEM_LIMIT]
    assert plan.rows in fits and plan.grid == (-(-ho // plan.rows), batch)
    # the most blocks; of R that tie, the smallest (fewest idle warps)
    assert all(blocks(r) < blocks(plan.rows) or
               (blocks(r) == blocks(plan.rows) and r >= plan.rows)
               for r in fits)
    if case[0] == "conv1 (Cin 3)":
        assert plan.rows == 2 and plan.grid == (56, batch)


@pytest.mark.parametrize("case", [
    # (B, H, W, Cin, Cout, k, stride, aligned)
    ("Cout 7", (4, 33, 20, 5, 7, 3, 1, True)),
    ("Cout 7, Cin 8", (4, 33, 20, 8, 7, 3, 1, True)),
    # Cin 4 is no multiple of 8 for the tiled kernel; Cout 48 is wider than
    # the strip kernel takes
    ("Cin 4", (2, 27, 27, 4, 48, 3, 2, True)),
    ("misaligned weights", (4, 27, 27, 32, 64, 3, 2, False)),
    ("conv1, x or w misaligned", (64, 224, 224, 3, 16, 3, 2, False)),
    ("conv1, a row of 669 floats", (64, 223, 223, 3, 16, 3, 2, True)),
    ("Cin 5", (2, 27, 28, 5, 16, 3, 2, True)),
    ("Cout 6", (2, 27, 28, 3, 6, 3, 2, True)),
    ("staged rows over 48 KB", (1, 64, 2048, 4, 16, 3, 2, True)),
    ("B over the grid's y", (65536, 8, 8, 3, 16, 3, 2, True)),
], ids=lambda c: c[0])
def test_plan_sends_the_rest_to_the_direct_kernel(case):
    plan = conv_tile_plan(*case[1])
    assert plan.variant == "direct" and plan.tile is None and plan.grid is None
    assert plan.rows is None


@pytest.mark.parametrize("shape", [
    (256, 224, 224, 3, 16, 3, 2),   # 111 rows: a tail of 7 at R = 8
    (64, 224, 224, 3, 16, 3, 2),
    (1, 224, 224, 3, 16, 3, 2),     # R = 2: a tail of 1
    (3, 20, 8, 4, 8, 5, 1),         # 16 rows
    (2, 9, 300, 1, 8, 3, 1),        # 7 rows: fewer than R
])
def test_strip_grid_covers_ho_exactly(shape):
    b, h, w, cin, cout, k, s = shape
    plan = conv_tile_plan(b, h, w, cin, cout, k, s, aligned=True)
    assert plan.variant == "strip"
    ho = conv_out_size(h, k, s)
    gx, gy = plan.grid
    assert (gx - 1) * plan.rows < ho <= gx * plan.rows and gy == b
    # each output row has one strip, whose staged rows lie in the image
    owner = []
    for st in range(gx):
        rows = min(plan.rows, ho - st * plan.rows)
        owner += [st] * rows
        assert st * plan.rows * s + strip_input_rows(rows, k, s) <= h
    assert len(owner) == ho


@pytest.mark.parametrize("rows", STRIP_ROWS)
def test_every_strip_fits_shared_memory_at_conv1(rows):
    """conv1's staged rows plus its 1,792 bytes of weights and bias stay
    within 48 KB for every R of the switch."""
    smem = strip_smem_bytes(rows, 224, 3, 16, 3, 2)
    assert smem == 4 * (3 * 3 * 3 * 16 + 16) + ((rows - 1) * 2 + 3) * 2688
    assert smem <= STATIC_SMEM_LIMIT
    assert {4: 25_984, 8: 47_488}.get(rows, smem) == smem


def test_strip_rows_match_the_cuda_source():
    """The plan's strip ids index the kernel's switch in ``csrc/conv.cu``."""
    src = CONV_CU.read_text()
    cases = re.findall(r"case (\d+): return \(int\)launch_strip<(\d+)>", src)
    assert [(int(c), int(r)) for c, r in cases] == list(enumerate(STRIP_ROWS))
    assert re.search(r"constexpr int kStripSlots = (\d+);", src).group(1) == \
        str(STRIP_SLOTS)
    assert re.search(r"constexpr int kStripCo = (\d+);", src).group(1) == \
        str(STRIP_CO)
    assert len(SIGNATURES["cnn_conv2d_bias_relu_strip"]) == len(
        SIGNATURES["cnn_conv2d_bias_relu"]) + 1


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
        assert name == "cnn_conv2d_bias_relu_strip" and plan.variant == "strip"
        assert args[-1] == STRIP_ROWS.index(plan.rows)
    else:
        assert name == "cnn_conv2d_bias_relu_tiled" and args[-1] == plan.tile
    assert len(args) == len(SIGNATURES[name])
    tiled = int(layer != "conv1")

    def counts():
        return (conv2d_bias_relu.launches, conv2d_bias_relu.launches_strip,
                conv2d_bias_relu.launches_tiled,
                conv2d_bias_relu.launches_direct)

    assert counts() == (1, 1 - tiled, tiled, 0)
    reset_launches()
    assert counts() == (0, 0, 0, 0)


def test_wrapper_counts_the_direct_kernel(monkeypatch):
    """A shape neither shared-memory kernel takes (Cout 7) goes to the
    direct kernel's entry point and counter."""
    calls = []
    monkeypatch.setattr(hconv, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hconv, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    x = torch.empty((2, 9, 9, 3), device="meta")
    w = torch.empty((3, 3, 3, 7), device="meta")
    reset_launches()
    conv2d_bias_relu(x, w, torch.empty((7,), device="meta"), 1, False)
    (name, args), = calls
    assert name == "cnn_conv2d_bias_relu"
    assert len(args) == len(SIGNATURES[name])
    assert (conv2d_bias_relu.launches, conv2d_bias_relu.launches_strip,
            conv2d_bias_relu.launches_tiled,
            conv2d_bias_relu.launches_direct) == (1, 0, 0, 1)
    reset_launches()


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


def _emulate_strip(x, w, bias, stride, relu, rows):
    """The strip kernel's walk in torch: for each block (strip, image), the
    input rows it stages, flattened as in shared memory; for each warp (an
    output row), 128-pixel chunk, lane and slot, the sum over (dy, dx, ci)
    in that order read from the staged rows alone, then bias and ReLU.
    Returns the output and how many times each (b, oy, ox, co) was
    written."""
    bsz, h, wid, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    ho, wo = conv_out_size(h, k, stride), conv_out_size(wid, k, stride)
    rowlen = wid * cin
    wk = w.reshape(k * k * cin, cout)
    y = torch.full((bsz, ho, wo, cout), float("nan"))
    writes = torch.zeros((bsz, ho, wo, cout), dtype=torch.int32)
    lane = torch.arange(32)[:, None]
    slot = torch.arange(STRIP_SLOTS)[None, :]
    for b in range(bsz):
        for st in range(-(-ho // rows)):
            oy0 = st * rows
            n = min(rows, ho - oy0)
            first, count = oy0 * stride, strip_input_rows(n, k, stride)
            assert first + count <= h
            staged = x[b, first:first + count].reshape(-1)
            for warp in range(n):
                for c0 in range(0, wo, 32 * STRIP_SLOTS):
                    ox = c0 + 32 * slot + lane               # [32, 4]
                    valid = ox < wo
                    base = torch.where(valid, ox, 0) * stride * cin
                    for co0 in range(0, cout, STRIP_CO):
                        co = torch.arange(co0, min(co0 + STRIP_CO, cout))
                        acc = torch.zeros((32, STRIP_SLOTS, co.numel()))
                        t = 0
                        for dy in range(k):
                            for dx in range(k):
                                for ci in range(cin):
                                    idx = ((warp * stride + dy) * rowlen
                                           + dx * cin + base + ci)
                                    assert int(idx.max()) < staged.numel()
                                    acc = acc + staged[idx][..., None] * wk[t, co]
                                    t += 1
                        out = acc + bias[co]
                        if relu:
                            out = torch.clamp_min(out, 0.0)
                        oxv = ox[valid]
                        y[b, oy0 + warp, oxv[:, None], co] = out[valid]
                        writes[b, oy0 + warp, oxv[:, None], co] += 1
    return y, writes


STRIP_WALKS = [
    # (B, H, W, Cin, Cout, k, stride): conv1's geometry, then rows past one
    # 128-pixel chunk, two passes of 16 channels, k 5, a partial channel
    # pass
    (2, 36, 36, 3, 16, 3, 2),
    (1, 9, 272, 1, 8, 3, 1),
    (1, 21, 24, 4, 32, 5, 2),
    (2, 15, 14, 2, 12, 3, 2),
]


@pytest.mark.parametrize("rows", STRIP_ROWS)
@pytest.mark.parametrize("shape", STRIP_WALKS,
                         ids=lambda g: "x".join(map(str, g)))
def test_strip_walk_writes_each_output_once_and_equals_the_plain_conv(
        rng, shape, rows):
    b, h, wid, cin, cout, k, s = shape
    assert (wid * cin) % 4 == 0
    x = torch.from_numpy(rng.random((b, h, wid, cin), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((k, k, cin, cout)) * 0.3)
                         .astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal((cout,)) * 0.1)
                            .astype(np.float32))
    for relu_on in (False, True):
        got, writes = _emulate_strip(x, w, bias, s, relu_on, rows)
        assert bool((writes == 1).all())
        torch.testing.assert_close(got, conv2d(x, w, bias, s, relu_on),
                                   **CONV_TOL)


@pytest.mark.parametrize("relu_on", [False, True])
def test_strip_walk_vs_pallas_interpret_on_conv1_geometry(rng, relu_on):
    """conv1's geometry (Cin 3 -> 16, 3x3 stride 2) at B = 2 and 36 px,
    through the strip walk with the plan's R, against cnn_tpu's Pallas
    ``_forward``."""
    b, h, cin, cout = 2, 36, 3, 16
    plan = conv_tile_plan(b, h, h, cin, cout, 3, 2, aligned=True)
    assert plan.variant == "strip"
    x = rng.random((b, h, h, cin), dtype=np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    want = np.asarray(pallas_conv_forward(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), 2, relu_on,
        interpret=True))
    got, writes = _emulate_strip(torch.from_numpy(x), torch.from_numpy(wt),
                                 torch.from_numpy(bias), 2, relu_on,
                                 plan.rows)
    assert bool((writes == 1).all())
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)
