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
from cnn_tpu_torch.ops.hopper import read_counters, reset_launches
from cnn_tpu_torch.ops.hopper._build import SIGNATURES
from cnn_tpu_torch.ops.hopper.conv import (H100_SMS, STATIC_SMEM_LIMIT,
                                           STRIP_SMEM_MAX, STRIP_WIDE_ROW,
                                           STRIP_YS,
                                           STRIP_COUT_MAX, STRIP_ROWS, TILES,
                                           conv2d_bias_relu, conv_tile_plan,
                                           strip_input_rows,
                                           strip_margin_floats,
                                           strip_smem_bytes)

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

    # R 4, or 8 past STRIP_WIDE_ROW output floats a row, among those that
    # fit; the largest of them with two blocks an SM, else the most blocks
    want = 8 if conv_out_size(w, k, s) * cout > STRIP_WIDE_ROW else 4
    fits = [r for r in STRIP_ROWS
            if r <= want and strip_smem_bytes(min(r, ho), w, cin, cout, k, s)
            <= STRIP_SMEM_MAX]
    assert plan.rows in fits and plan.grid == (-(-ho // plan.rows), batch)
    many = [r for r in fits if blocks(r) >= 2 * H100_SMS]
    assert plan.rows == (max(many) if many else min(fits))
    if case[0] == "conv1 (Cin 3)":
        rows = 2 if batch == 1 else 4
        assert plan.rows == rows and plan.grid == (-(-111 // rows), batch)


@pytest.mark.parametrize("case", [
    # (B, H, W, Cin, Cout, k, stride, aligned)
    ("Cout 7", (4, 33, 20, 5, 7, 3, 1, True)),
    ("Cout 7, Cin 8", (4, 33, 20, 8, 7, 3, 1, True)),
    # Cin 4 is no multiple of 8 for the tiled kernel; Cout 68 is wider than
    # the strip kernel takes (64)
    ("Cin 4", (2, 27, 27, 4, 68, 3, 2, True)),
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
    within 48 KB for every R of the switch (Cout 16: one pass, no output
    staging)."""
    smem = strip_smem_bytes(rows, 224, 3, 16, 3, 2)
    assert smem == 4 * (3 * 3 * 3 * 16 + 16) + ((rows - 1) * 2 + 3) * 2688
    assert smem <= STATIC_SMEM_LIMIT <= STRIP_SMEM_MAX
    assert {4: 25_984, 8: 47_488}.get(rows, smem) == smem


def test_strip_rows_match_the_cuda_source():
    """The plan's strip ids index the kernel's switch in ``csrc/conv.cu``."""
    src = CONV_CU.read_text()
    cases = re.findall(r"case (\d+): return \(int\)launch_strip_pad<(\d+)>",
                       src)
    assert [(int(c), int(r)) for c, r in cases] == list(enumerate(STRIP_ROWS))
    assert re.search(r"constexpr int kStripSlots = (\d+);", src).group(1) == \
        str(STRIP_SLOTS)
    assert re.search(r"constexpr int kStripCo = (\d+);", src).group(1) == \
        str(STRIP_CO)
    assert len(SIGNATURES["cnn_conv2d_bias_relu_strip"]) == len(
        SIGNATURES["cnn_conv2d_bias_relu"]) + 1
    # the padded layout: margins of p*Cin floats rounded up to 16 bytes on
    # each side of a row, and the launch's shared memory, as the plan's
    # strip_margin_floats / strip_smem_bytes compute them
    for line in ("return (p * Cin + 3) / 4 * 4;",
                 "return W * Cin + 2 * strip_margin_floats(p, Cin);",
                 "((rows - 1) * s + k) * strip_row_floats(W, Cin, p) +",
                 "4 * (size_t)strip_smem_floats(rows, k, s, W, Cin, Cout, p);",
                 "(Cout > kStripCo ? rows * 32 * kStripYs : 0);   // output "
                 "staging",
                 "return ((Cout + kStripCo - 1) / kStripCo * kStripCo * k * k "
                 "* Cin + Cout +\n          3) / 4 * 4;",
                 "constexpr int kStripYs = kStripCo + 4;",
                 f"constexpr int kStripSmemMax = {STRIP_SMEM_MAX // 1024} "
                 "* 1024;",
                 "if (smem > kStripSmemMax) return cudaErrorInvalidValue;",
                 "if (smem > 48 * 1024) {",
                 "const int Ho = (H + 2 * p - k) / s + 1, "
                 "Wo = (W + 2 * p - k) / s + 1;"):
        assert line in src, line
    for p, cin, want in ((0, 3, 0), (1, 3, 4), (1, 4, 4), (2, 3, 8),
                         (2, 1, 4), (3, 4, 12)):
        assert strip_margin_floats(p, cin) == want
    assert STRIP_YS == STRIP_CO + 4 and hconv.STRIP_CO == STRIP_CO
    assert strip_smem_bytes(2, 224, 3, 64, 3, 1, 1) == 4 * (
        (27 * 64 + 64) + 4 * (672 + 2 * 4) + 2 * 32 * STRIP_YS)
    # Cout 12: one block of 16 weight columns, no staging; Cout 24: two
    assert strip_smem_bytes(2, 16, 2, 12, 3, 1, 1) == 4 * (
        (18 * 16 + 12) + 4 * (32 + 2 * 4))
    assert strip_smem_bytes(2, 16, 2, 24, 3, 1, 0) == 4 * (
        (18 * 32 + 24) + 4 * 32 + 2 * 32 * STRIP_YS)


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


def test_wrapper_counts_the_padded_strip(monkeypatch):
    """A padded Cin-3 stem goes to the strip's entry point with its padding
    after the stride, and counts as a strip, a padded conv and a padded
    strip; AlexNet's unpadded conv1 counts no padded strip."""
    calls = []
    monkeypatch.setattr(hconv, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hconv, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    reset_launches()
    for cout, s in ((16, 2), (64, 1)):
        x = torch.empty((2, 224, 224, 3), device="meta")
        w = torch.empty((3, 3, 3, cout), device="meta")
        y = conv2d_bias_relu(x, w, torch.empty((cout,), device="meta"), s,
                             True, 1)
        assert y.shape == (2, 224 // s, 224 // s, cout)
        (name, args), = calls[-1:]
        plan = conv_tile_plan(2, 224, 224, 3, cout, 3, s, True, 1)
        assert name == "cnn_conv2d_bias_relu_strip"
        assert args[10:12] == (s, 1) and args[-1] == STRIP_ROWS.index(
            plan.rows)
    x = torch.empty((2, 224, 224, 3), device="meta")
    conv2d_bias_relu(x, torch.empty((3, 3, 3, 16), device="meta"),
                     torch.empty((16,), device="meta"), 2, True)
    c = {k.split(".")[1]: v for k, v in read_counters().items()
         if k.startswith("conv2d_bias_relu.")}
    assert (c["launches"], c["launches_strip"], c["launches_strip_padded"],
            c["launches_padded"], c["launches_direct"],
            c["launches_bf16_strip_padded"]) == (3, 3, 2, 2, 0, 0)
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


def _stage_padded(x, b, oy0, n, stride, padding, k):
    """A padded strip's staging as the kernel does it: one 16-byte
    cp.async per chunk of each staged row (the margins and rows outside the
    image zero-filled by a source size of 0), into a buffer of NaN, each
    destination and source 16-byte aligned. Returns the staged floats, the
    row stride and the shift of padded column 0."""
    _, h, wid, cin = x.shape
    rowlen = wid * cin
    margin = strip_margin_floats(padding, cin)
    assert margin % 4 == 0 and margin >= padding * cin
    rs = rowlen + 2 * margin
    nin = strip_input_rows(n, k, stride)
    n4, m4 = rowlen // 4, margin // 4
    staged = torch.full((nin * rs,), float("nan"))
    flat = x[b].reshape(-1)
    written = torch.zeros(nin * rs, dtype=torch.int32)
    for i in range(nin * (n4 + 2 * m4)):
        r, c = divmod(i, n4 + 2 * m4)
        iy = oy0 * stride - padding + r
        dst = r * rs + 4 * c
        assert dst % 4 == 0
        if m4 <= c < m4 + n4 and 0 <= iy < h:
            src = iy * rowlen + 4 * (c - m4)
            assert src % 4 == 0 and src + 4 <= flat.numel()
            staged[dst:dst + 4] = flat[src:src + 4]
        else:
            staged[dst:dst + 4] = 0.0
        written[dst:dst + 4] += 1
    assert bool((written == 1).all())
    return staged, rs, margin - padding * cin


def _emulate_strip(x, w, bias, stride, relu, rows, padding=0):
    """The strip kernel's walk in torch: for each block (strip, image), the
    input rows it stages, flattened as in shared memory (with ``padding``,
    each row with its zero margins and the rows outside the image zero,
    ``_stage_padded``); for each warp (an output row), 128-pixel chunk,
    lane and slot, the sum over (dy, dx, ci) in that order read from the
    staged rows alone, then bias and ReLU. Returns the output and how many
    times each (b, oy, ox, co) was written."""
    bsz, h, wid, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    ho = conv_out_size(h, k, stride, padding)
    wo = conv_out_size(wid, k, stride, padding)
    rowlen = wid * cin
    kk = k * k * cin
    # the weights as staged: blocks of 16 output channels, [Cout/16][K][16],
    # zero past Cout
    nblk = -(-cout // STRIP_CO)
    wpad = torch.zeros((kk, nblk * STRIP_CO))
    wpad[:, :cout] = w.reshape(kk, cout)
    sw = wpad.reshape(kk, nblk, STRIP_CO).permute(1, 0, 2).reshape(-1)
    y = torch.full((bsz, ho, wo, cout), float("nan"))
    writes = torch.zeros((bsz, ho, wo, cout), dtype=torch.int32)
    lane = torch.arange(32)[:, None]
    slot = torch.arange(STRIP_SLOTS)[None, :]
    for b in range(bsz):
        for st in range(-(-ho // rows)):
            oy0 = st * rows
            n = min(rows, ho - oy0)
            if padding:
                staged, rs, shift = _stage_padded(x, b, oy0, n, stride,
                                                  padding, k)
            else:
                first, count = oy0 * stride, strip_input_rows(n, k, stride)
                assert first + count <= h
                staged, rs, shift = x[b, first:first + count].reshape(-1), \
                    rowlen, 0
            for warp in range(n):
                for c0 in range(0, wo, 32 * STRIP_SLOTS):
                    ox = c0 + 32 * slot + lane               # [32, 4]
                    valid = ox < wo
                    base = torch.where(valid, ox, 0) * stride * cin
                    for co0 in range(0, cout, STRIP_CO):
                        co = torch.arange(co0, min(co0 + STRIP_CO, cout))
                        acc = torch.zeros((32, STRIP_SLOTS, co.numel()))
                        wp = co0 * kk        # this pass's weight block
                        for dy in range(k):
                            for dx in range(k):
                                for ci in range(cin):
                                    idx = ((warp * stride + dy) * rs + shift
                                           + dx * cin + base + ci)
                                    assert int(idx.min()) >= 0
                                    assert int(idx.max()) < staged.numel()
                                    wv = sw[wp:wp + co.numel()]
                                    acc = acc + staged[idx][..., None] * wv
                                    wp += STRIP_CO
                        out = acc + bias[co]
                        if relu:
                            out = torch.clamp_min(out, 0.0)
                        _store_slots(y, writes, out, b, oy0 + warp, c0,
                                     co0, wo)
    return y, writes


def _store_slots(y, writes, out, b, oy, c0, co0, wo):
    """The strip's epilogue for one pass of channels. Cout <= 16: lane l
    stores its pixel's channels itself. Wider: each slot's 32 pixels
    through the warp's staging (lane l writes its pixel's channels at
    l * STRIP_YS, 16-byte aligned), then 16-byte chunks in pixel order,
    lane l on chunk l + 32q: pixel (l + 32q) // 4, part (l + 32q) % 4."""
    cout = y.shape[-1]
    nco = out.shape[-1]
    for j in range(STRIP_SLOTS):
        px0 = c0 + 32 * j
        if px0 >= wo:
            break
        if cout <= STRIP_CO:
            for lane in range(min(32, wo - px0)):
                y[b, oy, px0 + lane] = out[lane, j]
                writes[b, oy, px0 + lane] += 1
            continue
        staging = torch.full((32 * STRIP_YS,), float("nan"))
        for lane in range(32):
            assert (lane * STRIP_YS) % 4 == 0
            staging[lane * STRIP_YS:lane * STRIP_YS + nco] = out[lane, j]
        npx = min(32, wo - px0)
        for q in range(4):
            for lane in range(32):
                i = lane + 32 * q
                px, part = i >> 2, i & 3
                if px < npx and co0 + 4 * part < cout:
                    src = px * STRIP_YS + 4 * part
                    assert src % 4 == 0 and (co0 + 4 * part) % 4 == 0
                    c = slice(co0 + 4 * part, co0 + 4 * part + 4)
                    y[b, oy, px0 + px, c] = staging[src:src + 4]
                    writes[b, oy, px0 + px, c] += 1


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


# the families' padded Cin-3 stems (k 3, p 1), scaled down to 32 px and
# batch 2: resnet10 3 -> 16 s2, resnet18 / mobilenet 3 -> 32 s2, pipecnn
# 3 -> 64 s2, vgg8 3 -> 32 s1, vgg11 3 -> 64 s1 (Ho 16 or 32); then a
# ragged last strip at every R (Ho 13), a row past one 128-pixel chunk,
# padding 2 and Cin 4 / Cin 1 (margins of 8 and 2 floats, rounded to 8 and
# 4)
PADDED_STEMS = {
    "resnet10": (2, 32, 32, 3, 16, 3, 2, 1),
    "resnet18_mobilenet": (2, 32, 32, 3, 32, 3, 2, 1),
    "pipecnn": (2, 32, 32, 3, 64, 3, 2, 1),
    "vgg8": (1, 32, 32, 3, 32, 3, 1, 1),
    "vgg11": (1, 32, 32, 3, 64, 3, 1, 1),
}
PADDED_WALKS = {
    "ragged_13_rows": (1, 25, 28, 3, 16, 3, 2, 1),
    "row_past_128": (1, 5, 136, 3, 8, 3, 1, 1),
    "cin4_pad2": (1, 11, 12, 4, 12, 3, 2, 2),
    "cin1_k5": (1, 14, 16, 1, 8, 5, 1, 2),
}


def _f32_inputs(rng, b, h, wid, cin, cout, k):
    x = torch.from_numpy(rng.random((b, h, wid, cin), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((k, k, cin, cout)) * 0.3)
                         .astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal((cout,)) * 0.1)
                            .astype(np.float32))
    return x, w, bias


@pytest.mark.parametrize("batch", [1, 8, 64, 256])
@pytest.mark.parametrize("stem", list(PADDED_STEMS))
def test_plan_sends_the_padded_stems_to_the_strip(stem, batch):
    """At full size (224 px) every family's padded Cin-3 stem takes the
    strip: R 8 where a row holds more than 4,096 output floats (3 -> 64,
    and stride 1), else 4; 2 at batch 1 (and 8 at stride 2), 4 for the
    stride-1 stems at 8, where larger R would leave fewer than two blocks
    an SM."""
    _, _, _, cin, cout, k, s, p = PADDED_STEMS[stem]
    plan = conv_tile_plan(batch, 224, 224, cin, cout, k, s, True, p)
    ho = conv_out_size(224, k, s, p)
    want = {1: 2, 8: 4 if s == 1 else 2}.get(
        batch, 8 if ho * cout > STRIP_WIDE_ROW else 4)
    assert plan.variant == "strip" and plan.rows == want
    assert plan.grid == (-(-ho // want), batch)
    assert cout <= STRIP_COUT_MAX
    assert strip_smem_bytes(want, 224, cin, cout, k, s, p) <= STRIP_SMEM_MAX


@pytest.mark.parametrize("rows", STRIP_ROWS)
@pytest.mark.parametrize("shape", [*PADDED_STEMS.values(),
                                   *PADDED_WALKS.values()],
                         ids=[*PADDED_STEMS, *PADDED_WALKS])
def test_padded_strip_walk_writes_each_output_once_and_equals_the_plain_conv(
        rng, shape, rows):
    """The padded walk: staged rows with zero margins and zero rows,
    16-byte-aligned copies, reads inside the staged rows, each output
    written once, equal to the plain conv at the conv tolerance."""
    b, h, wid, cin, cout, k, s, p = shape
    x, w, bias = _f32_inputs(rng, b, h, wid, cin, cout, k)
    for relu_on in (False, True):
        got, writes = _emulate_strip(x, w, bias, s, relu_on, rows, p)
        assert bool((writes == 1).all())
        assert not bool(got.isnan().any())
        torch.testing.assert_close(got, conv2d(x, w, bias, s, relu_on, p),
                                   **CONV_TOL)


def test_padded_strip_walk_vs_cnn_tpu(rng):
    """resnet10's stem geometry (3 -> 16, k3 s2 p1) at 32 px through the
    padded walk with the plan's R, against cnn_tpu's Pallas ``_forward`` on
    the zero-padded x (interpret mode) and ``cnn_tpu.ops.conv.conv2d``
    with ``padding=1``."""
    b, h, wid, cin, cout, k, s, p = PADDED_STEMS["resnet10"]
    plan = conv_tile_plan(b, h, wid, cin, cout, k, s, True, p)
    assert plan.variant == "strip"
    x, w, bias = _f32_inputs(rng, b, h, wid, cin, cout, k)
    got, writes = _emulate_strip(x, w, bias, s, True, plan.rows, p)
    assert bool((writes == 1).all())
    xj = jnp.asarray(x.numpy())
    pallas = np.asarray(pallas_conv_forward(
        jnp.pad(xj, ((0, 0), (p, p), (p, p), (0, 0))),
        jnp.asarray(w.numpy()), jnp.asarray(bias.numpy()), s, True,
        interpret=True))
    xla = jops.relu(jops.conv2d({"w": jnp.asarray(w.numpy()),
                                 "b": jnp.asarray(bias.numpy())}, xj, s,
                                padding=p))
    np.testing.assert_allclose(got.numpy(), pallas, **CONV_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **CONV_TOL)


def test_padded_strip_infinity_reaches_exactly_its_windows(rng):
    """An infinity at the image's edges (beside the margins) and inside
    reaches exactly the outputs whose window holds it, as in the plain
    conv: the margins and zero rows add finite zeros, and no read leaves
    the staged rows."""
    b, h, wid, cin, cout, k, s, p = 1, 12, 16, 3, 8, 3, 1, 1
    x, w, bias = _f32_inputs(rng, b, h, wid, cin, cout, k)
    x[0, 0, 0, 0] = float("inf")             # top-left, by both margins
    x[0, h - 1, wid - 1, 2] = float("-inf")  # bottom-right
    x[0, 5, 7, 1] = float("inf")
    for rows in STRIP_ROWS:
        got, writes = _emulate_strip(x, w, bias, s, False, rows, p)
        ref = conv2d(x, w, bias, s, False, p)
        assert bool((writes == 1).all())
        assert torch.equal(got.isfinite(), ref.isfinite())
        assert not bool(ref.isfinite().all())
        assert torch.equal(got[~got.isfinite()], ref[~ref.isfinite()])


# ------------------------------------------------------- the pointwise ----

# the families' float32 1x1s at 224 px: (H, Cin, Cout, stride) of
# MobileNet's pw_1-pw_6 and the projections of resnet10 and resnet18
FAMILY_1X1 = [(112, 32, 64, 1), (56, 64, 128, 1), (56, 128, 128, 1),
              (28, 128, 256, 1), (28, 256, 256, 1), (14, 256, 512, 1),
              (112, 16, 32, 2), (56, 32, 64, 2), (28, 64, 128, 2),
              (112, 32, 64, 2), (56, 64, 128, 2), (28, 128, 256, 2)]
PW_CONSUMERS = 256   # csrc/conv.cu kPwConsumers


@pytest.mark.parametrize("batch", [1, 8, 64, 256])
@pytest.mark.parametrize("shape", FAMILY_1X1,
                         ids=lambda g: "x".join(map(str, g)))
def test_plan_sends_the_1x1s_to_the_pointwise_kernel(shape, batch):
    """Every family float32 1x1 with Cout >= 64 takes "pw" at every batch
    (resnet10's 16 -> 32 projection the tiled kernel); its persistent grid
    walks every M tile exactly once per column range, and the column
    ranges cover Cout exactly."""
    h, cin, cout, s = shape
    plan = conv_tile_plan(batch, h, h, cin, cout, 1, s, aligned=True)
    m = _m(batch, h, h, 1, s)
    if cout < 64:
        assert plan.variant == "tiled" and hconv.pw_tile_for(
            m, cin, cout) is None
        return
    assert plan.variant == "pw" and plan.rows is None
    bm, bn = hconv.PW_TILES[plan.tile][:2]
    blocks, ranges = plan.grid
    assert plan.grid == hconv.pw_grid(m, cout, plan.tile)
    assert (ranges - 1) * bn < cout <= ranges * bn
    tiles = -(-m // bm)
    walked = sorted(t for bx in range(blocks)
                    for t in range(bx, tiles, blocks))
    assert walked == list(range(tiles))
    assert blocks * ranges <= H100_SMS or blocks == 1
    assert hconv.pw_smem_bytes(plan.tile, cin) <= hconv.PW_SMEM_MAX
    # the first tile in PW_TILES' order with two waves of output tiles,
    # else the one with the most
    if hconv.pw_tiles(m, cout, plan.tile) < 2 * H100_SMS:
        assert plan.tile == len(hconv.PW_TILES) - 1


@pytest.mark.parametrize("case", [
    # (B, H, W, Cin, Cout, k, stride, aligned, padding)
    ("3x3", (8, 56, 56, 64, 128, 3, 1, True, 0)),
    ("padded 1x1", (8, 56, 56, 64, 128, 1, 1, True, 1)),
    ("Cin 6", (8, 56, 56, 6, 128, 1, 1, True, 0)),
    ("Cout 66", (8, 56, 56, 64, 66, 1, 1, True, 0)),
    ("misaligned", (8, 56, 56, 64, 128, 1, 1, False, 0)),
    ("stride 9", (8, 90, 90, 64, 128, 1, 9, True, 0)),
    ("Cin 1024", (8, 14, 14, 1024, 128, 1, 1, True, 0)),
], ids=lambda c: c[0])
def test_pw_plan_leaves_what_the_kernel_cannot_take(case):
    """A shape outside the kernel's preconditions goes where it went
    before: the tiled kernel, or the direct one."""
    b, h, w, cin, cout, k, s, aligned, p = case[1]
    assert not hconv.pw_kernel_takes(cin, cout, k, s, p, aligned)
    plan = conv_tile_plan(b, h, w, cin, cout, k, s, aligned, p)
    want = ("tiled" if cin % 8 == 0 and cout % 4 == 0 and aligned
            else "direct")
    assert plan.variant == want


@pytest.mark.parametrize("tile", range(len(hconv.PW_TILES)))
def test_every_pw_tile_fits_its_block(tile):
    """256 consumer threads a block, warps of 4 rows x 8 column groups,
    rows 8 apart in row % 8 (the swizzle's reads), and the largest family
    Cin (256) within the shared-memory budget where the plan can take the
    tile."""
    bm, bn, tm, tn, stages = hconv.PW_TILES[tile]
    assert (bm // tm) * (bn // tn) == PW_CONSUMERS
    assert tn % 4 == 0 and (bn // tn) % 8 == 0 and (bm // tm) % 8 == 0
    assert stages >= 2 and bm <= 256 and bn <= 256
    assert hconv.pw_smem_bytes(tile, 256) <= hconv.PW_SMEM_MAX or tile == 0
    assert hconv.pw_smem_bytes(tile, 128) <= hconv.PW_SMEM_MAX
    assert hconv.pw_smem_bytes(tile, 32) == (
        1024 + stages * bm * 128 + 4 * bm * bn + 4 * 32 * bn)


def test_pw_tiles_match_the_cuda_source():
    """The plan's pointwise tile ids index the kernel's switch in
    ``csrc/conv.cu``, and its constants and budget are the kernel's."""
    src = CONV_CU.read_text()
    cases = re.findall(r"case (\d+): return \(int\)launch_pw<(\d+), (\d+), "
                       r"(\d+), (\d+), (\d+)>", src)
    assert [(int(c), *map(int, rest)) for c, *rest in cases] == [
        (i, *t) for i, t in enumerate(hconv.PW_TILES)]
    assert re.search(r"constexpr int kPwCh = (\d+);", src).group(1) == str(
        hconv.PW_CH)
    assert re.search(r"constexpr int kPwConsumers = (\d+);", src).group(
        1) == str(PW_CONSUMERS)
    assert f"constexpr int kPwSmemMax = {hconv.PW_SMEM_MAX // 1024} * " \
        "1024;" in src
    assert re.search(r"constexpr int kTmaSw = (\d+);", src).group(1) == str(
        hconv.PW_ALIGN)
    assert ("return kTmaSw + S * BM * kPwRow + BM * BN * 4 + Cin * BN * 4;"
            in src)
    assert len(SIGNATURES["cnn_conv2d_bias_relu_pw"]) == len(
        SIGNATURES["cnn_conv2d_bias_relu_tiled"]) + 1


@pytest.mark.parametrize("shape", [(56, 64, 128, 1), (112, 16, 32, 2),
                                   (28, 64, 128, 2)],
                         ids=["pw_2", "r10_16_32", "r10_64_128"])
def test_wrapper_launches_the_pw_kernel_and_counts_it(monkeypatch, shape):
    """Off the CPU a 1x1 with Cout >= 64 goes to the pointwise entry point
    with its tile id and the grid's x after the shared arguments, counted
    as a pointwise launch and a 1x1; Cout 32 goes to the tiled kernel
    (meta tensors stand in for the card; the launch is recorded, not
    made)."""
    calls = []
    monkeypatch.setattr(hconv, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hconv, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    h, cin, cout, s = shape
    x = torch.empty((8, h, h, cin), device="meta")
    w = torch.empty((1, 1, cin, cout), device="meta")
    reset_launches()
    y = conv2d_bias_relu(x, w, torch.empty((cout,), device="meta"), s, True)
    ho = conv_out_size(h, 1, s)
    assert y.shape == (8, ho, ho, cout)
    plan = conv_tile_plan(8, h, h, cin, cout, 1, s, aligned=True)
    (name, args), = calls
    assert len(args) == len(SIGNATURES[name])
    assert args[4:13] == (8, h, h, cin, cout, 1, s, 0, 1)
    c = {k.split(".")[1]: v for k, v in read_counters().items()
         if k.startswith("conv2d_bias_relu.")}
    if cout >= 64:
        assert name == "cnn_conv2d_bias_relu_pw" and plan.variant == "pw"
        assert args[13:] == (plan.tile, plan.grid[0])
    else:
        assert name == "cnn_conv2d_bias_relu_tiled" and args[13] == plan.tile
    pw = int(cout >= 64)
    assert (c["launches"], c["launches_pw"], c["launches_tiled"],
            c["launches_1x1"], c["launches_direct"]) == (1, pw, 1 - pw, 1, 0)
    reset_launches()
    assert read_counters()["conv2d_bias_relu.launches_pw"] == 0


def _fma(a, b, acc):
    """fmaf in torch: the float32 product is exact in float64, the sum is
    rounded to float64 and then to float32 (a rare tie one float32 ulp from
    fmaf's single rounding; the bit-for-bit test below uses exactly
    representable sums, where every rounding is exact)."""
    return (acc.double() + a.double() * b.double()).float()


def _emulate_pw(x, w, bias, stride, relu, tile, blocks):
    """The pointwise kernel's walk in torch: for each column range and
    block, the M tiles blockIdx.x, blockIdx.x + blocks, ...; per tile the
    K slices of 32 channels as the copies write them into a stage (rows
    past M and channels past Cin zero, 16-byte chunk c of row r at chunk
    c ^ (r % 8)), read back by each of the 256 consumer threads (warp w,
    lane l: rows tm + i*BM/TM and columns tn*4 + g*BN/(TN/4) + e, tm = (w
    // warps across) * 4 + l // 8, tn = (w % warps across) * 8 + l % 8)
    through the same XOR; one fmaf chain per output from 0 in ci order,
    then the bias, then the ReLU; the tile staged, then stored clipped at
    M and Cout. Returns the output and how many times each output was
    written."""
    bm, bn, tm_n, tn_n, _ = hconv.PW_TILES[tile]
    bsz, h, wid, cin = x.shape
    cout = w.shape[-1]
    ho, wo = conv_out_size(h, 1, stride), conv_out_size(wid, 1, stride)
    m = bsz * ho * wo
    a_rows = x[:, ::stride, ::stride, :].reshape(m, cin)   # the pixels read
    t = torch.arange(PW_CONSUMERS)
    warp, lane = t // 32, t % 32
    across = bn // tn_n // 8
    tm = (warp // across) * 4 + lane // 8
    tn = (warp % across) * 8 + lane % 8
    rows = tm[:, None] + torch.arange(tm_n)[None, :] * (bm // tm_n)
    j = torch.arange(tn_n)
    cols = (j // 4)[None, :] * (bn // (tn_n // 4)) + tn[:, None] * 4 + \
        (j % 4)[None, :]
    # every output of the tile belongs to exactly one thread's slot
    owner = torch.zeros((bm, bn), dtype=torch.int32)
    owner.index_put_((rows[:, :, None].expand(-1, -1, tn_n),
                      cols[:, None, :].expand(-1, tm_n, -1)),
                     torch.ones((), dtype=torch.int32), accumulate=True)
    assert bool((owner == 1).all())
    y = torch.full((m, cout), float("nan"))
    writes = torch.zeros((m, cout), dtype=torch.int32)
    tiles = -(-m // bm)
    r = torch.arange(bm)[:, None]
    c = torch.arange(hconv.PW_CH)[None, :]
    swizzled = r * hconv.PW_CH + ((c // 4) ^ (r % 8)) * 4 + c % 4
    for n0 in range(0, cout, bn):
        sw = torch.zeros((cin, bn))                   # resident weights
        sw[:, :min(bn, cout - n0)] = w[0, 0, :, n0:n0 + bn]
        bv = torch.zeros(bn)
        bv[:min(bn, cout - n0)] = bias[n0:n0 + bn]
        for bx in range(blocks):
            for tile_m in range(bx, tiles, blocks):
                m0 = tile_m * bm
                acc = torch.zeros((PW_CONSUMERS, tm_n, tn_n))
                for k0 in range(0, cin, hconv.PW_CH):
                    src = torch.zeros((bm, hconv.PW_CH))
                    part = a_rows[m0:m0 + bm, k0:k0 + hconv.PW_CH]
                    src[:part.shape[0], :part.shape[1]] = part
                    stage = torch.full((bm * hconv.PW_CH,), float("nan"))
                    stage[swizzled.reshape(-1)] = src.reshape(-1)
                    for ch in range(min(hconv.PW_CH, cin - k0) // 4):
                        for e in range(4):
                            a = stage[rows * hconv.PW_CH
                                      + (ch ^ (rows % 8)) * 4 + e]
                            b = sw[k0 + ch * 4 + e][cols]
                            acc = _fma(a[:, :, None], b[:, None, :], acc)
                out = acc + bv[cols][:, None, :]
                if relu:
                    out = torch.where(out > 0, out, torch.zeros(()))
                staging = torch.full((bm, bn), float("nan"))
                staging[rows[:, :, None], cols[:, None, :]] = out
                mr, nc = min(bm, m - m0), min(bn, cout - n0)
                y[m0:m0 + mr, n0:n0 + nc] = staging[:mr, :nc]
                writes[m0:m0 + mr, n0:n0 + nc] += 1
    return y.reshape(bsz, ho, wo, cout), writes


# (B, H, W, Cin, Cout, stride): an M tail, a partial K slice (Cin 40) and
# two slices, Cin 16 at stride 2 with an odd extent and an N tail (Cout
# 68), a stride-2 tail of rows
PW_WALKS = [(2, 12, 12, 64, 128, 1), (1, 9, 9, 16, 68, 2),
            (3, 7, 5, 40, 64, 1), (2, 11, 10, 8, 132, 2)]


@pytest.mark.parametrize("tile", range(len(hconv.PW_TILES)))
@pytest.mark.parametrize("shape", PW_WALKS,
                         ids=lambda g: "x".join(map(str, g)))
def test_pw_walk_writes_each_output_once_and_equals_the_plain_conv(
        rng, shape, tile):
    """The walk on the plan's grid and on two blocks (each walking several
    tiles), ReLU off and on: every output written once, bit-equal to the
    plain conv on inputs whose every sum is exact (multiples of 1/8 and
    1/16 of small integers), so that any misrouted read, row, column or
    slice shows whatever the order of the sums."""
    b, h, wid, cin, cout, s = shape
    x = torch.from_numpy(rng.integers(0, 8, (b, h, wid, cin))
                         .astype(np.float32) / 8)
    w = torch.from_numpy(rng.integers(-4, 5, (1, 1, cin, cout))
                         .astype(np.float32) / 16)
    bias = torch.from_numpy(rng.integers(-8, 9, cout).astype(np.float32)
                            / 16)
    m = _m(b, h, wid, 1, s)
    for blocks in sorted({hconv.pw_grid(m, cout, tile)[0], 2}):
        for relu_on in (False, True):
            got, writes = _emulate_pw(x, w, bias, s, relu_on, tile, blocks)
            assert bool((writes == 1).all())
            ref = conv2d(x, w, bias, s, relu_on)
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_pw_walk_vs_pallas_interpret_at_stride_1(rng):
    """MobileNet's pw_2 geometry (64 -> 128, 1x1) at 32 px and B = 2
    through the walk with the plan's tile and grid, against cnn_tpu's
    Pallas ``_forward`` at k = 1 in interpret mode, on random inputs."""
    b, h, cin, cout = 2, 32, 64, 128
    plan = conv_tile_plan(b, h, h, cin, cout, 1, 1, aligned=True)
    assert plan.variant == "pw"
    x = np.maximum(rng.standard_normal((b, h, h, cin)), 0).astype(np.float32)
    wt = (rng.standard_normal((1, 1, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    want = np.asarray(pallas_conv_forward(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), 1, True,
        interpret=True))
    got, writes = _emulate_pw(torch.from_numpy(x), torch.from_numpy(wt),
                              torch.from_numpy(bias), 1, True, plan.tile,
                              plan.grid[0])
    assert bool((writes == 1).all())
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)
