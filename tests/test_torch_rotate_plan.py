"""The tiled rotation kernel's plan and regions
(``cnn_tpu_torch/ops/hopper/augment.py``), on the CPU.

The kernel (``csrc/rotate.cu``) runs only on the card; here its tile plan
and the region function, which repeats the kernel's integer arithmetic, are
held against the taps the plain shears read, and a torch emulation of the
kernel's staged, skewed walk, tile by tile through the region function, is
held bit for bit against ``rotate_core_plain`` and against cnn_tpu's
``rotate_shear_xla`` (which shares ``_rotate_core`` with the Pallas kernel).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.ops.pallas.augment import (_geometry, _shift_vectors,
                                        rotate_shear_xla)
from cnn_tpu_torch.ops import augment as aug
from cnn_tpu_torch.ops.hopper import augment as haug
from cnn_tpu_torch.ops.hopper import reset_launches
from cnn_tpu_torch.ops.hopper._build import SIGNATURES
from cnn_tpu_torch.ops.hopper.augment import (ROTATE_T2_TASKS, ROTATE_THREADS,
                                              PLAN_TILE, SMEM_LIMIT, TILES,
                                              rotate_shear,
                                              rotate_tile_plan, tile_regions)

ROTATE_CU = (Path(__file__).resolve().parents[1] / "cnn_tpu_torch" / "csrc"
             / "rotate.cu")
# the smoke's fixed angles, and past 90 degrees (the per-element branch)
FIXED = [0.0, 15.0, -15.0, 44.0, -44.0, 46.0, -46.0, 75.0, -75.0]
WIDE = [100.0, -100.0, 135.0, -135.0, 180.0]
SIZES = [40, 64, 100, 256]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation runs thousands of tiny tensor ops, which threads only
    slow down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _degrees(seed, n_random=4, lim=75.0):
    rng = np.random.default_rng(seed)
    return FIXED + list(rng.uniform(-lim, lim, n_random)) + WIDE


def _theta(deg):
    return torch.deg2rad(torch.tensor(deg, dtype=torch.float32))


def _tiles(s, plan):
    return [(tr, tp) for tr in range(-(-s // plan.rows))
            for tp in range(-(-s // plan.pixels))]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("s", SIZES)
def test_plan_sizes_fit_a_block_and_cover_the_canvas(s, c, dtype):
    assert rotate_tile_plan(s, c, dtype) == rotate_tile_plan(
        s, c, dtype, PLAN_TILE[dtype])
    for tile in range(len(TILES)):
        p = rotate_tile_plan(s, c, dtype, tile)
        assert p.rows == min(TILES[tile].rows, s)
        assert p.pixels == min(TILES[tile].pixels, s)
        assert p.lanes_max % 64 == 0
        assert p.lanes_max >= (p.pixels + 1 + p.rows) * c
        item = 4 if dtype == torch.float32 else 2
        rows_cap = p.table_max + p.rows
        assert p.smem_bytes == (item * (p.rows + 1) * p.lanes_max
                                + 8 * p.lanes_max + 4 * p.table_max
                                + 4 * (5 * rows_cap + 1))
        assert p.smem_bytes <= SMEM_LIMIT
        assert p.lanes_max <= ROTATE_T2_TASKS * ROTATE_THREADS
        tiles_r = -(-s // p.rows)
        assert p.grid == (tiles_r * p.grid[1], -(-s // p.pixels))
        assert (tiles_r - 1) * p.rows < s <= tiles_r * p.rows
    assert rotate_tile_plan(s, c, dtype) is rotate_tile_plan(s, c, dtype)


def test_plan_refuses_other_dtypes_and_huge_canvases():
    with pytest.raises(TypeError):
        rotate_tile_plan(64, 3, torch.float64)
    with pytest.raises(ValueError):
        rotate_tile_plan(30000, 3, torch.float32)


def test_kernel_source_matches_the_plan():
    src = ROTATE_CU.read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) == str(
        ROTATE_THREADS)
    assert re.search(r"constexpr int kT2Tasks = (\d+);", src).group(1) == str(
        ROTATE_T2_TASKS)
    # k3s / a3s hold one tile's rows in static shared memory
    assert max(t.rows for t in TILES) <= int(
        re.search(r"__shared__ int k3s\[(\d+)\]", src).group(1))
    assert len(SIGNATURES["cnn_rotate_shear"]) == len(
        SIGNATURES["cnn_rotate_shear_direct"]) + 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_launches_the_tiled_kernel_and_counts_it(monkeypatch, dtype):
    """Off the CPU the wrapper calls the tiled entry point with the plan's
    tile and counts the launch; ``launch_rotate`` reaches either kernel
    and counts nothing (meta tensors stand in for the card)."""
    calls = []
    monkeypatch.setattr(haug, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(haug, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    x = torch.empty((2, 256, 256, 3), dtype=dtype, device="meta")
    theta = torch.zeros(2, device="meta")
    reset_launches()
    assert rotate_shear(x, theta).shape == x.shape
    p = rotate_tile_plan(256, 3, dtype)
    (name, args), = calls
    assert name == "cnn_rotate_shear" and len(args) == len(SIGNATURES[name])
    assert args[-5:] == (p.rows, p.pixels, p.lanes_max, p.table_max,
                         p.smem_bytes)
    assert args[-6] == int(dtype == torch.bfloat16)
    assert rotate_shear.launches == 1
    haug.launch_rotate(x, theta, direct=True)
    haug.launch_rotate(x, theta, tile=len(TILES) - 1)
    assert [n for n, _ in calls[1:]] == ["cnn_rotate_shear_direct",
                                         "cnn_rotate_shear"]
    assert len(calls[1][1]) == len(SIGNATURES["cnn_rotate_shear_direct"])
    assert rotate_shear.launches == 1
    reset_launches()
    assert rotate_shear.launches == 0


# ---------------------------------------------------------------------------
# (a) the regions hold every tap the plain shears read; (b) the budget
# ---------------------------------------------------------------------------

def _check_tile_taps(reg, s, c, k1, k2all, k3):
    """Every tap of the plain shears for the tile's outputs lies in the
    regions: T2 lanes in the window, T1 (q, u) in row q's lane range, and
    the canvas taps of T1 (q, u) in row q's segment."""
    g = aug.geometry(s, c)
    plc, lane = g.pad_l * c, g.lane
    r = torch.arange(reg.r0, reg.r0 + reg.rows)
    v = reg.p0 * c + torch.arange(reg.pix * c)
    src = plc + v[None, :] + c * k3[r][:, None]
    ok = (src >= 0) & (src + c < lane)
    rr = r[:, None].expand_as(src)
    # the T2 taps (r, u) that the third shear reads
    rt = torch.cat([rr[ok], rr[ok]])
    ut = torch.cat([src[ok], src[ok] + c])
    if ut.numel() == 0:
        return
    assert int(ut.min()) >= reg.u_lo and int(ut.max()) <= reg.u_hi
    i = ut - reg.u_lo
    assert torch.equal(reg.k2[i], k2all[ut])
    kmin = int(reg.k2.min())
    t1 = reg.t1_rows
    rq = torch.tensor([row.q for row in t1])
    i0 = torch.tensor([row.i0 for row in t1])
    i1 = torch.tensor([row.i1 for row in t1])
    # each row's canvas segment; an empty one where q is no image row
    seg_lo = torch.tensor([row.segment[0] if row.segment else 1 << 30
                           for row in t1])
    seg_hi = torch.tensor([row.segment[1] if row.segment else -(1 << 30)
                           for row in t1])
    for dq in (0, 1):   # the two T1 rows each T2 value blends
        q = rt + k2all[ut] + dq
        # the lane's skewed slot j = q - (r0 + k2[u]) lies in 0..rows
        j = q - reg.r0 - k2all[ut]
        assert int(j.min()) >= 0 and int(j.max()) <= reg.rows
        t = q - reg.r0 - kmin
        assert int(t.min()) >= 0 and int(t.max()) < len(t1)
        assert torch.equal(rq[t], q)
        assert bool(((i >= i0[t]) & (i < i1[t])).all())
        # the canvas taps of T1 (q, u), for image rows and unmasked taps
        live = (q >= 0) & (q < s)
        q, u, t = q[live], ut[live], t[live]
        s1 = u + c * k1[q]
        tap = (s1 >= 0) & (s1 + c < lane)
        assert bool(((s1[tap] >= seg_lo[t[tap]])
                     & (s1[tap] + c <= seg_hi[t[tap]])).all())


def _per_element_tiles(s, c, tile, deg):
    """{angle: tiles of the per-element branch} for ``TILES[tile]``."""
    theta = _theta(deg)
    s1, s2, s3 = aug.shift_vectors(theta, s, c)
    plan = rotate_tile_plan(s, c, torch.float32, tile)
    out = {}
    for n, d in enumerate(deg):
        for tr, tp in _tiles(s, plan):
            if not tile_regions(s1[n], s2[n], s3[n], s, c, plan, tr, tp).fits:
                out.setdefault(d, []).append((tr, tp))
    return out


@pytest.mark.parametrize("tile", sorted(set(PLAN_TILE.values())))
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("s", SIZES)
def test_regions_hold_every_tap(s, c, tile):
    deg = _degrees(s + c) + [90.0, -90.0] + list(
        np.random.default_rng(s * c).uniform(-90, 90, 4))
    theta = _theta(deg)
    s1, s2, s3 = aug.shift_vectors(theta, s, c)
    plan = rotate_tile_plan(s, c, torch.float32, tile)
    for n, d in enumerate(deg):
        k1, k2all, k3 = (torch.floor(v[n]).long() for v in (s1, s2, s3))
        for tr, tp in _tiles(s, plan):
            reg = tile_regions(s1[n], s2[n], s3[n], s, c, plan, tr, tp)
            if reg.fits:
                _check_tile_taps(reg, s, c, k1, k2all, k3)


@pytest.mark.parametrize("tile", range(len(TILES)))
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("s", SIZES)
def test_every_tile_fits_its_buffer_up_to_90_degrees(s, c, tile):
    deg = [0.0, 30.0, -45.0, 60.0, 75.0, -75.0, 89.0, 90.0, -90.0] + list(
        np.random.default_rng(s + c + tile).uniform(-90, 90, 8))
    assert not _per_element_tiles(s, c, tile, deg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_angles_reach_the_per_element_branch(dtype):
    """Past 90 degrees the third shear can spread by more than the buffer
    holds over a tile's rows. The smoke's cases past 90 degrees reach the
    per-element branch in each dtype's plan. With the float32 plan (16 x 128
    tiles): none at +-100 degrees; at +-135, 12 of 32 tiles at S = 256,
    C = 3 (the rows whose shift is not clamped at +-p3) and 2 of 7 at
    S = 100; at 180, the tile that straddles the center row at S = 100 and
    none at S = 256, where the center falls between two tiles. With the
    bf16 plan (32 x 128): 4 of 16 at +-135 (S = 256), 1 of 4 at 135 and 180
    (S = 100)."""
    tile = PLAN_TILE[dtype]
    for s, wide in ((256, (135.0, -135.0)), (100, (135.0, -135.0, 180.0))):
        got = _per_element_tiles(s, 3, tile, WIDE)
        assert set(got) == set(wide), (s, got)
    expect = {torch.float32: (12, 2, 1), torch.bfloat16: (4, 1, 1)}[dtype]
    assert (len(_per_element_tiles(256, 3, tile, [135.0])[135.0]),
            len(_per_element_tiles(100, 3, tile, [135.0])[135.0]),
            len(_per_element_tiles(100, 3, tile, [180.0])[180.0])) == expect


@pytest.mark.parametrize("c", [1, 3])
def test_each_lane_takes_rows_plus_one_t1_rows(c):
    """The lane ranges of the T1 rows cover each window lane exactly
    rows + 1 times, once per skewed slot."""
    s = 100
    theta = _theta(_degrees(7))
    s1, s2, s3 = aug.shift_vectors(theta, s, c)
    plan = rotate_tile_plan(s, c, torch.float32)
    for n in range(len(theta)):
        for tr, tp in _tiles(s, plan):
            reg = tile_regions(s1[n], s2[n], s3[n], s, c, plan, tr, tp)
            if not reg.fits or reg.k2 is None:
                continue
            w = reg.u_hi - reg.u_lo + 1
            count = torch.zeros(w, dtype=torch.long)
            for row in reg.t1_rows:
                count[row.i0:row.i1] += 1
            assert bool((count == reg.rows + 1).all())


# ---------------------------------------------------------------------------
# (c) the staged, skewed walk, emulated tile by tile
# ---------------------------------------------------------------------------

def _per_element(x, s, c, k1, a1, k2, a2, k3, a3, r, v):
    """The direct kernel's arithmetic (the tiled kernel's per-element
    branch) for outputs (r, v) of one image x [S, S*C]."""
    g = aug.geometry(s, c)
    plc, lane = g.pad_l * c, g.lane
    zero = torch.zeros((), dtype=x.dtype)

    def canvas(q, w):
        w = w - plc
        ok = (w >= 0) & (w < s * c) & (q >= 0) & (q < s)
        return torch.where(ok, x[q.clamp(0, s - 1), w.clamp(0, s * c - 1)],
                           zero)

    def t1(q, u):
        qc = q.clamp(0, s - 1)
        src = u + c * k1[qc]
        ok = (q >= 0) & (q < s) & (src >= 0) & (src + c < lane)
        return torch.where(ok, aug._blend(canvas(q, src), canvas(q, src + c),
                                          a1[qc]), zero)

    def t2(rq, u):
        q = rq + k2[u]
        return aug._blend(t1(q, u), t1(q + 1, u), a2[u])

    src = plc + v + c * k3[r]
    ok = (src >= 0) & (src + c < lane)
    sc = src.clamp(0, lane - 1 - c)
    return torch.where(ok, aug._blend(t2(r, sc), t2(r, sc + c), a3[r]), zero)


def emulate_tiled(imgs, s1, s2, s3, tile=None):
    """The tiled kernel's walk on [B,S,S,C] canvases and their shift
    vectors: per tile, T1 row by row over the region function's lane ranges
    into the skewed buffer (each slot written once), T2 down each lane, the
    output from two T2 values of its row."""
    b, s, _, c = imgs.shape
    dt = imgs.dtype
    g = aug.geometry(s, c)
    plc, lane = g.pad_l * c, g.lane
    plan = rotate_tile_plan(s, c, dt, tile)
    out = torch.empty((b, s, s * c), dtype=dt)
    zero = torch.zeros((), dtype=dt)
    staged = 0
    for n in range(b):
        x = imgs[n].reshape(s, s * c)
        (k1, a1), (k2, a2), (k3, a3) = (aug._split(v[n], dt)
                                        for v in (s1, s2, s3))
        for tr, tp in _tiles(s, plan):
            reg = tile_regions(s1[n], s2[n], s3[n], s, c, plan, tr, tp)
            rows, cols = reg.rows, reg.pix * c
            r = torch.arange(reg.r0, reg.r0 + rows)[:, None]
            v = reg.p0 * c + torch.arange(cols)[None, :]
            if not reg.fits:
                y = _per_element(x, s, c, k1, a1, k2, a2, k3, a3,
                                 r.expand(rows, cols), v.expand(rows, cols))
                out[n, reg.r0:reg.r0 + rows, reg.p0 * c:reg.p0 * c + cols] = y
                continue
            staged += 1
            src = plc + v + c * k3[r]
            ok = (src >= 0) & (src + c < lane)
            w = reg.u_hi - reg.u_lo + 1
            if w <= 0:
                assert not ok.any()
                y = torch.zeros((rows, cols), dtype=dt)
            else:
                buf = torch.zeros((rows + 1, w), dtype=dt)
                written = torch.zeros((rows + 1, w), dtype=torch.long)
                kmin = int(reg.k2.min())
                for t, row in enumerate(reg.t1_rows):
                    i = torch.arange(row.i0, row.i1)
                    if i.numel() == 0:
                        continue
                    u = reg.u_lo + i
                    j = t - (reg.k2[i] - kmin)
                    val = torch.zeros(i.shape, dtype=dt)
                    if 0 <= row.q < s:
                        tap = u + c * k1[row.q]
                        live = (tap >= 0) & (tap + c < lane)
                        w0, w1 = tap - plc, tap + c - plc
                        x0 = torch.where((w0 >= 0) & (w0 < s * c),
                                         x[row.q, w0.clamp(0, s * c - 1)], zero)
                        x1 = torch.where((w1 >= 0) & (w1 < s * c),
                                         x[row.q, w1.clamp(0, s * c - 1)], zero)
                        val = torch.where(live, aug._blend(x0, x1, a1[row.q]),
                                          zero)
                    buf[j, i] = val
                    written[j, i] += 1
                assert bool((written == 1).all())
                t2 = aug._blend(buf[:-1], buf[1:], a2[reg.u_lo:reg.u_hi + 1])
                i0 = (src - reg.u_lo).clamp(0, w - 1)
                i1 = (src + c - reg.u_lo).clamp(0, w - 1)
                rr = torch.arange(rows)[:, None].expand_as(i0)
                y = torch.where(ok, aug._blend(t2[rr, i0], t2[rr, i1],
                                               a3[r]), zero)
            out[n, reg.r0:reg.r0 + rows, reg.p0 * c:reg.p0 * c + cols] = y
    return out.reshape(b, s, s, c), staged


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t.view(
        torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("s", [40, 64, 100])
def test_emulated_walk_is_bit_exact_with_the_plain_shears(s, c, dtype):
    deg = _degrees(3 * s + c)
    theta = _theta(deg)
    x = torch.from_numpy(np.random.default_rng(s + c).uniform(
        0, 1, (len(deg), s, s, c)).astype(np.float32)).to(dtype)
    vecs = aug.shift_vectors(theta, s, c)
    got, staged = emulate_tiled(x, *vecs)
    want = aug.rotate_core_plain(x, *vecs)
    assert staged > 0
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("tile", range(len(TILES)))
def test_emulated_walk_every_tile_shape(tile):
    """The other tile shapes the smoke sweeps, at S = 100 (no tile divides
    it) in float32."""
    deg = _degrees(tile, n_random=2)
    theta = _theta(deg)
    x = torch.from_numpy(np.random.default_rng(tile).uniform(
        0, 1, (len(deg), 100, 100, 3)).astype(np.float32))
    vecs = aug.shift_vectors(theta, 100, 3)
    got, _ = emulate_tiled(x, *vecs, tile=tile)
    assert torch.equal(_bits(got), _bits(aug.rotate_core_plain(x, *vecs)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_walk_at_the_training_canvas(dtype):
    """S = 256, C = 3, the training shape: a few angles, each tile."""
    deg = [0.0, 44.0, -46.0, 75.0, -75.0, 135.0]
    theta = _theta(deg)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (len(deg), 256, 256, 3)).astype(np.float32)).to(dtype)
    vecs = aug.shift_vectors(theta, 256, 3)
    got, _ = emulate_tiled(x, *vecs)
    assert torch.equal(_bits(got), _bits(aug.rotate_core_plain(x, *vecs)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [40, 64])
def test_emulated_walk_matches_rotate_shear_xla(s, dtype):
    """On cnn_tpu's own shift vectors the emulated walk gives
    ``rotate_shear_xla``'s result bit for bit (float32) and equal after
    casting (bf16)."""
    deg = np.array(FIXED + [60.0, -30.0], np.float32)
    theta = np.deg2rad(deg).astype(np.float32)
    x = np.random.default_rng(s).uniform(0, 1, (len(deg), s, s, 3)).astype(
        np.float32)
    dims = _geometry(s, 3)
    vecs = [torch.from_numpy(np.asarray(v).reshape(len(deg), -1).copy())
            for v in _shift_vectors(jnp.asarray(theta), s, 3, dims["pad_l"],
                                    dims["lane"])]
    want = np.asarray(rotate_shear_xla(jnp.asarray(x).astype(dtype),
                                       jnp.asarray(theta)).astype(jnp.float32))
    got, _ = emulate_tiled(torch.from_numpy(x).to(getattr(torch, dtype)),
                           *vecs)
    np.testing.assert_array_equal(got.float().numpy(), want)
