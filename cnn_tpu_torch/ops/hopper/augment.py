"""Three-shear rotation of [B,S,S,C] canvases: wrapper of ``csrc/rotate.cu``.

Replaces ``cnn_tpu/ops/pallas/augment.py:rotate_shear_pallas``. The shift
vectors come from ``ops/augment.py:shift_vectors``, on the device, so the
kernel and the plain version (``rotate_core_plain``) shear by the same
amounts; the kernel's result is bit-identical to the plain version's.

The kernel (``cnn_rotate_shear``) takes one output tile of R rows x P pixels
of one image per block and stages each shear once in shared memory. The TPU
kernel's padded working canvas (3.35 MiB in float32 at S = 256) fits no
block, but a tile needs little of it: the middle shear moves lane u by up to
180 rows at S = 256, yet that shift is a base each lane carries, not a
spread across the tile. For the tile's rows r0..r0+R-1, lane u of the
second shear reads only the R+1 rows r0+k2[u] .. r0+k2[u]+R of the first,
so the first shear is stored per lane skewed by the lane's own shift. The
halos are the spread of the third shear's shift over the R rows (at most R
for |theta| <= 90 degrees) and one pixel for each blend's second tap.
``rotate_tile_plan`` sizes the tile and its buffers; ``tile_regions`` gives
what a tile reads, with the kernel's integer arithmetic, for the CPU tests.
A tile whose window exceeds the buffer (|theta| > 90 degrees only) is
computed element by element inside the same kernel.

The previous design, one thread per output element with the three shears
fused by recomputation (7 blends and up to 8 gathered loads an element),
stays as ``cnn_rotate_shear_direct``, on no path; ``launch_rotate`` reaches
it for comparisons.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from cnn_tpu_torch.ops.augment import geometry, rotate_shear_plain, shift_vectors
from cnn_tpu_torch.ops.hopper._build import cuda_args, launch

DTYPES = (torch.float32, torch.bfloat16)
ROTATE_THREADS = 256          # csrc/rotate.cu: kThreads
ROTATE_T2_TASKS = 4           # csrc/rotate.cu: kT2Tasks
SMEM_LIMIT = 227 * 1024 - 1024   # a block's shared memory, less the static part


class RotateTile(NamedTuple):
    """An output tile of the tiled rotation kernel: rows x pixels."""
    rows: int
    pixels: int


# tile id -> tile; the smoke times them all. The plan's tile for each dtype
# (about 40 KB of shared memory, five blocks an SM) was the fastest of that
# sweep at [256,256,256,3] on the H100.
TILES = (RotateTile(16, 128), RotateTile(32, 128), RotateTile(32, 64),
         RotateTile(24, 96), RotateTile(32, 96), RotateTile(16, 64))
PLAN_TILE = {torch.float32: 0, torch.bfloat16: 1}


class RotatePlan(NamedTuple):
    """The tiled kernel's launch for one canvas shape and dtype.

    ``rows`` x ``pixels``: the tile (cut to S). ``lanes_max``: the T2 lane
    window the buffer holds, a multiple of 64. ``table_max``: entries of the
    lane-range table. ``smem_bytes``: dynamic shared memory of a block.
    ``grid``: (tiles of an image, tiles along a row); the images run on the
    grid's second axis, offsets inside an image are 32-bit."""
    rows: int
    pixels: int
    lanes_max: int
    table_max: int
    smem_bytes: int
    grid: tuple[int, int]


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@functools.lru_cache(maxsize=64)   # a pure function, called every launch
def rotate_tile_plan(s: int, c: int, dtype: torch.dtype,
                     tile: int | None = None) -> RotatePlan:
    """Tile ``TILES[tile]`` (default: the dtype's ``PLAN_TILE``) for
    [*, s, s, c] canvases of ``dtype``, its buffers sized for |theta| <= 90
    degrees.

    Over R rows the third shear's integer shift spreads by at most R when
    |tan(theta/2)| <= 1, so the T2 lanes a tile reads are at most
    (P + 1 + R) * C; the second shear's integer shift spreads by at most one
    row per pixel (|sin(theta)| <= 1) plus one, over that window. T1 takes
    R + 1 values of T per lane, the lane shifts an int and a float each,
    the lane-range table one int per row of that spread; the T1 rows it
    reaches (that spread plus R + 1, at most ``table_max + R``) two ints of
    lane range, a shift, a weight and a chunk count each. The second shear
    takes at most ROTATE_T2_TASKS columns a thread, so the window is at
    most that many times the block's threads."""
    if dtype not in DTYPES:
        raise TypeError(f"rotate_tile_plan: expects float32 or bf16, got {dtype}")
    t = TILES[PLAN_TILE[dtype] if tile is None else tile]
    rows, pixels = min(t.rows, s), min(t.pixels, s)
    lanes_max = _round_up((pixels + 1 + rows) * c, 64)
    table_max = lanes_max // c + 4
    item = torch.empty((), dtype=dtype).element_size()
    rows_cap = table_max + rows
    smem = (item * (rows + 1) * lanes_max + 8 * lanes_max + 4 * table_max
            + 4 * (5 * rows_cap + 1))
    if smem > SMEM_LIMIT or lanes_max > ROTATE_T2_TASKS * ROTATE_THREADS:
        raise ValueError(f"rotate_tile_plan: tile {t} at C={c} needs {smem} "
                         f"bytes of shared memory (limit {SMEM_LIMIT}) and "
                         f"a window of {lanes_max} lanes (limit "
                         f"{ROTATE_T2_TASKS * ROTATE_THREADS})")
    if s * geometry(s, c).lane >= 2 ** 31:
        raise ValueError(f"rotate_tile_plan: S={s} overflows 32-bit offsets")
    tiles_p = -(-s // pixels)
    return RotatePlan(rows, pixels, lanes_max, table_max, smem,
                      (-(-s // rows) * tiles_p, tiles_p))


class T1Row(NamedTuple):
    """Row ``q`` of the first shear as one tile reads it: the window lanes
    [i0, i1) (relative to ``u_lo``) and, if q is an image row, the padded
    canvas lanes [lo, hi] of its taps (before the zero masks)."""
    q: int
    i0: int
    i1: int
    segment: tuple[int, int] | None


class TileRegions(NamedTuple):
    """What one tile of the tiled kernel reads, as the kernel computes it.

    Output rows r0..r0+rows-1, pixels p0..p0+pix-1. T2 lane window [u_lo,
    u_hi] (W = u_hi - u_lo + 1 lanes, W <= 0 when every output is 0). If
    ``fits`` the tile is staged: lane u_lo+i takes T1 rows r0 + k2[i] + j,
    j = 0..rows, and ``t1_rows`` lists every T1 row with its lanes and canvas
    segment; otherwise the kernel computes the tile element by element."""
    r0: int
    p0: int
    rows: int
    pix: int
    u_lo: int
    u_hi: int
    fits: bool
    k2: torch.Tensor | None
    t1_rows: tuple[T1Row, ...]


def tile_regions(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor, s: int,
                 c: int, plan: RotatePlan, tr: int, tp: int) -> TileRegions:
    """The regions of tile (``tr``, ``tp``) of one image, from its shift
    vectors s1, s3 [S] and s2 [L] (float32, from ``shift_vectors``), with the
    integer arithmetic of ``csrc/rotate.cu``."""
    g = geometry(s, c)
    plc = g.pad_l * c
    r0, p0 = tr * plan.rows, tp * plan.pixels
    rows, pix = min(plan.rows, s - r0), min(plan.pixels, s - p0)
    k3 = torch.floor(s3[r0:r0 + rows]).long()
    u_lo = max(plc + (p0 + int(k3.min())) * c, 0)
    u_hi = min(plc + (p0 + pix + 1 + int(k3.max())) * c - 1, g.lane - 1)
    w = u_hi - u_lo + 1
    if w > plan.lanes_max:
        return TileRegions(r0, p0, rows, pix, u_lo, u_hi, False, None, ())
    if w <= 0:
        return TileRegions(r0, p0, rows, pix, u_lo, u_hi, True, None, ())
    k2 = torch.floor(s2[u_lo:u_hi + 1]).long()
    ka, kb = int(k2[0]), int(k2[-1])
    up = kb >= ka
    kmin, spread = min(ka, kb), abs(kb - ka)
    if spread + 2 > plan.table_max:
        return TileRegions(r0, p0, rows, pix, u_lo, u_hi, False, k2, ())
    # first[k]: the first position, in ascending order of k2, with
    # k2 - kmin >= k
    asc = (k2 if up else k2.flip(0)) - kmin
    first = torch.searchsorted(asc, torch.arange(spread + 2)).tolist()
    k1 = torch.floor(s1).long()
    t1_rows = []
    for t in range(spread + rows + 1):
        q = r0 + kmin + t
        ka_, kb_ = max(t - rows, 0), min(t, spread)
        i0 = first[ka_] if up else w - first[kb_ + 1]
        i1 = first[kb_ + 1] if up else w - first[ka_]
        seg = None
        if 0 <= q < s and i1 > i0:
            seg = (u_lo + i0 + c * int(k1[q]), u_lo + i1 - 1 + c * int(k1[q]) + c)
        t1_rows.append(T1Row(q, i0, i1, seg))
    return TileRegions(r0, p0, rows, pix, u_lo, u_hi, True, k2, tuple(t1_rows))


def _check(imgs: torch.Tensor, theta: torch.Tensor) -> None:
    if imgs.dim() != 4 or imgs.shape[1] != imgs.shape[2] \
            or theta.shape != imgs.shape[:1]:
        raise ValueError(f"rotate_shear: expects [B,S,S,C] and theta [B], got "
                         f"{tuple(imgs.shape)} and {tuple(theta.shape)}")
    if imgs.dtype not in DTYPES:
        raise TypeError(f"rotate_shear: expects float32 or bf16, got {imgs.dtype}")


def launch_rotate(imgs: torch.Tensor, theta: torch.Tensor,
                  tile: int | None = None,
                  direct: bool = False) -> torch.Tensor:
    """Launches the tiled kernel with the plan's tile or ``TILES[tile]``, or
    the previous design if ``direct``, on CUDA tensors; counts nothing."""
    _check(imgs, theta)
    b, s, _, c = imgs.shape
    s1, s2, s3 = (v.contiguous() for v in shift_vectors(theta, s, c))
    stream = cuda_args("rotate_shear", imgs, s1, s2, s3,
                       dtypes=(imgs.dtype,) + (torch.float32,) * 3)
    g = geometry(s, c)
    out = torch.empty_like(imgs)
    args = (imgs.data_ptr(), s1.data_ptr(), s2.data_ptr(), s3.data_ptr(),
            out.data_ptr(), b, s, c, g.lane, g.pad_l,
            int(imgs.dtype == torch.bfloat16))
    if direct:
        launch("cnn_rotate_shear_direct", imgs.device, stream, *args)
    else:
        p = rotate_tile_plan(s, c, imgs.dtype, tile)
        launch("cnn_rotate_shear", imgs.device, stream, *args, p.rows,
               p.pixels, p.lanes_max, p.table_max, p.smem_bytes)
    return out


def rotate_shear(imgs: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate the sampling coordinates of [B,S,S,C] float32 or bf16 canvases
    by ``theta[b]`` radians about the center. A CPU tensor takes the plain
    version; a CUDA tensor the tiled kernel."""
    _check(imgs, theta)
    if imgs.device.type == "cpu":
        return rotate_shear_plain(imgs, theta)
    out = launch_rotate(imgs, theta)
    rotate_shear.launches += 1
    return out


rotate_shear.launches = 0
