"""Conv + bias (+ ReLU), NHWC/HWIO, float32 and bf16, with zero padding:
wrapper of ``csrc/conv.cu``.

Replaces ``cnn_tpu/ops/pallas/conv.py:conv2d_bias_relu_pallas``: the kernels
are its forward (``_forward``); ``conv2d_bias_relu_fn`` is its ``custom_vjp``
as a ``torch.autograd.Function``. ``cnn_tpu`` computes that backward with
XLA convolutions outside any Pallas kernel (``_vjp_bwd``), so here ATen's
convolution gradients compute it, in full float32 for float32 inputs and in
bf16 for bf16 ones.

Four kernels compute the float32 forward: a row-strip kernel over shared
memory (``cnn_conv2d_bias_relu_strip``) for few input channels, conv1 of
the AlexNet and the families' padded Cin-3 stems; a pointwise kernel
(``cnn_conv2d_bias_relu_pw``) for the 1x1s (MobileNet's pointwise convs,
ResNet's projections): a persistent grid, the weights resident in shared
memory, a ring of tensor-memory copies under mbarriers that runs on from
one output tile into the next, and a bulk tensor store of each tile that
drains while the next is computed; a tiled implicit GEMM over shared
memory (``cnn_conv2d_bias_relu_tiled``) for the other shapes whose vector
loads it can make, conv2-4 and the families' padded 3x3s; and the direct
kernel (``cnn_conv2d_bias_relu``) for the rest. ``conv_tile_plan``
chooses by shape and alignment alone. All four sum in the same order and
give the same bits.

Four tensor-core kernels compute the bf16 forward, ``_forward``'s bf16
path (exact bf16 products summed in float32, the bias read into float32,
the optional ReLU, one rounding to bf16), behind one entry point
(``cnn_conv2d_bias_relu_bf16``) whose variant ``conv_bf16_plan`` chooses by
shape and alignment:

- "strip" (Cout <= 64): a block stages the input rows of R output rows
  whole and ``mma.sync`` m16n8k16 reads its A fragments straight from
  them, one k16 step per kernel row (K 27 padded to 48); the output leaves
  through shared memory as 16-byte stores. Bound by bytes. Two layouts of
  the staged rows (``BF16_STRIP_TILES``): natural for AlexNet's conv1
  (k*Cin <= 16, even s*Cin, input rows of whole 16-byte chunks, no
  padding), and widened for the families' padded Cin-3 stems (any stride
  and padding, k <= 4, W % 8 == 0): each pixel staged as 4 elements, the
  4th zero, zero margins and zero rows for the padding.
- "wgmma" (conv2-3: Cin % 8 == 0, x 16-byte aligned, where "tma" does not
  take the shape): ``wgmma.mma_async`` m64nBNk16 on A (the im2col rows,
  K-major) and B (w, MN-major, read with transpose-B) in shared memory,
  filled by a ring of 16-byte ``cp.async`` slices; the tile
  (``WGMMA_TILES``, ``wgmma_tile_for``) takes BM 128 where blocks fill half
  the SMs, else BM 64 and, for a long K, two warpgroups that each walk half
  of it and sum in one fixed order. Bound by the rate its SMs take in
  copies.
- "tma" (Cin % 64 == 0, x 16-byte aligned, where the card measured it
  faster than "wgmma": the families' padded 3x3s and 1x1s, AlexNet's
  conv4): the same wgmmas on 128-byte-swizzled stages that the Tensor
  Memory Accelerator fills, one im2col copy of x per (tap, 64 channels)
  and one tiled copy of w per 64 columns, behind a producer warp and an
  ``mbarrier`` ring; the tile from ``TMA_TILES`` / ``tma_tile_for``.
- "gather" / "vec": the first design, ``mma.sync`` over A staged element
  by element or by 16-byte copies in slices of 32, two stages. The plan
  gives "gather" every shape the other three do not take (Cin 12, k 5,
  misaligned x); "vec" runs only when named, for comparisons.

Every variant takes Cout % 8 == 0 and 16-byte aligned weights; the
wrapper raises on any other bf16 shape. No variant splits K across
blocks: two launches give the same bits.

Padding (``padding=p``, the families' padded convs, which ``cnn_tpu`` runs
through XLA): every kernel reads a tap in the padding as zero, so no padded
copy of x is made (the strips stage zero margins and zero rows beside the
image's rows); the plans send a padded Cin-3 stem to the strips and the
other padded convs to the tiled kernel (float32) and to the tma or wgmma
kernel (bf16). The kernels take p <= 16 on extents up to 16,384.

``conv2d_bias_relu_op`` is the same Function registered as the custom op
``cnn_tpu_torch::conv2d_bias_relu``, so that a selective checkpoint policy
can name it (``nn/module.py:StackedBlocks``, ``remat='conv'``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.nn import grad as nn_grad

from cnn_tpu_torch.ops.conv import conv2d, conv_out_size
from cnn_tpu_torch.ops.hopper._build import cuda_args, launch

PAD_MAX, EXTENT_MAX = 16, 16384      # csrc/conv.cu kPadMax, kExtentMax


class Tile(NamedTuple):
    """A block tile of the tiled kernel: BM x BN outputs, TM x TN a thread."""
    bm: int
    bn: int
    tm: int
    tn: int

    @property
    def threads(self) -> int:
        return (self.bm // self.tm) * (self.bn // self.tn)

    @property
    def smem_bytes(self) -> int:
        """Static shared memory: the stages of A (rows padded) and B slices."""
        return 4 * TILED_STAGES * (self.bm * TILED_BK_PAD + TILED_BK * self.bn)


# tile id -> tile, in the order of csrc/conv.cu's switch on the tile id
TILES = (Tile(128, 128, 8, 8), Tile(64, 128, 8, 8), Tile(128, 64, 8, 8),
         Tile(64, 64, 8, 4), Tile(128, 32, 8, 4), Tile(64, 32, 4, 4))
TILED_BK, TILED_BK_PAD, TILED_STAGES = 8, 12, 3
STATIC_SMEM_LIMIT = 48 * 1024
H100_SMS = 132
MAX_GRID_Y = 65535

# strip id -> output rows per block (one warp each), in the order of
# csrc/conv.cu's switch on the strip id
STRIP_ROWS = (2, 4, 8)
STRIP_CIN_MAX, STRIP_COUT_MAX = 4, 64
STRIP_WIDE_ROW = 4096        # Wo * Cout past which the plan takes R = 8
STRIP_CO = 16                # output channels of one pass (a weight block)
STRIP_YS = 20                # floats of a pixel in a warp's output staging
STRIP_SMEM_MAX = 96 * 1024   # dynamic: the launch sets the attribute


def strip_input_rows(rows: int, k: int, stride: int) -> int:
    """Input rows a strip of ``rows`` output rows stages."""
    return (rows - 1) * stride + k


def strip_margin_floats(padding: int, cin: int) -> int:
    """The zero margin on each side of a padded strip's staged row:
    padding*Cin floats rounded up to 16 bytes, so that the image's floats
    start 16-byte aligned (``csrc/conv.cu:strip_margin_floats``)."""
    return -(-(padding * cin) // 4) * 4


def strip_smem_bytes(rows: int, w: int, cin: int, cout: int, k: int,
                     stride: int, padding: int = 0) -> int:
    """Shared memory of a strip of ``rows`` output rows: the weights in
    blocks of 16 output channels (zero past Cout) and the bias, rounded up
    to 16 bytes; the (rows-1)*stride + k whole input rows the strip reads,
    each with its zero margins; for Cout > 16, each warp's output staging
    (32 pixels of ``STRIP_YS`` floats); as
    ``csrc/conv.cu:strip_smem_floats`` computes it."""
    blocks = -(-cout // STRIP_CO) * STRIP_CO
    weights = -(-(blocks * k * k * cin + cout) // 4) * 4
    row = w * cin + 2 * strip_margin_floats(padding, cin)
    staging = rows * 32 * STRIP_YS if cout > STRIP_CO else 0
    return 4 * (weights + strip_input_rows(rows, k, stride) * row + staging)


# the pointwise kernel: tile id -> (BM, BN, TM, TN, stages), in the order
# of csrc/conv.cu's switch. A block of 256 consumer threads (a TM x TN
# micro-tile each) and one producer warp owns BN columns and walks M tiles
# of BM rows; its ring holds `stages` K slices of PW_CH channels.
PW_TILES = ((128, 128, 8, 8, 4), (128, 128, 8, 8, 2), (256, 64, 8, 8, 3),
            (128, 64, 8, 4, 4))
PW_CH = 32                   # channels of a K slice: one 128-byte row
PW_CONSUMERS = 256
PW_ALIGN = 1024              # the 128-byte swizzle's period
PW_SMEM_MAX = 226 * 1024     # dynamic: the launch sets the attribute
PW_STRIDE_MAX = 8            # the im2col map's traversal stride


def pw_smem_bytes(tile: int, cin: int) -> int:
    """Dynamic shared memory of a pointwise block (``csrc/conv.cu:
    pw_smem_bytes``): 1 KB to align the ring, the ring's stages of BM
    pixels x 128 bytes, the output tile's staging (BM x BN floats) and the
    resident weights (Cin x BN floats)."""
    bm, bn, _, _, stages = PW_TILES[tile]
    return PW_ALIGN + stages * bm * 4 * PW_CH + 4 * bm * bn + 4 * cin * bn


def pw_kernel_takes(cin: int, cout: int, k: int, stride: int,
                    padding: int, aligned: bool) -> bool:
    """Whether the pointwise kernel can compute the shape (its entry
    point's preconditions): a 1x1 with no padding, rows of x and y in
    whole 16 bytes (Cin % 4 == 0, Cout % 4 == 0: the tensor maps'
    strides), x and w 16-byte aligned, a stride the im2col map allows, and
    a tile whose shared memory fits ``PW_SMEM_MAX``."""
    return (k == 1 and padding == 0 and cin % 4 == 0 and cout % 4 == 0
            and aligned and 1 <= stride <= PW_STRIDE_MAX
            and any(pw_smem_bytes(t, cin) <= PW_SMEM_MAX
                    for t in range(len(PW_TILES))))


def pw_tiles(m: int, cout: int, tile: int) -> int:
    """Output tiles of ``tile`` over M pixels and Cout: M tiles times
    column ranges."""
    bm, bn = PW_TILES[tile][:2]
    return -(-m // bm) * -(-cout // bn)


def pw_tile_for(m: int, cin: int, cout: int) -> int | None:
    """The pointwise tile for M output pixels, Cin and Cout, or None where
    the plan leaves the shape to the tiled kernel: Cout below 64, which
    fills no BN 64 tile (resnet10's 16 -> 32 projection; on the H100 the
    pointwise kernel took 1.25x the tiled kernel's time there at B=64,
    PERF.md §6). Which kernel a shape takes does not depend on M, so a
    layer launches one kernel at every batch.

    A tile is a candidate where its shared memory fits (``pw_smem_bytes``)
    and Cout fills its BN: for Cout above 64 BM 128 x BN 128 (an 8 x 8
    micro-tile; four stages where the weights leave room, Cin <= 128,
    else two), then BM 256 x BN 64 (8 x 8), then BM 128 x BN 64 (8 x 4);
    for Cout 64 the last two. The first candidate whose output tiles
    (``pw_tiles``) fill two waves of 132 blocks is taken, else the last
    (the most tiles): a persistent block walks its tiles one after
    another, and with fewer tiles than that the SMs wait on the last ones.
    On the H100 (``chip_smoke.py``'s pointwise phase) each pick was
    within 5% of the fastest tile at the families' 1x1s at B = 64."""
    fits = [t for t in ((0, 1, 2, 3) if cout > 64 else (2, 3))
            if pw_smem_bytes(t, cin) <= PW_SMEM_MAX
            and cout >= PW_TILES[t][1]]
    if not fits:
        return None
    return next((t for t in fits if pw_tiles(m, cout, t) >= 2 * H100_SMS),
                fits[-1])


def pw_grid(m: int, cout: int, tile: int) -> tuple[int, int]:
    """The pointwise grid for M output pixels, Cout and ``tile``: (blocks
    a column range, column ranges). The 132 SMs are shared among the
    ranges, one block each (its shared memory keeps one block an SM), at
    least one block a range and at most one per M tile."""
    bm, bn = PW_TILES[tile][:2]
    ranges = -(-cout // bn)
    return min(-(-m // bm), max(1, H100_SMS // ranges)), ranges


class ConvPlan(NamedTuple):
    """``variant`` "direct"; "tiled" with its ``tile`` id and grid; "pw"
    with its ``tile`` id (``PW_TILES``) and grid (blocks a column range,
    column ranges); or "strip" with its ``rows`` per block and grid
    (strips, images)."""
    variant: str
    tile: int | None = None
    grid: tuple[int, int] | None = None
    rows: int | None = None


@functools.lru_cache(maxsize=256)   # a pure function, called every launch
def conv_tile_plan(b: int, h: int, w: int, cin: int, cout: int, k: int,
                   stride: int, aligned: bool, padding: int = 0) -> ConvPlan:
    """The kernel for this shape (``padding``: the zero padding).

    The strip kernel needs 1 <= Cin <= 4, Cout % 4 == 0 and <= 64, input
    rows of W*Cin floats that are a multiple of 4 (16-byte copies), x and w
    16-byte aligned (``aligned``), B <= 65,535 (the grid's y), padding up to
    ``PAD_MAX`` (the families' Cin-3 stems: staged with zero margins and
    zero rows) and a strip whose staged rows, weights and output staging
    fit in 96 KB. R is 4, or 8 where an output row holds more than
    ``STRIP_WIDE_ROW`` floats (Wo * Cout): a block stages its weights and
    its rows once, and the 128-register lanes leave 16 warps an SM at any
    R, so larger strips save staging; halved while the grid gives fewer
    than two blocks per SM (few images), as a block stages all its rows
    before any warp sums. On the H100 (``chip_smoke.py``'s stem sweep,
    alone at B=64, ms for R 2 / 4 / 8): conv1 0.0552 / 0.0536 / 0.0604,
    resnet10's stem 0.0600 / 0.0585 / 0.0592, 3 -> 32 s2 0.0952 / 0.0894 /
    0.0915, 3 -> 64 s2 0.1841 / 0.1748 / 0.1685, vgg8's 3 -> 32 s1 0.2736
    / 0.2590 / 0.2526, vgg11's 3 -> 64 s1 0.5387 / 0.5165 / 0.5006; every
    stem 2.5-4.2x faster than the direct kernel it replaced.

    The pointwise kernel takes the 1x1s that it can compute
    (``pw_kernel_takes``: k 1, padding 0, Cin % 4 == 0, Cout % 4 == 0, x
    and w 16-byte aligned, stride <= 8, a tile within ``PW_SMEM_MAX`` of
    shared memory) and for which ``pw_tile_for`` finds a tile (Cout >=
    64), on the grid of ``pw_grid``; each block walks the M tiles
    blockIdx.x, blockIdx.x + blocks, ...

    The tiled kernel (``tiled_plan``) needs Cin % 8 == 0 (a K slice of 8
    stays inside one tap and loads as 16-byte vectors), Cout % 4 == 0 and
    x and w 16-byte aligned; anything else takes the direct kernel.
    """
    if (1 <= cin <= STRIP_CIN_MAX and cout % 4 == 0
            and cout <= STRIP_COUT_MAX and (w * cin) % 4 == 0 and aligned
            and b <= MAX_GRID_Y and 0 <= padding <= PAD_MAX):
        ho = conv_out_size(h, k, stride, padding)
        want = 8 if conv_out_size(w, k, stride, padding) * cout > \
            STRIP_WIDE_ROW else 4
        fits = [r for r in STRIP_ROWS if r <= want and strip_smem_bytes(
            min(r, ho), w, cin, cout, k, stride, padding)
            <= STRIP_SMEM_MAX]
        if fits:
            many = [r for r in fits if -(-ho // r) * b >= 2 * H100_SMS]
            r = max(many) if many else min(fits)
            return ConvPlan("strip", grid=(-(-ho // r), b), rows=r)
    m = (b * conv_out_size(h, k, stride, padding)
         * conv_out_size(w, k, stride, padding))
    tile = (pw_tile_for(m, cin, cout)
            if pw_kernel_takes(cin, cout, k, stride, padding, aligned)
            else None)
    if tile is not None:
        return ConvPlan("pw", tile, pw_grid(m, cout, tile))
    if cin % TILED_BK or cout % 4 or not aligned:
        return ConvPlan("direct")
    return tiled_plan(m, cout)


def tiled_plan(m: int, cout: int) -> ConvPlan:
    """The tiled kernel's tile and grid for M output pixels and Cout. Its
    BN is Cout rounded up to 32, 64 or 128, or half of that; of those
    tiles, the largest one that still gives two waves of 132 SMs, else the
    one with the most blocks."""
    full = next((n for n in (32, 64, 128) if n >= cout), 128)
    cands = [i for i, t in enumerate(TILES) if t.bn in (full, full // 2)]

    def grid(i):
        return (-(-m // TILES[i].bm), -(-cout // TILES[i].bn))

    def blocks(i):
        gx, gy = grid(i)
        return gx * gy

    def area(i):
        return TILES[i].bm * TILES[i].bn

    enough = [i for i in cands if blocks(i) >= 2 * H100_SMS]
    best = (max(enough, key=area) if enough
            else max(cands, key=lambda i: (blocks(i), area(i))))
    return ConvPlan("tiled", best, grid(best))


# bf16, the mma.sync kernel: tile id -> (MT, NT), in the order of
# csrc/conv.cu's switch; a block of BF16_WARPS warps owns BM = 64 * MT rows
# and BN = 8 * NT columns
BF16_TILES = tuple((mt, nt) for mt in (1, 2) for nt in (2, 4, 8, 16))
# the entry point's variant argument: the mma.sync kernel's two stagings of
# A, then the strip, the wgmma and the tma kernels
BF16_VARIANTS = ("gather", "vec", "strip", "wgmma", "tma")
BF16_BK = 32                        # the mma.sync K slice: two k16 steps
BF16_WARPS = 4

# the bf16 strip kernel: output rows per block (one warp each), and strip
# id -> (R, widened), in the order of csrc/conv.cu's switch: the natural
# layout of the staged rows, then the widened one (4 elements a pixel)
BF16_STRIP_ROWS = (1, 2, 4, 8)
BF16_STRIP_TILES = tuple((r, wide) for wide in (False, True)
                         for r in BF16_STRIP_ROWS)
BF16_STRIP_KC = 16           # k*Cin of a kernel row: one k16 MMA step
BF16_STRIP_WIDE = 4          # elements of a widened pixel
BF16_STRIP_COUT_MAX = 64     # eight n8 tiles
BF16_STRIP_SMEM_MAX = 96 * 1024
# the largest R the plan takes (R = 4 was the fastest at conv1's shape at
# batch 256 and 64 on the H100: chip_smoke.py's sweep, PERF.md §6)
BF16_STRIP_R = 4

# the bf16 wgmma kernel: tile id -> (BN, MT, BK, stages, split, A via L1),
# in the order of csrc/conv.cu's switch. A block of `split` warpgroups owns
# BM = 64 * MT rows and BN columns and walks K in slices of BK through a
# ring of `stages`; `split` 2 gives each warpgroup half of the slices.
WGMMA_TILES = ((16, 1, 32, 4, 1, 1),
               (32, 1, 32, 4, 1, 1), (32, 2, 32, 4, 1, 1),
               (32, 2, 32, 6, 1, 1),
               (64, 1, 32, 4, 1, 0), (64, 1, 32, 8, 1, 0),
               (64, 1, 32, 4, 2, 0), (64, 2, 32, 4, 1, 0),
               (64, 2, 32, 6, 1, 0),
               (128, 1, 32, 8, 1, 0), (128, 1, 32, 4, 2, 0),
               (128, 2, 32, 4, 1, 0), (128, 2, 32, 6, 2, 0),
               (128, 2, 64, 4, 1, 0))
# the plan's tiles: many blocks (BM 128), few blocks with a short K (a deep
# ring) or a long K (split); few blocks never keep BN 128
WGMMA_MANY = {16: (16, 1, 32, 4, 1, 1), 32: (32, 2, 32, 6, 1, 1),
              64: (64, 2, 32, 4, 1, 0), 128: (128, 2, 32, 4, 1, 0)}
WGMMA_FEW = {16: (16, 1, 32, 4, 1, 1), 32: (32, 1, 32, 4, 1, 1),
             64: (64, 1, 32, 8, 1, 0)}
WGMMA_FEW_LONG_K = {16: (16, 1, 32, 4, 1, 1), 32: (32, 1, 32, 4, 1, 1),
                    64: (64, 1, 32, 4, 2, 0)}
WGMMA_LONG_K = 16            # slices of 32 from which the split pays

# the bf16 tma kernel: tile id -> (BN, BM, stages, consumer warpgroups), in
# the order of csrc/conv.cu's switch. A block of `consumers` warpgroups and
# one producer warp owns BM rows and BN columns; each K slice is one tap x
# TMA_CIN channels. The plan takes five of them; the other four stay for
# the smoke's sweep, which sets the plan's rule.
TMA_TILES = ((64, 64, 6, 1), (64, 128, 4, 1), (64, 128, 4, 2),
             (64, 128, 6, 1), (64, 256, 4, 2),
             (128, 64, 6, 1), (128, 128, 4, 1), (128, 128, 4, 2),
             (128, 256, 3, 2))
# the plan's tiles (tma_tile_for)
TMA_FEW, TMA_MANY = (64, 64, 6, 1), (64, 128, 4, 2)
TMA_NARROW, TMA_WIDE = (128, 128, 4, 1), (128, 256, 3, 2)
TMA_SHORT, TMA_SHORT_K = (128, 64, 6, 1), 2
TMA_CIN = 64                 # channels of a K slice: one 128-byte row
TMA_STRIDE_MAX = 8           # the im2col map's traversal stride


def strip_bf16_wide_row(w: int, padding: int) -> int:
    """Pixels of a widened staged row: a zero margin of ``padding`` pixels
    rounded up to an even count (16 bytes), the image row, ``padding``
    pixels, rounded up to an even row (``csrc/conv.cu``)."""
    lead = -(-padding // 2) * 2
    return -(-(lead + w + padding) // 2) * 2


def strip_bf16_smem_bytes(rows: int, w: int, cin: int, cout: int, k: int,
                          stride: int, padding: int = 0,
                          wide: bool = False) -> int:
    """Shared memory of a bf16 strip of ``rows`` output rows, as
    ``csrc/conv.cu:strip_bf16_smem_bytes``: the B fragments (8 bytes a
    lane per kernel row and n8 tile), the staged input rows (natural: 16
    bytes of padding after them; widened: 8-byte pixels, margins
    included), the output rows (widened: 16 pixels a warp, rows of Cout + 8
    bf16)."""
    frag = k * (cout // 8) * 32 * 8
    nin = strip_input_rows(rows, k, stride)
    if wide:
        rows_in = nin * strip_bf16_wide_row(w, padding) * BF16_STRIP_WIDE * 2
        out = rows * 16 * (cout + 8) * 2
    else:
        rows_in = 2 * nin * w * cin + 16
        out = 2 * rows * conv_out_size(w, k, stride, padding) * cout
    return frag + rows_in + out


def strip_bf16_takes(w: int, cin: int, cout: int, k: int, stride: int,
                     padding: int, wide: bool) -> bool:
    """Whether a strip layout takes the shape (``csrc/conv.cu:
    strip_bf16_takes``): Cout <= 64; natural, no padding, one k16 step per
    kernel row (k*Cin <= 16), 4-byte A words (s*Cin even) and input rows of
    whole 16-byte chunks (W*Cin % 8 == 0); widened, Cin 3, k*4 <= 16 and
    rows of whole groups of 8 pixels (W % 8 == 0), any stride and
    padding."""
    if cout > BF16_STRIP_COUT_MAX:
        return False
    if wide:
        return cin == 3 and k * BF16_STRIP_WIDE <= BF16_STRIP_KC and w % 8 == 0
    return (padding == 0 and k * cin <= BF16_STRIP_KC
            and (stride * cin) % 2 == 0 and (w * cin) % 8 == 0)


def strip_bf16_tile(b: int, h: int, w: int, cin: int, cout: int, k: int,
                    stride: int, x_aligned: bool,
                    padding: int = 0) -> int | None:
    """The bf16 strip's id in ``BF16_STRIP_TILES``, or None where it cannot
    take the shape: x aligned, B <= 65,535 (the grid's y), and the natural
    layout where it takes the shape (AlexNet's conv1), else the widened one
    (the padded Cin-3 stems, ``strip_bf16_takes``). R is the largest of
    ``BF16_STRIP_ROWS`` up to ``BF16_STRIP_R`` whose strip fits 96 KB.

    On the H100 (``chip_smoke.py``'s stem phase, alone, B=64): conv1 on
    the natural layout 0.0228 ms, widened 0.0269 (batch 256: 0.0690 /
    0.0852), so the natural layout stays where it can; the widened stems at
    R 4 ran 2.6-3.4x faster than the gather they replaced (resnet10's
    0.0283 against 0.0959), and R 8 was within 4% of R 4 at each."""
    if not (x_aligned and b <= MAX_GRID_Y and 0 <= padding <= PAD_MAX):
        return None
    wide = next((v for v in (False, True) if strip_bf16_takes(
        w, cin, cout, k, stride, padding, v)), None)
    if wide is None:
        return None
    ho = conv_out_size(h, k, stride, padding)
    return next((BF16_STRIP_TILES.index((r, wide))
                 for r in sorted(BF16_STRIP_ROWS, reverse=True)
                 if r <= BF16_STRIP_R and strip_bf16_smem_bytes(
                     min(r, ho), w, cin, cout, k, stride, padding, wide)
                 <= BF16_STRIP_SMEM_MAX), None)


def bf16_bn(cout: int) -> int:
    """Cout rounded up to a power of two between 16 and 128."""
    bn = 16
    while bn < min(cout, 128):
        bn *= 2
    return bn


def wgmma_tile_for(cout: int, m: int, kk: int) -> int:
    """The wgmma tile for Cout, M output pixels and K = ``kk``.

    BN is ``bf16_bn(cout)``. Where BM = 128 still gives at least half of
    the 132 SMs a block, BM is 128 (``WGMMA_MANY``): half the blocks, so
    half the re-reads of w, which every block reads whole (conv2-4 at batch
    256, conv2-3 at 64). Fewer
    blocks than that leave SMs idle: BN 128 is halved into two column
    blocks, BM is 64, and the serial chain of K slices sets the time. A
    chain of 16 slices or more (conv4, K 576: 18) is split between the
    block's two warpgroups, each walking half and summing in one fixed
    order (``WGMMA_FEW_LONG_K``); a shorter one (conv3, K 288: 9) keeps
    one warpgroup and a deeper ring (``WGMMA_FEW``). On the H100 each
    choice was the fastest of the sweep or within 0.0007 ms of it
    (``chip_smoke.py``, PERF.md §6).
    """
    bn = bf16_bn(cout)
    if -(-m // 128) * -(-cout // bn) >= H100_SMS // 2:
        return WGMMA_TILES.index(WGMMA_MANY[bn])
    if bn == 128:
        bn = 64
    table = (WGMMA_FEW_LONG_K if -(-kk // 32) >= WGMMA_LONG_K
             else WGMMA_FEW)
    return WGMMA_TILES.index(table[bn])


def tma_tile_for(cout: int, m: int, kk: int) -> int:
    """The tma tile for Cout, M output pixels and K = ``kk``.

    A K of at most ``TMA_SHORT_K`` slices (1x1s over 64 or 128 channels)
    takes BM 64 (``TMA_FEW`` for Cout <= 64, else ``TMA_SHORT``): such a
    block fills one or two stages, and its ring shrinks to them, so many
    blocks share an SM and one's epilogue hides behind another's copies
    (MobileNet's pw_2 at B=64: 0.0328 ms, against 0.0399 with BM 256).
    Otherwise Cout <= 64, or too few BN 128 x BM 128 blocks to give half of
    the 132 SMs one (AlexNet's conv4 at B <= 64), takes BN 64 (Cout 128 in
    two column blocks): BM 128 with two consumer warpgroups (``TMA_MANY``)
    where that gives every SM a block, else BM 64 (``TMA_FEW``). A wider
    Cout takes BN 128 and BM 256 (``TMA_WIDE``: half the blocks that each
    read all of w) where the BM 256 blocks fill two or more waves of 132
    SMs, or fit in one wave that BM 128 would overflow; else BM 128
    (``TMA_NARROW``): at 1.5 waves the quantisation costs more than the
    re-reads save. On the H100 each pick was the fastest of the nine tiles
    or within 10% of it at every family conv shape and conv4 (PERF.md §6,
    ``chip_smoke.py``'s tma sweep).
    """
    if -(-kk // TMA_CIN) <= TMA_SHORT_K:
        return TMA_TILES.index(TMA_FEW if cout <= 64 else TMA_SHORT)
    b128 = -(-m // 128) * -(-cout // 128)
    if cout <= 64 or b128 < H100_SMS // 2:
        many = -(-m // 128) * -(-cout // 64) >= H100_SMS
        return TMA_TILES.index(TMA_MANY if many else TMA_FEW)
    b256 = -(-m // 256) * -(-cout // 128)
    wide = b256 >= 2 * H100_SMS or (b256 <= H100_SMS < b128)
    return TMA_TILES.index(TMA_WIDE if wide else TMA_NARROW)


def tma_takes(cin: int, stride: int, x_aligned: bool) -> bool:
    """Whether the tma kernel can take the shape: whole 64-channel slices,
    an aligned x (the tensor map's base), a traversal stride it allows."""
    return cin % TMA_CIN == 0 and x_aligned and stride <= TMA_STRIDE_MAX


class Bf16Plan(NamedTuple):
    """The bf16 kernel's ``variant`` (one of ``BF16_VARIANTS``), ``tile``
    id into that variant's table (``BF16_TILES``, ``BF16_STRIP_TILES``,
    ``WGMMA_TILES`` or ``TMA_TILES``), grid (M blocks, N blocks; strips,
    images for the strip) and K padded to what the kernel multiplies (its
    slices, or 16 per kernel row for the strip)."""
    variant: str
    tile: int
    grid: tuple[int, int]
    k_pad: int

    @property
    def bm(self) -> int:
        """Output rows (pixels) of a block; the strip's are R image rows."""
        if self.variant == "wgmma":
            return 64 * WGMMA_TILES[self.tile][1]
        if self.variant == "tma":
            return TMA_TILES[self.tile][1]
        if self.variant == "strip":
            return BF16_STRIP_TILES[self.tile][0]
        return BF16_WARPS * 16 * BF16_TILES[self.tile][0]

    @property
    def bn(self) -> int | None:
        """Output columns of a block; None for the strip, whose block
        computes every column of Cout."""
        if self.variant in ("wgmma", "tma"):
            return (WGMMA_TILES if self.variant == "wgmma"
                    else TMA_TILES)[self.tile][0]
        if self.variant == "strip":
            return None
        return 8 * BF16_TILES[self.tile][1]


@functools.lru_cache(maxsize=256)   # a pure function, called every launch
def conv_bf16_plan(b: int, h: int, w: int, cin: int, cout: int, k: int,
                   stride: int, x_aligned: bool,
                   variant: str | None = None,
                   padding: int = 0) -> Bf16Plan:
    """The bf16 kernel's launch for this shape (``padding``: the zero
    padding).

    "strip" (conv1, the padded Cin-3 stems) where ``strip_bf16_tile`` finds
    a layout and an R; else "tma"
    where ``tma_takes`` (Cin % 64 == 0, x 16-byte aligned, stride <= 8:
    the families' convs past their first stages, AlexNet's conv4; on the
    H100 it beat "wgmma" at each such shape the smoke sweeps, by 1.29-3.12x)
    with ``tma_tile_for``'s tile; else "wgmma" (conv2-3) where Cin % 8 == 0
    (a chunk of 8 never straddles a tap) and x is 16-byte aligned
    (``x_aligned``), with ``wgmma_tile_for``'s tile; else the mma.sync
    kernel with A staged element by element ("gather":
    Cin 12, k 5, misaligned x, rows that are no whole 16-byte chunks). Its
    "vec" staging takes the wgmma variant's shapes and is reached only by
    naming ``variant``, for comparisons; a named variant that cannot take
    the shape raises. The mma.sync kernel's BN is ``bf16_bn(cout)`` (wider
    Cout takes more column blocks).
    Raises on Cout % 8 != 0: B is staged 8 columns at a time.
    """
    if cout % 8 or cout < 8:
        raise ValueError(f"conv2d_bias_relu bf16: Cout {cout} is not a "
                         "multiple of 8")
    vec_ok = cin % 8 == 0 and x_aligned
    tma_ok = tma_takes(cin, stride, x_aligned)
    strip = strip_bf16_tile(b, h, w, cin, cout, k, stride, x_aligned,
                            padding)
    if variant is None:
        variant = ("strip" if strip is not None else "tma" if tma_ok
                   else "wgmma" if vec_ok else "gather")
    if variant not in BF16_VARIANTS or (
            variant in ("vec", "wgmma") and not vec_ok) or (
            variant == "tma" and not tma_ok) or (
            variant == "strip" and strip is None):
        raise ValueError(f"conv2d_bias_relu bf16: variant {variant} cannot "
                         f"take x [{b},{h},{w},{cin}], Cout {cout}, k {k}, "
                         f"stride {stride}, x aligned {x_aligned}")
    ho = conv_out_size(h, k, stride, padding)
    wo = conv_out_size(w, k, stride, padding)
    m, kk = b * ho * wo, k * k * cin
    if variant == "strip":
        rows = BF16_STRIP_TILES[strip][0]
        return Bf16Plan("strip", strip, (-(-ho // rows), b), 16 * k)
    if variant == "wgmma":
        tile = wgmma_tile_for(cout, m, kk)
        bn, mt, bk = WGMMA_TILES[tile][:3]
        return Bf16Plan("wgmma", tile, (-(-m // (64 * mt)), -(-cout // bn)),
                        -(-kk // bk) * bk)
    if variant == "tma":
        tile = tma_tile_for(cout, m, kk)
        bn, bm = TMA_TILES[tile][:2]
        return Bf16Plan("tma", tile, (-(-m // bm), -(-cout // bn)), kk)
    bn = bf16_bn(cout)
    gy = -(-cout // bn)
    mt = 2 if -(-m // 128) * gy >= 2 * H100_SMS else 1
    return Bf16Plan(variant, BF16_TILES.index((mt, bn // 8)),
                    (-(-m // (64 * mt)), gy), -(-kk // BF16_BK) * BF16_BK)


def conv2d_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int = 2, relu: bool = True,
                     padding: int = 0) -> torch.Tensor:
    """x [B,H,W,Cin], w [k,k,Cin,Cout], b [Cout] -> [B,Ho,Wo,Cout], all
    float32 or all bf16; ``padding`` zero rows and columns on each side.

    A CPU tensor takes the plain version (``ops/conv.py:conv2d``). While a
    program is exported (``export.py``) the call goes through the operator
    ``conv2d_bias_relu_op``, which ``torch.export`` records by name.
    """
    if torch.compiler.is_exporting():
        return conv2d_bias_relu_op(x, w, b, stride, relu, padding)
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError("conv2d_bias_relu: expects x [B,H,W,Cin], "
                         "w [k,k,Cin,Cout], b [Cout]")
    bsz, h, wid, cin = x.shape
    k, k2, wcin, cout = w.shape
    if k != k2 or wcin != cin or b.shape[0] != cout or stride < 1:
        raise ValueError(f"conv2d_bias_relu: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, stride {stride}")
    if h + 2 * padding < k or wid + 2 * padding < k:
        raise ValueError(f"conv2d_bias_relu: extent {h}x{wid} padded by "
                         f"{padding} is below k={k}")
    if x.device.type == "cpu":
        return conv2d(x, w, b, stride, relu, padding)
    if not 0 <= padding <= PAD_MAX or max(h, wid) > EXTENT_MAX:
        raise ValueError(f"conv2d_bias_relu: padding {padding} on a "
                         f"{h}x{wid} image: the kernels take padding <= "
                         f"{PAD_MAX} and extents <= {EXTENT_MAX}")
    # the families' shapes, beside the variants: padded convs and 1x1s
    shape_counters = (("padded",) if padding else ()) + (
        ("1x1",) if k == 1 else ())
    if x.dtype == torch.bfloat16:
        out, plan = launch_conv_bf16(x, w, b, stride, relu, padding=padding)
        # the padded strips (the families' stems) by name as well
        strip_padded = (("bf16_strip_padded",)
                        if plan.variant == "strip" and padding else ())
        for counter in (f"bf16_{plan.variant}", "bf16",
                        *(f"bf16_{c}" for c in shape_counters),
                        *shape_counters, *strip_padded):
            _count(counter)
        conv2d_bias_relu.launches += 1
        return out
    stream = cuda_args("conv2d_bias_relu", x, w, b, dtypes=(torch.float32,) * 3)
    out = torch.empty((bsz, conv_out_size(h, k, stride, padding),
                       conv_out_size(wid, k, stride, padding), cout),
                      dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h,
            wid, cin, cout, k, stride, padding, int(relu))
    plan = conv_tile_plan(bsz, h, wid, cin, cout, k, stride,
                          x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                          padding)
    if plan.variant == "strip":
        launch("cnn_conv2d_bias_relu_strip", x.device, stream, *args,
               STRIP_ROWS.index(plan.rows))
        conv2d_bias_relu.launches_strip += 1
        if padding:
            conv2d_bias_relu.launches_strip_padded += 1
    elif plan.variant == "pw":
        launch("cnn_conv2d_bias_relu_pw", x.device, stream, *args,
               plan.tile, plan.grid[0])
        conv2d_bias_relu.launches_pw += 1
    elif plan.variant == "tiled":
        launch("cnn_conv2d_bias_relu_tiled", x.device, stream, *args,
               plan.tile)
        conv2d_bias_relu.launches_tiled += 1
    else:
        launch("cnn_conv2d_bias_relu", x.device, stream, *args)
        conv2d_bias_relu.launches_direct += 1
    for counter in shape_counters:
        _count(counter)
    conv2d_bias_relu.launches += 1
    return out


def _count(counter: str) -> None:
    name = f"launches_{counter}"
    setattr(conv2d_bias_relu, name, getattr(conv2d_bias_relu, name) + 1)


def launch_conv_bf16(x, w, b, stride: int, relu: bool,
                     tile: int | None = None, variant: str | None = None,
                     padding: int = 0):
    """Launches the bf16 kernel on CUDA bf16 tensors with its plan's
    variant and tile, or with ``variant`` (one of ``BF16_VARIANTS``, planned
    for this shape; raises if it cannot take it) and ``tile`` (an id into
    that variant's table); returns the output and the plan. Counts
    nothing."""
    stream = cuda_args("conv2d_bias_relu", x, w, b,
                       dtypes=(torch.bfloat16,) * 3)
    bsz, h, wid, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    if w.data_ptr() % 16:
        raise ValueError("conv2d_bias_relu bf16: weights must be 16-byte "
                         "aligned")
    plan = conv_bf16_plan(bsz, h, wid, cin, cout, k, stride,
                          x.data_ptr() % 16 == 0, variant, padding)
    if tile is not None:
        plan = plan._replace(tile=tile)
    out = torch.empty((bsz, conv_out_size(h, k, stride, padding),
                       conv_out_size(wid, k, stride, padding), cout),
                      dtype=torch.bfloat16, device=x.device)
    launch("cnn_conv2d_bias_relu_bf16", x.device, stream, x.data_ptr(),
           w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, wid, cin, cout,
           k, stride, padding, int(relu), BF16_VARIANTS.index(plan.variant),
           plan.tile)
    return out, plan


conv2d_bias_relu.launches = 0          # every launch, any kernel
conv2d_bias_relu.launches_strip = 0    # the float32 kernels
conv2d_bias_relu.launches_tiled = 0
conv2d_bias_relu.launches_pw = 0
conv2d_bias_relu.launches_direct = 0
conv2d_bias_relu.launches_bf16 = 0     # the bf16 kernel, every variant
conv2d_bias_relu.launches_bf16_gather = 0
conv2d_bias_relu.launches_bf16_vec = 0
conv2d_bias_relu.launches_bf16_strip = 0
conv2d_bias_relu.launches_bf16_wgmma = 0
conv2d_bias_relu.launches_bf16_tma = 0
conv2d_bias_relu.launches_padded = 0       # by shape, any dtype: padded
conv2d_bias_relu.launches_1x1 = 0          # and 1x1 convs
conv2d_bias_relu.launches_bf16_padded = 0  # the same, bf16 only
conv2d_bias_relu.launches_bf16_1x1 = 0
conv2d_bias_relu.launches_strip_padded = 0       # the strips with padding:
conv2d_bias_relu.launches_bf16_strip_padded = 0  # the families' stems


def _save(ctx, x, w, out, stride, relu, padding) -> None:
    ctx.save_for_backward(x, w, out if relu else None)
    ctx.stride, ctx.relu, ctx.padding = stride, relu, padding


def _backward(ctx, g):
    """dx, dw, db of the conv (``Conv2dBiasReluFn``), each only where
    ``ctx.needs_input_grad`` asks for it."""
    x, w, out = ctx.saved_tensors
    if ctx.relu:
        g = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype,
                                                device=g.device))
    # NHWC / HWIO viewed as NCHW / OIHW: no copies
    g_nchw, x_nchw = g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1)
    dx = dw = db = None
    kw = {"stride": ctx.stride, "padding": ctx.padding}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        # only what is asked for: not dx for the first layer's images,
        # not dw and db for frozen parameters (Grad-CAM)
        if ctx.needs_input_grad[0]:
            dx = nn_grad.conv2d_input(x_nchw.shape, w_oihw, g_nchw, **kw)
            dx = dx.permute(0, 2, 3, 1).contiguous()
        if ctx.needs_input_grad[1]:
            dw = nn_grad.conv2d_weight(x_nchw, w_oihw.shape, g_nchw, **kw)
            dw = dw.permute(2, 3, 1, 0).contiguous()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if ctx.needs_input_grad[2]:
        db = g.sum(dim=(0, 1, 2))
    return dx, dw, db


class Conv2dBiasReluFn(torch.autograd.Function):
    """The conv kernel with ``_vjp_bwd``'s backward: the cotangent masked
    where ``out <= 0`` (ReLU on), ``dx`` the transposed conv at the exact
    input extent (rows and columns the window never read get 0; with
    padding, the transposed conv cropped by it), ``dw`` cropped to k x k,
    ``db`` the sum of the cotangent, each in its input's dtype.

    ``cnn_tpu`` runs those convolutions at ``Precision.HIGHEST`` in float32;
    cuDNN would take TF32 by default (``torch.backends.cudnn.allow_tf32``),
    so the backward turns TF32 off for its own calls whatever the global
    setting. In bf16 (``_vjp_bwd`` at default precision) ATen's bf16
    convolution gradients compute them.
    """

    @staticmethod
    def forward(ctx, x, w, b, stride, relu, padding=0):
        out = conv2d_bias_relu(x, w, b, stride, relu, padding)
        _save(ctx, x, w, out, stride, relu, padding)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_backward(ctx, g), None, None, None)


def conv2d_bias_relu_fn(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        stride: int = 2, relu: bool = True,
                        padding: int = 0) -> torch.Tensor:
    """Differentiable ``conv2d_bias_relu``."""
    return Conv2dBiasReluFn.apply(x, w, b, stride, relu, padding)


@torch.library.custom_op("cnn_tpu_torch::conv2d_bias_relu", mutates_args=())
def conv2d_bias_relu_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        stride: int, relu: bool,
                        padding: int) -> torch.Tensor:
    """``conv2d_bias_relu_fn`` as an operator that dispatch sees by name
    (``torch.ops.cnn_tpu_torch.conv2d_bias_relu``): the same launch and
    the same backward."""
    return conv2d_bias_relu(x, w, b, stride, relu, padding)


@conv2d_bias_relu_op.register_fake
def _(x, w, b, stride, relu, padding):
    k = w.shape[0]
    return x.new_empty((x.shape[0], conv_out_size(x.shape[1], k, stride,
                                                  padding),
                        conv_out_size(x.shape[2], k, stride, padding),
                        w.shape[-1]))


def _op_setup(ctx, inputs, output):
    x, w, _, stride, relu, padding = inputs
    _save(ctx, x, w, output, stride, relu, padding)


def _op_backward(ctx, g):
    return (*_backward(ctx, g), None, None, None)


conv2d_bias_relu_op.register_autograd(_op_backward, setup_context=_op_setup)
