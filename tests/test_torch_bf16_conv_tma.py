"""The bf16 conv's "tma" variant (``csrc/conv.cu``:
``conv2d_bf16_tma_kernel``), on the CPU, before any card runs it.

- A numpy emulation of the kernel's walk: the im2col tensor map as the
  Tensor Memory Accelerator walks it (the pixel box's corners, the
  traversal strides, the tap offsets, the zero fill in the padding and past
  the last image), the 128-byte swizzle as TMA writes a stage, w's tiled
  64 x 64 boxes (zero past Cout), wgmma's shared-memory matrix descriptors
  packed as the kernel packs them and decoded as the hardware reads a
  128-byte-swizzled K-major A and MN-major B, BM 256's two consumer
  warpgroups on one B stage, the accumulator's lane layout, the output
  tile and its masked 16-byte stores. Shared memory starts as NaN (and
  every stage again before its slice lands), so a read of anything no copy
  wrote shows; outputs count their writes. Each emulation is held against
  the plain bf16 conv and the Pallas ``_forward`` in interpret mode on a
  zero-padded x (a VALID conv of the padded x is the same function).
- The ring's protocol: the producer's and consumers' mbarrier waits, with
  the kernel's parity expressions, under random interleavings: no stage is
  overwritten while a wgmma reads it, none is read before its slice lands,
  and the walk ends.
- The plan (which shapes take "tma", and its tile) and ``TMA_TILES``
  against the source's switch and constants; the wrapper's counter.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.ops.pallas.conv import _forward as pallas_conv_forward
from cnn_tpu_torch.ops.conv import conv2d, conv_out_size
from cnn_tpu_torch.ops.hopper import conv as hconv
from cnn_tpu_torch.ops.hopper import (conv2d_bias_relu, read_counters,
                                      reset_launches)
from cnn_tpu_torch.ops.hopper._build import SIGNATURES
from cnn_tpu_torch.ops.hopper.conv import (BF16_VARIANTS, H100_SMS, TMA_CIN,
                                           TMA_FEW, TMA_MANY, TMA_NARROW,
                                           TMA_SHORT, TMA_SHORT_K,
                                           TMA_STRIDE_MAX, TMA_TILES, TMA_WIDE,
                                           conv_bf16_plan)
from test_torch_bf16_conv_hopper import (_bf16_round, _bits, _ordered,
                                         _to_regs, _vals)

BF16 = torch.bfloat16
CONV_CU = (Path(__file__).resolve().parents[1] / "cnn_tpu_torch" / "csrc"
           / "conv.cu")
NAN16 = np.uint16(0x7FC0)   # a bf16 quiet NaN
SMEM_MAX = 227 * 1024       # a block's shared memory, H100
# the kernel's constants (test_tables_match_the_source reads them)
ROW = 128                   # kTmaRow: a stage's row, 64 channels
PIX = 128                   # kTmaPix: pixels of one im2col copy
SW = 1024                   # kTmaSw: the 128-byte swizzle's period
BOX = TMA_CIN * ROW         # kTmaBox: a 64 x 64 box of w


# --- the Tensor Memory Accelerator -------------------------------------------

def sw128(addr):
    """The 128-byte swizzle on a shared-memory byte address, as TMA writes
    and wgmma reads it: bits 4-6 (the 16-byte chunk of a 128-byte row) XOR
    bits 7-9 (the row within a 1024-byte period)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def im2col_map(x_shape, k: int, stride: int, pad: int, pixels: int) -> dict:
    """x's im2col tensor map as ``tma_maps`` encodes it: dims (C, W, H, N)
    innermost first, the pixel box's lower corner -pad and upper corner
    pad - (k-1) in W and H, traversal strides {1, s, s, 1}, 64 channels
    and ``pixels`` pixels a copy."""
    b, h, w, c = x_shape
    return {"dims": (c, w, h, b), "lower": (-pad, -pad),
            "upper": (pad - (k - 1), pad - (k - 1)),
            "strides": (1, stride, stride, 1), "channels": TMA_CIN,
            "pixels": pixels}


def tma_im2col(xb: np.ndarray, mp: dict, coords, offsets) -> np.ndarray:
    """The rows one im2col copy lands, [pixels, channels] of bf16 bits:
    from (w, h, n) of ``coords`` the unit walks the pixel box (W from its
    lower corner to W - 1 + its upper corner, then H, then the next image)
    by the traversal strides; pixel j reads channels [c, c + 64) at its
    position shifted by the im2col ``offsets`` (dx, dy), zero where that
    lies outside the tensor (the padding, an image past the last)."""
    c, w, h, n = coords
    dx, dy = offsets
    cdim, wdim, hdim, ndim = mp["dims"]
    lo_w, lo_h = mp["lower"]
    hi_w, hi_h = wdim - 1 + mp["upper"][0], hdim - 1 + mp["upper"][1]
    _, sw, sh, _ = mp["strides"]
    assert lo_w <= w <= hi_w and lo_h <= h <= hi_h, "start outside the box"
    out = np.zeros((mp["pixels"], mp["channels"]), np.uint16)
    ch = c + np.arange(mp["channels"])
    for j in range(mp["pixels"]):
        iw, ih = w + dx, h + dy
        if 0 <= iw < wdim and 0 <= ih < hdim and 0 <= n < ndim:
            ok = ch < cdim
            out[j, ok] = xb[n, ih, iw, ch[ok]]
        w += sw
        if w > hi_w:
            w, h = lo_w, h + sh
            if h > hi_h:
                h, n = lo_h, n + 1
    return out


def tma_tile(wmat: np.ndarray, c0: int, c1: int) -> np.ndarray:
    """w's tiled map: the 64 x 64 box of columns [c0, c0 + 64) and k rows
    [c1, c1 + 64) of the [K, Cout] bits, zero past either edge."""
    out = np.zeros((TMA_CIN, TMA_CIN), np.uint16)
    part = wmat[c1:c1 + TMA_CIN, c0:c0 + TMA_CIN]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def write_sw128(smem: np.ndarray, base: int, rows: np.ndarray) -> None:
    """A copy's rows of 128 bytes landed at ``base`` (1024-aligned) in the
    128-byte swizzle."""
    assert base % SW == 0 and rows.shape[1] * 2 == ROW
    r, col = np.indices(rows.shape)
    smem[sw128(base + r * ROW + 2 * col) // 2] = rows


# --- wgmma's descriptors -----------------------------------------------------

def desc(addr: int, lbo: int, sbo: int, swizzle: bool = True) -> int:
    """A shared-memory matrix descriptor as conv.cu's ``wgmma_desc`` and
    ``wgmma_desc_sw128`` pack it: the start address, the leading and stride
    byte offsets in 16-byte units (bits 0-13, 16-29, 32-45), base offset 0
    (bits 49-51), layout type B128 (bits 62-63 = 1) or none (0)."""
    for v in (addr, lbo, sbo):
        assert v % 16 == 0 and v >> 18 == 0, v
    return ((addr >> 4) | (lbo >> 4) << 16 | (sbo >> 4) << 32
            | (1 << 62 if swizzle else 0))


def _decode(d: int):
    assert (d >> 49) & 7 == 0, "base offset"
    return ((d & 0x3FFF) << 4, ((d >> 16) & 0x3FFF) << 4,
            ((d >> 32) & 0x3FFF) << 4, d >> 62)


def _smem_vals(smem: np.ndarray, byte: np.ndarray) -> np.ndarray:
    assert (byte % 2 == 0).all() and byte.min() >= 0 and \
        byte.max() < 2 * smem.size
    return _vals(smem[byte // 2])


def read_a(smem: np.ndarray, d: int) -> np.ndarray:
    """The 64 x 16 K-major A of one wgmma k16 step: with layout B128, row
    r's 16 values start at the row's byte (r % 8) * 128 of its 8-row group
    (the stride byte offset apart) plus the start address's offset within
    the row, swizzled; with no swizzle, core matrices of 8 rows x 16 bytes
    (K-adjacent ones the leading byte offset apart)."""
    start, lbo, sbo, layout = _decode(d)
    r, kk = np.arange(64)[:, None], np.arange(16)[None, :]
    if layout == 1:
        byte = sw128(start + (r // 8) * sbo + (r % 8) * ROW + kk * 2)
    else:
        assert layout == 0
        byte = start + (r // 8) * sbo + (kk // 8) * lbo + (r % 8) * 16 + \
            (kk % 8) * 2
    return _smem_vals(smem, byte)


def read_b(smem: np.ndarray, d: int, n: int) -> np.ndarray:
    """The 16 x n MN-major B of one k16 step (transpose-B): with layout
    B128, k row kr holds 64 columns in one 128-byte row, 8-row groups of K
    the stride byte offset apart and 64-column blocks the leading byte
    offset apart, swizzled; with no swizzle, core matrices of 8 k rows x 8
    columns (N-adjacent ones the stride byte offset apart)."""
    start, lbo, sbo, layout = _decode(d)
    kr, nn = np.arange(16)[:, None], np.arange(n)[None, :]
    if layout == 1:
        byte = sw128(start + (kr // 8) * sbo + (kr % 8) * ROW
                     + (nn // 64) * lbo + (nn % 64) * 2)
    else:
        assert layout == 0
        byte = start + (nn // 8) * sbo + (kr // 8) * lbo + (kr % 8) * 16 + \
            (nn % 8) * 2
    return _smem_vals(smem, byte)


# --- the kernel --------------------------------------------------------------

def ring_bytes(tile: int, kt: int) -> int:
    """The dynamic shared memory a launch asks for past the alignment
    slack, as conv.cu's ``tma_smem_bytes``: the stages K's ``kt`` slices
    use (at least the output tile, which aliases them), else the ring."""
    bn, bm, stages, _ = TMA_TILES[tile]
    stage = bm * ROW + (bn // TMA_CIN) * BOX
    return (max(kt * stage, bm * (bn + 8) * 2) if kt < stages
            else stages * stage)


def emulate_tma(x, w, b, stride, pad, relu, tile, swap_b=False,
                swizzle=True):
    """``conv2d_bf16_tma_kernel`` with TMA_TILES[tile] on bf16 values held
    as float32; ``swap_b`` exchanges B's leading and stride byte offsets,
    ``swizzle`` False packs descriptors without the B128 layout type."""
    bsz, h, wid, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    ho = conv_out_size(h, k, stride, pad)
    wo = conv_out_size(wid, k, stride, pad)
    m_all = bsz * ho * wo
    bn, bm, stages, nc = TMA_TILES[tile]
    mt = bm // 64 // nc
    pix = min(bm, PIX)
    cc = cin // TMA_CIN
    kt_all = k * k * cc
    a_bytes = bm * ROW
    stage = a_bytes + (bn // TMA_CIN) * BOX
    smem_bytes = ring_bytes(tile, kt_all)
    assert smem_bytes + SW <= SMEM_MAX
    xb, wb = _bits(x), _bits(w).reshape(k * k * cin, cout)
    mp = im2col_map(x.shape, k, stride, pad, pix)
    y = np.full(m_all * cout, NAN16, np.uint16)
    writes = np.zeros(y.size, np.int32)
    th = np.arange(128)
    warp, g, t = th >> 5, (th & 31) >> 2, th & 3
    stride_o = bn + 8
    for bx in range(-(-m_all // bm)):
        for by in range(-(-cout // bn)):
            m0, n0 = bx * bm, by * bn
            smem = np.full(smem_bytes // 2, NAN16, np.uint16)
            # the producer lane: tap (0,0) of each copy's first pixel
            coords = []
            for j in range(bm // pix):
                m = m0 + j * pix
                q = m // wo
                coords.append(((m % wo) * stride - pad,
                               (q % ho) * stride - pad, q // ho))
            acc = np.zeros((nc, mt, 64, bn), np.float32)
            for kt in range(kt_all):
                sa = (kt % stages) * stage
                sb = sa + a_bytes
                assert sa + stage <= smem_bytes
                smem[sa // 2:(sa + stage) // 2] = NAN16   # stale data out
                tap, c = kt // cc, (kt % cc) * TMA_CIN
                dy, dx = tap // k, tap % k
                landed = 0
                for j, (cw, ch, cn) in enumerate(coords):
                    rows = tma_im2col(xb, mp, (c, cw, ch, cn), (dx, dy))
                    write_sw128(smem, sa + j * pix * ROW, rows)
                    landed += rows.nbytes
                for j in range(bn // TMA_CIN):
                    box = tma_tile(wb, n0 + j * TMA_CIN, kt * TMA_CIN)
                    write_sw128(smem, sb + j * BOX, box)
                    landed += box.nbytes
                assert landed == stage    # the bytes the barrier expects
                for wg in range(nc):      # both read the one B stage
                    for ks in range(TMA_CIN // 16):
                        lbo, sbo = (SW, BOX) if swap_b else (BOX, SW)
                        bt = read_b(smem, desc(sb + ks * 16 * ROW, lbo, sbo,
                                               swizzle), bn)
                        for i in range(mt):
                            at = read_a(smem, desc(
                                sa + wg * mt * 64 * ROW + i * 64 * ROW
                                + ks * 32, 16, SW, swizzle))
                            acc[wg, i] = (acc[wg, i].astype(np.float64)
                                          + at.astype(np.float64) @ bt
                                          ).astype(np.float32)
            # the epilogue: registers, bias, ReLU, one rounding into the
            # output tile over the ring, then the masked 16-byte stores
            assert bm * stride_o * 2 <= smem_bytes
            smem[:] = NAN16
            for j in range(bn // 8):
                col = 8 * j + 2 * t
                nok = n0 + col < cout
                bias = np.stack([np.where(nok, b[np.minimum(
                    n0 + col + e, cout - 1)], 0) for e in (0, 1)], -1)
                for wg in range(nc):
                    for i in range(mt):
                        regs = _to_regs(acc[wg, i])
                        for half in (0, 1):
                            e = 4 * j + 2 * half
                            v = regs[:, e:e + 2] + bias.astype(np.float32)
                            if relu:
                                v = np.where(v > 0, v, np.float32(0))
                            r = (wg * mt + i) * 64 + 16 * warp + g + 8 * half
                            vb = _bits(_bf16_round(v))
                            for q in (0, 1):
                                smem[r * stride_o + col + q] = vb[:, q]
            for c in range(bm * (bn // 8)):
                r, j = divmod(c, bn // 8)
                m, n = m0 + r, n0 + 8 * j
                if m < m_all and n < cout:
                    src = r * stride_o + 8 * j
                    y[m * cout + n:m * cout + n + 8] = smem[src:src + 8]
                    writes[m * cout + n:m * cout + n + 8] += 1
    return _vals(y).reshape(bsz, ho, wo, cout), writes


def _inputs(rng, bsz, h, wid, cin, cout, k):
    x = np.maximum(_bf16_round(rng.standard_normal((bsz, h, wid, cin))), 0)
    w = _bf16_round(rng.standard_normal((k, k, cin, cout)) * 0.2)
    b = _bf16_round(rng.standard_normal(cout) * 0.1)
    return x, w, b


_PALLAS = {}


def _pallas(x, w, b, stride, pad, relu, key):
    """The Pallas ``_forward`` in interpret mode on x zero-padded by numpy,
    once per case."""
    if key not in _PALLAS:
        xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        _PALLAS[key] = np.asarray(pallas_conv_forward(
            *(jnp.asarray(a).astype(jnp.bfloat16) for a in (xp, w, b)),
            stride, relu, interpret=True), np.float32)
    return _PALLAS[key]


def _plain(x, w, b, stride, pad, relu):
    return conv2d(*(torch.from_numpy(a).to(BF16) for a in (x, w, b)), stride,
                  relu, pad).float().numpy()


def _check(y, writes, x, w, b, stride, pad, relu, key):
    """Every output written once, no NaN read, within 1 bf16 ulp of the
    plain bf16 conv and of the Pallas kernel in interpret mode."""
    assert (writes == 1).all()
    assert not np.isnan(y).any()
    for ref in (_plain(x, w, b, stride, pad, relu),
                _pallas(x, w, b, stride, pad, relu, key)):
        ulps = np.abs(_ordered(y) - _ordered(ref))
        assert ulps.max() <= 1, f"{(ulps > 0).sum()} differ, max {ulps.max()}"


def _tile(t) -> int:
    return TMA_TILES.index(t)


# (B, H, W, Cin, Cout, k, stride, pad, relu, tile): a padded 3x3 at stride
# 1 (M 162: a tile runs across an image into the next and past M) and 2,
# 1x1s at stride 1 (one or two slices: the short ring) and 2, AlexNet conv4's
# geometry (13 x 13 x 64 -> 128, VALID, stride 2), M 330 off BM 256's
# multiple, Cin 128 (two slices a tap), Cout 200 (a part column box)
TMA_CASES = {
    "3x3_s1_p1": (2, 9, 9, 64, 64, 3, 1, 1, True, _tile(TMA_MANY)),
    "3x3_s2_p1": (2, 9, 11, 64, 128, 3, 2, 1, False, _tile(TMA_NARROW)),
    "1x1_s1": (2, 8, 8, 64, 128, 1, 1, 0, True, _tile(TMA_WIDE)),
    "1x1_short": (2, 8, 8, 64, 128, 1, 1, 0, False, _tile(TMA_SHORT)),
    "1x1_cin128_short": (1, 9, 9, 128, 128, 1, 1, 0, True, _tile(TMA_SHORT)),
    "1x1_s2": (3, 9, 9, 64, 128, 1, 2, 0, False, _tile(TMA_FEW)),
    "conv4": (2, 13, 13, 64, 128, 3, 2, 0, True, _tile(TMA_FEW)),
    "m_ragged_bm256": (3, 10, 11, 64, 64, 3, 1, 1, True,
                       _tile((64, 256, 4, 2))),
    "cin128": (1, 8, 8, 128, 128, 3, 1, 1, False, _tile(TMA_NARROW)),
    "cout200": (1, 7, 7, 64, 200, 3, 1, 1, True, _tile(TMA_WIDE)),
}


@pytest.mark.parametrize("case", list(TMA_CASES))
def test_tma_walk_matches_the_plain_conv_and_pallas(rng, case):
    bsz, h, wid, cin, cout, k, stride, pad, relu, tile = TMA_CASES[case]
    x, w, b = _inputs(rng, bsz, h, wid, cin, cout, k)
    y, writes = emulate_tma(x, w, b, stride, pad, relu, tile)
    _check(y, writes, x, w, b, stride, pad, relu, case)


@pytest.mark.parametrize("tile", range(len(TMA_TILES)))
def test_tma_walk_at_every_tile(rng, tile):
    """Every tile of the switch on one shape: a padded 3x3 at stride 1, M
    98 (a part tile), Cout 128 (two BN 64 blocks or one BN 128)."""
    x, w, b = _inputs(rng, 2, 7, 7, 64, 128, 3)
    y, writes = emulate_tma(x, w, b, 1, 1, True, tile)
    _check(y, writes, x, w, b, 1, 1, True, "every_tile")


def test_tma_emulation_sees_a_wrong_layout(rng):
    """The descriptors' layout matters: B's leading and stride byte offsets
    exchanged (BN 128 spans two 64-column boxes), or the B128 layout type
    left out, read the wrong bytes (or bytes past the ring) and the output
    no longer matches."""
    x, w, b = _inputs(rng, 1, 6, 6, 64, 128, 3)
    ref = _plain(x, w, b, 1, 1, False)
    for kw in ({"swap_b": True}, {"swizzle": False}):
        try:
            y, _ = emulate_tma(x, w, b, 1, 1, False, _tile(TMA_NARROW), **kw)
        except AssertionError:      # a read past the shared memory
            continue
        assert np.isnan(y).any() or \
            np.abs(_ordered(y) - _ordered(ref)).max() > 1, kw


def test_im2col_walk_of_a_padded_stride_two_conv():
    """The box walk on its own: the pixels an im2col copy visits are tap
    (dx, dy) of consecutive output pixels, across rows and images, zero in
    the padding and past the last image."""
    bsz, h, wid, k, s, p = 2, 5, 6, 3, 2, 1
    ho, wo = conv_out_size(h, k, s, p), conv_out_size(wid, k, s, p)
    x = np.arange(bsz * h * wid * 64, dtype=np.uint16).reshape(
        bsz, h, wid, 64) % 30000 + 1
    mp = im2col_map(x.shape, k, s, p, 32)
    for dx, dy in ((0, 0), (2, 1), (1, 2)):
        rows = tma_im2col(x, mp, (0, -p, -p, 0), (dx, dy))
        for j in range(32):
            n, oy, ox = j // (ho * wo), (j // wo) % ho, j % wo
            iy, ix = oy * s - p + dy, ox * s - p + dx
            inside = n < bsz and 0 <= iy < h and 0 <= ix < wid
            want = x[n, iy, ix] if inside else np.zeros(64, np.uint16)
            assert np.array_equal(rows[j], want), (dx, dy, j)
        assert (rows[bsz * ho * wo:] == 0).all()    # past M


def test_swizzle_permutes_chunks_within_each_row():
    """The 128-byte swizzle moves each 16-byte chunk within its own row,
    by the row's index in its 1024-byte period: a bijection."""
    addr = np.arange(0, 4096, 2)
    sw = sw128(addr)
    assert np.array_equal(np.sort(sw), addr)
    assert np.array_equal(sw // ROW, addr // ROW)
    assert np.array_equal(sw128(np.array([16, 128 + 16, 7 * 128])),
                          [16, 128, 7 * 128 + 7 * 16])


# --- the ring's protocol -----------------------------------------------------

class _MBarrier:
    """An mbarrier: ``count`` arrivals and the expected transaction bytes
    complete a phase; a wait on parity P passes once the phase of parity P
    has completed (at first, the phase before phase 0: parity 1)."""

    def __init__(self, count: int):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _settle(self):
        if self.pending == 0 and self.tx == 0:
            self.phase ^= 1
            self.pending = self.count

    def arrive(self, expect_tx: int = 0):
        self.tx += expect_tx
        self.pending -= 1
        assert self.pending >= 0
        self._settle()

    def complete_tx(self, n: int):
        self.tx -= n
        self._settle()

    def passes(self, parity: int) -> bool:
        return self.phase != parity


def _kernel_parities(src: str) -> tuple:
    """The kernel's wait parities, read from conv.cu, as functions of
    (kt, S)."""
    body = src[src.index("conv2d_bf16_tma_kernel("):]
    prod = re.search(r"mbar_wait\(smem_u32\(&empty\[st\]\), (.+?)\);", body)
    cons = re.search(r"mbar_wait\(smem_u32\(&full\[st\]\), (.+?)\);", body)
    assert prod.group(1) == "((kt / S) & 1) ^ 1"
    assert cons.group(1) == "(kt / S) & 1"
    return (lambda kt, s: ((kt // s) & 1) ^ 1, lambda kt, s: (kt // s) & 1)


@pytest.mark.parametrize("stages,consumers,kt_all",
                         [(3, 2, 18), (4, 1, 9), (4, 2, 1), (6, 1, 9),
                          (4, 2, 2), (3, 1, 36)])
def test_ring_protocol_under_random_interleavings(stages, consumers, kt_all):
    """Producer, copies in flight and each consumer warpgroup (its wgmma
    groups, wait_group 1, one arrive on the empty barrier of the slice
    before) step in random order: a stage is read only once its slice has
    landed, no copy lands on a stage a wgmma still reads, and every walk
    ends."""
    prod_parity, cons_parity = _kernel_parities(CONV_CU.read_text())
    for seed in range(25):
        r = np.random.default_rng(seed)
        full = [_MBarrier(1) for _ in range(stages)]
        empty = [_MBarrier(consumers) for _ in range(stages)]
        holds = [None] * stages          # the slice a stage holds
        readers = [set() for _ in range(stages)]   # wgmma groups reading it
        pkt, copies = 0, []              # copies: (stage, slice) in flight
        ckt = [0] * consumers
        groups = [[] for _ in range(consumers)]    # (stage, slice) pending
        done = [False] * consumers
        for _ in range(100000):
            moves = []
            if pkt < kt_all and empty[pkt % stages].passes(
                    prod_parity(pkt, stages)):
                moves.append("produce")
            if copies:
                moves.append("land")
            for c in range(consumers):
                if groups[c]:
                    moves.append(("retire", c))
                if done[c]:
                    continue
                if ckt[c] == kt_all:
                    moves.append(("finish", c))
                elif full[ckt[c] % stages].passes(
                        cons_parity(ckt[c], stages)):
                    moves.append(("issue", c))
            if not moves:
                break
            mv = moves[r.integers(len(moves))]
            if mv == "produce":
                st = pkt % stages
                assert not readers[st], "a copy overwrites a stage in use"
                full[st].arrive(expect_tx=2)     # A's and B's copies
                holds[st] = None
                copies += [(st, pkt), (st, pkt)]
                pkt += 1
            elif mv == "land":
                st, kt = copies.pop(r.integers(len(copies)))
                assert not readers[st], "a copy lands on a stage in use"
                holds[st] = kt
                full[st].complete_tx(1)
            elif mv[0] == "retire":     # the oldest group completes
                st, kt = groups[mv[1]].pop(0)
                readers[st].discard((mv[1], kt))
            elif mv[0] == "finish":     # wait_group 0
                if not groups[mv[1]]:
                    done[mv[1]] = True
            else:                       # a slice's wgmmas, then wait 1
                c = mv[1]
                kt = ckt[c]
                st = kt % stages
                assert holds[st] == kt and not any(
                    s == st for s, _ in copies), "read before it landed"
                readers[st].add((c, kt))
                groups[c].append((st, kt))
                while len(groups[c]) > 1:        # wgmma_wait<1>
                    ost, okt = groups[c].pop(0)
                    readers[ost].discard((c, okt))
                if kt > 0:
                    empty[(kt - 1) % stages].arrive()
                ckt[c] += 1
        assert all(done) and pkt == kt_all and not copies, (
            f"seed {seed}: the walk stopped: produced {pkt}, consumed {ckt}")


# --- the plan, the tables and the wrapper ------------------------------------

@pytest.mark.parametrize("batch", [1, 8, 64, 256])
def test_plan_sends_cin_64_shapes_to_tma(batch):
    """Every shape of Cin % 64 == 0 with x aligned takes "tma" (the smoke's
    sweep found it faster than "wgmma" at each family shape and at conv4),
    with the tile ``tma_tile_for`` gives; grid and K follow the tile."""
    shapes = [(56, 64, 64, 3, 1, 1), (56, 64, 128, 1, 1, 0),
              (28, 64, 128, 1, 2, 0), (28, 128, 256, 3, 2, 1),
              (14, 512, 512, 3, 1, 1), (13, 64, 128, 3, 2, 0),
              (112, 64, 64, 3, 2, 1)]
    for h, cin, cout, k, s, p in shapes:
        plan = conv_bf16_plan(batch, h, h, cin, cout, k, s, True, None, p)
        ho = conv_out_size(h, k, s, p)
        m = batch * ho * ho
        bn, bm, stages, consumers = TMA_TILES[plan.tile]
        assert plan.variant == "tma" and (plan.bn, plan.bm) == (bn, bm)
        assert plan.grid == (-(-m // bm), -(-cout // bn))
        assert plan.k_pad == k * k * cin
        b128 = -(-m // 128) * -(-cout // 128)
        if k * k * cin // TMA_CIN <= TMA_SHORT_K:      # 1x1, Cin <= 128
            assert TMA_TILES[plan.tile] == (TMA_FEW if cout <= 64
                                            else TMA_SHORT)
        elif cout <= 64 or b128 < H100_SMS // 2:
            assert bn == 64 and (bm == 128) == (
                -(-m // 128) * -(-cout // 64) >= H100_SMS)
        else:
            b256 = -(-m // 256) * -(-cout // 128)
            assert bn == 128 and (bm == 256) == (
                b256 >= 2 * H100_SMS or b256 <= H100_SMS < b128)
        assert ring_bytes(plan.tile, k * k * cin // 64) + SW <= SMEM_MAX
    # the measured picks at the families' and AlexNet's shapes
    if batch == 64:
        pick = {(56, 64, 64, 3, 1, 1): TMA_MANY,       # PipeCNN's trunk
                (56, 64, 128, 1, 1, 0): TMA_SHORT,     # MobileNet's pw_2
                (13, 64, 128, 3, 2, 0): TMA_FEW,       # AlexNet's conv4
                (14, 512, 512, 3, 1, 1): TMA_NARROW,   # VGG11's last
                (28, 128, 256, 3, 2, 1): TMA_WIDE}     # resnet18 block
        for (h, cin, cout, k, s, p), t in pick.items():
            assert TMA_TILES[conv_bf16_plan(64, h, h, cin, cout, k, s, True,
                                            None, p).tile] == t


def test_plan_keeps_other_shapes_off_tma():
    # Cin 16, 32 and 96 (no whole 64-channel slices) stay on wgmma; x off
    # alignment gathers; a stride past the map's 8 stays on wgmma
    for cin in (16, 32, 96):
        assert conv_bf16_plan(8, 28, 28, cin, 64, 3, 1, True, None,
                              1).variant == "wgmma"
    assert conv_bf16_plan(8, 28, 28, 64, 64, 3, 1, False, None,
                          1).variant == "gather"
    assert conv_bf16_plan(2, 40, 40, 64, 64, 3, TMA_STRIDE_MAX + 1,
                          True).variant == "wgmma"
    # named: "wgmma" still plans a Cin-64 shape; "tma" refuses what it
    # cannot take
    assert conv_bf16_plan(64, 56, 56, 64, 64, 3, 1, True, "wgmma",
                          1).variant == "wgmma"
    for args in ((8, 28, 28, 32, 64, 3, 1, True),
                 (8, 28, 28, 64, 64, 3, 1, False),
                 (2, 40, 40, 64, 64, 3, 9, True)):
        with pytest.raises(ValueError):
            conv_bf16_plan(*args, "tma")


def test_tables_match_the_source():
    src = CONV_CU.read_text()
    body = src[src.index('extern "C" int cnn_conv2d_bias_relu_bf16('):]
    assert BF16_VARIANTS.index("tma") == 4
    tiles = re.findall(r"case (\d+): return \(int\)launch_bf16_tma<"
                       r"(\d+), (\d+), (\d+), (\d+)>", body)
    assert [(int(i), tuple(int(v) for v in t)) for i, *t in tiles] == list(
        enumerate(TMA_TILES))
    for name, value in (("kTmaCh", TMA_CIN), ("kTmaPix", PIX),
                        ("kTmaRow", ROW), ("kTmaSw", SW)):
        assert f"constexpr int {name} = {value};" in src, name
    assert "constexpr int kTmaBox = kTmaCh * kTmaRow;" in src
    assert "(variant == 4 && (Cin % kTmaCh != 0 || xa % 16 != 0 || " \
        "ya % 16 != 0 ||\n                        stride > 8" in src
    # the maps, the producer's coordinates and the descriptors, as the
    # emulation builds them
    assert "const int lower[2] = {-p, -p}, upper[2] = {p - (k - 1), " \
        "p - (k - 1)};" in src
    assert "const cuuint32_t xes[4] = {1, (cuuint32_t)s, (cuuint32_t)s, 1};" \
        in src
    assert "const cuuint64_t xdim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, " \
        "(cuuint64_t)H,\n                              (cuuint64_t)B};" in src
    assert "const cuuint32_t box[2] = {kTmaCh, kTmaCh}" in src
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in src
    for line in ("cw[j] = ox * s - p;", "ch[j] = (q % Ho) * s - p;",
                 "cn[j] = q / Ho;",
                 "const int tap = kt / cc, c = (kt - tap * cc) * kTmaCh;",
                 "const int dy = tap / k, dx = tap - dy * k;",
                 "wgmma_desc_sw128(sb + ks * 16 * kTmaRow, kTmaBox, kTmaSw);",
                 "wgmma_desc_sw128(sa + i * 64 * kTmaRow + ks * 32, 16,",
                 "const uint32_t sa = ring + st * kStage + wg * MT * 64 * "
                 "kTmaRow;",
                 "const int r = (wg * MT + i) * 64 + 16 * wp + g + 8 * half;",
                 "return wgmma_desc(saddr, lbo, sbo) | (1ull << 62);",
                 "mbar_init(smem_u32(&empty[i]), NC);"):
        assert line in src, line
    assert TMA_FEW in TMA_TILES and TMA_MANY in TMA_TILES
    assert TMA_NARROW in TMA_TILES and TMA_WIDE in TMA_TILES
    for t in TMA_TILES:
        bn, bm, stages, consumers = t
        assert bm % (64 * consumers) == 0 and bn in (64, 128)
        assert bm * (bn + 8) * 2 <= ring_bytes(TMA_TILES.index(t), stages)
        assert ring_bytes(TMA_TILES.index(t), stages) + SW <= SMEM_MAX


def test_wrapper_counts_the_tma_variant(monkeypatch):
    calls = []
    monkeypatch.setattr(hconv, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hconv, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    reset_launches()
    x = torch.empty((8, 56, 56, 64), dtype=BF16, device="meta")
    w = torch.empty((3, 3, 64, 64), dtype=BF16, device="meta")
    bias = torch.empty((64,), dtype=BF16, device="meta")
    y = conv2d_bias_relu(x, w, bias, 1, True, 1)
    assert y.shape == (8, 56, 56, 64) and y.dtype == BF16
    (name, args), = calls
    assert name == "cnn_conv2d_bias_relu_bf16"
    assert len(args) == len(SIGNATURES[name])
    assert args[-2:] == (4, TMA_TILES.index(TMA_MANY))
    counts = read_counters()
    assert counts["conv2d_bias_relu.launches_bf16_tma"] == 1
    assert counts["conv2d_bias_relu.launches_bf16_padded"] == 1
    assert counts["conv2d_bias_relu.launches_bf16_wgmma"] == 0
    # a named variant launches without counting
    _, plan = hconv.launch_conv_bf16(x, w, bias, 1, False, variant="wgmma",
                                     padding=1)
    assert plan.variant == "wgmma" and calls[-1][1][-2] == 3
    assert read_counters() == counts
    reset_launches()
