"""The bf16 conv's Hopper variants (``csrc/conv.cu``: the "strip" kernel
for conv1 and the "wgmma" kernel for conv2-4), on the CPU, before any card
runs them.

- The plan (``ops/hopper/conv.py:conv_bf16_plan``) for the four AlexNet
  layers at the serving and training batches and off those shapes, and its
  tables against the source's switches and constants.
- A numpy emulation of the strip kernel: the staged input rows (one
  contiguous run of x), the B fragments re-laid out once per block, the A
  fragment words read as 32-bit loads from the staged rows and masked past
  k*Cin, the m16n8k16 MMA as PTX lays out its fragments, the output staged
  in shared memory and copied out in 16-byte chunks.
- A numpy emulation of the wgmma kernel: the ring's stages filled by each
  thread's 16-byte copies at the kernel's offsets, wgmma's shared-memory
  matrix descriptors packed as the kernel packs them and decoded as the
  hardware reads a no-swizzle K-major A and MN-major B, the accumulator's
  lane layout, the split's fixed-order sum through shared memory, the output
  tile and its masked 16-byte stores.

Shared memory is filled with NaN first (and every ring stage again before
its slice lands), so a read of anything no copy wrote shows; outputs start
as NaN and count their writes. Each emulation is held against the plain
bf16 conv and the Pallas ``_forward`` in interpret mode. The wrappers'
per-variant counters are checked on meta tensors.
"""

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
from cnn_tpu_torch.ops.hopper import (conv2d_bias_relu, read_counters,
                                      reset_launches)
from cnn_tpu_torch.ops.hopper._build import SIGNATURES
from cnn_tpu_torch.ops.hopper.conv import (BF16_STRIP_COUT_MAX,
                                           BF16_STRIP_KC, BF16_STRIP_R,
                                           BF16_STRIP_ROWS,
                                           BF16_STRIP_SMEM_MAX,
                                           BF16_STRIP_TILES, BF16_STRIP_WIDE,
                                           BF16_VARIANTS, H100_SMS,
                                           WGMMA_FEW, WGMMA_FEW_LONG_K,
                                           WGMMA_LONG_K, WGMMA_MANY,
                                           WGMMA_TILES, conv_bf16_plan,
                                           strip_bf16_smem_bytes,
                                           strip_bf16_takes,
                                           strip_bf16_wide_row)

BF16 = torch.bfloat16
CONV_CU = (Path(__file__).resolve().parents[1] / "cnn_tpu_torch" / "csrc"
           / "conv.cu")
NAN16 = np.uint16(0x7FC0)   # a bf16 quiet NaN
# the bf16 conv's bar against the plain conv where a sum may cancel: 1 bf16
# ulp + 1e-5 x S (PERF.md section 2, the card's bar)
BF16_SREL = 1e-5

# (H, Cin, Cout) of the BN AlexNet's convs at 224 px, all 3x3 stride 2
ALEXNET = {"conv1": (224, 3, 16), "conv2": (55, 16, 32),
           "conv3": (27, 32, 64), "conv4": (13, 64, 128)}


# wgmma's shared-memory matrix layout in the kernel, no swizzle (conv.cu's
# kWg* constants, which test_tables_match_the_source reads): core matrices
# of 8 rows x 16 bytes; A K-major, B MN-major
WGMMA_CORE = 128
WGMMA_A_LBO = WGMMA_CORE                   # A: K-adjacent core matrices
WGMMA_B_SBO = WGMMA_CORE                   # B: N-adjacent core matrices
SMEM_MAX = 227 * 1024                      # a block's shared memory, H100


def wgmma_a_sbo(bk: int) -> int:
    """A's stride byte offset: 8-row groups, BK / 8 core matrices apart."""
    return WGMMA_CORE * bk // 8


def wgmma_b_lbo(bn: int) -> int:
    """B's leading byte offset: K-adjacent core matrices, BN * 16 bytes."""
    return bn * 16


def wgmma_stage_bytes(bn: int, mt: int, bk: int) -> int:
    """One ring stage of one warpgroup: a BM x BK slice of A, BK x BN of B."""
    return 2 * bk * (64 * mt + bn)


def wgmma_smem_bytes(tile: int) -> int:
    bn, mt, bk, stages, split, _ = WGMMA_TILES[tile]
    return split * stages * wgmma_stage_bytes(bn, mt, bk)


def wgmma_desc(addr: int, lbo: int, sbo: int) -> int:
    """A wgmma shared-memory matrix descriptor, no swizzle, as conv.cu's
    ``wgmma_desc`` packs it: bits 0-13 the start address, 16-29 the
    leading byte offset, 32-45 the stride byte offset, each in 16-byte
    units; base offset and layout type (bits 49-51, 62-63) 0."""
    for v in (addr, lbo, sbo):
        if v % 16 or v >> 18:
            raise ValueError(f"wgmma_desc: {v} is not a 16-byte multiple "
                             "below 256 KB")
    return (addr >> 4) | (lbo >> 4) << 16 | (sbo >> 4) << 32


def _m(b, h, w, k, s):
    return b * conv_out_size(h, k, s) * conv_out_size(w, k, s)


# --- the plan --------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 8, 64, 256])
@pytest.mark.parametrize("layer", list(ALEXNET))
def test_plan_sends_the_alexnet_layers_to_the_hopper_variants(layer, batch):
    h, cin, cout = ALEXNET[layer]
    plan = conv_bf16_plan(batch, h, h, cin, cout, 3, 2, True)
    ho = conv_out_size(h, 3, 2)
    if layer == "conv1":
        assert plan.variant == "strip"
        rows, wide = BF16_STRIP_TILES[plan.tile]
        assert rows == BF16_STRIP_R == 4 and not wide   # the natural rows
        assert plan.grid == (-(-ho // rows), batch)
        assert plan.k_pad == 48                 # 3 kernel rows x 16
        return
    m = _m(batch, h, h, 3, 2)
    if layer == "conv4":
        # Cin 64: the tma kernel, BN 64 in two column blocks where BN 128
        # would leave most SMs idle; its wgmma plan stays reachable by name
        assert plan.variant == "tma" and plan.k_pad == 576
        want = hconv.TMA_NARROW if batch == 256 else hconv.TMA_FEW
        assert hconv.TMA_TILES[plan.tile] == want
        assert plan.grid == (-(-m // want[1]), -(-cout // want[0]))
        plan = conv_bf16_plan(batch, h, h, cin, cout, 3, 2, True, "wgmma")
    assert plan.variant == "wgmma"
    bn, mt, bk, stages, split, a_l1 = WGMMA_TILES[plan.tile]
    assert plan.grid == (-(-m // (64 * mt)), -(-cout // bn))
    assert plan.k_pad == -(-9 * cin // bk) * bk
    assert wgmma_smem_bytes(plan.tile) <= SMEM_MAX
    assert a_l1 == (cin == 16)
    many = -(-m // 128) >= H100_SMS // 2
    if many:    # BM 128 and BN Cout: conv2-4 at 256, conv2-3 at 64
        assert (bn, mt) == (cout, 2)
    else:       # BM 64; BN 128 halved into two column blocks
        assert (bn, mt) == (min(cout, 64), 1)
        # conv4's 18 slices are split between two warpgroups; conv2-3 keep
        # one warpgroup
        assert split == (2 if layer == "conv4" else 1)
    want = {(256, "conv2"): (32, 2, 32, 6, 1, 1),
            (256, "conv3"): (64, 2, 32, 4, 1, 0),
            (256, "conv4"): (128, 2, 32, 4, 1, 0),
            (64, "conv4"): (64, 1, 32, 4, 2, 0),
            (8, "conv4"): (64, 1, 32, 4, 2, 0)}.get((batch, layer))
    if want:
        assert WGMMA_TILES[plan.tile] == want


def test_plan_off_the_alexnet_shapes():
    # the mma.sync kernel's gather takes what neither Hopper variant takes
    for args in ((2, 9, 9, 3, 16, 3, 2, True),     # W*Cin 27: no 16-byte rows
                 (2, 9, 9, 12, 16, 3, 2, True),    # Cin 12: k*Cin 36, Cin % 8
                 (2, 8, 8, 4, 16, 5, 1, True),     # k 5 x Cin 4 = 20 > 16
                 (2, 27, 27, 16, 32, 3, 2, False),   # x off alignment
                 (2, 16, 16, 3, 72, 3, 2, True),   # Cout 72 > 64, Cin 3
                 # s*Cin 3 is odd, W 12 no whole groups of 8 pixels
                 (2, 16, 12, 3, 16, 3, 1, True)):
        assert conv_bf16_plan(*args).variant == "gather", args
    # the strip's edges: Cin 1-4 with k*Cin <= 16 and even s*Cin
    assert conv_bf16_plan(1, 11, 24, 1, 16, 5, 2, True).variant == "strip"
    assert conv_bf16_plan(1, 8, 12, 2, 16, 3, 1, True).variant == "strip"
    assert conv_bf16_plan(1, 7, 10, 4, 32, 3, 1, True).variant == "strip"
    # R falls to what fits: rows of 1,024 px overflow 96 KB at R 4
    p = conv_bf16_plan(1, 40, 1024, 2, 16, 3, 2, True)
    rows = BF16_STRIP_TILES[p.tile][0]
    assert rows < BF16_STRIP_R and strip_bf16_smem_bytes(
        rows, 1024, 2, 16, 3, 2) <= BF16_STRIP_SMEM_MAX
    # wgmma: Cout 8 in a BN 16 block, Cout 200 in four BN 64 blocks
    p = conv_bf16_plan(2, 9, 9, 16, 8, 3, 2, True)
    assert (p.variant, p.bn, p.grid[1]) == ("wgmma", 16, 1)
    p = conv_bf16_plan(2, 9, 9, 16, 200, 3, 2, True)
    assert (p.variant, p.bn, p.grid[1]) == ("wgmma", 64, 4)
    # a named variant is planned for this shape, or refused
    assert conv_bf16_plan(256, 55, 55, 16, 32, 3, 2, True,
                          "vec").variant == "vec"
    assert conv_bf16_plan(256, 224, 224, 3, 16, 3, 2, True,
                          "gather").variant == "gather"
    for variant, args in (("strip", (2, 9, 9, 16, 32, 3, 2, True)),
                          ("wgmma", (2, 9, 9, 3, 16, 3, 2, True)),
                          ("vec", (2, 9, 9, 16, 32, 3, 2, False)),
                          ("tiled", (2, 9, 9, 16, 32, 3, 2, True))):
        with pytest.raises(ValueError):
            conv_bf16_plan(*args, variant)


def test_tables_match_the_source():
    src = CONV_CU.read_text()
    # the entry point's variant order
    body = src[src.index('extern "C" int cnn_conv2d_bias_relu_bf16('):]
    assert BF16_VARIANTS == ("gather", "vec", "strip", "wgmma", "tma")
    assert "(0 gather, 1\n// vec, 2 strip, 3 wgmma, 4 tma)" in src
    assert re.findall(r"case (\d): return \(int\)launch_bf16_tile<(\w+)>",
                      body) == [("0", "false"), ("1", "true")]
    strips = re.findall(r"case (\d+): return \(int\)launch_bf16_strip<"
                        r"(\d+), (true|false)>", body)
    assert [(int(i), int(r), v == "true") for i, r, v in strips] == [
        (i, *t) for i, t in enumerate(BF16_STRIP_TILES)]
    assert BF16_STRIP_TILES == tuple(
        (r, v) for v in (False, True) for r in BF16_STRIP_ROWS)
    # the widened layout's rows and the strip's shared memory, as the
    # plan's strip_bf16_wide_row / strip_bf16_smem_bytes compute them
    for line in ("constexpr int kStripBfWide = 4;",
                 "return (p + 1) / 2 * 2; }",
                 "return (strip_bf16_lead(p) + W + p + 1) / 2 * 2;",
                 "return wide ? nin * strip_bf16_wide_row(W, p) * "
                 "kStripBfWide * 2\n              : nin * W * Cin * 2 + 16;",
                 "(wide ? rows * 16 * (Cout + 8) * 2 : "
                 "rows * Wo * Cout * 2);",
                 "return wide ? Cin == 3 && k * kStripBfWide <= kStripBfKc "
                 "&& W % 8 == 0",
                 # the n8 tiles a lane holds: the fewest of 2, 4, 8
                 "if (Cout <= 16)\n    return launch_bf16_strip_nt<R, kWide, "
                 "2>",
                 "if (Cout <= 32)\n    return launch_bf16_strip_nt<R, kWide, "
                 "4>",
                 "return launch_bf16_strip_nt<R, kWide, kStripBfNtMax>("):
        assert line in src, line
    assert BF16_STRIP_WIDE == 4 and BF16_STRIP_COUT_MAX == 64
    for w, p, want in ((224, 1, 228), (224, 0, 224), (16, 2, 20),
                       (8, 3, 16)):
        assert strip_bf16_wide_row(w, p) == want
    tiles = re.findall(r"case (\d+): return \(int\)launch_bf16_wgmma<"
                       r"(\d+), (\d+), (\d+), (\d+), (\d+), (true|false)>",
                       body)
    assert [(int(i), tuple(int(v) for v in t[:5]) + (int(t[5] == "true"),))
            for i, *t in tiles] == list(enumerate(WGMMA_TILES))
    # the plan's tables name tiles of the switch, one per BN it can pick
    # (few blocks halve BN 128)
    for table in (WGMMA_MANY, WGMMA_FEW, WGMMA_FEW_LONG_K):
        assert all(t in WGMMA_TILES and t[0] == bn for bn, t in table.items())
    assert sorted(WGMMA_MANY) == [16, 32, 64, 128]
    assert sorted(WGMMA_FEW) == sorted(WGMMA_FEW_LONG_K) == [16, 32, 64]
    # the packer's fields, as the kernel's wgmma_desc shifts them
    assert ("return (uint64_t)((saddr >> 4) & 0x3FFF) |\n"
            "         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |\n"
            "         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);") in src
    assert WGMMA_LONG_K == 16
    # the strip's limits and the wgmma layout constants
    for name, value in (("kStripBfNtMax", BF16_STRIP_COUT_MAX // 8),
                        ("kStripBfKc", BF16_STRIP_KC),
                        ("kWgThreads", 128), ("kWgCore", WGMMA_CORE)):
        assert f"constexpr int {name} = {value};" in src, name
    assert f"constexpr int kStripBfSmemMax = {BF16_STRIP_SMEM_MAX // 1024} " \
        "* 1024;" in src
    assert "constexpr int kWgALbo = kWgCore;" in src and WGMMA_A_LBO == 128
    assert "constexpr int kWgBSbo = kWgCore;" in src and WGMMA_B_SBO == 128
    assert "constexpr int kASbo = kWgCore * kCpr;" in src
    assert wgmma_a_sbo(32) == 512 and wgmma_b_lbo(64) == 1024
    assert "wgmma_desc(sb + ks * 2 * BN * 16, BN * 16, kWgBSbo)" in src
    assert ("wgmma_desc(sa + i * 8 * kASbo + ks * 2 * kWgALbo,\n"
            "                                kWgALbo, kASbo)") in src
    # transpose A 0 (K-major), transpose B 1 (MN-major), for every N
    assert src.count("p, 1, 1, 0, 1;") == 4
    # the ring fits, with the epilogue's buffers inside it
    for t in WGMMA_TILES:
        bn, mt, bk, stages, split, _ = t
        ring = split * stages * wgmma_stage_bytes(bn, mt, bk)
        red = mt * bn // 2 * 128 * 4 if split > 1 else 0
        assert red + 64 * mt * (bn + 8) * 2 <= ring <= SMEM_MAX, t


def test_wgmma_desc_packs_the_fields():
    d = wgmma_desc(0x1230, 128, 512)
    assert d & 0x3FFF == 0x123
    assert (d >> 16) & 0x3FFF == 8 and (d >> 32) & 0x3FFF == 32
    assert d >> 46 == 0                   # base offset 0, no swizzle
    for bad in ((8, 128, 512), (0, 100, 512), (1 << 18, 128, 512)):
        with pytest.raises(ValueError):
            wgmma_desc(*bad)


# --- helpers of both emulations --------------------------------------------------

def _bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 value (ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        BF16).float().numpy()


def _bits(a: np.ndarray) -> np.ndarray:
    """bf16 values held as float32 -> their 16-bit patterns."""
    return (np.ascontiguousarray(a, np.float32).view(np.uint32)
            >> 16).astype(np.uint16)


def _vals(bits: np.ndarray) -> np.ndarray:
    """16-bit patterns -> the bf16 values, as float32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _round_bits(v: np.ndarray) -> np.ndarray:
    return _bits(_bf16_round(v))


def _ordered(a: np.ndarray) -> np.ndarray:
    """bf16 values (as float32) on an ordered integer line of bf16 ulps."""
    bits = (a.astype(np.float32).view(np.int32) >> 16).astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _mma16816(c, a_regs, b_regs):
    """m16n8k16 on the lanes' registers as PTX lays them out (A rows g,
    g+8 and columns 2t, 2t+1, 2t+8, 2t+9; B rows 2t, 2t+1, 2t+8, 2t+9 of
    column g; C rows g, g+8, columns 2t, 2t+1): each bf16 product exact, a
    step's float32 sum taken in float64 and rounded once."""
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    a = np.full((16, 16), np.nan)
    for reg, (dr, dc) in zip(a_regs, ((0, 0), (8, 0), (0, 8), (8, 8))):
        for e in (0, 1):
            a[g + dr, 2 * t + dc + e] = reg[:, e]
    bt = np.full((16, 8), np.nan)
    for reg, dk in zip(b_regs, (0, 8)):
        for e in (0, 1):
            bt[2 * t + dk + e, g] = reg[:, e]
    d = a @ bt
    out = c.astype(np.float64)
    out[:, 0] += d[g, 2 * t]
    out[:, 1] += d[g, 2 * t + 1]
    out[:, 2] += d[g + 8, 2 * t]
    out[:, 3] += d[g + 8, 2 * t + 1]
    return out.astype(np.float32)


def _inputs(rng, bsz, h, wid, cin, cout, k):
    x = _bf16_round(rng.standard_normal((bsz, h, wid, cin)))
    if cin > 3:
        x = np.maximum(x, 0)
    w = _bf16_round(rng.standard_normal((k, k, cin, cout)) * 0.2)
    b = _bf16_round(rng.standard_normal(cout) * 0.1)
    return x, w, b


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each bf16 value (as float32); 0 at 0."""
    m, e = np.frexp(np.abs(a).astype(np.float64))
    return np.where(a == 0, 0.0, np.ldexp(1.0, e - 8))


def _within(y, ref, x, w, b, stride, padding, srel):
    """y within 1 bf16 ulp of ref, or (``srel``) within 1 bf16 ulp + srel x
    S, S the same conv of |x|, |w| and |b|: the float32 reassociation bound
    where a sum cancels towards 0 and an ulp shrinks with it."""
    if not srel:
        ulps = np.abs(_ordered(y) - _ordered(ref))
        assert ulps.max() <= 1, f"{(ulps > 0).sum()} differ, max {ulps.max()}"
        return
    s_abs = conv2d(*(torch.from_numpy(np.abs(a)) for a in (x, w, b)),
                   stride, False, padding).numpy()
    bar = _bf16_ulp(ref) + srel * s_abs
    dev = np.abs(y.astype(np.float64) - ref)
    assert (dev <= bar).all(), f"max {(dev / bar).max():.3g} x the bar"


def _check(y, writes, x, w, b, stride, relu, padding=0, pallas=True,
           srel=0.0):
    """Every output written once, no NaN read, within 1 bf16 ulp (``srel``:
    + srel x S) of the plain bf16 conv and (k 3, ``pallas``) of the Pallas
    kernel in interpret mode on the zero-padded x."""
    assert (writes == 1).all()
    assert not np.isnan(y).any()
    ref = conv2d(*(torch.from_numpy(a).to(BF16) for a in (x, w, b)), stride,
                 relu, padding).float().numpy()
    _within(y, ref, x, w, b, stride, padding, srel)
    if w.shape[0] == 3 and pallas:
        xp = np.pad(x, ((0, 0), (padding, padding), (padding, padding),
                        (0, 0)))
        want = pallas_conv_forward(
            *(jnp.asarray(a).astype(jnp.bfloat16) for a in (xp, w, b)),
            stride, relu, interpret=True)
        _within(y, np.asarray(want, np.float32), x, w, b, stride, padding,
                srel)


# --- the strip kernel --------------------------------------------------------------

def _stage_wide(smem, xb, bi, h, wid, oy0, nin, stride, padding, sx0,
                rowlen, lead):
    """The widened staging as the kernel does it: per (row, group of 8
    pixels) three 16-byte loads of x (24 bf16, as twelve 32-bit words) and
    four 16-byte stores of 8-byte pixels built by the kernel's shifts; a
    row outside the image stored as zeros; then the margins, pairs of zero
    pixels. Every address 16-byte aligned, every staged element written
    once."""
    ng, rp = wid // 8, rowlen // BF16_STRIP_WIDE
    written = np.zeros(smem.size, np.int32)
    for i in range(nin * ng):
        r, q = divmod(i, ng)
        iy = oy0 * stride - padding + r
        v = np.zeros(12, np.uint32)
        if 0 <= iy < h:
            src = ((bi * h + iy) * wid + 8 * q) * 3
            assert src % 8 == 0                       # 16-byte loads
            e = xb[src:src + 24].astype(np.uint32)
            v = e[0::2] | (e[1::2] << 16)
        o = np.zeros(16, np.uint32)
        for j in range(8):
            e3 = 3 * j
            if j % 2 == 0:
                o[2 * j] = v[e3 // 2]
                o[2 * j + 1] = v[e3 // 2 + 1] & 0xFFFF
            else:
                o[2 * j] = (v[e3 // 2] >> 16) | ((v[e3 // 2 + 1] << 16)
                                                 & 0xFFFFFFFF)
                o[2 * j + 1] = v[e3 // 2 + 1] >> 16
        dst = sx0 + (r * rp + lead + 8 * q) * BF16_STRIP_WIDE
        assert dst % 8 == 0                           # 16-byte stores
        halves = np.stack([o & 0xFFFF, o >> 16], -1).reshape(-1)
        smem[dst:dst + 32] = halves.astype(np.uint16)
        written[dst:dst + 32] += 1
    mp = (rp - wid) // 2
    for i in range(nin * mp):
        r, c = divmod(i, mp)
        c *= 2
        px = c if c < lead else wid + c
        dst = sx0 + (r * rp + px) * BF16_STRIP_WIDE
        assert dst % 8 == 0
        smem[dst:dst + 8] = 0
        written[dst:dst + 8] += 1
    staged = written[sx0:sx0 + nin * rowlen]
    assert (staged == 1).all() and written.sum() == staged.sum()


def emulate_strip(x, w, b, stride, relu, rows_per_block, padding=0,
                  wide=False):
    """``conv2d_bf16_strip_kernel<R, wide>`` on bf16 values held as
    float32."""
    bsz, h, wid, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    ho = conv_out_size(h, k, stride, padding)
    wo = conv_out_size(wid, k, stride, padding)
    assert strip_bf16_takes(wid, cin, cout, k, stride, padding, wide)
    cs = BF16_STRIP_WIDE if wide else cin      # elements of a staged pixel
    kc, nt, R = k * cs, cout // 8, rows_per_block
    lead = -(-padding // 2) * 2
    rowlen = (strip_bf16_wide_row(wid, padding) * BF16_STRIP_WIDE if wide
              else wid * cin)
    shift = (lead - padding) * BF16_STRIP_WIDE if wide else 0
    xb, wb = _bits(x).reshape(-1), _bits(w).reshape(-1)
    y = np.full(bsz * ho * wo * cout, NAN16, np.uint16)
    writes = np.zeros(y.size, np.int32)
    ra = min(R, ho)
    frag = k * nt * 32 * 8                                 # bytes
    xbytes = ((ra - 1) * stride + k) * rowlen * 2 + (0 if wide else 16)
    ys = cout + 8 if wide else cout          # a staged output pixel
    smem_bytes = frag + xbytes + (ra * 16 * ys * 2 if wide
                                  else ra * wo * cout * 2)
    assert smem_bytes == strip_bf16_smem_bytes(ra, wid, cin, cout, k, stride,
                                               padding, wide)
    sx0, sy0 = frag // 2, (frag + xbytes) // 2              # in bf16
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    mlo = ((2 * t < kc), (2 * t + 1 < kc))                  # A word halves
    mhi = ((2 * t + 8 < kc), (2 * t + 9 < kc))
    for bi in range(bsz):
        for strip in range(-(-ho // R)):
            smem = np.full(smem_bytes // 2, NAN16, np.uint16)
            oy0 = strip * R
            rows = min(R, ho - oy0)
            nin = (rows - 1) * stride + k
            if wide:
                _stage_wide(smem, xb, bi, h, wid, oy0, nin, stride, padding,
                            sx0, rowlen, lead)
                x_end = sx0 + nin * rowlen       # reads stay in the rows
            else:
                # the staged rows: one contiguous run of x
                n = nin * rowlen
                assert n % 8 == 0
                src = (bi * h + oy0 * stride) * rowlen
                smem[sx0:sx0 + n] = xb[src:src + n]
                x_end = sy0                      # and the 16-byte padding
            # the B fragments: [dy][j][lane] as (b0, b1), each a 32-bit
            # word whose low half holds the lower k row; widened, column c
            # is tap c // 4, channel c % 4 (zero for channel 3)
            for i in range(k * nt * 32):
                l_, dj = i & 31, i >> 5
                dy, j = dj // nt, dj % nt
                col, c0 = 8 * j + (l_ >> 2), 2 * (l_ & 3)
                for hh in range(2):
                    for e in range(2):
                        c = c0 + 8 * hh + e
                        if wide:
                            dx, ci = divmod(c, BF16_STRIP_WIDE)
                            ok, row = dx < k and ci < cin, (dy * k + dx) * cin + ci
                        else:
                            ok, row = c < kc, dy * kc + c
                        smem[4 * i + 2 * hh + e] = (
                            wb[row * cout + col] if ok else 0)
            for warp in range(rows):
                ps = stride * cs
                yr = sy0 + (warp * 16 * ys if wide else warp * wo * cout)
                for ox0 in range(0, wo, 16):
                    pa, pb = ox0 + g, ox0 + g + 8
                    va, vb = pa < wo, pb < wo
                    acc = np.zeros((nt, 32, 4), np.float32)
                    if wide:     # a chunk's staging holds nothing stale
                        smem[yr:yr + 16 * ys] = NAN16
                    for dy in range(k):
                        row = sx0 + (warp * stride + dy) * rowlen + shift

                        def word(p, valid, mask, off):
                            """The 32-bit loads of bf16 elements e, e+1
                            where the kernel loads, masked per half."""
                            out = np.zeros((32, 2), np.float32)
                            load = valid & (mask[0] | mask[1])
                            e = row + p * ps + 2 * t + off
                            assert (e[load] % 2 == 0).all()
                            assert (e[load] >= sx0).all()
                            assert (e[load] + 1 < x_end).all()
                            for hf in range(2):
                                sel = load & mask[hf]
                                out[sel, hf] = _vals(smem[e[sel] + hf])
                            return out

                        a = [word(pa, va, mlo, 0), word(pb, vb, mlo, 0),
                             word(pa, va, mhi, 8), word(pb, vb, mhi, 8)]
                        for j in range(nt):
                            i0 = (dy * nt + j) * 32 + lanes
                            bw = [np.stack([_vals(smem[4 * i0 + 2 * hh]),
                                            _vals(smem[4 * i0 + 2 * hh + 1])],
                                           -1) for hh in range(2)]
                            acc[j] = _mma16816(acc[j], a, bw)
                    p0 = ox0 if wide else 0
                    for j in range(nt):
                        for half, (p, valid) in enumerate(((pa, va),
                                                           (pb, vb))):
                            col = 8 * j + 2 * t
                            v = acc[j][:, 2 * half:2 * half + 2] + np.stack(
                                [b[col], b[col + 1]], -1)
                            if relu:
                                v = np.where(v > 0, v, np.float32(0))
                            vb16 = _round_bits(v)
                            for ln in np.nonzero(valid)[0]:
                                e = yr + (p[ln] - p0) * ys + col[ln]
                                smem[e:e + 2] = vb16[ln]
                    if wide:
                        # this warp's pixels: one contiguous run of y in
                        # 16-byte chunks
                        cpp, nv = cout // 8, min(16, wo - ox0)
                        dst = ((bi * ho + oy0 + warp) * wo + ox0) * cout
                        assert dst % 8 == 0
                        for i in range(nv * cpp):
                            px, c = divmod(i, cpp)
                            src = yr + px * ys + 8 * c
                            assert src % 8 == 0
                            y[dst + 8 * i:dst + 8 * i + 8] = smem[src:src + 8]
                            writes[dst + 8 * i:dst + 8 * i + 8] += 1
            if not wide:
                # the copy out: 16-byte chunks of one contiguous run of y
                n_out = rows * wo * cout
                assert n_out % 8 == 0
                dst = (bi * ho + oy0) * wo * cout
                y[dst:dst + n_out] = smem[sy0:sy0 + n_out]
                writes[dst:dst + n_out] += 1
    return _vals(y).reshape(bsz, ho, wo, cout), writes


# (B, H, W, Cin, Cout, stride, k): conv1 at a small extent, a ragged last
# strip and two m16 tiles a row, Cout 8 / 24 / 32 (1, 3, 4 n8 tiles), k*Cin
# 6 (no second half of the k16 step) and 12, k 5 with Cin 1 (k*Cin 5)
STRIP_CASES = {
    "conv1": (1, 15, 16, 3, 16, 2, 3),
    "ragged_strip_two_tiles": (2, 19, 40, 3, 16, 2, 3),
    "cout8": (1, 9, 16, 3, 8, 2, 3),
    "cout24": (1, 9, 16, 3, 24, 2, 3),
    "cout32_cin4_s1": (1, 7, 10, 4, 32, 1, 3),
    "cin2_s1": (1, 8, 12, 2, 16, 1, 3),
    "cin1_k5": (1, 11, 24, 1, 16, 2, 5),
}


@pytest.mark.parametrize("relu_on", [False, True])
@pytest.mark.parametrize("case", list(STRIP_CASES))
def test_strip_walk_matches_the_plain_conv(rng, case, relu_on):
    bsz, h, wid, cin, cout, stride, k = STRIP_CASES[case]
    x, w, b = _inputs(rng, bsz, h, wid, cin, cout, k)
    plan = conv_bf16_plan(bsz, h, wid, cin, cout, k, stride, True)
    assert plan.variant == "strip"
    rows, wide = BF16_STRIP_TILES[plan.tile]
    assert not wide
    y, writes = emulate_strip(x, w, b, stride, relu_on, rows)
    _check(y, writes, x, w, b, stride, relu_on)


@pytest.mark.parametrize("rows", BF16_STRIP_ROWS)
def test_strip_walk_at_every_r(rng, rows):
    """Every R of the switch, on 9 output rows (a short last strip but for
    R = 1) and an input row of 40 px."""
    x, w, b = _inputs(rng, 1, 19, 40, 3, 16, 3)
    y, writes = emulate_strip(x, w, b, 2, True, rows)
    _check(y, writes, x, w, b, 2, True)


def test_strip_masks_the_columns_past_k_cin(rng):
    """An infinity in x reaches exactly the outputs whose window holds it,
    as in the plain conv: the A word that holds column k*Cin - 1 also holds
    the next pixel's first value, which the mask drops instead of
    multiplying it by a zero weight (inf x 0 = NaN)."""
    x, w, b = _inputs(rng, 1, 9, 16, 3, 16, 3)
    x[0, 2, 6, 0] = np.inf            # column 6 of row 2: pixels 2 and 3
    x[0, 4, 9, 2] = -np.inf
    y, writes = emulate_strip(x, w, b, 2, False, 4)
    ref = conv2d(*(torch.from_numpy(a).to(BF16) for a in (x, w, b)), 2,
                 False).float().numpy()
    assert (writes == 1).all()
    assert np.array_equal(np.isfinite(y), np.isfinite(ref))
    assert not np.isfinite(ref).all()
    assert np.array_equal(y[~np.isfinite(y)], ref[~np.isfinite(ref)])


# the families' padded Cin-3 stems (k 3, p 1) on the widened layout, scaled
# down to 32 px: resnet10 3 -> 16 s2, resnet18 / mobilenet 3 -> 32 s2,
# pipecnn 3 -> 64 s2, vgg8 3 -> 32 s1, vgg11 3 -> 64 s1; then a ragged last
# strip and a chunk of fewer than 16 pixels (Wo 13), padding 2 and 3 (odd:
# a lead margin rounded up), k 2 and 4, AlexNet's unpadded conv1 geometry
# (the sweep's widened tile there), Cout 8 and 40
# (B, H, W, Cin, Cout, stride, k, padding)
WIDE_STEMS = {
    "resnet10": (1, 32, 32, 3, 16, 2, 3, 1),
    "resnet18_mobilenet": (1, 32, 32, 3, 32, 2, 3, 1),
    "pipecnn": (1, 32, 32, 3, 64, 2, 3, 1),
    "vgg8": (1, 32, 32, 3, 32, 1, 3, 1),
    "vgg11": (1, 32, 32, 3, 64, 1, 3, 1),
}
WIDE_WALKS = {
    "ragged": (2, 27, 24, 3, 16, 2, 3, 1),
    "pad2_s1": (1, 9, 16, 3, 8, 1, 3, 2),
    "pad3_s3": (1, 14, 16, 3, 24, 3, 3, 3),
    "k2": (1, 9, 8, 3, 16, 1, 2, 1),
    "k4_pad1": (1, 10, 16, 3, 40, 2, 4, 1),
    "conv1_unpadded": (1, 15, 16, 3, 16, 2, 3, 0),
}


@pytest.mark.parametrize("batch", [1, 8, 64, 256])
@pytest.mark.parametrize("stem", list(WIDE_STEMS))
def test_plan_sends_the_padded_stems_to_the_widened_strip(stem, batch):
    """At 224 px every family's padded Cin-3 stem takes the strip variant,
    widened, at R 4 (its shared memory within 96 KB), K padded to 16 a
    kernel row; unpadded, the same shape at stride 2 keeps the natural
    layout."""
    _, _, _, cin, cout, s, k, p = WIDE_STEMS[stem]
    plan = conv_bf16_plan(batch, 224, 224, cin, cout, k, s, True, None, p)
    ho = conv_out_size(224, k, s, p)
    assert plan.variant == "strip" and plan.k_pad == 48
    assert BF16_STRIP_TILES[plan.tile] == (BF16_STRIP_R, True)
    assert plan.grid == (-(-ho // BF16_STRIP_R), batch)
    assert strip_bf16_smem_bytes(4, 224, cin, cout, k, s, p, True) <= \
        BF16_STRIP_SMEM_MAX
    natural = conv_bf16_plan(batch, 224, 224, cin, cout, k, 2, True)
    assert BF16_STRIP_TILES[natural.tile] == (BF16_STRIP_R, False)


def test_widened_strip_declines_what_it_cannot_take():
    # padded Cin 2 or 4 (no widened layout), W % 8 != 0, k 5 (k*4 > 16),
    # Cout 72, x off alignment: the gather; a named strip raises
    for args in ((2, 16, 16, 2, 16, 3, 2, True), (2, 16, 16, 4, 16, 3, 1, True),
                 (2, 16, 12, 3, 16, 3, 2, True), (2, 16, 16, 3, 16, 5, 1, True),
                 (2, 16, 16, 3, 72, 3, 1, True), (2, 16, 16, 3, 16, 3, 1, False)):
        assert conv_bf16_plan(*args, None, 1).variant == "gather", args
        with pytest.raises(ValueError):
            conv_bf16_plan(*args, "strip", 1)


@pytest.mark.parametrize("rows", BF16_STRIP_ROWS)
@pytest.mark.parametrize("case", [*WIDE_STEMS, *WIDE_WALKS])
def test_widened_strip_walk_matches_the_plain_conv(rng, case, rows):
    """The widened walk at every R: 16-byte loads and stores of the
    staging, the zero margins and rows, even A words inside the staged
    rows, each output written once, within 1 bf16 ulp of the plain bf16
    conv (ReLU on and off)."""
    bsz, h, wid, cin, cout, stride, k, p = {**WIDE_STEMS, **WIDE_WALKS}[case]
    x, w, b = _inputs(rng, bsz, h, wid, cin, cout, k)
    for relu_on in (False, True):
        y, writes = emulate_strip(x, w, b, stride, relu_on, rows, p, True)
        _check(y, writes, x, w, b, stride, relu_on, p, pallas=False,
               srel=BF16_SREL)


def test_widened_strip_walk_vs_cnn_tpu(rng):
    """resnet10's stem geometry (3 -> 16, k3 s2 p1) at 32 px with the plan's
    tile, against cnn_tpu's Pallas ``_forward`` on the zero-padded x
    (interpret mode, bf16) and ``cnn_tpu.ops.conv.conv2d(padding=1)`` on the
    same values in float32: 1 bf16 ulp + 1e-5 x S."""
    bsz, h, wid, cin, cout, stride, k, p = WIDE_STEMS["resnet10"]
    plan = conv_bf16_plan(bsz, h, wid, cin, cout, k, stride, True, None, p)
    rows, wide = BF16_STRIP_TILES[plan.tile]
    assert plan.variant == "strip" and wide
    x, w, b = _inputs(rng, bsz, h, wid, cin, cout, k)
    y, writes = emulate_strip(x, w, b, stride, True, rows, p, True)
    _check(y, writes, x, w, b, stride, True, p, srel=BF16_SREL)
    xla = np.asarray(jops.relu(jops.conv2d(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), stride,
        padding=p)))
    _within(y, xla, x, w, b, stride, p, BF16_SREL)


def test_widened_strip_infinity_reaches_exactly_its_windows(rng):
    """An infinity in x beside the margins (the first and last columns, the
    first and last rows) and inside reaches exactly the outputs whose window
    holds it, as in the plain conv: the zero 4th element and the margins
    meet finite weights, and the masks drop the next pixel's values."""
    x, w, b = _inputs(rng, 1, 12, 16, 3, 16, 3)
    x[0, 0, 0, 0] = np.inf
    x[0, 11, 15, 2] = -np.inf
    x[0, 5, 8, 1] = np.inf
    for stride in (1, 2):
        y, writes = emulate_strip(x, w, b, stride, False, 4, 1, True)
        ref = conv2d(*(torch.from_numpy(a).to(BF16) for a in (x, w, b)),
                     stride, False, 1).float().numpy()
        assert (writes == 1).all()
        assert np.array_equal(np.isfinite(y), np.isfinite(ref))
        assert not np.isfinite(ref).all()
        assert np.array_equal(y[~np.isfinite(y)], ref[~np.isfinite(ref)])


# --- the wgmma kernel --------------------------------------------------------------

def _decode(desc):
    """start address, leading and stride byte offsets of a descriptor."""
    assert desc >> 46 == 0                # no swizzle, base offset 0
    return ((desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4,
            ((desc >> 32) & 0x3FFF) << 4)


def _smem_vals(smem, byte):
    """The bf16 values at these byte offsets; NaN past the allocation."""
    idx = byte // 2
    inside = idx < smem.size
    return np.where(inside, _vals(smem[np.where(inside, idx, 0)]), np.nan)


def _read_a(smem, desc):
    """The 64 x 16 K-major A operand, no swizzle, as wgmma reads it: 8-row
    x 16-byte core matrices, K-adjacent ones LBO apart, 8-row groups SBO
    apart (byte offsets into ``smem``, a bf16 array)."""
    start, lbo, sbo = _decode(desc)
    m, kk = np.arange(64)[:, None], np.arange(16)[None, :]
    byte = start + (m // 8) * sbo + (kk // 8) * lbo + (m % 8) * 16 + \
        (kk % 8) * 2
    return _smem_vals(smem, byte)


def _read_b(smem, desc, n):
    """The 16 x N MN-major B operand (transpose-B), no swizzle: core
    matrices of 8 k rows x 8 n columns (16 bytes a k row), N-adjacent ones
    SBO apart, K-adjacent ones LBO apart."""
    start, lbo, sbo = _decode(desc)
    kk, nn = np.arange(16)[:, None], np.arange(n)[None, :]
    byte = start + (nn // 8) * sbo + (kk // 8) * lbo + (kk % 8) * 16 + \
        (nn % 8) * 2
    return _smem_vals(smem, byte)


def _to_regs(tile):
    """A 64 x N float32 tile -> the accumulator registers [thread, e]:
    warp w, lane 4g + t holds rows 16w + g (e % 4 < 2) and 16w + g + 8,
    columns 8j + 2t + e % 2 (j = e // 4)."""
    n = tile.shape[1]
    th = np.arange(128)
    warp, g, t = th >> 5, (th & 31) >> 2, th & 3
    regs = np.empty((128, n // 2), np.float32)
    for e in range(n // 2):
        j, q = e // 4, e % 4
        regs[:, e] = tile[16 * warp + g + 8 * (q // 2), 8 * j + 2 * t + q % 2]
    return regs


def emulate_wgmma(x, w, b, stride, relu, tile, swap=False):
    """``conv2d_bf16_wgmma_kernel`` with WGMMA_TILES[tile] on bf16 values
    held as float32; ``swap`` exchanges the descriptors' leading and stride
    byte offsets."""
    bsz, h, wid, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    ho, wo = conv_out_size(h, k, stride), conv_out_size(wid, k, stride)
    m_all, kk = bsz * ho * wo, k * k * cin
    bn, mt, bk, stages, split, _ = WGMMA_TILES[tile]
    bm, cpr = 64 * mt, bk // 8
    a_sbo, b_lbo = wgmma_a_sbo(bk), wgmma_b_lbo(bn)
    a_bytes = bm * bk * 2
    stage = wgmma_stage_bytes(bn, mt, bk)
    n_acc = bn // 2
    xb, wb = _bits(x).reshape(-1), _bits(w).reshape(-1)
    y = np.full(m_all * cout, NAN16, np.uint16)
    writes = np.zeros(y.size, np.int32)
    kt_all = -(-kk // bk)
    per = -(-kt_all // split)
    th = np.arange(128)

    def desc(addr, lbo, sbo):
        return wgmma_desc(addr, sbo, lbo) if swap else wgmma_desc(addr, lbo,
                                                                  sbo)

    for bx in range(-(-m_all // bm)):
        for by in range(-(-cout // bn)):
            m0, n0 = bx * bm, by * bn
            smem = np.full(split * stages * stage // 2, NAN16, np.uint16)
            # each thread's A rows: copy i of thread t is chunk t + 128 i
            rowbase = {}
            for i in range(bm * cpr // 128):
                idx = th + 128 * i
                r = 8 * (idx // (8 * cpr)) + (idx & 7)
                m = m0 + r
                ox, q = m % wo, m // wo
                oy, bb = q % ho, q // ho
                rowbase[i] = np.where(
                    m < m_all, ((bb * h + oy * stride) * wid + ox * stride)
                    * cin, -1)
            ca = (th >> 3) % cpr
            accs = []
            for wg in range(split):
                kt0 = wg * per
                nk = max(0, min(kt_all, kt0 + per) - kt0)
                ring = wg * stages * stage
                acc = np.zeros((mt, 64, bn), np.float32)
                for it in range(nk):
                    kt, st = kt0 + it, it % stages
                    sa = ring + st * stage
                    sb = sa + a_bytes
                    smem[sa // 2:(sa + stage) // 2] = NAN16   # stale data out
                    for tt in range(128):
                        kc = kt * bk + 8 * ca[tt]
                        if kc < kk:
                            tap, ci = kc // cin, kc % cin
                            off = ((tap // k) * wid + tap % k) * cin + ci
                        for i in rowbase:
                            base = rowbase[i][tt]
                            dst = (sa + 16 * (tt + 128 * i)) // 2
                            ok = kc < kk and base >= 0
                            smem[dst:dst + 8] = (xb[base + off:base + off + 8]
                                                 if ok else 0)
                    for idx in range(bk * bn // 8):
                        kr = (idx // bn) * 8 + (idx & 7)
                        j = (idx >> 3) % (bn // 8)
                        kg, n = kt * bk + kr, n0 + 8 * j
                        dst = (sb + 16 * idx) // 2
                        smem[dst:dst + 8] = (wb[kg * cout + n:kg * cout + n + 8]
                                             if kg < kk and n < cout else 0)
                    for ks in range(bk // 16):
                        bt = _read_b(smem, desc(sb + ks * 2 * bn * 16, b_lbo,
                                                WGMMA_B_SBO), bn)
                        for i in range(mt):
                            at = _read_a(smem, desc(
                                sa + i * 8 * a_sbo + ks * 2 * WGMMA_A_LBO,
                                WGMMA_A_LBO, a_sbo))
                            acc[i] = (acc[i].astype(np.float64)
                                      + at.astype(np.float64) @ bt).astype(
                                          np.float32)
                accs.append(acc)
            # the epilogue: registers, the split's fixed-order sum through
            # shared memory, bias, ReLU, rounding into the output tile
            smem[:] = NAN16
            regs = [np.stack([_to_regs(a[i]) for i in range(mt)])
                    for a in accs]                  # [mt, thread, e]
            red_f = 0
            if split > 1:
                red = np.full(mt * n_acc * 128, np.nan, np.float32)
                for i in range(mt):
                    for e in range(n_acc):
                        red[(i * n_acc + e) * 128 + th] = regs[1][i, :, e]
                red_f = mt * n_acc * 128 * 4
            so = red_f // 2
            stride_o = bn + 8
            warp, g, t = th >> 5, (th & 31) >> 2, th & 3
            for i in range(mt):
                for j in range(bn // 8):
                    col = 8 * j + 2 * t
                    nok = n0 + col < cout
                    bias = np.stack([np.where(nok, b[np.minimum(
                        n0 + col + e, cout - 1)], 0) for e in (0, 1)], -1)
                    for half in (0, 1):
                        e = 4 * j + 2 * half
                        v = regs[0][i, :, e:e + 2].copy()
                        if split > 1:   # the first half of K, then the second
                            v = v + np.stack(
                                [red[(i * n_acc + e + q) * 128 + th]
                                 for q in (0, 1)], -1)
                        v = v + bias.astype(np.float32)
                        if relu:
                            v = np.where(v > 0, v, np.float32(0))
                        r = 64 * i + 16 * warp + g + 8 * half
                        vb16 = _round_bits(v)
                        for q in (0, 1):
                            smem[so + r * stride_o + col + q] = vb16[:, q]
            for c in range(bm * (bn // 8)):
                r, j = c // (bn // 8), c % (bn // 8)
                m, n = m0 + r, n0 + 8 * j
                if m < m_all and n < cout:
                    src = so + r * stride_o + 8 * j
                    y[m * cout + n:m * cout + n + 8] = smem[src:src + 8]
                    writes[m * cout + n:m * cout + n + 8] += 1
    return _vals(y).reshape(bsz, ho, wo, cout), writes


def _tile(*t):
    return WGMMA_TILES.index(t)


# (B, H, W, Cin, Cout, stride, k, tile): the plan's tile of each layer's
# kind at a small extent (ragged M everywhere), BM 128 and 64, the split
# with one and two m64 tiles, BK 64, Cout 8 in a BN 16 block, Cout 48 and
# 200 (masked columns, four column blocks), k 5 at stride 1
WGMMA_CASES = {
    "conv2_many": (2, 11, 11, 16, 32, 2, 3, _tile(32, 2, 32, 6, 1, 1)),
    "conv2_few": (2, 11, 11, 16, 32, 2, 3, _tile(32, 1, 32, 4, 1, 1)),
    "conv3_many": (1, 11, 9, 32, 64, 2, 3, _tile(64, 2, 32, 4, 1, 0)),
    "conv3_few_deep": (1, 11, 9, 32, 64, 2, 3, _tile(64, 1, 32, 8, 1, 0)),
    "conv4_many": (2, 7, 7, 64, 128, 2, 3, _tile(128, 2, 32, 4, 1, 0)),
    "conv4_split": (2, 7, 7, 64, 128, 2, 3, _tile(64, 1, 32, 4, 2, 0)),
    "conv4_split_bm128": (2, 7, 7, 64, 128, 2, 3, _tile(128, 2, 32, 6, 2, 0)),
    "conv4_bk64": (2, 7, 7, 64, 128, 2, 3, _tile(128, 2, 64, 4, 1, 0)),
    "cout8": (1, 12, 13, 8, 8, 2, 3, _tile(16, 1, 32, 4, 1, 1)),
    "cout48": (1, 9, 9, 16, 48, 2, 3, _tile(64, 1, 32, 8, 1, 0)),
    "cout200": (1, 7, 7, 16, 200, 2, 3, _tile(64, 1, 32, 8, 1, 0)),
    "k5_s1": (1, 8, 8, 8, 16, 1, 5, _tile(16, 1, 32, 4, 1, 1)),
}


@pytest.mark.parametrize("relu_on", [False, True])
@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_wgmma_walk_matches_the_plain_conv(rng, case, relu_on):
    bsz, h, wid, cin, cout, stride, k, tile = WGMMA_CASES[case]
    x, w, b = _inputs(rng, bsz, h, wid, cin, cout, k)
    y, writes = emulate_wgmma(x, w, b, stride, relu_on, tile)
    _check(y, writes, x, w, b, stride, relu_on)


@pytest.mark.parametrize("tile", range(len(WGMMA_TILES)))
def test_wgmma_walk_at_every_tile(rng, tile):
    """Every tile of the switch on one shape: K 288 (9 slices of 32, 5 of
    64), Cout 64 (four BN 16 blocks, or half of a BN 128 one), M 25."""
    x, w, b = _inputs(rng, 1, 11, 11, 32, 64, 3)
    y, writes = emulate_wgmma(x, w, b, 2, True, tile)
    _check(y, writes, x, w, b, 2, True)


def test_wgmma_emulation_sees_swapped_offsets(rng):
    """Exchanging the descriptors' leading and stride byte offsets reads
    the wrong bytes: the emulation's output no longer matches."""
    x, w, b = _inputs(rng, 2, 7, 7, 64, 128, 3)
    tile = _tile(64, 1, 32, 4, 2, 0)
    ref = conv2d(*(torch.from_numpy(a).to(BF16) for a in (x, w, b)), 2,
                 False).float().numpy()
    y, writes = emulate_wgmma(x, w, b, 2, False, tile, swap=True)
    assert (writes == 1).all()
    dev = np.abs(_ordered(y) - _ordered(ref))
    assert np.isnan(y).any() or dev.max() > 1


def test_wgmma_split_sums_in_one_fixed_order(rng):
    """The split's sum is the first warpgroup's half of K plus the second's,
    in that order: the emulation gives the same bits when run twice, and
    its accumulator registers round-trip through the reduction buffer."""
    x, w, b = _inputs(rng, 2, 7, 7, 64, 128, 3)
    tile = _tile(64, 1, 32, 4, 2, 0)
    y1, _ = emulate_wgmma(x, w, b, 2, True, tile)
    y2, _ = emulate_wgmma(x, w, b, 2, True, tile)
    assert np.array_equal(y1.view(np.uint32), y2.view(np.uint32))
    tile_vals = rng.standard_normal((64, 64)).astype(np.float32)
    regs = _to_regs(tile_vals)
    th = np.arange(128)
    back = np.empty((64, 64), np.float32)
    for e in range(32):
        j, q = e // 4, e % 4
        back[16 * (th >> 5) + ((th & 31) >> 2) + 8 * (q // 2),
             8 * j + 2 * (th & 3) + q % 2] = regs[:, e]
    assert np.array_equal(back, tile_vals)


# --- the wrapper's launches and per-variant counters, on meta tensors -----------

def test_wrapper_counts_each_bf16_variant(monkeypatch):
    calls = []
    monkeypatch.setattr(hconv, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hconv, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    reset_launches()

    def run(bsz, h, wid, cin, cout, k=3, stride=2):
        x = torch.empty((bsz, h, wid, cin), dtype=BF16, device="meta")
        w = torch.empty((k, k, cin, cout), dtype=BF16, device="meta")
        bias = torch.empty((cout,), dtype=BF16, device="meta")
        return conv2d_bias_relu(x, w, bias, stride, True)

    for bsz in (1, 64, 256):
        for layer, (h, cin, cout) in ALEXNET.items():
            y = run(bsz, h, h, cin, cout)
            assert y.dtype == BF16 and y.shape[-1] == cout
            (name, args), = calls[-1:]
            assert name == "cnn_conv2d_bias_relu_bf16"
            assert len(args) == len(SIGNATURES[name])
            plan = conv_bf16_plan(bsz, h, h, cin, cout, 3, 2, True)
            assert args[-2:] == (BF16_VARIANTS.index(plan.variant), plan.tile)
            assert args[-2] == {"conv1": 2, "conv4": 4}.get(layer, 3)
    run(2, 9, 9, 12, 16)                 # Cin 12: the gather
    # a padded Cin-3 stem: the widened strip, counted by name too
    x = torch.empty((2, 32, 32, 3), dtype=BF16, device="meta")
    w = torch.empty((3, 3, 3, 64), dtype=BF16, device="meta")
    conv2d_bias_relu(x, w, torch.empty((64,), dtype=BF16, device="meta"), 1,
                     True, 1)
    assert calls[-1][1][-2:] == (2, BF16_STRIP_TILES.index((4, True)))
    assert calls[-1][1][10:12] == (1, 1)
    counts = read_counters()
    assert counts["conv2d_bias_relu.launches"] == 14
    assert counts["conv2d_bias_relu.launches_bf16"] == 14
    assert counts["conv2d_bias_relu.launches_bf16_strip"] == 4
    assert counts["conv2d_bias_relu.launches_bf16_strip_padded"] == 1
    assert counts["conv2d_bias_relu.launches_bf16_padded"] == 1
    assert counts["conv2d_bias_relu.launches_strip_padded"] == 0
    assert counts["conv2d_bias_relu.launches_bf16_wgmma"] == 6
    assert counts["conv2d_bias_relu.launches_bf16_tma"] == 3
    assert counts["conv2d_bias_relu.launches_bf16_gather"] == 1
    assert counts["conv2d_bias_relu.launches_bf16_vec"] == 0
    assert counts["conv2d_bias_relu.launches_tiled"] == 0
    # a named variant launches without counting
    x = torch.empty((2, 27, 27, 16), dtype=BF16, device="meta")
    wt = torch.empty((3, 3, 16, 32), dtype=BF16, device="meta")
    bias = torch.empty((32,), dtype=BF16, device="meta")
    _, plan = hconv.launch_conv_bf16(x, wt, bias, 2, False, variant="vec")
    assert plan.variant == "vec" and calls[-1][1][-2] == 1
    assert read_counters() == counts
    reset_launches()
