"""The bf16 mma.sync conv kernel's plan (``ops/hopper/conv.py:conv_bf16_plan``
with its "gather" or "vec" variant named) and a numpy emulation of its walk,
on the CPU, before any card runs it. The Hopper variants the plan gives the
AlexNet layers are tested in ``tests/test_torch_bf16_conv_hopper.py``.

The emulation repeats ``csrc/conv.cu``'s ``conv2d_bf16_kernel`` block by
block: the rows' bases in x, the two staging paths of each K slice of A
("vec": chunk column ``tid & 3``, rows ``tid >> 2`` + 32 i; "gather": lane
l on column l, rows ``warp`` + 4 i) and of B, into shared memory laid out
as the kernel lays it out and filled with NaN first, so that a read of an
element no thread staged shows; the A fragments read as 32-bit words and
the B fragments as ``ldmatrix.x2.trans`` delivers them; the m16n8k16 MMA
as PTX defines its fragments (A rows g, g+8 and columns 2t, 2t+1, 2t+8,
2t+9; B rows 2t, 2t+1, 2t+8, 2t+9 of column g; C rows g, g+8 and columns
2t, 2t+1); the epilogue's bias, ReLU, rounding and masked stores into an
output filled with NaN. It is held against the plain bf16 conv and the
Pallas ``_forward`` in interpret mode, every output written exactly once.
The wrappers' launches and counters are checked on meta tensors.
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
from cnn_tpu_torch.ops.hopper import pool as hpool
from cnn_tpu_torch.ops.hopper import (conv2d_bias_relu, max_pool2d_bwd,
                                      max_pool2d_fwd, read_counters,
                                      reset_launches)
from cnn_tpu_torch.ops.hopper._build import SIGNATURES
from cnn_tpu_torch.ops.hopper.conv import (BF16_BK, BF16_TILES,
                                           BF16_VARIANTS, BF16_WARPS,
                                           H100_SMS, conv_bf16_plan)

BF16 = torch.bfloat16
CONV_CU = (Path(__file__).resolve().parents[1] / "cnn_tpu_torch" / "csrc"
           / "conv.cu")

# (H, Cin, Cout) of the BN AlexNet's convs at 224 px, all 3x3 stride 2
ALEXNET = {"conv1": (224, 3, 16), "conv2": (55, 16, 32),
           "conv3": (27, 32, 64), "conv4": (13, 64, 128)}


def _m(b, h, w, k, s):
    return b * conv_out_size(h, k, s) * conv_out_size(w, k, s)


# --- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 8, 64, 256])
@pytest.mark.parametrize("layer", list(ALEXNET))
def test_plan_on_the_alexnet_layers(layer, batch):
    h, cin, cout = ALEXNET[layer]
    # the plan sends the AlexNet layers to the Hopper variants
    # (tests/test_torch_bf16_conv_hopper.py); this kernel's plan is the one
    # it gives a named variant, as the smoke's comparisons ask for it
    assert conv_bf16_plan(batch, h, h, cin, cout, 3, 2, True).variant == {
        "conv1": "strip", "conv4": "tma"}.get(layer, "wgmma")
    plan = conv_bf16_plan(batch, h, h, cin, cout, 3, 2, True,
                          "gather" if layer == "conv1" else "vec")
    assert plan.variant == ("gather" if layer == "conv1" else "vec")
    assert plan.bn == cout            # 16..128: one column block
    assert plan.k_pad == -(-9 * cin // BF16_BK) * BF16_BK
    # K 27, 144, 288, 576: conv1 and conv2 end in a zero-padded slice
    assert plan.k_pad == {"conv1": 32, "conv2": 160, "conv3": 288,
                          "conv4": 576}[layer]
    m = _m(batch, h, h, 3, 2)
    assert plan.grid == (-(-m // plan.bm), 1)
    # BM 128 where that still gives two waves of 132 SMs, else 64
    assert plan.bm == (128 if -(-m // 128) >= 2 * H100_SMS else 64)
    # the serving buckets leave a ragged M edge for the store to mask
    if batch in (1, 8):
        assert m % plan.bm != 0


def test_plan_pads_k_and_picks_the_staging():
    p = conv_bf16_plan(2, 9, 9, 3, 16, 3, 2, True)
    assert (p.variant, p.k_pad) == ("gather", 32)       # 27 -> 32
    # Cin % 8 == 0 with x aligned: the wgmma variant by default, this
    # kernel's vec staging by name
    assert conv_bf16_plan(2, 9, 9, 8, 16, 3, 2, True).variant == "wgmma"
    assert conv_bf16_plan(2, 9, 9, 8, 16, 3, 2, True,
                          "vec").variant == "vec"
    assert conv_bf16_plan(2, 9, 9, 8, 16, 3, 2, False).variant == "gather"
    assert conv_bf16_plan(2, 9, 9, 12, 16, 3, 2, True).variant == "gather"
    assert conv_bf16_plan(2, 9, 9, 4, 16, 5, 1, True).k_pad == 128   # 100
    p = conv_bf16_plan(2, 9, 9, 16, 200, 3, 2, True, "vec")   # Cout > 128
    assert (p.bn, p.grid[1]) == (128, 2)
    assert conv_bf16_plan(2, 9, 9, 16, 8, 3, 2, True, "vec").bn == 16
    assert conv_bf16_plan(2, 9, 9, 16, 48, 3, 2, True, "vec").bn == 64
    for cout in (7, 12, 4):
        with pytest.raises(ValueError):
            conv_bf16_plan(2, 9, 9, 16, cout, 3, 2, True)


def test_plan_constants_match_the_source():
    src = CONV_CU.read_text()
    assert f"constexpr int kBfBK = {BF16_BK};" in src
    assert f"constexpr int kBfWarps = {BF16_WARPS};" in src
    body = src[src.index("cudaError_t launch_bf16_tile"):]
    cases = re.findall(r"case (\d+): return launch_bf16<(\d+), (\d+), kVecA>",
                       body)
    assert [(int(mt), int(nt)) for _, mt, nt in cases] == list(BF16_TILES)
    assert [int(i) for i, _, _ in cases] == list(range(len(BF16_TILES)))
    assert BF16_VARIANTS.index("vec") == 1   # the entry point's vec flag
    # static shared memory of the largest tile under 48 KB, as the kernel's
    # static_assert has it
    bm, bn = BF16_WARPS * 16 * 2, 8 * 16
    assert 2 * (bm * (BF16_BK + 8) + BF16_BK * (bn + 8)) * 2 + bm * 8 \
        <= 48 * 1024


# --- the emulation ---------------------------------------------------------------

def _bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 value (ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        BF16).float().numpy()


def emulate(x, w, b, stride, relu, plan):
    """``conv2d_bf16_kernel`` on bf16 values held as float32 arrays."""
    bsz, h, wid, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    ho, wo = conv_out_size(h, k, stride), conv_out_size(wid, k, stride)
    m_all, kk = bsz * ho * wo, k * k * cin
    mt, nt = BF16_TILES[plan.tile]
    bm, bn = plan.bm, plan.bn
    a_stride, b_stride = BF16_BK + 8, bn + 8
    threads = BF16_WARPS * 32
    xf, wf = x.reshape(-1), w.reshape(kk, cout)
    y = np.full(m_all * cout, np.nan, np.float32)
    writes = np.zeros(m_all * cout, np.int32)
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3

    def tap_offset(kg):
        tap, ci = kg // cin, kg % cin
        dy, dx = tap // k, tap % k
        return (dy * wid + dx) * cin + ci

    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            m0, n0 = bx * bm, by * bn
            rowbase = np.full(bm, -1, np.int64)
            for r in range(bm):
                m = m0 + r
                if m < m_all:
                    ox, tt = m % wo, m // wo
                    oy, bb = tt % ho, tt // ho
                    rowbase[r] = ((bb * h + oy * stride) * wid
                                  + ox * stride) * cin
            acc = np.zeros((BF16_WARPS, mt, nt, 32, 4), np.float32)
            for kt in range(-(-kk // BF16_BK)):
                k0 = kt * BF16_BK
                sa = np.full(bm * a_stride, np.nan, np.float32)
                sb = np.full(BF16_BK * b_stride, np.nan, np.float32)
                for tid in range(threads):
                    if plan.variant == "vec":
                        c = tid & 3
                        kc = k0 + 8 * c
                        off = tap_offset(kc) if kc < kk else 0
                        for r in range(tid >> 2, bm, threads // 4):
                            ok = kc < kk and rowbase[r] >= 0
                            sa[r * a_stride + 8 * c:r * a_stride + 8 * c + 8] \
                                = (xf[rowbase[r] + off:rowbase[r] + off + 8]
                                   if ok else 0.0)
                    else:
                        warp, lane = tid >> 5, tid & 31
                        kg = k0 + lane
                        off = tap_offset(kg) if kg < kk else 0
                        for r in range(warp, bm, BF16_WARPS):
                            ok = kg < kk and rowbase[r] >= 0
                            sa[r * a_stride + lane] = (xf[rowbase[r] + off]
                                                       if ok else 0.0)
                    for c in range(tid, BF16_BK * nt, threads):
                        r, j = c // nt, c % nt
                        kr, n = k0 + r, n0 + 8 * j
                        ok = kr < kk and n < cout
                        sb[r * b_stride + 8 * j:r * b_stride + 8 * j + 8] = (
                            wf[kr, n:n + 8] if ok else 0.0)
                for warp in range(BF16_WARPS):
                    for ks in (0, 16):
                        af = []
                        for i in range(mt):
                            r = warp * 16 * mt + i * 16 + g
                            e0 = r * a_stride + ks + 2 * t   # word p0[0]
                            e1 = (r + 8) * a_stride + ks + 2 * t
                            assert (e0 % 2 == 0).all() and (e1 % 2 == 0).all()
                            # a0 = p0[0], a1 = p1[0], a2 = p0[4], a3 = p1[4]
                            af.append([sa[np.stack([e, e + 1], -1)]
                                       for e in (e0, e1, e0 + 8, e1 + 8)])
                        for j in range(nt):
                            # ldmatrix.x2.trans: lane l < 16 names row
                            # ks + l at column 8j; matrix q holds the rows
                            # of lanes 8q..8q+7, and lane 4g+t receives its
                            # elements (2t, g) and (2t+1, g)
                            row_addr = ((ks + (lanes & 15)) * b_stride + 8 * j)
                            bfr = []
                            for q in range(2):
                                mat = np.stack([sb[row_addr[8 * q + i] +
                                                   np.arange(8)]
                                                for i in range(8)])
                                bfr.append(np.stack([mat[2 * t, g],
                                                     mat[2 * t + 1, g]], -1))
                            for i in range(mt):
                                acc[warp, i, j] = _mma(acc[warp, i, j],
                                                       af[i], bfr)
            for warp in range(BF16_WARPS):
                for i in range(mt):
                    for half in (0, 1):
                        m = m0 + warp * 16 * mt + i * 16 + g + 8 * half
                        for j in range(nt):
                            n = n0 + 8 * j + 2 * t
                            for e in (0, 1):
                                ok = (m < m_all) & (n < cout)
                                v = acc[warp, i, j][lanes, 2 * half + e] + \
                                    b[np.minimum(n + e, cout - 1)]
                                if relu:
                                    v = np.where(v > 0, v, np.float32(0))
                                idx = m[ok] * cout + n[ok] + e
                                y[idx] = _bf16_round(v[ok])
                                np.add.at(writes, idx, 1)
    return y.reshape(bsz, ho, wo, cout), writes


def _mma(c, a_regs, b_regs):
    """m16n8k16: rebuild the tiles from the lanes' registers as PTX lays
    them out, multiply (each bf16 product exact), and hand the sums back in
    the C layout. The float32 sum of a step is taken in float64 and rounded
    once; the card's order within a step may differ by float32 ulps."""
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


# (B, H, W, Cin, Cout, stride): conv1 (gather, K 27 -> 32), conv2-4 (vec),
# a ragged M edge, an odd extent, Cout 8 (a half column block), Cout 48 and
# Cin 12 (gather with K past one slice), k 5 at stride 1
EMU_CASES = {
    "conv1": (1, 15, 17, 3, 16, 2, 3),
    "conv2": (2, 11, 11, 16, 32, 2, 3),
    "conv3": (1, 11, 9, 32, 64, 2, 3),
    "conv4": (2, 7, 7, 64, 128, 2, 3),
    "ragged_m": (3, 9, 9, 16, 16, 2, 3),
    "cout8_odd": (1, 12, 13, 8, 8, 2, 3),
    "cin12_cout48": (1, 9, 9, 12, 48, 2, 3),
    "k5_s1": (1, 8, 8, 4, 16, 1, 5),
}


@pytest.mark.parametrize("relu_on", [False, True])
@pytest.mark.parametrize("case", list(EMU_CASES))
def test_emulated_walk_matches_the_plain_conv(rng, case, relu_on):
    bsz, h, wid, cin, cout, stride, k = EMU_CASES[case]
    x = _bf16_round(rng.standard_normal((bsz, h, wid, cin)))
    if cin > 3:
        x = np.maximum(x, 0)
    w = _bf16_round(rng.standard_normal((k, k, cin, cout)) * 0.2)
    b = _bf16_round(rng.standard_normal(cout) * 0.1)
    plan = conv_bf16_plan(bsz, h, wid, cin, cout, k, stride, True,
                          "vec" if cin % 8 == 0 else "gather")
    y, writes = emulate(x, w, b, stride, relu_on, plan)
    assert (writes == 1).all()          # every output once, nothing else
    assert not np.isnan(y).any()        # and no unstaged element was read
    ref = conv2d(*(torch.from_numpy(a).to(BF16) for a in (x, w, b)), stride,
                 relu_on).float().numpy()
    ulps = np.abs(_ordered(y) - _ordered(ref))
    assert ulps.max() <= 1, f"{(ulps > 0).sum()} differ, max {ulps.max()}"
    if k == 3:   # the Pallas kernel in interpret mode, on the same values
        want = pallas_conv_forward(
            *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b)),
            stride, relu_on, interpret=True)
        assert np.abs(_ordered(y) - _ordered(
            np.asarray(want, np.float32))).max() <= 1


def _ordered(a: np.ndarray) -> np.ndarray:
    """bf16 values (as float32) on an ordered integer line of bf16 ulps."""
    bits = (a.astype(np.float32).view(np.int32) >> 16).astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def test_emulation_sees_an_unstaged_read(rng):
    """The emulation reports a walk that misses outputs: a tile of 16
    columns in one column block for Cout 32 leaves half of them unwritten
    (NaN, no write)."""
    x = _bf16_round(rng.random((1, 9, 9, 16)))
    w = _bf16_round(rng.standard_normal((3, 3, 16, 32)))
    b = np.zeros(32, np.float32)
    plan = conv_bf16_plan(1, 9, 9, 16, 32, 3, 2, True, "vec")
    narrow = plan._replace(tile=BF16_TILES.index((1, 2)))   # BN 16, 1 block
    y, writes = emulate(x, w, b, 2, False, narrow)
    assert (writes == 0).any() and np.isnan(y).any()


# --- the wrappers' bf16 launches and counters, on meta tensors ----------------

def test_conv_wrapper_launches_and_counts_the_bf16_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(hconv, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hconv, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    reset_launches()
    for layer, (h, cin, cout) in ALEXNET.items():
        x = torch.empty((8, h, h, cin), dtype=BF16, device="meta")
        w = torch.empty((3, 3, cin, cout), dtype=BF16, device="meta")
        b = torch.empty((cout,), dtype=BF16, device="meta")
        y = conv2d_bias_relu(x, w, b, 2, layer != "conv4")
        ho = conv_out_size(h, 3, 2)
        assert y.shape == (8, ho, ho, cout) and y.dtype == BF16
        (name, args), = calls[-1:]
        assert name == "cnn_conv2d_bias_relu_bf16"
        assert len(args) == len(SIGNATURES[name])
        plan = conv_bf16_plan(8, h, h, cin, cout, 3, 2, True)
        assert args[-2:] == (BF16_VARIANTS.index(plan.variant), plan.tile)
        assert args[-3] == int(layer != "conv4")
    counts = read_counters()
    assert counts["conv2d_bias_relu.launches"] == 4
    assert counts["conv2d_bias_relu.launches_bf16"] == 4
    assert counts["conv2d_bias_relu.launches_bf16_strip"] == 1
    assert counts["conv2d_bias_relu.launches_bf16_wgmma"] == 2
    assert counts["conv2d_bias_relu.launches_bf16_tma"] == 1
    assert counts["conv2d_bias_relu.launches_bf16_gather"] == 0
    assert counts["conv2d_bias_relu.launches_bf16_vec"] == 0
    assert counts["conv2d_bias_relu.launches_strip"] == 0
    assert counts["conv2d_bias_relu.launches_tiled"] == 0
    assert counts["conv2d_bias_relu.launches_direct"] == 0
    with pytest.raises(ValueError):     # a bf16 shape the kernel refuses
        conv2d_bias_relu(torch.empty((1, 9, 9, 3), dtype=BF16, device="meta"),
                         torch.empty((3, 3, 3, 7), dtype=BF16, device="meta"),
                         torch.empty((7,), dtype=BF16, device="meta"), 2,
                         False)
    reset_launches()


def test_pool_wrappers_launch_and_count_the_bf16_kernels(monkeypatch):
    calls = []
    monkeypatch.setattr(hpool, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hpool, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    reset_launches()
    x = torch.empty((2, 111, 111, 16), dtype=BF16, device="meta")
    y, tap = max_pool2d_fwd(x, with_tap=True)
    assert y.dtype == BF16 and y.shape == (2, 55, 55, 16)
    g = torch.empty((2, 55, 55, 16), dtype=BF16, device="meta")
    dx = max_pool2d_bwd(tap, g, 111, 111)
    assert dx.dtype == BF16 and dx.shape == (2, 111, 111, 16)
    assert [c[0] for c in calls] == ["cnn_maxpool2x2_fwd_window_bf16",
                                     "cnn_maxpool2x2_bwd_window_bf16"]
    for name, args in calls:
        assert len(args) == len(SIGNATURES[name])
    counts = read_counters()
    assert counts["max_pool2d_fwd.launches"] == 1
    assert counts["max_pool2d_fwd.launches_bf16"] == 1
    assert counts["max_pool2d_fwd.launches_bf16_window"] == 1
    assert counts["max_pool2d_fwd.launches_window"] == 0   # the f32 kernels
    assert counts["max_pool2d_bwd.launches"] == 1
    assert counts["max_pool2d_bwd.launches_bf16"] == 1
    assert counts["max_pool2d_bwd.launches_window"] == 0   # the f32 kernels
    assert counts["max_pool2d_bwd.launches_element"] == 0
    # C 6 is the element kernel's in float32; bf16 has no element kernel
    with pytest.raises(ValueError):
        max_pool2d_bwd(torch.empty((2, 3, 4, 6), dtype=torch.uint8,
                                   device="meta"),
                       torch.empty((2, 3, 4, 6), dtype=BF16, device="meta"),
                       7, 9)
    reset_launches()
