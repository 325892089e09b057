"""The pool kernels' plans (``cnn_tpu_torch/ops/hopper/pool.py``) on the
CPU.

Backward: the choice between the window and the element kernel, the launch
counts per variant, and a torch emulation of the window kernel's writes
(one thread per pooled pixel and 4 channels, four 16-byte stores, the
cropped row and column of an odd extent zeroed by the last pooled row and
column) held bit for bit against the plain backward and cnn_tpu's Pallas
``_bwd_call`` in interpret mode.

Forward: ``pool_fwd_variant`` and ``pool_fwd_block``, the wrapper's entry
point and counters per variant, and a torch emulation of the window
forward's walk (block, thread row and column, 16-byte channel group ->
the addresses of its four loads and two stores, the comparisons as the
kernel makes them on the float bits) that writes every y element and tap
once, held bit for bit against ``ops/pool.py:max_pool2d_taps`` and the
Pallas ``_fwd_call`` in interpret mode."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.ops.pallas.pool import _bwd_call as pallas_pool_bwd
from cnn_tpu.ops.pallas.pool import _fwd_call as pallas_pool_fwd
from cnn_tpu_torch.ops import pool as plain
from cnn_tpu_torch.ops.hopper import pool as hpool
from cnn_tpu_torch.ops.hopper import reset_launches
from cnn_tpu_torch.ops.hopper._build import SIGNATURES
from cnn_tpu_torch.ops.hopper.pool import (max_pool2d_bwd, max_pool2d_fwd,
                                           pool_bwd_variant, pool_fwd_block,
                                           pool_fwd_variant)

BF16 = torch.bfloat16


@pytest.mark.parametrize("case", [
    # (B, H2, W2, C, aligned) -> variant
    ("AlexNet, C 16", (256, 55, 55, 16, True), "window"),
    ("C 8", (2, 3, 4, 8, True), "window"),
    ("C 4", (1, 1, 1, 4, True), "window"),
    ("C 6", (2, 3, 4, 6, True), "element"),
    ("C 3", (2, 3, 4, 3, True), "element"),
    ("misaligned g or tap", (256, 55, 55, 16, False), "element"),
    ("no pooled row (H 1)", (2, 0, 4, 16, True), "element"),
    ("no pooled column (W 1)", (2, 4, 0, 16, True), "element"),
], ids=lambda c: c[0])
def test_pool_bwd_variant(case):
    _, shape, want = case
    assert pool_bwd_variant(*shape) == want


def _emulate_window(tap, g, h, w):
    """The window kernel's stores in torch: thread t of block row = b*H2+i
    owns pooled pixel j = t // (C/4) and channels 4*(t % (C/4)) .. +3; it
    writes its four taps' float4s, and the zeros of the cropped row and
    column where it is the last pooled row or column. Returns dx and how
    many times each element was written."""
    b, h2, w2, c = g.shape
    c4 = c // 4
    dx = torch.full((b, h, w, c4, 4), float("nan"))
    writes = torch.zeros((b, h, w, c4), dtype=torch.int32)
    row = torch.arange(b * h2)[:, None]            # blockIdx.x
    t = torch.arange(w2 * c4)[None, :]             # the block's threads
    bb, i = row // h2, row % h2
    j, cg = t // c4, t % c4
    gv = g.reshape(b * h2, w2 * c4, 4)             # one float4 per thread
    tv = tap.reshape(b * h2, w2 * c4, 4)           # one uint32 per thread
    zero = torch.zeros(())

    def store(y, x, val, where=None):
        yy, xx, bbb, cc = torch.broadcast_tensors(y, x, bb, cg)
        if where is not None:
            keep = torch.broadcast_to(where, yy.shape)
            yy, xx, bbb, cc, val = (yy[keep], xx[keep], bbb[keep], cc[keep],
                                    torch.broadcast_to(val, (*keep.shape, 4))[keep])
        dx[bbb, yy, xx, cc] = val
        writes.index_put_((bbb, yy, xx, cc), torch.ones_like(yy, dtype=torch.int32),
                          accumulate=True)

    for q in range(4):
        store(2 * i + (q >> 1), 2 * j + (q & 1),
              torch.where(tv == q, gv, zero))
    crop_row = (i == h2 - 1) & bool(h & 1)
    crop_col = (j == w2 - 1) & bool(w & 1)
    zeros4 = torch.zeros((b * h2, w2 * c4, 4))
    for dxq in (0, 1):
        store(2 * i + 2, 2 * j + dxq, zeros4, crop_row)
        store(2 * i + dxq, 2 * j + 2, zeros4, crop_col)
    store(2 * i + 2, 2 * j + 2, zeros4, crop_row & crop_col)
    return dx.reshape(b, h, w, c), writes


def _pool_case(rng, b, h, w, c):
    """The tap of a forward on ReLU output quantized to quarters (exact
    ties), and a cotangent."""
    x = np.maximum(np.round(rng.standard_normal((b, h, w, c)) * 4) / 4,
                   0).astype(np.float32)
    g = rng.standard_normal((b, h // 2, w // 2, c)).astype(np.float32)
    return x, g


EXTENTS = [(2, 111, 111, 16), (2, 110, 110, 16), (3, 7, 9, 8), (1, 9, 6, 4)]


@pytest.mark.parametrize("shape", EXTENTS, ids=lambda s: "x".join(map(str, s)))
def test_window_walk_writes_each_element_once_bit_exact(rng, shape):
    b, h, w, c = shape
    x, g = _pool_case(rng, b, h, w, c)
    _, tap = plain.max_pool2d_taps(torch.from_numpy(x))
    g = torch.from_numpy(g)
    got, writes = _emulate_window(tap, g, h, w)
    assert bool((writes == 1).all())
    want = plain.max_pool2d_bwd(tap, g, h, w)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not got[:, 2 * (h // 2):].any() and not got[:, :, 2 * (w // 2):].any()
    # autograd through the plain forward routes g the same way
    xa = torch.from_numpy(x).requires_grad_(True)
    (auto,) = torch.autograd.grad(plain.max_pool2d(xa), xa, g)
    assert torch.equal(got.view(torch.int32), auto.view(torch.int32))


@pytest.mark.parametrize("shape", [(2, 111, 111, 16), (3, 7, 9, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_window_walk_vs_pallas_interpret(rng, shape):
    b, h, w, c = shape
    x, g = _pool_case(rng, b, h, w, c)
    _, mask = pallas_pool_fwd(jnp.asarray(x), interpret=True)
    want = np.asarray(pallas_pool_bwd(mask, jnp.asarray(g), h, w,
                                      interpret=True))
    tap = torch.from_numpy(np.asarray(mask).astype(np.uint8))
    got, writes = _emulate_window(tap, torch.from_numpy(g), h, w)
    assert bool((writes == 1).all())
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("c,variant", [(16, "window"), (8, "window"),
                                       (6, "element")])
def test_wrapper_launches_the_variants_kernel_and_counts_it(monkeypatch, c,
                                                            variant):
    """Off the CPU the wrapper calls the variant's entry point and counts the
    launch under it (meta tensors stand in for the card; the launch is
    recorded, not made)."""
    calls = []
    monkeypatch.setattr(hpool, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hpool, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    tap = torch.empty((2, 55, 55, c), dtype=torch.uint8, device="meta")
    g = torch.empty((2, 55, 55, c), device="meta")
    reset_launches()
    dx = max_pool2d_bwd(tap, g, 111, 111)
    assert dx.shape == (2, 111, 111, c)
    (name, args), = calls
    assert name == {"window": "cnn_maxpool2x2_bwd_window",
                    "element": "cnn_maxpool2x2_bwd"}[variant]
    assert len(args) == len(SIGNATURES[name]) and args[-4:] == (2, 111, 111, c)

    def counts():
        return (max_pool2d_bwd.launches, max_pool2d_bwd.launches_window,
                max_pool2d_bwd.launches_element)

    assert counts() == (1, int(variant == "window"), int(variant == "element"))
    reset_launches()
    assert counts() == (0, 0, 0)


def test_both_entry_points_take_one_signature():
    assert SIGNATURES["cnn_maxpool2x2_bwd_window"] == \
        SIGNATURES["cnn_maxpool2x2_bwd"]


# --- the forward ---------------------------------------------------------


@pytest.mark.parametrize("case", [
    # (B, H2, W2, C, bf16, aligned) -> variant
    ("bf16 AlexNet, C 16", (256, 55, 55, 16, True, True), "window"),
    ("bf16 C 8", (2, 3, 4, 8, True, True), "window"),
    ("bf16 VGG C 512", (64, 7, 7, 512, True, True), "window"),
    ("bf16 C 12", (2, 3, 4, 12, True, True), "element"),
    ("bf16 C 4", (2, 3, 4, 4, True, True), "element"),
    ("bf16 C 3", (2, 3, 4, 3, True, True), "element"),
    ("bf16 misaligned x", (256, 55, 55, 16, True, False), "element"),
    ("f32 AlexNet, C 16", (256, 55, 55, 16, False, True), "window"),
    ("f32 C 8", (2, 3, 4, 8, False, True), "window"),
    ("f32 C 12", (2, 3, 4, 12, False, True), "window"),
    ("f32 C 6", (2, 3, 4, 6, False, True), "element"),
    ("f32 C 3", (2, 3, 4, 3, False, True), "element"),
    ("f32 misaligned x", (256, 55, 55, 16, False, False), "element"),
    ("no pooled row (H 1)", (2, 0, 4, 16, False, True), "element"),
    ("no pooled column (W 1)", (2, 4, 0, 16, True, True), "element"),
], ids=lambda c: c[0])
def test_pool_fwd_variant(case):
    _, shape, want = case
    assert pool_fwd_variant(*shape) == want


@pytest.mark.parametrize("case", [
    # (B, H2, W2, C, bf16) -> (tx, ty, blocks)
    ("bf16 AlexNet: 110 groups a row", (256, 55, 55, 16, True), (128, 2, 7040)),
    ("f32 AlexNet: 220 groups", (256, 55, 55, 16, False), (224, 1, 14080)),
    ("f32 vgg8 pool_1: 896 groups, strided", (64, 112, 112, 32, False),
     (512, 1, 7168)),
    ("bf16 vgg11 pool_8: 448 groups", (64, 7, 7, 512, True), (448, 1, 448)),
    ("7x9x8 bf16: rows past the last", (3, 3, 4, 8, True), (32, 8, 2)),
    ("5x4x4 f32: one row a block", (1, 2, 2, 4, False), (32, 2, 1)),
], ids=lambda c: c[0])
def test_pool_fwd_block(case):
    _, shape, want = case
    tx, ty, blocks = pool_fwd_block(*shape)
    assert (tx, ty, blocks) == want
    # what the launcher takes: whole warps, at most 1,024 threads
    assert tx % 32 == 0 and 32 <= tx <= 512 and tx * ty <= 1024
    assert blocks * ty >= shape[0] * shape[1] > (blocks - 1) * ty


def _window_fwd_lanes(a, b, c, d, bf16):
    """The kernel's ``window1`` on every channel: the inputs as integer bit
    patterns; a bf16 value widened to float by its bits (16 on top).
    Returns the winner's bits and its tap."""
    if bf16:
        a, b, c, d = (v.to(torch.int32) << 16 for v in (a, b, c, d))

    def f(v):
        return v.view(torch.float32)

    r0, r1 = f(b) > f(a), f(d) > f(c)
    m0, m1 = torch.where(r0, b, a), torch.where(r1, d, c)
    down = f(m1) > f(m0)
    out = torch.where(down, m1, m0)
    tap = torch.where(down, torch.where(r1, 3, 2), torch.where(r0, 1, 0))
    if bf16:
        out = (out >> 16).to(torch.int16)
    return out, tap.to(torch.uint8)


def _emulate_fwd_window(x):
    """The window forward's walk in torch: block ``blk`` of the grid of
    ``pool_fwd_block``, thread (tx_i, ty_i): pooled row blk*ty + ty_i (none
    past B*H2), groups t = tx_i, tx_i + tx, ... < W2*G of it (16 bytes of
    channels each), read at the kernel's addresses (groups 2t - t%G and
    2t - t%G + G of x's rows 2i and 2i+1) and stored at group row*W2*G + t
    of y and of the tap. Returns y, the tap and how many times each y
    group was written."""
    b, h, w, c = x.shape
    bf16 = x.dtype == BF16
    kv = 8 if bf16 else 4
    g, h2, w2 = c // kv, h // 2, w // 2
    n, rows = w2 * g, b * h2
    tx, ty, blocks = pool_fwd_block(b, h2, w2, c, bf16)
    xg = x.contiguous().view(torch.int16 if bf16 else torch.int32)
    xg = xg.reshape(-1, kv)                          # x in 16-byte groups
    y = torch.full((rows * n, kv), -1, dtype=xg.dtype)
    tap = torch.full((rows * n, kv), 255, dtype=torch.uint8)
    writes = torch.zeros(rows * n, dtype=torch.int32)
    blk = torch.arange(blocks)[:, None, None]
    row = (blk * ty + torch.arange(ty)[None, :, None]).expand(-1, -1, tx)
    lane = torch.arange(tx)[None, None, :].expand(blocks, ty, -1)
    for k in range(-(-n // tx)):
        t = lane + k * tx
        live = (row < rows) & (t < n)
        r, t = row[live], t[live]
        bb = r // h2
        i = r - bb * h2
        x0 = (bb * h + 2 * i) * w * g                # group of (b, 2i, 0, 0)
        x1 = x0 + w * g
        qa = 2 * t - t % g
        qb = qa + g
        out, taps = _window_fwd_lanes(xg[x0 + qa], xg[x0 + qb], xg[x1 + qa],
                                      xg[x1 + qb], bf16)
        yi = r * n + t
        y[yi], tap[yi] = out, taps
        writes.index_add_(0, yi, torch.ones_like(yi, dtype=torch.int32))
    y = y.view(x.dtype).reshape(b, h2, w2, c)
    return y, tap.reshape(b, h2, w2, c), writes


def _fwd_case(rng, shape):
    """ReLU output quantized to quarters (exact ties are common; +0 only,
    as -0 + 0 is +0)."""
    x = np.maximum(np.round(rng.standard_normal(shape) * 4) / 4, 0) + 0.0
    return x.astype(np.float32)


# (shape, dtype): odd and even extents, bf16 at C 8 and 16 (its window
# kernel's C), float32 at C 4 and 12 as well
FWD_CASES = [((3, 7, 9, 8), "f32"), ((3, 7, 9, 8), "bf16"),
             ((4, 5, 4, 8), "f32"), ((4, 5, 4, 8), "bf16"),
             ((2, 5, 4, 4), "f32"), ((2, 5, 9, 12), "f32"),
             ((1, 32, 32, 16), "f32"), ((1, 32, 32, 16), "bf16")]


@pytest.mark.parametrize("shape,dtype", FWD_CASES,
                         ids=["x".join(map(str, s)) + "-" + d
                              for s, d in FWD_CASES])
def test_fwd_window_walk_writes_each_output_once_bit_exact(rng, shape,
                                                           dtype):
    bf16 = dtype == "bf16"
    assert pool_fwd_variant(shape[0], shape[1] // 2, shape[2] // 2,
                            shape[3], bf16, True) == "window"
    x = torch.from_numpy(_fwd_case(rng, shape))
    x = x.to(BF16) if bf16 else x
    # +-0 and NaN where the plain version defines the result: the first of
    # equal values wins, and a NaN never wins a comparison
    flat = x.view(-1)
    flat[5::11] = -0.0
    flat[7::29] = float("nan")
    got, tap, writes = _emulate_fwd_window(x)
    assert bool((writes == 1).all())
    want, want_tap = plain.max_pool2d_taps(x)
    view = torch.int16 if bf16 else torch.int32
    assert torch.equal(got.view(view), want.view(view))
    assert torch.equal(tap, want_tap)


@pytest.mark.parametrize("shape", [(3, 7, 9, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fwd_window_walk_vs_pallas_interpret(rng, shape):
    """The Pallas forward on the float32 values, against the emulated walk
    in float32 and in bf16 (quarters are exact in bf16, and a maximum is
    exact, so the bf16 walk gives the float32 bits less their low half):
    one JAX compile."""
    x = _fwd_case(rng, shape)
    want, mask = pallas_pool_fwd(jnp.asarray(x), interpret=True)
    want, mask = np.asarray(want), np.asarray(mask)
    for dtype in (torch.float32, BF16):
        got, tap, writes = _emulate_fwd_window(torch.from_numpy(x).to(dtype))
        assert bool((writes == 1).all())
        np.testing.assert_array_equal(got.float().numpy().view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(tap.numpy(), mask.astype(np.uint8))


@pytest.mark.parametrize("case", [
    # (dtype, C, storage offset in elements) -> variant
    ("bf16 C 16", BF16, 16, 0, "window"),
    ("bf16 C 12", BF16, 12, 0, "element"),
    ("bf16 misaligned", BF16, 16, 1, "element"),
    ("f32 C 16", torch.float32, 16, 0, "window"),
    ("f32 C 3", torch.float32, 3, 0, "element"),
    ("f32 misaligned", torch.float32, 16, 1, "element"),
], ids=lambda c: c[0])
def test_fwd_wrapper_launches_the_variants_kernel_and_counts_it(monkeypatch,
                                                                case):
    """Off the CPU the forward wrapper calls the variant's entry point with
    its block, and counts the launch under the variant and dtype (meta
    tensors stand in for the card; the launch is recorded, not made)."""
    _, dtype, c, offset, variant = case
    calls = []
    monkeypatch.setattr(hpool, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hpool, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    shape = (2, 111, 111, c)
    x = torch.empty(2 * 111 * 111 * c + offset, dtype=dtype,
                    device="meta")[offset:].view(shape)
    reset_launches()
    y, tap = max_pool2d_fwd(x, with_tap=True)
    assert y.shape == tap.shape == (2, 55, 55, c) and y.dtype == dtype
    bf16 = dtype == BF16
    (name, args), = calls
    assert name == {"window": "cnn_maxpool2x2_fwd_window",
                    "element": "cnn_maxpool2x2_fwd"}[variant] + (
                        "_bf16" if bf16 else "")
    assert len(args) == len(SIGNATURES[name])
    assert args[3:7] == (2, 111, 111, c)
    if variant == "window":
        assert args[7:] == pool_fwd_block(2, 55, 55, c, bf16)[:2]
    counts = {k: getattr(max_pool2d_fwd, k) for k in (
        "launches", "launches_window", "launches_element", "launches_bf16",
        "launches_bf16_window", "launches_bf16_element")}
    want = {"launches": 1, "launches_bf16": int(bf16),
            "launches_window": int(not bf16 and variant == "window"),
            "launches_element": int(not bf16 and variant == "element"),
            "launches_bf16_window": int(bf16 and variant == "window"),
            "launches_bf16_element": int(bf16 and variant == "element")}
    assert counts == want
    max_pool2d_fwd(x)                  # without the tap: a null pointer
    assert calls[1][1][2] is None and max_pool2d_fwd.launches == 2
    reset_launches()
    assert not any(getattr(max_pool2d_fwd, k) for k in counts)


def test_fwd_entry_points_signatures():
    """The window entry points take the element one's arguments and the
    block's (tx, ty)."""
    for sfx in ("", "_bf16"):
        assert SIGNATURES[f"cnn_maxpool2x2_fwd_window{sfx}"] == \
            SIGNATURES[f"cnn_maxpool2x2_fwd{sfx}"] + [SIGNATURES[
                "cnn_maxpool2x2_fwd"][-1]] * 2


def test_fwd_window_walk_is_the_sources():
    """The emulated walk's index math is the kernel's, read from
    ``csrc/pool.cu``: the row of a thread, its split, the two rows' bases
    and the window's two groups."""
    src = (Path(hpool.__file__).resolve().parents[2] / "csrc"
           / "pool.cu").read_text()
    body = src[src.index("maxpool2x2_fwd_window_kernel("):]
    body = body[:body.index("\n}\n")]
    for line in ("const int row = blockIdx.x * blockDim.y + threadIdx.y;",
                 "if (row >= rows) return;",
                 "const int b = row / H2, i = row - b * H2;",
                 "x + ((int64_t)b * H + 2 * i) * W * C);",
                 "const uint4* x1 = x0 + W * G;",
                 "for (int t = threadIdx.x; t < n; t += blockDim.x) {",
                 "const int qa = 2 * t - t % G, qb = qa + G;",
                 "yrow[t] = o;"):
        assert line in body, line
