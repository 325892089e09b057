"""The normalize kernel's plan and index walk, on the CPU.

``normalize_plan`` (variant, grid, head, tail) is checked for aligned and
misaligned pointers; a numpy emulation of ``csrc/normalize.cu``'s walk
(the head; 16-element chunks, two a trip of a grid-stride loop, loaded by
one lane, staged per warp and stored by others; the tail)
shows every element written exactly once, from aligned addresses where the
variant promises them, with the plain version's bits; and the kernel's
division, a reciprocal multiply with one fmaf correction, is checked in
exact arithmetic against numpy's float32 x / 255 for all 256 bytes.
"""

import re
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.ops.pallas.normalize import uint8_normalize_pallas
from cnn_tpu.ops.preprocess import uint8_to_float as j_uint8_to_float
from cnn_tpu_torch.ops.hopper import normalize as hnorm
from cnn_tpu_torch.ops.hopper import reset_launches, uint8_normalize
from cnn_tpu_torch.ops.hopper._build import SIGNATURES
from cnn_tpu_torch.ops.hopper.normalize import (CHUNK, THREADS, UNROLL,
                                                VARIANTS, WAVE,
                                                NormalizePlan,
                                                normalize_plan)
from cnn_tpu_torch.ops.preprocess import uint8_to_float

SOURCE = (Path(__file__).resolve().parents[1] / "cnn_tpu_torch" / "csrc"
          / "normalize.cu").read_text()
BASE = 0x7F3A_2000_0000        # an address the allocator could return
IMAGE = 224 * 224 * 3          # one serving image, 150,528 elements
LENGTHS = [1, 15, 16, 17, IMAGE, 3 * IMAGE + 7]


def _round_f32(v: Fraction) -> Fraction:
    """``v`` rounded to the nearest float32, ties to even (normal range)."""
    if v == 0:
        return v
    sign, v = (-1, -v) if v < 0 else (1, v)
    e = 0
    while v >= 2 ** (e + 1):
        e += 1
    while v < 2 ** e:
        e -= 1
    scale = Fraction(2) ** (23 - e)
    m = v * scale
    whole, rest = divmod(m.numerator, m.denominator)
    if 2 * rest > m.denominator or (2 * rest == m.denominator and whole % 2):
        whole += 1
    return sign * whole / scale


def _kernel_div255(x: int) -> Fraction:
    """The kernel's ``div255`` in exact arithmetic, each operation rounded
    once to float32: q = x * r, e = fmaf(-q, 255, x), fmaf(e, r, q)."""
    r = _round_f32(Fraction(1, 255))
    q = _round_f32(x * r)
    e = _round_f32(-q * 255 + x)
    return _round_f32(e * r + q)


# the kernel's 256 results, as float32
DIV255 = np.array([float(_kernel_div255(x)) for x in range(256)], np.float32)


def test_division_formula_is_ieee_for_every_byte():
    want = np.arange(256, dtype=np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(DIV255.view(np.int32), want.view(np.int32))
    # the correction is needed: the product alone is off on 126 bytes
    r = np.float32(1.0) / np.float32(255.0)
    product = np.arange(256, dtype=np.float32) * r
    assert (product.view(np.int32) != want.view(np.int32)).sum() == 126


def test_reciprocal_constant_matches_the_source():
    (lit,) = re.findall(r"const float r = (0x[0-9a-fA-F.p+-]+)f;", SOURCE)
    assert np.float32(float.fromhex(lit)) == np.float32(1) / np.float32(255)


def test_constants_match_the_cuda_source():
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE))
    assert int(consts["kThreads"]) == THREADS
    assert int(consts["kChunk"]) == CHUNK
    assert int(consts["kBlocksPerSm"]) * 132 == WAVE
    assert "__launch_bounds__(kThreads, kBlocksPerSm)" in SOURCE
    # the entry point's variant 0 is the wide (aligned-input) kernel
    assert VARIANTS[0] == "wide"
    assert re.search(r"if \(variant == 0\) \{\s*normalize_u8_wide_kernel<true>",
                     SOURCE)
    assert len(SIGNATURES["cnn_normalize_u8"]) == 6
    assert len(SIGNATURES["cnn_normalize_u8_direct"]) == 3


@pytest.mark.parametrize("case", [
    # (what, n, x offset in bytes, y offset in bytes, variant, head)
    ("serving batch, both aligned", 64 * IMAGE, 0, 0, "wide", 0),
    ("x 4 bytes in, y aligned", 1000, 4, 0, "wide", 12),
    ("x 1 byte in, y 4 bytes in", 1000, 1, 4, "wide", 15),
    ("x 6 bytes in, y 8 bytes in", 1000, 6, 8, "wide", 10),
    ("x 3 bytes in, y aligned", 1000, 3, 0, "bytes", 0),
    ("x 2 bytes in, y aligned", 1000, 2, 0, "bytes", 0),
    ("x aligned, y 4 bytes in", 1000, 0, 4, "bytes", 3),
    ("x aligned, y 12 bytes in", 1000, 0, 12, "bytes", 1),
    ("shorter than the head", 5, 4, 0, "wide", 5),
    ("one element", 1, 0, 0, "wide", 0),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_plan_variant_and_head(case):
    _, n, xo, yo, variant, head = case
    plan = normalize_plan(n, BASE + xo, BASE + yo)
    assert isinstance(plan, NormalizePlan)
    assert (plan.variant, plan.head) == (variant, head)
    chunks = (n - plan.head) // CHUNK
    assert plan.head + CHUNK * chunks + plan.tail == n
    assert 0 <= plan.tail < CHUNK


@pytest.mark.parametrize("images,blocks", [(1, 19), (8, 147), (64, WAVE),
                                           (256, 4 * WAVE)])
def test_plan_grid_at_the_serving_batches(images, blocks):
    """Less than a wave of work: one trip of two chunks a thread; more:
    whole waves (64 images fill 1.11 waves, so one wave loops)."""
    plan = normalize_plan(images * IMAGE, BASE, BASE)
    assert plan == NormalizePlan("wide", blocks, 0, 0)


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, WAVE * THREADS * UNROLL
                               * CHUNK - 1, WAVE * THREADS * UNROLL * CHUNK,
                               WAVE * THREADS * UNROLL * CHUNK * 3 + 12345,
                               10 ** 9 + 7])
def test_plan_grid_is_one_trip_or_whole_waves(n):
    plan = normalize_plan(n, BASE, BASE)
    chunks = (n - plan.head) // CHUNK
    per_block = THREADS * UNROLL
    assert plan.blocks >= 1
    if chunks <= WAVE * per_block:
        assert plan.blocks == max(1, -(-chunks // per_block))
    else:
        assert plan.blocks % WAVE == 0
        assert plan.blocks * per_block <= chunks   # each thread a full trip
        assert (plan.blocks + WAVE) * per_block > chunks


def test_plan_refuses_an_unaligned_float_output():
    with pytest.raises(ValueError):
        normalize_plan(100, BASE, BASE + 2)


def _walk(n: int, x_ptr: int, y_ptr: int, x: np.ndarray) -> tuple:
    """The kernel's stores, as numpy: (y, how often each element was
    written). Each warp loads 32 chunks a lane apart, stages them as 128
    words, and store j of lane l writes word 32 j + l; asserts that every
    16-byte access the variant promises aligned is."""
    plan = normalize_plan(n, x_ptr, y_ptr)
    chunks = (n - plan.head) // CHUNK
    stride = plan.blocks * THREADS
    warps = np.arange(0, stride, 32, dtype=np.int64)   # each warp's c0
    groups, trip = [], 0
    while True:                          # c0 += 2 stride while c0 < chunks
        c0 = warps[warps + 2 * stride * trip < chunks] + 2 * stride * trip
        if not c0.size:
            break
        groups += [c0, c0 + stride]      # the two chunk groups in flight
        trip += 1
    base = np.concatenate(groups) if groups else np.zeros(0, np.int64)
    loaded = base[:, None] + np.arange(32)          # lane l's chunk
    valid = loaded < chunks
    first = plan.head + CHUNK * loaded
    if plan.variant == "wide":
        assert ((x_ptr + first[valid]) % 16 == 0).all()
    staged = np.zeros((base.size, 32, CHUNK), np.uint8)
    staged[valid] = x[first[valid][:, None] + np.arange(CHUNK)]
    words = staged.reshape(base.size, 128, 4)
    g = np.arange(128)                              # store j, lane l: 32 j + l
    stored = base[:, None] + g // 4 < chunks
    elem = plan.head + CHUNK * base[:, None] + 4 * g  # the float4's first
    assert ((y_ptr + 4 * elem[stored]) % 16 == 0).all()
    idx = (elem[stored][:, None] + np.arange(4)).ravel()
    vals = DIV255[words[stored]].ravel()
    tid = np.arange(stride, dtype=np.int64)
    end = plan.head + CHUNK * chunks
    scalar = np.concatenate([tid[tid < plan.head], end + tid[tid < n - end]])
    idx = np.concatenate([idx, scalar])
    vals = np.concatenate([vals, DIV255[x[scalar]]])
    written = np.bincount(idx, minlength=n)
    y = np.full(n, np.nan, np.float32)
    y[idx] = vals
    return y, written


@pytest.mark.parametrize("offset", range(16))
def test_bytes_variant_load_shifts_words_into_place(rng, offset):
    """``load_chunk<false>``: the aligned 4-byte words holding a chunk (a
    fifth word only off a word boundary), each output word the low 32 bits
    of (next:this) >> 8 * (address % 4), as ``__funnelshift_r``."""
    buf = rng.integers(0, 256, 64, dtype=np.uint8)
    start = 16 + offset                  # the chunk's first byte
    words = buf.view("<u4").astype(np.uint64)
    first, shift = start // 4, 8 * (start % 4)
    held = [words[first + j] for j in range(4)]
    held.append(words[first + 4] if shift else np.uint64(0))
    got = [((held[j + 1] << np.uint64(32) | held[j]) >> np.uint64(shift))
           & np.uint64(0xFFFFFFFF) for j in range(4)]
    chunk = np.array(got, "<u4").view(np.uint8)
    np.testing.assert_array_equal(chunk, buf[start:start + 16])


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("x_off", range(16))
def test_walk_writes_every_element_once_bit_exact(rng, n, x_off):
    """Input offsets 0-15 bytes; output offsets 0-15 floats (a float32
    tensor starts on a multiple of 4 bytes), through both variants."""
    x = rng.integers(0, 256, n, dtype=np.uint8)
    want = uint8_to_float(torch.from_numpy(x)).numpy()
    for y_off in range(16):
        y, written = _walk(n, BASE + x_off, BASE + 4 * y_off, x)
        assert (written == 1).all()
        np.testing.assert_array_equal(y.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", [(1, 224, 224, 3), (2, 16, 16, 3)])
def test_walk_matches_jax_and_pallas_interpret(rng, shape):
    """Bit for bit against ``cnn_tpu``'s ``uint8_to_float``. The Pallas
    kernel in interpret mode multiplies by float32(1/255) instead of
    dividing (XLA's CPU rewrite: bit-equal to that product), so it is held
    bit for bit where that product is correctly rounded and within 1 ulp on
    the other bytes."""
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    y, written = _walk(x.size, BASE, BASE, x.ravel())
    assert (written == 1).all()
    y = y.reshape(shape)
    want = np.asarray(j_uint8_to_float(jnp.asarray(x)))
    np.testing.assert_array_equal(y.view(np.int32), want.view(np.int32))
    pallas = np.asarray(uint8_normalize_pallas(jnp.asarray(x), interpret=True))
    product = x.astype(np.float32) * (np.float32(1) / np.float32(255))
    np.testing.assert_array_equal(pallas.view(np.int32),
                                  product.view(np.int32))
    exact = product == want
    assert exact.mean() > 0.4
    np.testing.assert_array_equal(y[exact].view(np.int32),
                                  pallas[exact].view(np.int32))
    ulps = np.abs(y.view(np.int32).astype(np.int64)
                  - pallas.view(np.int32).astype(np.int64))
    assert ulps.max() == 1


@pytest.mark.parametrize("direct", [False, True])
def test_wrapper_launches_the_plan_and_counts_it(monkeypatch, direct):
    """Off the CPU the wrapper launches the plan's kernel and counts it
    under its variant; ``launch_normalize(direct=True)`` reaches the
    previous design and counts nothing (meta tensors stand in for the card;
    the launch is recorded, not made)."""
    calls = []
    monkeypatch.setattr(hnorm, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hnorm, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    x = torch.empty((8, 224, 224, 3), dtype=torch.uint8, device="meta")
    reset_launches()
    if direct:
        y, variant = hnorm.launch_normalize(x, direct=True)
        assert variant == "direct"
    else:
        y = uint8_normalize(x)
    assert y.shape == x.shape and y.dtype == torch.float32
    (name, args), = calls
    assert len(args) == len(SIGNATURES[name])
    counts = (uint8_normalize.launches, uint8_normalize.launches_wide,
              uint8_normalize.launches_bytes)
    if direct:
        assert name == "cnn_normalize_u8_direct"
        assert counts == (0, 0, 0)
    else:
        plan = normalize_plan(x.numel(), 0, 0)
        assert name == "cnn_normalize_u8"
        assert args[2:] == (x.numel(), 0, plan.blocks, plan.head)
        assert counts == (1, 1, 0)
    reset_launches()
