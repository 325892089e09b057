"""The pool backward's two kernels (``cnn_tpu_torch/ops/hopper/pool.py``) on
the CPU: the choice between the window and the element kernel, the launch
counts per variant, and a torch emulation of the window kernel's writes
(one thread per pooled pixel and 4 channels, four 16-byte stores, the
cropped row and column of an odd extent zeroed by the last pooled row and
column) held bit for bit against the plain backward and cnn_tpu's Pallas
``_bwd_call`` in interpret mode."""

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
from cnn_tpu_torch.ops.hopper.pool import max_pool2d_bwd, pool_bwd_variant


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
