"""The ops of the ResNet, VGG, MobileNet and PipeCNN families on the CPU:
the padded, stride-1 and 1x1 plain convs and their autograd Function and
custom op against ``cnn_tpu/ops/conv.py`` (XLA at HIGHEST, ``jax.vjp``),
the depthwise conv and the average pools against ``cnn_tpu``'s, and the
conv kernels' plans at every conv of the six families at batch 1, 8, 64
and 256: which variant each takes, and that the wrapper hands the padding
to the planned entry point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu import ops as jops
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.nn import Conv2D
from cnn_tpu_torch.ops import conv as tconv
from cnn_tpu_torch.ops import pool as tpool
from cnn_tpu_torch.ops.hopper import conv as hconv
from cnn_tpu_torch.ops.hopper import read_counters, reset_launches
from cnn_tpu_torch.ops.hopper._build import SIGNATURES
from cnn_tpu_torch.ops.hopper.conv import (BF16_VARIANTS, conv2d_bias_relu,
                                           conv2d_bias_relu_fn,
                                           conv2d_bias_relu_op,
                                           conv_bf16_plan, conv_tile_plan)
from test_torch_conv_plan import _emulate_pw

# float32 sums in another order than XLA's (PERF.md section 2)
CONV_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-5          # times max(1, max|ref|), the conv Function's bar

# (B, H, Cin, Cout, k, stride, padding): padded stems at stride 2 and 1,
# stride-1 3x3, 1x1 projections with K 16 and 32, a pointwise 1x1 at 7x7
SHAPES = [(2, 17, 3, 16, 3, 2, 1), (2, 12, 3, 32, 3, 1, 1),
          (2, 9, 16, 16, 3, 1, 1), (2, 9, 16, 32, 1, 2, 0),
          (2, 8, 32, 64, 1, 2, 0), (2, 7, 64, 128, 1, 1, 0),
          (1, 5, 8, 8, 3, 1, 2), (3, 10, 8, 16, 3, 2, 1)]


def _inputs(rng, b, h, cin, cout, k):
    x = rng.standard_normal((b, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, bias


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_conv_matches_cnn_tpu(rng, shape):
    b, h, cin, cout, k, s, p = shape
    x, w, bias = _inputs(rng, b, h, cin, cout, k)
    want = np.asarray(jops.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                                  jnp.asarray(x), s, padding=p))
    got = conv2d_bias_relu(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(bias), s, False, p)
    assert got.shape == want.shape == (
        b, jops.conv_out_size(h, k, s, p), jops.conv_out_size(h, k, s, p),
        cout)
    assert tconv.conv_out_size(h, k, s, p) == jops.conv_out_size(h, k, s, p)
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)
    relu = conv2d_bias_relu(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(bias), s, True, p)
    assert torch.equal(relu, torch.clamp(got, min=0))


@pytest.mark.parametrize("route", ["function", "op"])
@pytest.mark.parametrize("shape", SHAPES[:6])
def test_padded_conv_gradients_match_jax_vjp(rng, shape, route):
    """dx, dw, db of the conv Function and of the custom op through a ReLU,
    against ``jax.vjp`` of ``cnn_tpu``'s conv."""
    b, h, cin, cout, k, s, p = shape
    x, w, bias = _inputs(rng, b, h, cin, cout, k)
    ho = jops.conv_out_size(h, k, s, p)
    g = rng.standard_normal((b, ho, ho, cout)).astype(np.float32)

    def f(x, w, bias):
        return jax.nn.relu(jops.conv2d({"w": w, "b": bias}, x, s, padding=p))
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]

    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    conv = conv2d_bias_relu_fn if route == "function" else conv2d_bias_relu_op
    y = conv(tx, tw, tb, s, True, p)
    got = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(g))
    for gt, wt, name in zip(got, want, ("dx", "dw", "db")):
        assert gt.shape == wt.shape, name
        assert np.abs(gt.numpy() - wt).max() <= GRAD_TOL * max(
            1.0, np.abs(wt).max()), name


@pytest.mark.parametrize("mult,stride,padding", [(1, 1, 1), (1, 2, 1),
                                                 (2, 1, 0), (1, 2, 0)])
def test_depthwise_conv_matches_cnn_tpu(rng, mult, stride, padding):
    c = 6
    x = rng.standard_normal((2, 9, 9, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 1, c * mult)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(c * mult) * 0.1).astype(np.float32)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(bias)}

    def f(x, params):
        return jops.depthwise_conv2d(params, x, stride, padding=padding,
                                     channel_multiplier=mult)
    want, vjp = jax.vjp(f, jnp.asarray(x), params)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    got = tconv.depthwise_conv2d(tx, tw, tb, stride, padding, mult)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **CONV_TOL)
    g = rng.standard_normal(got.shape).astype(np.float32)
    jdx, jp = vjp(jnp.asarray(g))
    grads = torch.autograd.grad(got, (tx, tw, tb), torch.from_numpy(g))
    for gt, wt in zip(grads, (jdx, jp["w"], jp["b"])):
        wt = np.asarray(wt)
        assert np.abs(gt.numpy() - wt).max() <= GRAD_TOL * max(
            1.0, np.abs(wt).max())


def test_depthwise_conv_keeps_the_exact_multiplier_guard():
    """An input with half the channels the bank was built for divides
    ``w.shape[3]`` but is refused, as ``cnn_tpu`` refuses it."""
    w = torch.zeros(3, 3, 1, 8)
    with pytest.raises(ValueError, match="built for 8 channels"):
        tconv.depthwise_conv2d(torch.zeros(1, 5, 5, 4), w, torch.zeros(8),
                               1, 1, channel_multiplier=1)
    assert tconv.depthwise_conv2d(torch.zeros(1, 5, 5, 4), w, torch.zeros(8),
                                  1, 1, channel_multiplier=2).shape == (
        1, 5, 5, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avg_pools_match_cnn_tpu(rng, dtype):
    x = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for got, want in ((tpool.avg_pool2d(tx, 2, 2), jops.avg_pool2d(jx, 2, 2)),
                      (tpool.global_avg_pool(tx), jops.global_avg_pool(jx))):
        assert str(got.dtype).endswith(dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=1e-6 if dtype == "float32" else 0)


def test_pw_walk_vs_pallas_interpret_at_stride_2(rng):
    """resnet18's 32 -> 64 stride-2 projection at 32 px and B = 2 through
    the pointwise kernel's walk (``tests/test_torch_conv_plan.py``) with
    the plan's tile and grid, against cnn_tpu's Pallas ``_forward`` at
    k = 1, stride 2, in interpret mode, and ``cnn_tpu.ops.conv.conv2d``."""
    from cnn_tpu.ops.pallas.conv import _forward as pallas_conv_forward
    b, h, cin, cout, s = 2, 32, 32, 64, 2
    plan = conv_tile_plan(b, h, h, cin, cout, 1, s, True)
    assert plan.variant == "pw"
    x, w, bias = _inputs(rng, b, h, cin, cout, 1)
    want = np.asarray(pallas_conv_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), s, False,
        interpret=True))
    got, writes = _emulate_pw(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(bias), s, False, plan.tile,
                              plan.grid[0])
    assert bool((writes == 1).all())
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)
    xla = jops.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                      jnp.asarray(x), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **CONV_TOL)


# ------------------------------------------------------------- the plans ----

FAMILIES = ("resnet10", "resnet18", "vgg8", "vgg11", "mobilenet", "pipecnn")


def family_convs(name: str, size: int = 224):
    """(H, Cin, Cout, k, stride, padding) of every Conv2D of ``name`` at
    ``size`` px, in layer order (the shapes ``cnn_tpu``'s ``out_shapes``
    gives), and the count of Conv2D layers."""
    jm = j_get_model(name, num_classes=3, image_size=size)
    out, n = [], 0

    def walk(layers, shape):
        nonlocal n
        for layer in layers:
            if type(layer).__name__ == "ResidualBlock":
                walk(layer.body.layers, shape)
                if layer.proj is not None:
                    walk([layer.proj], shape)
            elif type(layer).__name__ == "StackedBlocks":
                for _ in range(layer.n_blocks):
                    walk([layer.block], shape)
            elif type(layer).__name__ == "Conv2D":
                n += 1
                out.append((shape[0], layer.in_channels, layer.out_channels,
                            layer.kernel_size, layer.stride, layer.padding))
            shape = layer.out_shape(shape)
        return shape
    walk(jm.layers, (size, size, 3))
    return sorted(set(out)), n


# the variants every family conv takes, float32 / bf16: a padded Cin-3 stem
# takes both strips (bf16: the widened layout); a float32 1x1 with Cout >=
# 64 the pointwise kernel (resnet10's 16 -> 32 projection, Cout 32, stays
# tiled); every other conv is tiled, and in bf16 tma where Cin % 64 == 0,
# wgmma but for the 1x1 stride-2 projections with k*Cin = 16 (ResNet's
# block_2), which the bf16 strip takes (natural layout)
@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("batch", [1, 8, 64, 256])
def test_plans_take_every_family_conv(name, batch):
    for h, cin, cout, k, s, p in family_convs(name)[0]:
        f32 = conv_tile_plan(batch, h, h, cin, cout, k, s, True, p)
        bf = conv_bf16_plan(batch, h, h, cin, cout, k, s, True, None, p)
        strip = k * cin == 16 and p == 0 and cout <= 64
        f32_want = "pw" if k == 1 and cout >= 64 else "tiled"
        want = (("strip", "strip") if cin == 3
                else (f32_want, "strip" if strip else
                      "tma" if cin % 64 == 0 else "wgmma"))
        assert (f32.variant, bf.variant) == want, (h, cin, cout, k, s, p)
        ho = tconv.conv_out_size(h, k, s, p)
        if bf.variant == "wgmma":
            assert bf.grid[0] * 64 * hconv.WGMMA_TILES[bf.tile][1] >= \
                batch * ho * ho
            assert bf.k_pad >= k * k * cin and bf.k_pad % 32 == 0
        if bf.variant == "tma":
            bn, bm = hconv.TMA_TILES[bf.tile][:2]
            assert (bf.grid[0] - 1) * bm < batch * ho * ho <= bf.grid[0] * bm
            assert bf.grid[1] == -(-cout // bn) and bf.k_pad == k * k * cin
        if cin == 3:    # the stems: padded, R from the plans' rules
            assert p == 1 and k == 3
            assert f32.grid == (-(-ho // f32.rows), batch)
            assert f32.rows == (2 if batch == 1 else 8 if batch >= 64 and (
                ho * cout > hconv.STRIP_WIDE_ROW) else 4 if batch >= 64
                or s == 1 else 2)
            assert hconv.BF16_STRIP_TILES[bf.tile] == (4, True)
            assert bf.grid == (-(-ho // 4), batch) and bf.k_pad == 48
        if f32.variant == "tiled":
            t = hconv.TILES[f32.tile]
            assert (f32.grid[0] - 1) * t.bm < batch * ho * ho <= \
                f32.grid[0] * t.bm
        if f32.variant == "pw":
            bm, bn = hconv.PW_TILES[f32.tile][:2]
            assert f32.grid[1] == -(-cout // bn) and cout >= bn
            assert 1 <= f32.grid[0] <= -(-(batch * ho * ho) // bm)


def test_a_padded_conv_never_takes_a_strip():
    """A padded conv never takes a strip that cannot take it: the float32
    strip stages padded rows for Cin <= 4 (zero margins and zero rows),
    the bf16 strip only for Cin 3 (the widened layout); other padded shapes
    decline to the direct kernel and the gather, as before."""
    for p in (0, 1, 2):
        assert conv_tile_plan(8, 224, 224, 4, 16, 3, 2, True,
                              p).variant == "strip"
    # Cout 68 and misaligned x decline with or without padding
    assert conv_tile_plan(8, 224, 224, 4, 68, 3, 2, True, 1).variant == \
        "direct"
    assert conv_tile_plan(8, 224, 224, 3, 16, 3, 2, False, 1).variant == \
        "direct"
    assert conv_bf16_plan(8, 224, 224, 3, 16, 3, 2, True, None,
                          1).variant == "strip"
    assert conv_bf16_plan(8, 224, 224, 2, 16, 3, 2, True).variant == "strip"
    assert conv_bf16_plan(8, 224, 224, 2, 16, 3, 2, True, None,
                          1).variant == "gather"
    with pytest.raises(ValueError):
        conv_bf16_plan(8, 224, 224, 2, 16, 3, 2, True, "strip", 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_passes_the_padding_to_the_planned_entry(monkeypatch, dtype):
    """Off the CPU the wrapper hands ``padding`` to the entry point its
    plan names, after the stride (meta tensors stand in for the card)."""
    calls = []
    monkeypatch.setattr(hconv, "cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(hconv, "launch", lambda name, dev, stream, *args:
                        calls.append((name, args)))
    reset_launches()
    for h, cin, cout, k, s, p in family_convs("resnet10", 64)[0]:
        x = torch.empty((8, h, h, cin), dtype=dtype, device="meta")
        w = torch.empty((k, k, cin, cout), dtype=dtype, device="meta")
        b = torch.empty((cout,), dtype=dtype, device="meta")
        y = conv2d_bias_relu(x, w, b, s, False, p)
        ho = tconv.conv_out_size(h, k, s, p)
        assert y.shape == (8, ho, ho, cout)
        name, args = calls[-1]
        assert len(args) == len(SIGNATURES[name])
        assert args[10:12] == (s, p)
        if dtype == torch.bfloat16:
            plan = conv_bf16_plan(8, h, h, cin, cout, k, s, True, None, p)
            assert args[-2:] == (BF16_VARIANTS.index(plan.variant), plan.tile)
    counts = read_counters()
    n = len(family_convs("resnet10", 64)[0])
    assert counts["conv2d_bias_relu.launches"] == n
    if dtype == torch.bfloat16:
        # the stem is a padded strip, block_2's 1x1 projection (k*Cin 16)
        # an unpadded one, the four shapes of Cin 64 and 128 take tma
        tma = sum(cin % 64 == 0
                  for _, cin, *_ in family_convs("resnet10", 64)[0])
        assert tma == 4
        assert counts["conv2d_bias_relu.launches_bf16_gather"] == 0
        assert counts["conv2d_bias_relu.launches_bf16_strip"] == 2
        assert counts["conv2d_bias_relu.launches_bf16_strip_padded"] == 1
        assert counts["conv2d_bias_relu.launches_strip_padded"] == 0
        assert counts["conv2d_bias_relu.launches_bf16_tma"] == tma
        assert counts["conv2d_bias_relu.launches_bf16_wgmma"] == n - 2 - tma
    else:
        # the 1x1 projections 32 -> 64 and 64 -> 128 take the pointwise
        # kernel, 16 -> 32 the tiled one
        pw = sum(k == 1 and cout >= 64
                 for _, _, cout, k, *_ in family_convs("resnet10", 64)[0])
        assert pw == 2
        assert counts["conv2d_bias_relu.launches_direct"] == 0
        assert counts["conv2d_bias_relu.launches_strip"] == 1
        assert counts["conv2d_bias_relu.launches_strip_padded"] == 1
        assert counts["conv2d_bias_relu.launches_bf16_strip_padded"] == 0
        assert counts["conv2d_bias_relu.launches_pw"] == pw
        assert counts["conv2d_bias_relu.launches_tiled"] == n - 1 - pw
    reset_launches()


def test_wrapper_refuses_padding_past_the_kernels(monkeypatch):
    monkeypatch.setattr(hconv, "cuda_args", lambda *a, **k: 0)
    x = torch.empty((1, 9, 9, 8), device="meta")
    w = torch.empty((3, 3, 8, 8), device="meta")
    with pytest.raises(ValueError, match="padding"):
        conv2d_bias_relu(x, w, torch.empty(8, device="meta"), 1, False, 17)


@pytest.mark.parametrize("name", FAMILIES)
def test_every_conv_of_a_forward_goes_through_the_wrapper(monkeypatch, name):
    """A forward calls the conv wrapper once per Conv2D layer, fused or not
    (the plain conv counted behind it), and never ATen's conv there: only
    the depthwise convs reach ``F.conv2d``."""
    calls = {"conv": 0, "aten": 0}
    real, real_aten = hconv.conv2d, tconv.F.conv2d

    def plain(*args):
        calls["conv"] += 1
        return real(*args)

    def aten(*args, **kwargs):
        calls["aten"] += 1
        return real_aten(*args, **kwargs)
    monkeypatch.setattr(hconv, "conv2d", plain)
    monkeypatch.setattr(tconv.F, "conv2d", aten)
    model = get_model(name, image_size=32, device="cpu").eval()
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    n_convs = family_convs(name, 32)[1]
    n_dw = sum(1 for m in model.modules()
               if type(m).__name__ == "DepthwiseConv2D")
    assert calls == {"conv": n_convs, "aten": n_dw}
    if name == "pipecnn":     # two stem convs, two per trunk block
        assert n_convs == 2 + 2 * model.net["trunk"].n_blocks
    else:
        assert sum(isinstance(m, Conv2D) for m in model.modules()) == n_convs
