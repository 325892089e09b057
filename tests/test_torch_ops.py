"""cnn_tpu_torch layer ops and kernel wrappers (their plain versions, on the
CPU) against cnn_tpu: the XLA ops and the Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu import ops as jops
from cnn_tpu.ops.pallas.conv import _forward as pallas_conv_forward
from cnn_tpu.ops.pallas.normalize import uint8_normalize_pallas
from cnn_tpu.ops.pallas.pool import _fwd_call as pallas_pool_fwd
from cnn_tpu.ops.preprocess import uint8_to_float as j_uint8_to_float
from cnn_tpu_torch.nn import Flatten
from cnn_tpu_torch.ops.activations import relu
from cnn_tpu_torch.ops.batchnorm import batch_norm2d_eval
from cnn_tpu_torch.ops.conv import conv2d, conv_out_size
from cnn_tpu_torch.ops.hopper import (conv2d_bias_relu, max_pool2d_fwd,
                                      uint8_normalize)
from cnn_tpu_torch.ops.linear import linear
from cnn_tpu_torch.ops.pool import max_pool2d
from cnn_tpu_torch.ops.preprocess import uint8_to_float

# float32 sums in another order than XLA's: 1e-5 absolute and relative
CONV_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 224, 224, 3),
                                   (3, 5, 7, 1)])
def test_normalize_bit_exact_vs_jax(rng, shape):
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(j_uint8_to_float(jnp.asarray(x)))
    for fn in (uint8_to_float, uint8_normalize):
        got = fn(_t(x)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_normalize_every_byte_is_ieee_division():
    x = np.arange(256, dtype=np.uint8)
    got = uint8_normalize(_t(x)).numpy()
    want = x.astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_normalize_vs_pallas_interpret(rng):
    x = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    want = np.asarray(uint8_normalize_pallas(jnp.asarray(x), interpret=True))
    # interpret mode may fold /255 into a reciprocal multiply: 1 ulp, as
    # tests/test_pallas.py allows
    np.testing.assert_allclose(uint8_normalize(_t(x)).numpy(), want,
                               rtol=1.3e-7, atol=0)


def _pool_inputs(rng):
    ties = np.maximum(np.round(rng.standard_normal((2, 8, 8, 16)) * 2) / 2,
                      0).astype(np.float32)       # ReLU zeros + equal values
    ties[0, 4, 4, 0] = ties[0, 4, 5, 0] = ties[0, 5, 4, 0] = 3.0
    return {
        "ties": ties,
        "odd_7x9": rng.standard_normal((2, 7, 9, 8)).astype(np.float32),
        "conv1_111": np.maximum(rng.standard_normal((1, 111, 111, 4)),
                                0).astype(np.float32),
    }


@pytest.mark.parametrize("case", ["ties", "odd_7x9", "conv1_111"])
def test_pool_value_and_tap_vs_pallas_interpret(rng, case):
    x = _pool_inputs(rng)[case]
    want, want_tap = pallas_pool_fwd(jnp.asarray(x), interpret=True)
    got, tap = max_pool2d_fwd(_t(x), with_tap=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tap.dtype == torch.uint8
    np.testing.assert_array_equal(tap.numpy().astype(np.int32),
                                  np.asarray(want_tap))


@pytest.mark.parametrize("case", ["ties", "odd_7x9", "conv1_111"])
def test_pool_value_vs_xla(rng, case):
    x = _pool_inputs(rng)[case]
    want = np.asarray(jops.max_pool2d(jnp.asarray(x), 2, 2))
    np.testing.assert_array_equal(max_pool2d(_t(x)).numpy(), want)
    np.testing.assert_array_equal(max_pool2d_fwd(_t(x)).numpy(), want)


def test_pool_tie_goes_to_earliest_tap():
    x = np.zeros((1, 2, 2, 4), np.float32)
    x[0, :, :, 1] = [[0, 1], [1, 1]]      # tap 1 wins over 2 and 3
    x[0, :, :, 2] = [[0, 0], [1, 1]]      # tap 2 wins over 3
    x[0, :, :, 3] = [[2, 1], [2, 2]]      # tap 0 wins
    _, tap = max_pool2d_fwd(_t(x), with_tap=True)
    assert tap.flatten().tolist() == [0, 1, 2, 0]


CONV_CASES = {
    # (B, H, W, Cin, Cout, k, stride)
    "cin3_s2": (2, 17, 17, 3, 16, 3, 2),
    "odd_33_to_16": (2, 33, 33, 8, 12, 3, 2),
    "rect_s1": (1, 9, 12, 5, 7, 3, 1),
    "k5_s3": (2, 16, 14, 4, 8, 5, 3),
    "conv4_shape": (1, 13, 13, 64, 128, 3, 2),
}


def _conv_inputs(rng, case):
    b, h, w, cin, cout, k, _ = CONV_CASES[case]
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    return x, wt, bias


@pytest.mark.parametrize("relu_on", [False, True])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_vs_pallas_interpret_and_xla(rng, case, relu_on):
    x, wt, bias = _conv_inputs(rng, case)
    stride = CONV_CASES[case][-1]
    pallas = np.asarray(pallas_conv_forward(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), stride, relu_on,
        interpret=True))
    xla = jops.conv2d({"w": jnp.asarray(wt), "b": jnp.asarray(bias)},
                      jnp.asarray(x), stride)
    if relu_on:
        xla = jops.relu(xla)
    got = conv2d_bias_relu(_t(x), _t(wt), _t(bias), stride, relu_on).numpy()
    assert got.shape == pallas.shape == (
        x.shape[0], conv_out_size(x.shape[1], wt.shape[0], stride),
        conv_out_size(x.shape[2], wt.shape[0], stride), wt.shape[-1])
    np.testing.assert_allclose(got, pallas, **CONV_TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **CONV_TOL)
    np.testing.assert_array_equal(
        got, conv2d(_t(x), _t(wt), _t(bias), stride, relu_on).numpy())


def test_conv_rejects_mismatched_shapes():
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError):
        conv2d_bias_relu(x, torch.zeros(3, 3, 4, 8), torch.zeros(8))
    with pytest.raises(ValueError):
        conv2d_bias_relu(x, torch.zeros(3, 3, 3, 8), torch.zeros(7))
    with pytest.raises(ValueError):
        conv2d_bias_relu(torch.zeros(1, 2, 2, 3), torch.zeros(3, 3, 3, 8),
                         torch.zeros(8))


@pytest.mark.parametrize("wrapper,args", [
    (uint8_normalize, lambda: (torch.zeros(2, 4, 4, 3, dtype=torch.uint8,
                                           device="meta"),)),
    (max_pool2d_fwd, lambda: (torch.zeros(2, 4, 4, 3, device="meta"),)),
    (conv2d_bias_relu, lambda: (torch.zeros(1, 8, 8, 3, device="meta"),
                                torch.zeros(3, 3, 3, 8, device="meta"),
                                torch.zeros(8, device="meta"))),
])
def test_wrappers_take_plain_version_only_on_cpu(wrapper, args):
    """No fallback: a tensor that is not on the CPU goes to the CUDA kernel
    or raises; it never reaches the plain version."""
    before = wrapper.launches
    with pytest.raises((ValueError, TypeError)):
        wrapper(*args())
    assert wrapper.launches == before


def test_relu_linear_batchnorm_vs_jax(rng):
    x = rng.standard_normal((3, 5, 5, 8)).astype(np.float32)
    x[0, 0, 0, :2] = 0.0
    np.testing.assert_array_equal(relu(_t(x)).numpy(),
                                  np.asarray(jops.relu(jnp.asarray(x))))

    w = rng.standard_normal((200, 3)).astype(np.float32)
    b = rng.standard_normal((3,)).astype(np.float32)
    want = jops.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                       jnp.asarray(x))
    np.testing.assert_allclose(linear(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    flat = Flatten("flatten")(_t(x)).numpy()
    np.testing.assert_array_equal(flat, x.reshape(3, -1))   # NHWC order

    p = {"gamma": rng.standard_normal(8).astype(np.float32),
         "beta": rng.standard_normal(8).astype(np.float32)}
    s = {"mean": rng.standard_normal(8).astype(np.float32),
         "var": rng.uniform(0.1, 2.0, 8).astype(np.float32)}
    want, _ = jops.batch_norm2d(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in s.items()}, jnp.asarray(x),
        train=False)
    got = batch_norm2d_eval(_t(x), _t(p["gamma"]), _t(p["beta"]),
                            _t(s["mean"]), _t(s["var"]))
    # the same formula in float32; XLA may fuse the multiply-add
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


# --- training slice: the VJPs, training-mode BN and the loss ---------------

import jax  # noqa: E402

from cnn_tpu.ops.losses import softmax as j_softmax  # noqa: E402
from cnn_tpu.ops.losses import softmax_cross_entropy as j_softmax_ce  # noqa: E402
from cnn_tpu.ops.pallas.conv import _vjp_bwd as pallas_conv_vjp_bwd  # noqa: E402
from cnn_tpu.ops.pallas.pool import _bwd_call as pallas_pool_bwd  # noqa: E402
from cnn_tpu_torch.ops import losses  # noqa: E402
from cnn_tpu_torch.ops.batchnorm import batch_norm2d_train  # noqa: E402
from cnn_tpu_torch.ops.hopper import (conv2d_bias_relu_fn,  # noqa: E402
                                      max_pool2d_bwd, max_pool2d_fn)
from cnn_tpu_torch.ops.pool import max_pool2d_bwd as max_pool2d_bwd_plain  # noqa: E402


@pytest.mark.parametrize("case", ["ties", "odd_7x9", "conv1_111"])
def test_pool_vjp_vs_pallas_interpret_and_xla(rng, case):
    """The pool Function's gradient, exactly: g routed to the first max of
    each window, zeros elsewhere and in the cropped row and column."""
    x = _pool_inputs(rng)[case]
    b, h, w, c = x.shape
    g = rng.standard_normal((b, h // 2, w // 2, c)).astype(np.float32)
    _, mask = pallas_pool_fwd(jnp.asarray(x), interpret=True)
    want = np.asarray(pallas_pool_bwd(mask, jnp.asarray(g), h, w,
                                      interpret=True))
    _, vjp = jax.vjp(lambda v: jops.max_pool2d(v, 2, 2), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0]), want)

    xt = _t(x).requires_grad_(True)
    (got,) = torch.autograd.grad(max_pool2d_fn(xt), xt, _t(g))
    np.testing.assert_array_equal(got.numpy(), want)
    _, tap = max_pool2d_fwd(_t(x), with_tap=True)
    for fn in (max_pool2d_bwd, max_pool2d_bwd_plain):
        np.testing.assert_array_equal(fn(tap, _t(g), h, w).numpy(), want)


@pytest.mark.parametrize("relu_on", [False, True])
@pytest.mark.parametrize("case", ["cin3_s2", "odd_33_to_16", "rect_s1",
                                  "k5_s3"])
def test_conv_vjp_vs_pallas_interpret_and_xla(rng, case, relu_on):
    """dx/dw/db of the conv Function against the Pallas conv's VJP (its
    forward in interpret mode) and against jax.vjp of the XLA conv."""
    x, wt, bias = _conv_inputs(rng, case)
    stride = CONV_CASES[case][-1]
    xj, wj, bj = jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias)
    out = pallas_conv_forward(xj, wj, bj, stride, relu_on, interpret=True)
    g = rng.standard_normal(out.shape).astype(np.float32)
    want_pallas = pallas_conv_vjp_bwd(stride, relu_on,
                                      (xj, wj, out if relu_on else None),
                                      jnp.asarray(g))

    def xla(x_, w_, b_):
        y = jops.conv2d({"w": w_, "b": b_}, x_, stride)
        return jops.relu(y) if relu_on else y

    _, vjp = jax.vjp(xla, xj, wj, bj)
    want_xla = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_(True) for a in (x, wt, bias)]
    got = torch.autograd.grad(conv2d_bias_relu_fn(*leaves, stride, relu_on),
                              leaves, _t(g))
    for name, a, p, q in zip(("dx", "dw", "db"), got, want_pallas, want_xla):
        np.testing.assert_allclose(a.numpy(), np.asarray(p), **CONV_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(q), **CONV_TOL,
                                   err_msg=name)


def test_conv_vjp_skips_dx_of_an_input_without_grad(rng):
    x, wt, bias = _conv_inputs(rng, "cin3_s2")
    w = _t(wt).requires_grad_(True)
    y = conv2d_bias_relu_fn(_t(x), w, _t(bias), 2, True)
    (dw,) = torch.autograd.grad(y.sum(), w)
    assert dw.shape == w.shape


def _scaled_close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    want = np.asarray(want)
    dev = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert dev <= tol * max(1.0, float(np.abs(want).max())), dev


def test_batchnorm_train_vs_jax(rng):
    """Training-mode BN: output, new moving statistics (biased variance,
    momentum 0.1) and the VJP through the batch statistics, at 1e-6
    (times max(1, max|ref|))."""
    x = (rng.standard_normal((4, 5, 6, 8)) * 3 + 2).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    gamma = rng.standard_normal(8).astype(np.float32)
    beta = rng.standard_normal(8).astype(np.float32)
    mean0 = rng.standard_normal(8).astype(np.float32)
    var0 = rng.uniform(0.1, 2.0, 8).astype(np.float32)
    state = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def jfn(x_, gamma_, beta_):
        return jops.batch_norm2d({"gamma": gamma_, "beta": beta_}, state, x_,
                                 train=True)

    args = (jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want, new_state = jfn(*args)
    _, vjp = jax.vjp(lambda *a: jfn(*a)[0], *args)
    want_grads = vjp(jnp.asarray(g))

    leaves = [_t(a).requires_grad_(True) for a in (x, gamma, beta)]
    y, mean, var = batch_norm2d_train(*leaves, _t(mean0), _t(var0))
    got_grads = torch.autograd.grad(y, leaves, _t(g))
    _scaled_close(y.detach().numpy(), want, 1e-6)
    _scaled_close(mean.numpy(), new_state["mean"], 1e-6)
    _scaled_close(var.numpy(), new_state["var"], 1e-6)
    for a, b_ in zip(got_grads, want_grads):
        _scaled_close(a.numpy(), b_, 1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_its_gradient_vs_jax(rng, smoothing):
    logits = (rng.standard_normal((6, 3)) * 4).astype(np.float32)
    labels = rng.integers(0, 3, 6)
    want, grad = jax.value_and_grad(j_softmax_ce)(
        jnp.asarray(logits), jnp.asarray(labels), smoothing)
    lt = _t(logits).requires_grad_(True)
    got = losses.softmax_cross_entropy(lt, torch.from_numpy(labels), smoothing)
    (got_grad,) = torch.autograd.grad(got, lt)
    _scaled_close(got.item(), want, 1e-6)
    _scaled_close(got_grad.numpy(), grad, 1e-6)
    one_hot = losses.one_hot(torch.from_numpy(labels), 3)
    _scaled_close(losses.softmax_cross_entropy(_t(logits), one_hot,
                                               smoothing).item(), want, 1e-6)
    _scaled_close(losses.softmax(_t(logits)).numpy(),
                  jax.nn.softmax(jnp.asarray(logits)), 1e-6)


def test_softmax_takes_cnn_tpu_axis_keyword(rng):
    """``softmax(x, axis=)``, ``cnn_tpu``'s keyword, over each axis of a
    [6, 3] batch, in float32 from bf16 logits too."""
    logits = (rng.standard_normal((6, 3)) * 4).astype(np.float32)
    for axis in (0, 1, -1):
        want = j_softmax(jnp.asarray(logits), axis=axis)
        got = losses.softmax(_t(logits), axis=axis)
        assert got.dtype == torch.float32
        _scaled_close(got.numpy(), want, 1e-6)
    half = _t(logits).to(torch.bfloat16)
    want = j_softmax(jnp.asarray(logits, jnp.bfloat16), axis=0)
    _scaled_close(losses.softmax(half, axis=0).numpy(), want, 1e-6)


@pytest.mark.parametrize("wrapper,args", [
    (max_pool2d_bwd, lambda: (torch.zeros(2, 2, 2, 3, dtype=torch.uint8,
                                          device="meta"),
                              torch.zeros(2, 2, 2, 3, device="meta"), 4, 4)),
])
def test_training_wrappers_take_plain_version_only_on_cpu(wrapper, args):
    """No fallback for the training slice's wrappers either."""
    before = wrapper.launches
    with pytest.raises((ValueError, TypeError)):
        wrapper(*args())
    assert wrapper.launches == before
