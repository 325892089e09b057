"""The bf16 compute policy of cnn_tpu_torch against cnn_tpu's, on the CPU.

The plain bf16 conv against the Pallas ``_forward`` in interpret mode on
bf16 inputs (within 1 bf16 ulp; bit-equal expected), the plain bf16 pool
against ``_fwd_call`` / ``_bwd_call`` (bit-exact), the conv Function's bf16
gradients against ``_vjp_bwd``, the bf16 prep on every byte, the whole BN
AlexNet in bf16 against ``model.apply(compute_dtype=jnp.bfloat16)`` and
``jax.grad(_loss_fn)``, and short bf16 training, eval and serving runs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_tpu_torch.nn.module as nn_module
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.ops.pallas.conv import _forward as pallas_conv_forward
from cnn_tpu.ops.pallas.conv import _vjp_bwd as pallas_conv_vjp_bwd
from cnn_tpu.ops.pallas.pool import _bwd_call as pallas_pool_bwd
from cnn_tpu.ops.pallas.pool import _fwd_call as pallas_pool_fwd
from cnn_tpu.ops.preprocess import uint8_to_float as j_uint8_to_float
from cnn_tpu.parallel.train_step import _loss_fn as j_loss_fn
from cnn_tpu_torch.data import DeviceDataset, make_device_train_step
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.ops import augment as aug
from cnn_tpu_torch.ops.batchnorm import batch_norm2d_train
from cnn_tpu_torch.ops.conv import conv2d
from cnn_tpu_torch.ops.hopper import (conv2d_bias_relu, conv2d_bias_relu_fn,
                                      max_pool2d_bwd, max_pool2d_fn,
                                      max_pool2d_fwd, uint8_normalize)
from cnn_tpu_torch.ops.linear import full_precision_reduction, linear
from cnn_tpu_torch.ops.pool import max_pool2d_bwd as pool_bwd_plain
from cnn_tpu_torch.ops.pool import max_pool2d_taps
from cnn_tpu_torch.ops.preprocess import uint8_to_float
from cnn_tpu_torch.optim import make_optimizer
from cnn_tpu_torch.parallel import (create_train_state, make_eval_step,
                                    make_train_step)
from cnn_tpu_torch.parallel.train_step import loss_fn, named_params, prep
from cnn_tpu_torch.serving import InferenceEngine
from cnn_tpu_torch.utils.checkpoint import load_jax_params

BF16 = torch.bfloat16

# The model-level bar. cnn_tpu's default bf16 model runs the XLA conv
# (cnn_tpu/nn/module.py:86), which rounds the conv to bf16 and then adds a
# bf16 bias, rounding again (cnn_tpu/ops/conv.py:206-224); the port's
# kernels, like the Pallas conv, add the bias in float32 and round once. So
# each conv output may differ by about one bf16 ulp (2^-8 relative), and
# four layers of BN, ReLU and pooling carry that to the logits and
# gradients. 5e-2 x max(1, max|ref|) per tensor, and the same argmax.
MODEL_TOL = 5e-2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """A float32 array rounded to bf16 (to nearest even) on both sides."""
    return _t(np.asarray(a, np.float32)).to(BF16), \
        jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _bits(t) -> np.ndarray:
    """The int16 bit patterns of a bf16 torch tensor or JAX array."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def _ulps(a, b) -> np.ndarray:
    """Distance in bf16 ulps: the bit patterns mapped onto one ordered
    integer line (+0 and -0 both to 0)."""
    def key(v):
        v = v.astype(np.int32)
        return np.where(v < 0, -(v & 0x7FFF), v)
    return np.abs(key(_bits(a)) - key(_bits(b)))


def _scaled_dev(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# --- the plain bf16 conv against the Pallas kernel --------------------------

# (B, H, W, Cin, Cout, stride): AlexNet's four Cin/Cout pairs at small
# extents, and an odd (and even) extent that VALID windows crop
CONV_CASES = {
    "conv1_3_16": (2, 23, 23, 3, 16, 2),
    "conv2_16_32": (2, 11, 11, 16, 32, 2),
    "conv3_32_64": (2, 13, 13, 32, 64, 2),
    "conv4_64_128": (2, 9, 9, 64, 128, 2),
    "odd_10x13": (1, 10, 13, 16, 32, 2),
}


def _conv_inputs(rng, case, relu_in=True):
    b, h, w, cin, cout, _ = CONV_CASES[case]
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    if relu_in and cin > 3:
        x = np.maximum(x, 0)      # a ReLU output, as conv2-4 see
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, bias


@pytest.mark.parametrize("relu_on", [False, True])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_plain_bf16_conv_vs_pallas_interpret(rng, case, relu_on):
    """Within 1 bf16 ulp of ``_forward(..., interpret=True)`` on the same
    bf16 inputs; the count of elements that differ at all is reported."""
    stride = CONV_CASES[case][-1]
    (xt, xj), (wt, wj), (bt, bj) = (_bf16(a) for a in _conv_inputs(rng, case))
    want = pallas_conv_forward(xj, wj, bj, stride, relu_on, interpret=True)
    assert want.dtype == jnp.bfloat16
    for fn in (conv2d, conv2d_bias_relu):   # the wrapper takes it on the CPU
        got = fn(xt, wt, bt, stride, relu_on)
        assert got.dtype == BF16 and got.shape == want.shape
        ulps = _ulps(got, want)
        print(f"{case} relu={relu_on}: {(ulps > 0).sum()} of {ulps.size} "
              f"elements differ, max {ulps.max()} ulp")
        assert ulps.max() <= 1


def test_plain_bf16_conv_rounds_once_after_float32_bias(rng):
    """The bf16 conv is the float32 conv of the bf16 values, plus the bias
    in float32, rounded once: exactly, since each bf16 product is exact in
    float32 and the sums run in the same order."""
    x, wt, bias = _conv_inputs(rng, "conv2_16_32")
    (xt, _), (wt_, _), (bt, _) = (_bf16(a) for a in (x, wt, bias))
    for relu_on in (False, True):
        want = conv2d(xt.float(), wt_.float(), bt.float(), 2, relu_on).to(BF16)
        np.testing.assert_array_equal(
            _bits(conv2d(xt, wt_, bt, 2, relu_on)), _bits(want))


# --- the plain bf16 pool against the Pallas kernels --------------------------

def _pool_case(rng, case):
    if case == "ties":
        # ReLU zeros and values quantized to quarters: exact ties in bf16
        x = np.maximum(np.round(rng.standard_normal((2, 8, 8, 16)) * 4) / 4, 0)
        x[0, 4, 4, 0] = x[0, 4, 5, 0] = x[0, 5, 4, 0] = 3.0
    elif case == "odd_7x9":
        x = np.maximum(np.round(rng.standard_normal((2, 7, 9, 8)) * 2) / 2, 0)
    else:   # conv1's output extent, bf16 values that tie after rounding
        x = np.maximum(rng.standard_normal((1, 111, 111, 4)), 0) * 1e-3 + 1.0
    return x.astype(np.float32)


@pytest.mark.parametrize("case", ["ties", "odd_7x9", "conv1_111"])
def test_plain_bf16_pool_vs_pallas_interpret(rng, case):
    """Forward value and tap and the backward, bit for bit, on inputs built
    to tie (the first maximum in row-major window order wins)."""
    xt, xj = _bf16(_pool_case(rng, case))
    b, h, w, c = xt.shape
    want, want_tap = pallas_pool_fwd(xj, interpret=True)
    assert want.dtype == jnp.bfloat16
    got, tap = max_pool2d_fwd(xt, with_tap=True)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(tap.numpy().astype(np.int32),
                                  np.asarray(want_tap))
    x00, x01 = xt[:, 0:2 * (h // 2):2, 0:2 * (w // 2):2], \
        xt[:, 0:2 * (h // 2):2, 1:2 * (w // 2):2]
    assert (x00 == x01).float().mean().item() > 0.2   # ties are common

    gt, gj = _bf16(rng.standard_normal((b, h // 2, w // 2, c)))
    dwant = pallas_pool_bwd(want_tap, gj, h, w, interpret=True)
    for fn in (max_pool2d_bwd, pool_bwd_plain):
        dx = fn(tap, gt, h, w)
        assert dx.dtype == BF16
        np.testing.assert_array_equal(_bits(dx), _bits(dwant))
    xa = xt.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(max_pool2d_fn(xa), xa, gt)
    np.testing.assert_array_equal(_bits(dx), _bits(dwant))


def test_plain_pool_keeps_the_dtype():
    """``ops/pool.py`` is dtype-generic: bf16 in, bf16 out, the same taps as
    the float32 pool on the same values."""
    x = torch.tensor([[1.0, 1.0, 2.0, 0.5], [0.0, 1.0, 2.0, 3.0],
                      [3.0, 0.0, 0.0, 0.0], [3.0, 3.0, 0.0, 0.0]])
    x = x.reshape(1, 4, 4, 1)
    out16, tap16 = max_pool2d_taps(x.to(BF16))
    out32, tap32 = max_pool2d_taps(x)
    assert out16.dtype == BF16
    assert torch.equal(out16.float(), out32) and torch.equal(tap16, tap32)
    assert tap16.flatten().tolist() == [0, 3, 0, 0]
    g = torch.ones(1, 2, 2, 1, dtype=BF16)
    assert pool_bwd_plain(tap16, g, 4, 4).dtype == BF16


# --- the conv Function's bf16 gradients against _vjp_bwd ---------------------

@pytest.mark.parametrize("relu_on", [False, True])
@pytest.mark.parametrize("case", ["conv1_3_16", "conv2_16_32", "odd_10x13"])
def test_bf16_conv_function_grads_vs_vjp_bwd(rng, case, relu_on):
    """dx/dw/db in bf16 against ``_vjp_bwd`` called with the same residuals
    and cotangent. Bar: within 2 bf16 ulps of max|ref| per tensor (ATen and
    XLA sum the bf16 products in other orders, each in float32, and round
    once)."""
    stride = CONV_CASES[case][-1]
    x, wt, bias = _conv_inputs(rng, case)
    (xt, xj), (wt_, wj), (bt, bj) = (_bf16(a) for a in (x, wt, bias))
    out = pallas_conv_forward(xj, wj, bj, stride, relu_on, interpret=True)
    gt, gj = _bf16(rng.standard_normal(out.shape))
    want = pallas_conv_vjp_bwd(stride, relu_on,
                               (xj, wj, out if relu_on else None), gj)
    leaves = [t.clone().requires_grad_(True) for t in (xt, wt_, bt)]
    got = torch.autograd.grad(conv2d_bias_relu_fn(*leaves, stride, relu_on),
                              leaves, gt)
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        assert a.dtype == BF16 and r.dtype == jnp.bfloat16, name
        ref = np.asarray(r, np.float32)
        top = float(np.abs(ref).max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
        dev = float(np.abs(a.float().numpy() - ref).max())
        print(f"{case} relu={relu_on} {name}: {dev / ulp if ulp else 0:.3g}"
              " ulps of max|ref|")
        assert dev <= 2 * ulp, f"{name}: {dev:.3g} over 2 ulps of {top:.3g}"


# --- the layers under a compute dtype ----------------------------------------

def test_bf16_linear_casts_and_sums_in_float32(rng):
    """``cnn_tpu/ops/linear.py`` in bf16: x and w cast, a bf16 product, the
    bias cast to the product's dtype; the product is the float32 sum of the
    exact bf16 products, rounded once (within 1 bf16 ulp: the CPU's bf16
    GEMM may sum in another order). The global reduction flag is left as
    it was."""
    x = _t(rng.standard_normal((4, 2, 2, 8)).astype(np.float32))
    w = _t(rng.standard_normal((32, 3)).astype(np.float32))
    b = _t(rng.standard_normal(3).astype(np.float32))
    before = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    got = linear(x, w, b, BF16)
    assert got.dtype == BF16
    prod = (x.reshape(4, -1).to(BF16).float() @ w.to(BF16).float()).to(BF16)
    assert _ulps(got, prod + b.to(BF16)).max() <= 1
    with full_precision_reduction():
        assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
        == before
    # the backward through the cast reaches the float32 parameters
    wl = w.clone().requires_grad_(True)
    (gw,) = torch.autograd.grad(linear(x, wl, b, BF16).float().sum(), wl)
    assert gw.dtype == torch.float32
    assert torch.equal(linear(x, w, b), x.reshape(4, -1) @ w + b)


def test_bn_keeps_float32_statistics_and_returns_bf16(rng):
    x = _t(rng.standard_normal((2, 5, 5, 8)).astype(np.float32)).to(BF16)
    gamma, beta = torch.ones(8), torch.zeros(8)
    mean, var = torch.zeros(8), torch.ones(8)
    y, new_mean, new_var = batch_norm2d_train(x, gamma, beta, mean, var)
    assert y.dtype == BF16
    assert new_mean.dtype == new_var.dtype == torch.float32
    x32 = x.float()
    np.testing.assert_allclose(new_mean.numpy(),
                               0.1 * x32.mean(dim=(0, 1, 2)).numpy(),
                               rtol=1e-5, atol=1e-7)


def test_sequential_fuses_conv_and_relu_in_bf16(monkeypatch):
    """The conv -> ReLU fusion keeps working under a compute dtype, and the
    kernels see bf16 inputs, weights and bias."""
    seen = []
    real = nn_module.conv2d_bias_relu

    def spy(x, w, b, stride, relu):
        seen.append((relu, x.dtype, w.dtype, b.dtype))
        return real(x, w, b, stride, relu)

    monkeypatch.setattr(nn_module, "conv2d_bias_relu", spy)
    model = get_model("alexnet", image_size=64, device="cpu").eval()
    with torch.no_grad():
        out = model(torch.rand(1, 64, 64, 3), compute_dtype=BF16)
    assert out.dtype == BF16
    assert seen == [(True, BF16, BF16, BF16)] * 4
    assert all(p.dtype == torch.float32 for p in model.parameters())


# --- the bf16 prep -------------------------------------------------------------

def test_bf16_prep_is_jax_bit_for_bit_on_every_byte():
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    want = _bits(j_uint8_to_float(jnp.asarray(x), jnp.bfloat16))
    for got in (uint8_to_float(_t(x), BF16), uint8_normalize(_t(x), BF16),
                prep(_t(x), BF16)):
        assert got.dtype == BF16
        np.testing.assert_array_equal(_bits(got), want)
    assert uint8_normalize(_t(x)).dtype == torch.float32


# --- the whole BN AlexNet in bf16 against cnn_tpu ------------------------------

def _models(rng, batch_norm=True):
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                         image_size=64)
    params, state = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.key(7)))
    state = {k: {"mean": rng.standard_normal(v["mean"].shape).astype(np.float32)
                 * 0.1,
                 "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
             for k, v in state.items()}
    model = get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                      image_size=64, device="cpu")
    load_jax_params(model, params, state)
    return jmodel, params, state, model


def _batch(rng, n=4):
    images = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, n).astype(np.int32)
    return images, labels


@pytest.mark.parametrize("train", [False, True])
def test_bf16_alexnet_logits_vs_jax(rng, train):
    """Eval (moving statistics) and training mode (batch statistics):
    logits within MODEL_TOL x max(1, max|ref|) of cnn_tpu's bf16 apply, the
    same argmax, and BN's moving statistics float32 after a training
    forward."""
    jmodel, params, state, model = _models(rng)
    images, _ = _batch(rng)
    xj = j_uint8_to_float(jnp.asarray(images), jnp.bfloat16)
    want, new_state, _ = jmodel.apply(params, state, xj, train=train,
                                      compute_dtype=jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    model.train(train)
    with torch.no_grad():
        got = model(prep(_t(images), BF16), compute_dtype=BF16)
    assert got.dtype == BF16
    want32 = np.asarray(want, np.float32)
    dev = _scaled_dev(got.float().numpy(), want32)
    print(f"train={train}: logits max|dev| {dev:.3g} x max(1,|ref|)")
    assert dev <= MODEL_TOL
    np.testing.assert_array_equal(got.float().argmax(-1).numpy(),
                                  want32.argmax(-1))
    for layer in model.net:
        if hasattr(layer, "var"):
            assert layer.mean.dtype == layer.var.dtype == torch.float32
            if train:
                assert _scaled_dev(layer.mean.numpy(),
                                   new_state[layer.name]["mean"]) <= MODEL_TOL


def test_f32_alexnet_still_meets_its_bar(rng):
    """The same model and batch in float32 (compute_dtype None and
    float32) stay within cnn_tpu's 1e-4 logit bar: the compute dtype left
    the float32 path alone."""
    jmodel, params, state, model = _models(rng)
    images, _ = _batch(rng)
    xj = j_uint8_to_float(jnp.asarray(images))
    want, _, _ = jmodel.apply(params, state, xj, train=False)
    model.eval()
    with torch.no_grad():
        for cd in (None, torch.float32):
            got = model(prep(_t(images), cd), compute_dtype=cd)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_bf16_alexnet_gradients_vs_jax_grad(rng, batch_norm):
    """One training step's parameter gradients against ``jax.grad`` of
    ``_loss_fn`` with ``compute_dtype=bf16``; the loss within MODEL_TOL; the
    gradients float32, as the master parameters.

    Without BN each gradient is within MODEL_TOL x max(1, max|ref|).

    With BN by batch statistics the bar per tensor is the larger of
    MODEL_TOL and twice JAX's own bf16 noise on the same batch: the largest
    deviation of JAX's bf16 gradients from its float32 ones over the
    tensors (0.11-0.15 x max(1, max|ref|) at this size, conv1's weights the
    largest). BN's backward subtracts the batch mean of the cotangent, so
    at batch 4 the first layers' gradients are small residues of cancelling
    terms, and any bf16 rounding of the activations (the XLA conv's second
    rounding among them) moves them that much on either side. A conv bias
    that feeds BN has an analytically zero gradient; JAX's bf16 step sums
    its bf16 cotangent in bf16 (0.5-0.9 where float32 gives 0.02-0.03), so
    the port's (summed in float32) is held to JAX's float32 gradient within
    MODEL_TOL instead.
    """
    jmodel, params, state, model = _models(rng, batch_norm)
    images, labels = _batch(rng)

    def jgrad(cd):
        xj = j_uint8_to_float(jnp.asarray(images), cd or jnp.float32)

        def jloss(p):
            return j_loss_fn(p, state, jmodel, xj, jnp.asarray(labels), None,
                             True, cd)[0]

        return jax.value_and_grad(jloss)(params)

    jl, jgrads = jgrad(jnp.bfloat16)
    _, jgrads32 = jgrad(None)
    model.train()
    params_t = named_params(model)
    loss, _ = loss_fn(model, prep(_t(images), BF16),
                      _t(labels.astype(np.int64)), 0.0, BF16)
    grads = dict(zip(params_t, torch.autograd.grad(loss,
                                                   list(params_t.values()))))
    assert abs(loss.item() - float(jl)) <= MODEL_TOL * max(1.0, abs(float(jl)))

    def fed_to_bn(name):
        layer, key = name.split(".")
        return batch_norm and layer.startswith("conv") and key == "b"

    def ref(tree, name):
        layer, key = name.split(".")
        return tree[layer][key]

    noise = max([_scaled_dev(ref(jgrads, n), ref(jgrads32, n))
                 for n in params_t if not fed_to_bn(n)])
    bar = max(MODEL_TOL, 2 * noise) if batch_norm else MODEL_TOL
    worst = {}
    for name, p in params_t.items():
        g = grads[name]
        assert g.dtype == p.dtype == torch.float32, name
        if fed_to_bn(name):
            worst[name] = _scaled_dev(g.numpy(), ref(jgrads32, name))
            assert worst[name] <= MODEL_TOL, (name, worst[name])
        else:
            worst[name] = _scaled_dev(g.numpy(), ref(jgrads, name))
            assert worst[name] <= bar, (name, worst[name], bar)
    print(f"batch_norm={batch_norm}: JAX's bf16 noise {noise:.4f}, bar "
          f"{bar:.4f}; gradients max|dev| x max(1,|ref|):",
          {k: round(v, 4) for k, v in worst.items()})


# --- short bf16 runs of the entry points ---------------------------------------

def _dataset(rng, n=8, size=72):
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return DeviceDataset.from_arrays(images, rng.integers(0, 3, n),
                                     device="cpu")


def test_bf16_device_train_steps(rng, monkeypatch):
    """``make_device_train_step(compute_dtype=bf16)`` with the full bf16
    augmentation: finite losses, float32 master parameters, momentum trace
    and BN moving statistics, and bf16 images at conv1 (and at every conv
    kernel)."""
    seen = []
    real = nn_module.conv2d_bias_relu_fn

    def spy(x, w, b, stride, relu):
        seen.append((x.dtype, w.dtype, b.dtype))
        return real(x, w, b, stride, relu)

    monkeypatch.setattr(nn_module, "conv2d_bias_relu_fn", spy)
    ds = _dataset(rng)
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=64, device="cpu")
    at_conv1 = []
    model.net["conv_layer_1"].register_forward_pre_hook(
        lambda mod, args: at_conv1.append(args[0].dtype))
    opt = make_optimizer("momentum", 1e-2, schedule="cosine", total_steps=3)
    ts = create_train_state(model, opt, seed=3)
    augment = functools.partial(aug.augment_batch, out_size=64, dtype=BF16)
    step = make_device_train_step(model, opt, ds, 4, compute_dtype=BF16,
                                  augment_fn=augment)
    losses = []
    for _ in range(3):
        ts, m = step(ts)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and ts.step == 3
    assert at_conv1 == [BF16] * 3
    assert seen == [(BF16, BF16, BF16)] * 12
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32
               for v in ts.opt_state[0].trace.values())
    for layer in model.net:
        if hasattr(layer, "var"):
            assert layer.mean.dtype == layer.var.dtype == torch.float32
            assert layer.mean.abs().sum() > 0   # it moved
    # without an augmentation the uint8 batch is normalized and rounded
    at_conv1.clear()
    plain_step = make_device_train_step(model, opt, ds, 4, compute_dtype=BF16)
    ts, m = plain_step(ts)
    assert at_conv1 == [BF16] and np.isfinite(m["loss"].item())


def test_bf16_train_step_casts_the_augmented_batch(rng):
    """``make_train_step``: an f32 ``augment_fn``'s output is cast to the
    compute dtype, as ``cnn_tpu``'s step does; uint8 without one is
    prepped to it."""
    model = get_model("alexnet", num_classes=3, image_size=64, device="cpu")
    at_conv1 = []
    model.net["conv_layer_1"].register_forward_pre_hook(
        lambda mod, args: at_conv1.append(args[0].dtype))
    opt = make_optimizer("sgd", 1e-2)
    ts = create_train_state(model, opt)
    images, labels = _batch(rng)
    augment = functools.partial(aug.augment_batch_fast, out_size=64)
    for fn in (augment, None):
        step = make_train_step(model, opt, compute_dtype=BF16, augment_fn=fn)
        ts, m = step(ts, _t(images), _t(labels.astype(np.int64)))
        assert np.isfinite(m["loss"].item())
    assert at_conv1 == [BF16, BF16]


def test_bf16_eval_step_and_engine_match_the_eager_forward(rng):
    """``make_eval_step(compute_dtype=bf16)`` and ``InferenceEngine(
    compute_dtype=bf16, device='cpu')``: predictions equal the eager bf16
    forward's argmax (the engine normalizes to float32 and the model casts
    at conv1, which is the same bf16 input)."""
    _, _, _, model = _models(rng)
    images, labels = _batch(rng, n=5)
    model.eval()
    with torch.no_grad():
        logits = model(prep(_t(images), BF16), compute_dtype=BF16).float()
        logits_f = model(uint8_to_float(_t(images)), compute_dtype=BF16)
    assert torch.equal(logits, logits_f.float())
    want = logits.argmax(-1)
    got = make_eval_step(model, compute_dtype=BF16)(
        _t(images), _t(labels.astype(np.int64)))
    assert torch.equal(got["pred"], want)
    assert int(got["correct"]) == int((want == _t(labels)).sum())
    eng = InferenceEngine(model, buckets=(1, 8), device="cpu",
                          compute_dtype=BF16)
    eng.warmup()
    pred, probs = eng.predict(images)
    np.testing.assert_array_equal(pred, want.numpy())
    np.testing.assert_array_equal(
        probs, torch.softmax(logits, dim=-1).numpy())
    assert probs.dtype == np.float32
