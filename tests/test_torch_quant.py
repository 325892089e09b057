"""``cnn_tpu_torch/quant.py`` against ``cnn_tpu/quant.py`` on the CPU: BN
folding and the int8 graph for AlexNet-BN, ResNet10 (projection
shortcuts), MobileNet (depthwise -> BN), PipeCNN (a stacked trunk) and
MoECNN, at 64 px from the committed checkpoints (AlexNet: the committed
``.model``'s convs and BN, with a seeded dense head for 64 px).

Bars (each test states its own):
- folding: the port's folded logits within 1e-5 x max(1, max|ref|) of
  ``cnn_tpu``'s folded ``apply`` and of the port's unfolded model: the
  folding is re-association only; the folded weights bit-equal to
  ``cnn_tpu``'s;
- int8, layer by layer: weights ``w_q``, their scales and biases
  bit-equal; every int32 accumulator bit-equal when both sides take JAX's
  quantized input and weights (conv, 1x1, the padded stem, depthwise, the
  trunk's blocks, the dense head);
- int8, whole model: logits within 1e-2 x max(1, max|ref|), the same
  argmax.
"""

import functools
import glob
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu import quant as jq
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.utils.checkpoint import import_reference_model as j_import
from cnn_tpu_torch import quant
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.nn import BatchNorm2D, Conv2D, ReLU, Sequential
from cnn_tpu_torch.nn import module as nn_module
from cnn_tpu_torch.nn.module import StackedBlocks
from cnn_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALEXNET_MODEL = os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                             "iter_12000_train_0.997_valid_0.937.model")
MODELS = ("alexnet", "resnet10", "mobilenet", "pipecnn", "moecnn")
SIZE = 64
FOLD_TOL = 1e-5      # times max(1, max|ref|)
INT8_TOL = 1e-2      # times max(1, max|ref|)


def _newest(name):
    return sorted(glob.glob(os.path.join(REPO, "checkpoints", name,
                                         "iter_*.ckpt")),
                  key=lambda p: int(os.path.basename(p).split("_")[1]))[-1]


@functools.lru_cache(maxsize=None)
def _weights(name):
    """``cnn_tpu``'s model at 64 px and numpy (params, state)."""
    jm = j_get_model(name, num_classes=3, image_size=SIZE, batch_norm=True)
    if name == "alexnet":
        full = j_get_model("alexnet", num_classes=3, image_size=224,
                           batch_norm=True)
        params, state = j_import(ALEXNET_MODEL, full.net)
        rng = np.random.default_rng(7)
        params = dict(params, linear_1={
            "w": (rng.standard_normal((128, 3)) * 0.05).astype(np.float32),
            "b": np.zeros(3, np.float32)})
        return jm, params, state
    payload = ckpt.read_checkpoint(_newest(name))
    return jm, payload["params"], payload["state"]


def _model(name):
    _, params, state = _weights(name)
    model = get_model(name, num_classes=3, image_size=SIZE, batch_norm=True,
                      device="cpu")
    ckpt.load_jax_params(model, params, state)
    return model.eval()


def _images(n=6, seed=3):
    # every JAX call takes 6 images: its op-by-op (eager) compilations,
    # cached by shape, then serve the calibration, the fold and the runs
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3),
                                                dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_int8(name):
    jm, params, state = _weights(name)
    return jq.quantize_int8(jm, params, state, _images())


def _scaled(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, np.abs(want).max()))


def _flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + (k,))
        else:
            yield ckpt.leaf_name(pre + (k,)), np.asarray(
                v.detach() if isinstance(v, torch.Tensor) else v)


def _relu_pairs(layers) -> int:
    """Conv2D -> ReLU pairs of a folded layer list, a trunk's n_blocks
    times over, residual bodies included."""
    n = 0
    for i, layer in enumerate(layers):
        if isinstance(layer, StackedBlocks):
            n += layer.n_blocks * _relu_pairs(list(layer.block.body))
        elif isinstance(layer, nn_module.ResidualBlock):
            n += _relu_pairs(list(layer.body))
        elif (isinstance(layer, Conv2D) and i + 1 < len(layers)
              and isinstance(layers[i + 1], ReLU)):
            n += 1
    return n


@pytest.mark.parametrize("name", MODELS)
def test_fold_matches_cnn_tpu(name):
    """The folded model against ``cnn_tpu``'s folded ``apply`` and against
    the unfolded model: logits within 1e-5 x max(1, max|ref|); the folded
    weights bit-equal to ``cnn_tpu``'s (the fold's float32 sqrt rounded as
    XLA's); no BN layer, no state, every other layer's name kept."""
    jm, params, state = _weights(name)
    jfold, jparams = jq.fold_batchnorm(jm, params, state)
    model = _model(name)
    folded = quant.fold_batchnorm(model)
    x = _images(seed=5).astype(np.float32) / 255.0
    want, _, _ = jfold.apply(jparams, {}, jnp.asarray(x))
    with torch.no_grad():
        got = folded(torch.from_numpy(x)).numpy()
        unfolded = model(torch.from_numpy(x)).numpy()
    assert _scaled(got, want) <= FOLD_TOL
    assert _scaled(got, unfolded) <= FOLD_TOL
    mine = {ckpt.leaf_name(p): t.detach().numpy()
            for p, t, _ in folded.net.tree_leaves()}
    theirs = dict(_flat(jparams))
    assert set(mine) == set(theirs)
    assert all(np.array_equal(mine[k], theirs[k]) for k in theirs)
    assert ckpt.model_trees(folded)[1] == {}
    names = [l.name for l in folded.net]
    assert names == [l.name for l in jfold.net.layers]
    assert not any(isinstance(m, BatchNorm2D) for m in folded.modules())


@pytest.mark.parametrize("name", MODELS)
def test_folded_graph_fuses_every_conv_relu(name):
    """After folding, each conv -> BN -> ReLU is conv -> ReLU, which runs
    as one ``relu=True`` launch, in a residual body and in the stacked
    trunk too; every other conv runs ``relu=False``."""
    folded = quant.fold_batchnorm(_model(name))
    calls = []
    real = nn_module.conv2d_bias_relu

    def rec(x, w, b, stride, relu, padding=0):
        calls.append(relu)
        return real(x, w, b, stride, relu, padding)

    with mock.patch.object(nn_module, "conv2d_bias_relu", rec), \
            torch.no_grad():
        folded(torch.zeros((1, SIZE, SIZE, 3)))
    pairs = _relu_pairs(list(folded.net))
    assert pairs > 0 and sum(calls) == pairs
    if name == "resnet10":
        # each block's conv2 adds the shortcut before its ReLU, and the
        # projections have no ReLU of their own
        assert calls.count(False) == 4 + 3


def test_capture_unfuses_a_folded_conv():
    """A captured conv of the folded graph runs ``relu=False`` and returns
    its own output, ``cnn_tpu``'s captured activation within 1e-5 x
    max(1, max|ref|)."""
    jm, params, state = _weights("alexnet")
    jfold, jparams = jq.fold_batchnorm(jm, params, state)
    folded = quant.fold_batchnorm(_model("alexnet"))
    x = _images(seed=9).astype(np.float32) / 255.0
    _, _, want = jfold.apply(jparams, {}, jnp.asarray(x),
                             capture=("conv_layer_2",))
    calls = []
    real = nn_module.conv2d_bias_relu

    def rec(x, w, b, stride, relu, padding=0):
        calls.append(relu)
        return real(x, w, b, stride, relu, padding)

    with mock.patch.object(nn_module, "conv2d_bias_relu", rec), \
            torch.no_grad():
        _, got = folded(torch.from_numpy(x), capture=("conv_layer_2",))
    assert calls == [True, False, True, True]
    assert (got["conv_layer_2"] < 0).any()
    assert _scaled(got["conv_layer_2"].numpy(),
                   want["conv_layer_2"]) <= FOLD_TOL


def test_fold_refuses_a_stateful_layer_it_cannot_fold():
    """A BN that follows no conv raises with ``cnn_tpu``'s message."""
    net = Sequential([Conv2D("c", 3, 8, 3, 2, device="cpu"),
                      ReLU("r"), BatchNorm2D("bn", 8, device="cpu")])
    model = torch.nn.Module()
    model.net, model.image_size, model.num_classes = net, 32, 3
    with pytest.raises(ValueError, match="cannot fold stateful layer bn "
                                         r"\(BatchNorm2D\)"):
        quant.fold_batchnorm(model)


@pytest.mark.parametrize("name", MODELS)
def test_int8_weights_and_scales_match_cnn_tpu(name):
    """``w_q``, ``w_scale`` and ``b`` bit-equal to ``cnn_tpu``'s for every
    conv and the dense head (a trunk's per block); the activation scales
    within 1e-5 relative: they are absmaxes of activations that the two
    sides sum in other orders."""
    _, jqp = _jax_int8(name)
    _, qp = quant.quantize_int8(_model(name), _images())
    mine = dict(_flat(qp))
    theirs = {k: v for k, v in _flat(jqp) if k in mine}
    keys = {k.rsplit(".", 1)[1] for k in theirs}
    assert keys == {"w_q", "w_scale", "b", "in_scale"}
    for k, want in theirs.items():
        got = mine[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k.endswith(".in_scale"):
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k
        else:
            assert np.array_equal(got, want), k


@functools.lru_cache(maxsize=None)
def _jax_int8_run(name):
    """Runs ``cnn_tpu``'s ``quantized_apply`` once, jit off (its trunk scan a
    Python loop), on six images; returns the input, the logits, each
    quantized activation in order, and each s8 x s8 -> s32 product as
    (kind, quantized input, int8 weights, stride, padding, groups, int32
    result)."""
    jfold, jqp = _jax_int8(name)
    records, levels = [], []
    real_conv, real_dot = jax.lax.conv_general_dilated, jax.lax.dot_general
    real_q = jq._q_act

    def conv(lhs, rhs, strides, padding, **kw):
        out = real_conv(lhs, rhs, strides, padding, **kw)
        if kw.get("preferred_element_type") == jnp.int32:
            records.append(("conv", np.asarray(lhs), np.asarray(rhs),
                            strides[0], padding[0][0],
                            kw.get("feature_group_count", 1),
                            np.asarray(out)))
        return out

    def dot(lhs, rhs, dims, **kw):
        out = real_dot(lhs, rhs, dims, **kw)
        if kw.get("preferred_element_type") == jnp.int32:
            records.append(("dense", np.asarray(lhs), np.asarray(rhs), 1, 0,
                            1, np.asarray(out)))
        return out

    def q_act(x, s):
        out = real_q(x, s)
        levels.append(np.asarray(out))
        return out

    x = _images(seed=11).astype(np.float32) / 255.0
    with jax.disable_jit(), \
            mock.patch.object(jax.lax, "conv_general_dilated", conv), \
            mock.patch.object(jax.lax, "dot_general", dot), \
            mock.patch.object(jq, "_q_act", q_act):
        logits = np.asarray(jq.quantized_apply(jfold, jqp, jnp.asarray(x)))
    return x, logits, levels, records


def _kind(rec) -> str:
    kind, qx, w, stride, padding, groups, _ = rec
    if kind == "dense":
        return "dense"
    if groups > 1:
        return "depthwise"
    if w.shape[0] == 1:
        return "1x1"
    return "stem" if w.shape[2] == 3 else "conv"


@pytest.mark.parametrize("name", MODELS)
def test_int8_accumulators_match_cnn_tpu(name):
    """Every int32 accumulator of ``cnn_tpu``'s int8 forward, recomputed by
    the port's products (im2col x ``torch._int_mm`` with its zero padding;
    depthwise as int32 tap sums) from the same quantized input and
    weights: bit-equal, layer by layer, the trunk block by block."""
    records = _jax_int8_run(name)[3]
    kinds = set()
    for rec in records:
        kind, qx, w, stride, padding, groups, want = rec
        qx_t, w_t = torch.from_numpy(qx.copy()), torch.from_numpy(w.copy())
        if kind == "dense":
            m, k = qx.shape
            cols = qx_t.new_zeros((m + quant.MM_ROWS_PAD,
                                   quant._pad_to(k)))
            cols[:m, :k] = qx_t
            got = quant._mm_s32(cols, quant._mm_weights(w_t), m, w.shape[1])
        elif groups > 1:
            got = quant._depthwise_s32(qx_t, w_t, stride, padding)
        else:
            got = quant._conv_s32(qx_t, quant._mm_weights(w_t), w.shape[0],
                                  stride, padding, w.shape[3])
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), (_kind(rec), w.shape)
        kinds.add(_kind(rec))
    want_kinds = {"alexnet": {"stem", "conv", "dense"},
                  "resnet10": {"stem", "conv", "1x1", "dense"},
                  "mobilenet": {"stem", "depthwise", "1x1", "dense"},
                  "pipecnn": {"stem", "conv", "dense"},
                  "moecnn": {"stem", "conv", "dense"}}[name]
    assert kinds == want_kinds
    if name == "pipecnn":        # two convs in each of the 8 blocks
        assert sum(_kind(r) == "conv" for r in records) == 1 + 2 * 8


def _with_jax_leaves(qp, jqp):
    """The port's qparams tree ``qp`` with every leaf taken from
    ``cnn_tpu``'s ``jqp`` (the product operands ``w_mm`` rebuilt from its
    ``w_q``)."""
    out = {}
    for k, v in qp.items():
        if isinstance(v, dict):
            out[k] = _with_jax_leaves(v, jqp[k])
        elif k == "w_mm":
            out[k] = quant._mm_weights(torch.from_numpy(np.array(jqp["w_q"])))
        else:
            out[k] = torch.from_numpy(np.array(jqp[k]))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_int8_logits_match_cnn_tpu(name):
    """The port's ``quantized_apply`` against ``cnn_tpu``'s on the same
    params (``cnn_tpu``'s int8 weights, scales and calibration): logits
    within 1e-2 x max(1, max|ref|), the same argmax.

    Where the two sides' float activations differ by a re-association (a
    residual add, the epilogue), a ``round`` can land one level apart and
    carry on. Counted on these inputs (quantized activations that differ,
    summed over the int8 layers): none in any of the five models. With
    each side's own calibration the scales can sit an ulp apart
    (``test_int8_weights_and_scales_match_cnn_tpu``); then PipeCNN's 16
    trunk convs carry a first flipped level to 3% of its activations, up
    to 5 levels apart, and its logits 8.5e-3 x max(1, max|ref|) apart on
    these inputs; the other four stay bit-equal in every level."""
    _, jqp = _jax_int8(name)
    folded, qp = quant.quantize_int8(_model(name), _images())
    qp = _with_jax_leaves(qp, jqp)
    x, want, jax_levels, _ = _jax_int8_run(name)
    levels = []
    real_q = quant._q_act

    def port_q(x, s):
        out = real_q(x, s)
        levels.append(out.numpy())
        return out

    with mock.patch.object(quant, "_q_act", port_q), torch.no_grad():
        got = quant.quantized_apply(folded, qp, torch.from_numpy(x)).numpy()
    assert _scaled(got, want) <= INT8_TOL
    assert (got.argmax(1) == want.argmax(1)).all()
    assert len(levels) == len(jax_levels)
    assert all(np.array_equal(a, b) for a, b in zip(levels, jax_levels))


def test_depthwise_s32_is_exact():
    """The depthwise int32 tap sums against an int64 reference, with a
    channel multiplier of 2, stride 2 and padding 1, at the extreme
    levels."""
    rng = np.random.default_rng(1)
    qx = rng.integers(-127, 128, (2, 9, 7, 5)).astype(np.int8)
    qx[0, :3] = 127
    w = rng.integers(-127, 128, (3, 3, 1, 10)).astype(np.int8)
    w[..., 0] = -127
    got = quant._depthwise_s32(torch.from_numpy(qx), torch.from_numpy(w),
                               2, 1).numpy()
    xp = np.pad(qx.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros((2, 5, 4, 10), np.int64)
    for dy in range(3):
        for dx in range(3):
            patch = xp[:, dy:dy + 9:2, dx:dx + 7:2, :]
            want += np.repeat(patch, 2, axis=-1) * w[dy, dx, 0].astype(
                np.int64)
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("k,cin,cout,stride,padding,bsz", [
    (3, 3, 16, 2, 0, 1),      # AlexNet conv1: K 27 padded to 32, M 4
    (3, 3, 3, 1, 1, 1),       # N 3 padded to 8
    (1, 16, 24, 2, 0, 2),     # a strided 1x1
])
def test_conv_s32_padding_is_exact(k, cin, cout, stride, padding, bsz):
    """The im2col product with its zero padding (16 rows, K and N to
    multiples of 8) against an int64 reference."""
    rng = np.random.default_rng(2)
    qx = rng.integers(-127, 128, (bsz, 5, 5, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    got = quant._conv_s32(torch.from_numpy(qx),
                          quant._mm_weights(torch.from_numpy(w)), k, stride,
                          padding, cout).numpy()
    xp = np.pad(qx.astype(np.int64), ((0, 0), (padding,) * 2,
                                      (padding,) * 2, (0, 0)))
    ho = (5 + 2 * padding - k) // stride + 1
    want = np.zeros((bsz, ho, ho, cout), np.int64)
    for dy in range(k):
        for dx in range(k):
            patch = xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                       dx:dx + stride * (ho - 1) + 1:stride, :]
            want += patch @ w[dy, dx].astype(np.int64)
    assert np.array_equal(got, want)
