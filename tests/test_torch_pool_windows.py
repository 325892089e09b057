"""``max_pool2d`` and ``MaxPool2D`` at any window and stride against
``cnn_tpu`` on the CPU: ``cnn_tpu.ops.max_pool2d`` (``lax.reduce_window``)
and ``jax.vjp`` of it (XLA's select-and-scatter), and the BN AlexNet with
its pool made the overlapping 3x3 stride-2 one (``cnn_tpu``'s
``build_alexnet(batch_norm=True)`` with ``max_pool_1`` replaced).

One input shape, [4, 33, 37, 8] (odd extents), at (k, s) in (2, 2),
(3, 2), (3, 1), (2, 1), (3, 3), float32 and bf16, on noise and on inputs
with exact ties (a ReLU's zeros, a coarse integer grid). Bars:

- forward bit-equal (a maximum is exact in any dtype);
- gradient bit-equal where windows do not overlap (k <= s: each pixel
  takes at most one cotangent); where they do, a pixel sums up to
  ceil(k/s)^2 routed cotangents in another order: 1e-6 x max(1, max|ref|)
  in float32, one bf16 ulp of max|ref| in bf16;
- the 3x3/2 AlexNet at 64 px, batch 4: logits within 1e-4 x max(1,
  max|ref|) (bf16 5e-2, the bf16 model bar), one training step's
  gradients, loss and BN statistics within 1e-4 x max(1, max|ref|) of
  ``jax.grad(_loss_fn)``, and BN folded and served (bucket 8) against
  ``cnn_tpu``'s folded model behind its engine; its serving artifact
  (the pool an ATen op in the program, not the 2x2 kernel's operator)
  served bit-equal to its engine; the whole-model remat step bit-equal to
  the plain step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu import quant as jq
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.nn import MaxPool2D as JMaxPool2D
from cnn_tpu.nn import Sequential as JSequential
from cnn_tpu.ops import max_pool2d as j_max_pool2d
from cnn_tpu.parallel.train_step import _loss_fn as j_loss_fn
from cnn_tpu.serving import InferenceEngine as JInferenceEngine
from cnn_tpu_torch import quant
from cnn_tpu_torch.export import ServingArtifact, export_serving_artifact
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.nn import MaxPool2D
from cnn_tpu_torch.ops.pool import max_pool2d
from cnn_tpu_torch.parallel.train_step import loss_fn, named_params
from cnn_tpu_torch.serving import InferenceEngine
from cnn_tpu_torch.utils import checkpoint as ckpt
from cnn_tpu_torch.utils.flops import _out_shape

SHAPE = (4, 33, 37, 8)
WINDOWS = [(2, 2), (3, 2), (3, 1), (2, 1), (3, 3)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
OVERLAP_F32 = 1e-6     # times max(1, max|ref|)
SIZE = 64
LOGIT_TOL = GRAD_TOL = 1e-4   # times max(1, max|ref|)
BF16_TOL = 5e-2
# a training batch on which no ReLU input or pool window sits within
# float32 reassociation of a tie in either package (the families' rule,
# tests/test_torch_families.py: a flipped decision routes a gradient
# elsewhere, which no tolerance covers)
BATCH_SEED = 0


def _input(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.standard_normal(SHAPE).astype(np.float32)
    if kind == "relu":          # a ReLU's output: about half exact zeros
        return np.maximum(rng.standard_normal(SHAPE), 0).astype(np.float32)
    return rng.integers(-2, 3, SHAPE).astype(np.float32)   # a coarse grid


def _bits(a) -> np.ndarray:
    """A float32 or bf16 tensor or array as the integers of its width."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.view(torch.int16 if a.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype == jnp.bfloat16 else np.int32)


def _bf16_ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


@pytest.mark.parametrize("kind", ["noise", "relu", "grid"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,s", WINDOWS)
def test_max_pool2d_matches_reduce_window(k, s, dtype, kind):
    """The forward bit-equal to ``cnn_tpu.ops.max_pool2d``; the gradient of
    the op and of the layer (``MaxPool2D``: the pool Function for 2x2/2)
    against ``jax.vjp`` at the bars of the module docstring."""
    tdt, jdt = DTYPES[dtype]
    x = _input(kind, 10 * k + s)
    jx = jnp.asarray(x, jdt)
    jy, vjp = jax.vjp(lambda a: j_max_pool2d(a, k, s), jx)
    g = np.random.default_rng(k * s).standard_normal(jy.shape).astype(
        np.float32)
    (jdx,) = vjp(jnp.asarray(g, jdt))
    want = np.asarray(jdx.astype(jnp.float32))
    layer = MaxPool2D("pool", kernel_size=k, stride=s)
    for fn in (lambda t: max_pool2d(t, k, s), layer):
        xt = torch.from_numpy(x).to(tdt).requires_grad_()
        y = fn(xt)
        assert y.dtype == tdt and y.is_contiguous()
        assert y.shape == jy.shape
        np.testing.assert_array_equal(_bits(y), _bits(jy))
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(tdt))
        got = dx.float().numpy()
        if k <= s:
            np.testing.assert_array_equal(_bits(dx), _bits(jdx))
        elif dtype == "float32":
            bar = OVERLAP_F32 * max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got - want).max()) <= bar
        else:
            bar = _bf16_ulp(float(np.abs(want).max()))
            assert float(np.abs(got - want).max()) <= bar
        with torch.no_grad():     # the bare forward of the layer's path
            np.testing.assert_array_equal(
                _bits(fn(torch.from_numpy(x).to(tdt))), _bits(jy))


@pytest.mark.parametrize("k,s", WINDOWS + [(1, 1), (1, 2), (4, 3), (5, 2)])
def test_pool_shapes_match_cnn_tpu(k, s):
    """``MaxPool2D.plan_rows`` (the rows over a ``'spatial'`` axis) and the
    FLOP walk's shape of the layer equal ``cnn_tpu``'s ``out_shape``, at
    every extent from the window up."""
    ours, theirs = MaxPool2D("p", k, s), JMaxPool2D("p", k, s)
    for h in range(k, 40):
        w = h + 3
        ho, wo, c = theirs.out_shape((h, w, 8))
        assert ours.plan_rows(h) == ho and ours.rows == h
        assert _out_shape(ours, (h, w, 8)) == (ho, wo, c)


def _j_model(size: int = SIZE):
    """``cnn_tpu``'s BN AlexNet with ``max_pool_1`` the 3x3 stride-2
    pool."""
    jm = j_get_model("alexnet", num_classes=3, batch_norm=True,
                     image_size=size)
    jm.net = JSequential([JMaxPool2D("max_pool_1", kernel_size=3, stride=2)
                          if l.name == "max_pool_1" else l
                          for l in jm.net.layers])
    return jm


def _model(params, state, size: int = SIZE):
    """The port's BN AlexNet with the same pool, ``cnn_tpu``'s trees
    loaded."""
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=size, device="cpu")
    model.net.layers["max_pool_1"] = MaxPool2D("max_pool_1", 3, 2)
    ckpt.load_jax_params(model, params, state)
    return model


def _weights(seed: int = 4):
    """Trees in the shapes of ``cnn_tpu``'s ``init``, drawn by numpy, BN's
    moving statistics away from 0 and 1."""
    rng = np.random.default_rng(seed)
    jm = _j_model()
    params, state = jax.eval_shape(jm.init, jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        params)
    state = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state)
    return jm, params, state


def _scaled(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, np.abs(want).max()))


def test_overlapping_pool_alexnet_shapes():
    """conv1's 31 rows at 64 px pool to 15, as the 2x2 pool's do, so the
    head keeps its width (at 224 px: 111 -> 55, 4608 features)."""
    jm, params, state = _weights()
    model = _model(params, state)
    assert [l.name for l in model.net] == [l.name for l in jm.layers]
    assert model.net["max_pool_1"].plan_rows(111) == 55
    assert model.net.plan_rows(SIZE) is None and model.net[
        "linear_1"].in_features == 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overlapping_pool_alexnet_logits(dtype):
    jm, params, state = _weights()
    x = np.random.default_rng(1).uniform(0, 1, (4, SIZE, SIZE, 3)).astype(
        np.float32)
    cd = None if dtype == "float32" else jnp.bfloat16
    want, _, _ = jm.apply(params, state, jnp.asarray(x), train=False,
                          compute_dtype=cd)
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad():
        got = _model(params, state).eval()(
            torch.from_numpy(x), compute_dtype=None if cd is None
            else torch.bfloat16).float().numpy()
    assert _scaled(got, want) <= (LOGIT_TOL if cd is None else BF16_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_overlapping_pool_alexnet_step_matches_jax_grad():
    """Training mode at batch 4: the loss, every gradient and the new
    moving statistics within 1e-4 x max(1, max|ref|) of
    ``jax.grad(_loss_fn)``."""
    jm, params, state = _weights()
    x = np.random.default_rng(BATCH_SEED).uniform(
        0, 1, (4, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.arange(4) % 3

    def f(p):
        return j_loss_fn(p, state, jm, jnp.asarray(x), jnp.asarray(labels),
                         None, True, None)
    (jloss, (jstate, _)), jgrads = jax.value_and_grad(f, has_aux=True)(
        params)
    model = _model(params, state).train()
    named = named_params(model)
    loss, _ = loss_fn(model, torch.from_numpy(x), torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(named.values()))
    assert _scaled(loss.item(), float(jloss)) <= GRAD_TOL
    flat = {ckpt.leaf_name(tuple(k.key for k in path)): leaf for path, leaf
            in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(flat) == sorted(named)
    for n, g in zip(named, grads):
        assert _scaled(g.numpy(), flat[n]) <= GRAD_TOL, n
    _, got_state = ckpt.model_trees(model)
    for path, want in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        node = got_state
        for k in path:
            node = node[k.key]
        assert _scaled(node, want) <= GRAD_TOL, path


def test_overlapping_pool_alexnet_folded_serving():
    """BN folded (``quant.fold_batchnorm``) and served at bucket 8 on 5
    images: the labels (int32) equal to those of ``cnn_tpu``'s folded model
    behind its engine, the probabilities within 1e-5."""
    jm, params, state = _weights()
    jfold, jparams = jq.fold_batchnorm(jm, params, state)
    imgs = np.random.default_rng(2).integers(0, 256, (5, SIZE, SIZE, 3),
                                             dtype=np.uint8)
    want_labels, want_probs = JInferenceEngine(
        jfold, jparams, {}, buckets=(8,)).predict(imgs)
    folded = quant.fold_batchnorm(_model(params, state).eval())
    labels, probs = InferenceEngine(folded, buckets=(8,),
                                    device="cpu").predict(imgs)
    assert labels.dtype == want_labels.dtype == np.int32
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(probs, want_probs, atol=1e-5, rtol=0)


def test_overlapping_pool_alexnet_artifact(tmp_path):
    """The exported program records the conv and normalize operators and
    no ``cnn_tpu_torch::max_pool2d_fwd`` (the 3x3 pool is ATen's op); loaded
    and served at bucket 8, its labels and probabilities bit-equal to the
    model's engine."""
    _, params, state = _weights()
    model = _model(params, state).eval()
    path = str(tmp_path / "pool33.ctsa")
    export_serving_artifact(model, path, platforms=("cpu",))
    with open(path, "rb") as f:
        data = f.read()
    assert b"cnn_tpu_torch.conv2d_bias_relu" in data
    assert b"cnn_tpu_torch.uint8_normalize" in data
    assert b"cnn_tpu_torch.max_pool2d_fwd" not in data
    imgs = np.random.default_rng(3).integers(0, 256, (5, SIZE, SIZE, 3),
                                             dtype=np.uint8)
    want = InferenceEngine(model, buckets=(8,), device="cpu").predict(imgs)
    got = InferenceEngine.from_artifact(
        ServingArtifact.load(path, device="cpu"), buckets=(8,)).predict(imgs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_overlapping_pool_alexnet_remat_step():
    """``loss_fn(remat=True)`` (the forward recomputed in the backward)
    gives the plain step's loss and gradients bit for bit."""
    _, params, state = _weights()
    x = torch.from_numpy(np.random.default_rng(BATCH_SEED).uniform(
        0, 1, (4, SIZE, SIZE, 3)).astype(np.float32))
    labels = torch.arange(4) % 3
    got = []
    for remat in (False, True):
        model = _model(params, state).train()
        loss, _ = loss_fn(model, x, labels, remat=remat)
        got.append((loss, *torch.autograd.grad(
            loss, list(named_params(model).values()))))
    assert all(torch.equal(a, b) for a, b in zip(*got))
