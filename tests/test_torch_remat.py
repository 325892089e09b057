"""Whole-model remat (``make_train_step(remat=True)``, ``cnn_tpu``'s
``jax.checkpoint`` of ``apply``) on the CPU, inputs drawn by numpy with
seed 31: the backward recomputes the forward, and the gradients, the loss,
the new state (BN's moving statistics, the MoE load and balance loss) and
the generator are bit-equal to ``remat=False``: AlexNet with BN and
Dropout, MoECNN with a balance loss, PipeCNN whose trunk keeps its own
``remat='conv'`` inside, two microbatches, and two steps of
``make_train_step``; and MoECNN's remat gradients against ``cnn_tpu``'s
``_loss_fn(remat=True)`` within 1e-4 x max(1, max|ref|)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.parallel.train_step import _loss_fn as j_loss_fn
import cnn_tpu_torch.nn.module as nn_module
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.optim import make_optimizer
from cnn_tpu_torch.parallel import create_train_state, make_train_step
from cnn_tpu_torch.parallel.train_step import (accumulate_grads,
                                               named_params, named_state)
from cnn_tpu_torch.utils import checkpoint as ckpt

SEED = 31
MODELS = {
    "alexnet": dict(num_classes=3, batch_norm=True, dropout=0.5,
                    image_size=64),
    "moecnn": dict(num_classes=3, width=16, n_experts=4, expert_hidden=32,
                   image_size=32, balance_coeff=0.01),
    "pipecnn": dict(num_classes=3, width=8, n_blocks=3, image_size=32,
                    dropout=0.25, remat="conv"),
}


def _batch(name, n=8):
    rng = np.random.default_rng(SEED)
    size = MODELS[name]["image_size"]
    x = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    return torch.from_numpy(x), torch.arange(n) % 3


def _run(name, remat, grad_accum=1):
    """One ``accumulate_grads`` from the same weights, batch and generator
    seed; returns the loss, the gradients, the state, the generator's
    state and the conv launches."""
    torch.manual_seed(0)
    model = get_model(name, device="cpu",
                      generator=torch.Generator().manual_seed(SEED),
                      **MODELS[name])
    ts = create_train_state(model, make_optimizer("sgd", 0.1), seed=SEED)
    x, y = _batch(name)
    calls = []
    real = nn_module.conv2d_bias_relu_fn

    def counted(*args):
        calls.append(1)
        return real(*args)
    with mock.patch.object(nn_module, "conv2d_bias_relu_fn", counted):
        grads, loss, _ = accumulate_grads(ts, x, y, grad_accum=grad_accum,
                                          remat=remat)
    state = {k: v.clone() for k, v in named_state(model).items()}
    return loss, grads, state, ts.rng.get_state(), len(calls)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("name", list(MODELS))
def test_remat_is_bit_equal(name, grad_accum):
    """The gradients, loss, new state and generator bit-equal with and
    without remat; with remat the forward ran twice (its convs launch
    again in the backward), but for PipeCNN's trunk, whose own 'conv'
    policy keeps its conv outputs."""
    plain = _run(name, False, grad_accum)
    again = _run(name, True, grad_accum)
    assert torch.equal(plain[0], again[0])
    assert sorted(plain[1]) == sorted(again[1])
    for k, g in plain[1].items():
        assert torch.equal(g, again[1][k]), k
    for k, v in plain[2].items():
        assert torch.equal(v, again[2][k]), k
    assert torch.equal(plain[3], again[3])
    if name == "moecnn":
        assert {"moe.load", "moe.aux_loss"} <= set(plain[2])
    assert again[4] > plain[4]


def test_train_step_remat_is_bit_equal():
    """``make_train_step(remat=True)``: two steps on uint8 images (the
    normalize, Dropout drawn from ``ts.rng``, the momentum update) land on
    the same params, state, generator and loss as without remat."""
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.integers(0, 256, (8, 64, 64, 3),
                                           dtype=np.uint8))
    labels = torch.arange(8) % 3
    out = {}
    for remat in (False, True):
        model = get_model("alexnet", device="cpu",
                          generator=torch.Generator().manual_seed(SEED),
                          **MODELS["alexnet"])
        opt = make_optimizer("momentum", 0.05)
        ts = create_train_state(model, opt, seed=SEED)
        step = make_train_step(model, opt, remat=remat)
        for _ in range(2):
            ts, m = step(ts, images, labels)
        out[remat] = ({**named_params(model), **named_state(model)},
                      ts.rng.get_state(), m["loss"])
    for k, v in out[False][0].items():
        assert torch.equal(v, out[True][0][k]), k
    assert torch.equal(out[False][1], out[True][1])
    assert torch.equal(out[False][2], out[True][2])


def test_moecnn_remat_grads_match_cnn_tpu():
    """MoECNN (balance 0.01) with numpy-drawn weights: the remat step's
    loss and gradients against ``jax.grad`` of ``_loss_fn(remat=True)``."""
    rng = np.random.default_rng(SEED)
    kw = MODELS["moecnn"]
    jm = j_get_model("moecnn", **kw)
    params, state = jax.eval_shape(jm.init, jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        params)
    state = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state)
    x, y = _batch("moecnn")
    (jl, _), jg = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True),
                          static_argnums=(2, 6, 7, 8))(
        params, state, jm, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
        jax.random.key(0), True, None, True)
    model = get_model("moecnn", device="cpu", **kw)
    ckpt.load_jax_params(model, params, state)
    ts = create_train_state(model, make_optimizer("sgd", 0.1))
    grads, loss, _ = accumulate_grads(ts, x, y, remat=True)
    assert abs(float(loss) - float(jl)) <= 1e-4 * max(1.0, abs(float(jl)))
    jflat = {ckpt.leaf_name(tuple(k.key for k in path)): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    for name, g in grads.items():
        ref = jflat[name].astype(np.float64)
        assert np.abs(g.numpy() - ref).max() <= 1e-4 * max(
            1.0, np.abs(ref).max()), name
