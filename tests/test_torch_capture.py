"""Activation capture (``Sequential.forward(capture=)``) against cnn_tpu's
``apply(capture=)`` on the CPU, at every layer name of the BN and non-BN
AlexNet, and the fusion rule it shares with Grad-CAM's tail replay."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_tpu_torch.nn.module as nn_module
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.nn.sequential import fuses, run_layers
from cnn_tpu_torch.utils.checkpoint import load_jax_params

NAMES = {
    False: ["conv_layer_1", "relu_layer_1", "max_pool_1", "conv_layer_2",
            "relu_layer_2", "conv_layer_3", "relu_layer_3", "conv_layer_4",
            "relu_layer_4", "linear_1"],
    True: ["conv_layer_1", "bn_layer_1", "relu_layer_1", "max_pool_1",
           "conv_layer_2", "bn_layer_2", "relu_layer_2", "conv_layer_3",
           "bn_layer_3", "relu_layer_3", "conv_layer_4", "bn_layer_4",
           "relu_layer_4", "linear_1"],
}


def _pair(rng, batch_norm):
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                         image_size=64)
    params, state = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.key(2)))
    state = {k: {"mean": rng.standard_normal(v["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
             for k, v in state.items()}
    model = get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                      image_size=64, device="cpu").eval()
    load_jax_params(model, params, state)
    return jmodel, params, state, model


@pytest.fixture()
def spy(monkeypatch):
    """The ``relu`` flag of every bare conv launch."""
    seen = []
    real = nn_module.conv2d_bias_relu

    def conv(x, w, b, stride, relu):
        seen.append(relu)
        return real(x, w, b, stride, relu)
    monkeypatch.setattr(nn_module, "conv2d_bias_relu", conv)
    return seen


@pytest.mark.parametrize("batch_norm", [False, True])
def test_every_layer_name_matches_cnn_tpu(rng, batch_norm):
    jmodel, params, state, model = _pair(rng, batch_norm)
    assert [l.name for l in model.net] == NAMES[batch_norm]
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want_out, _, want = jmodel.apply(params, state, jnp.asarray(x),
                                     train=False, capture=NAMES[batch_norm])
    with torch.no_grad():
        out, got = model(torch.from_numpy(x), capture=NAMES[batch_norm])
    assert sorted(got) == sorted(NAMES[batch_norm])
    for name in NAMES[batch_norm]:
        ref = np.asarray(want[name], np.float64)
        dev = np.abs(got[name].double().numpy() - ref).max()
        assert dev <= 1e-5 * max(1.0, np.abs(ref).max()), (name, dev)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_capturing_a_fused_conv_unfuses_only_that_pair(rng, spy, k):
    """Without BN each conv is fused with its ReLU; capturing conv k runs
    that conv with ``relu=False`` (its own, pre-ReLU output) and the plain
    ReLU, and the other three stay fused. The output is the same."""
    jmodel, params, state, model = _pair(rng, False)
    name = f"conv_layer_{k}"
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    _, _, want = jmodel.apply(params, state, jnp.asarray(x), train=False,
                              capture=(name,))
    with torch.no_grad():
        plain = model(torch.from_numpy(x))
        assert spy == [True] * 4
        spy.clear()
        out, got = model(torch.from_numpy(x), capture=(name,))
    assert spy == [i != k for i in range(1, 5)]
    assert (got[name] < 0).any()          # the conv's output, before ReLU
    ref = np.asarray(want[name], np.float64)
    assert np.abs(got[name].double().numpy() - ref).max() <= 1e-5 * max(
        1.0, np.abs(ref).max())
    assert torch.equal(out, plain)


def test_tail_replay_fuses_as_the_forward_does(rng, spy):
    """``run_layers`` on the layers after conv_layer_3 (no BN): the plain
    ReLU, then conv4 fused with its ReLU; the result equals the forward."""
    _, _, _, model = _pair(rng, False)
    layers = list(model.net)
    k = [l.name for l in layers].index("conv_layer_3")
    assert [fuses(layers, i) for i in range(len(layers))].count(True) == 4
    assert not fuses(layers, k, capture=("conv_layer_3",))
    x = torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        out, got = model(x, capture=("conv_layer_3",))
        spy.clear()
        tail = run_layers(layers[k + 1:], got["conv_layer_3"])
    assert spy == [True]
    assert torch.equal(tail, out)


def test_forward_without_capture_returns_the_output(rng):
    _, _, _, model = _pair(rng, True)
    x = torch.zeros(1, 64, 64, 3)
    with torch.no_grad():
        out = model(x)
        out2, got = model(x, capture=())
    assert torch.equal(out, out2) and got == {}
