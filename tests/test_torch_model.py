"""cnn_tpu_torch AlexNet and weight loading against cnn_tpu, on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_tpu_torch.nn.module as nn_module
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.utils import checkpoint as jckpt
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BN_MODEL = os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                        "iter_12000_train_0.997_valid_0.937.model")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_bn_state(state, rng):
    # non-trivial moving statistics, so eval BN is not the identity
    return {k: {"mean": rng.standard_normal(v["mean"].shape).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
            for k, v in state.items()}


@pytest.mark.parametrize("batch_norm,dropout", [(False, 0.0), (True, 0.0),
                                                (True, 0.5)])
def test_alexnet_logits_match_jax(rng, batch_norm, dropout):
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                         dropout=dropout, image_size=64)
    params, state = _np_tree(jmodel.init(jax.random.key(3)))
    state = _randomize_bn_state(state, rng)
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    want, _, _ = jmodel.apply(params, state, jnp.asarray(x), train=False)

    model = get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                      dropout=dropout, image_size=64, device="cpu").eval()
    ckpt.load_jax_params(model, params, state)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    # the logit bar cnn_tpu holds against the reference (docs/DESIGN.md §4)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    assert [l.name for l in model.net] == [l.name for l in jmodel.layers]


@pytest.mark.parametrize("batch_norm,fused", [(False, True), (True, False)])
def test_eval_fuses_conv_and_relu_only_when_adjacent(monkeypatch, batch_norm,
                                                     fused):
    seen = []
    real = nn_module.conv2d_bias_relu

    def spy(x, w, b, stride, relu):
        seen.append(relu)
        return real(x, w, b, stride, relu)

    monkeypatch.setattr(nn_module, "conv2d_bias_relu", spy)
    model = get_model("alexnet", batch_norm=batch_norm, image_size=64,
                      device="cpu").eval()
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    assert seen == [fused] * 4


@pytest.mark.parametrize("batch_norm,dropout", [(True, 0.0), (False, 0.5)])
def test_training_mode_bn_and_dropout_are_refused(batch_norm, dropout):
    """Training-mode dropout without a generator to draw its channels from
    is refused; given one, it drops them. Training-mode BN normalizes by the
    batch statistics and moves the moving ones, so a BN model trains."""
    model = get_model("alexnet", batch_norm=batch_norm, dropout=dropout,
                      image_size=64, device="cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    if dropout > 0:
        with pytest.raises(ValueError, match="generator"):
            model.train()(x)
        y = model.train()(x, generator=torch.Generator().manual_seed(1))
        assert torch.isfinite(y).all()
        return
    bn = model.net["bn_layer_1"]
    mean, var = bn.mean.clone(), bn.var.clone()
    y = model.train()(x)
    assert torch.isfinite(y).all()
    assert not torch.equal(bn.mean, mean) and not torch.equal(bn.var, var)


@pytest.mark.parametrize("batch_norm,fused", [(False, True), (True, False)])
def test_training_runs_the_functions_and_fuses_conv_and_relu(
        monkeypatch, batch_norm, fused):
    """With a gradient asked for, Conv2D and MaxPool2D go through the
    autograd Functions; conv+ReLU still fuse where no BN sits between."""
    seen, pools = [], []
    real_conv, real_pool = nn_module.conv2d_bias_relu_fn, nn_module.max_pool2d_fn

    def conv_spy(x, w, b, stride, relu):
        seen.append(relu)
        return real_conv(x, w, b, stride, relu)

    def pool_spy(x):
        pools.append(x.shape)
        return real_pool(x)

    monkeypatch.setattr(nn_module, "conv2d_bias_relu_fn", conv_spy)
    monkeypatch.setattr(nn_module, "max_pool2d_fn", pool_spy)
    model = get_model("alexnet", batch_norm=batch_norm, image_size=64,
                      device="cpu").train()
    model(torch.rand(2, 64, 64, 3)).sum().backward()
    assert seen == [fused] * 4 and len(pools) == 1
    assert all(p.grad is not None for p in model.parameters())


def test_init_draws_from_the_given_generator():
    def weights(seed):
        m = get_model("alexnet", image_size=64, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
        return torch.cat([p.detach().flatten() for p in m.parameters()])

    assert torch.equal(weights(4), weights(4))
    assert not torch.equal(weights(4), weights(5))
    w = weights(6)
    assert abs(w.std().item() - 0.1) < 0.01    # N(0, 1) / 10, cnn_tpu's init


@pytest.mark.parametrize("batch_norm", [False, True])
def test_param_count_matches_jax(batch_norm):
    jnet = j_get_model("alexnet", batch_norm=batch_norm).net
    model = get_model("alexnet", batch_norm=batch_norm, device="cpu")
    for vectors in (2, 4):
        assert ckpt.reference_param_count(model, vectors) == \
            jckpt.reference_param_count(jnet, vectors)


def test_import_reference_model_matches_jax():
    jnet = j_get_model("alexnet", num_classes=3, batch_norm=True).net
    want_p, want_s = _np_tree(jckpt.import_reference_model(BN_MODEL, jnet))
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      device="cpu")
    params, state = ckpt.import_reference_model(BN_MODEL, model)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(want_p)
    for got, want in zip(jax.tree_util.tree_leaves((params, state)),
                         jax.tree_util.tree_leaves((want_p, want_s))):
        np.testing.assert_array_equal(got, want)

    ckpt.load_reference_model(model, BN_MODEL)
    np.testing.assert_array_equal(
        model.net["conv_layer_2"].w.detach().numpy(),
        want_p["conv_layer_2"]["w"])
    np.testing.assert_array_equal(
        model.net["bn_layer_4"].var.numpy(), want_s["bn_layer_4"]["var"])


def test_import_legacy_two_vector_bn(tmp_path):
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      device="cpu")
    jnet = j_get_model("alexnet", num_classes=3, batch_norm=True).net
    n = ckpt.reference_param_count(model, bn_vectors=2)
    path = tmp_path / "legacy.model"
    np.arange(n, dtype="<f4").tofile(path)
    params, state = ckpt.import_reference_model(path, model)
    want_p, want_s = _np_tree(jckpt.import_reference_model(str(path), jnet))
    for got, want in zip(jax.tree_util.tree_leaves((params, state)),
                         jax.tree_util.tree_leaves((want_p, want_s))):
        np.testing.assert_array_equal(got, want)
    assert (state["bn_layer_1"]["var"] == 1).all()

    np.zeros(n + 1, "<f4").tofile(path)
    with pytest.raises(ValueError):
        ckpt.import_reference_model(path, model)


def test_load_jax_params_rejects_shape_mismatch():
    jmodel = j_get_model("alexnet", num_classes=4, image_size=64)
    params, state = _np_tree(jmodel.init(jax.random.key(0)))
    model = get_model("alexnet", num_classes=3, image_size=64, device="cpu")
    with pytest.raises(ValueError):
        ckpt.load_jax_params(model, params, state)
