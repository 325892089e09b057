"""Channel dropout and the AlexNet options around it, against cnn_tpu on the
CPU: ``channel_dropout`` in its three modes bit for bit given JAX's
permutation, the AlexNet with ``compat_bn`` and ``dropout_compat``, and one
training step with dropout against ``jax.grad(_loss_fn)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.ops.dropout import channel_dropout as j_channel_dropout
from cnn_tpu.parallel.train_step import _loss_fn as j_loss_fn
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.ops import dropout as dropout_ops
from cnn_tpu_torch.ops.dropout import channel_dropout, draw_permutation
from cnn_tpu_torch.parallel.train_step import loss_fn, named_params
from cnn_tpu_torch.utils.checkpoint import load_jax_params

MODES = ("reference", "sampled", "inverted")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [0.25, 0.5])
def test_channel_dropout_bit_equal_given_the_permutation(rng, mode, train,
                                                         dtype, p):
    x = rng.standard_normal((3, 5, 4, 12)).astype(np.float32)
    key = jax.random.key(7)
    perm = np.array(jax.random.permutation(key, 12))
    want = j_channel_dropout(jnp.asarray(x, dtype), p, train=train, rng=key,
                             compat=mode)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = channel_dropout(xt, p, train=train, perm=torch.from_numpy(perm),
                          compat=mode)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if train:     # exactly int(p*C) channels are dropped
        dropped = (got.float() == 0).all(dim=(0, 1, 2)).sum().item()
        assert dropped == int(p * 12)


def test_channel_dropout_refusals():
    x = torch.ones(1, 2, 2, 4)
    with pytest.raises(ValueError, match="unknown dropout compat"):
        channel_dropout(x, 0.5, train=True, compat="spatial")
    with pytest.raises(ValueError, match="permutation"):
        channel_dropout(x, 0.5, train=True, compat="sampled")
    with pytest.raises(ValueError, match="cannot drop all"):
        channel_dropout(x, 1.0, train=True, compat="reference")
    assert channel_dropout(x, 0.0, train=True) is x


def test_draw_permutation_is_a_seeded_permutation():
    a = draw_permutation(128, torch.Generator().manual_seed(3))
    b = draw_permutation(128, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert torch.equal(torch.sort(a).values, torch.arange(128))


@pytest.mark.parametrize("batch_norm", [True, False])
@pytest.mark.parametrize("compat", MODES)
def test_alexnet_compat_options_match_jax(rng, batch_norm, compat):
    """``compat_bn`` starts the moving variance at 0; ``dropout_compat`` sets
    the eval scaling. The fresh moving statistics equal; then, with
    non-trivial ones carried across, eval logits within 1e-4 at 64 px."""
    kw = dict(num_classes=3, batch_norm=batch_norm, dropout=0.5,
              image_size=64, compat_bn=True, dropout_compat=compat)
    jmodel = j_get_model("alexnet", **kw)
    params, state = _np(jmodel.init(jax.random.key(5)))
    model = get_model("alexnet", device="cpu", **kw).eval()
    for layer, st in state.items():
        for k, v in st.items():
            np.testing.assert_array_equal(getattr(model.net[layer], k).numpy(),
                                          v)
    state = {k: {"mean": rng.standard_normal(v["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
             for k, v in state.items()}
    load_jax_params(model, params, state)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want, _, _ = jmodel.apply(params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    assert [l.name for l in model.net] == [l.name for l in jmodel.layers]


def test_space_to_depth_raises_naming_itself():
    """``space_to_depth``, once refused, builds conv1 and conv2 as s2d
    convs (tests/test_torch_s2d.py holds them to cnn_tpu); an s2d conv at
    a stride other than 2 still raises, naming s2d, as cnn_tpu asserts."""
    from cnn_tpu_torch.nn import Conv2D
    model = get_model("alexnet", image_size=64, space_to_depth=True,
                      device="cpu")
    assert [l.s2d for l in model.net if l.name.startswith("conv")] == \
        [True, True, False, False]
    with pytest.raises(AssertionError, match="s2d"):
        Conv2D("conv", 3, 16, 3, 1, s2d=True, device="cpu")


def test_training_dropout_needs_a_generator():
    model = get_model("alexnet", dropout=0.5, image_size=64, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        model.train()(torch.zeros(1, 64, 64, 3))


@pytest.mark.parametrize("batch_norm,compat", [(True, "inverted"),
                                               (False, "sampled"),
                                               (True, "reference")])
def test_train_step_with_dropout_matches_jax_grad(rng, monkeypatch,
                                                  batch_norm, compat):
    """One training-mode forward and backward at 64 px, batch 8, dropout
    0.25 at conv4, the port fed the permutation JAX draws for the layer
    (``fold_in(rng, index)``): the loss within 1e-5, every gradient within
    1e-4 x max(1, max|ref|)."""
    kw = dict(num_classes=3, batch_norm=batch_norm, dropout=0.25,
              image_size=64, dropout_compat=compat)
    jmodel = j_get_model("alexnet", **kw)
    params, state = _np(jmodel.init(jax.random.key(9)))
    x = rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 3, 8).astype(np.int32)
    key = jax.random.key(21)

    def jloss(p):
        return j_loss_fn(p, state, jmodel, jnp.asarray(x), jnp.asarray(y),
                         key, True, None)
    (want_loss, _), want = jax.value_and_grad(jloss, has_aux=True)(params)

    idx = [l.name for l in jmodel.layers].index("dropout_layer_1")
    perm = np.array(jax.random.permutation(jax.random.fold_in(key, idx),
                                           128))
    drawn = []

    def fixed(channels, generator):
        drawn.append(channels)
        return torch.from_numpy(perm)
    monkeypatch.setattr(dropout_ops, "draw_permutation", fixed)
    model = get_model("alexnet", device="cpu", **kw).train()
    load_jax_params(model, params, state)
    named = named_params(model)
    loss, _ = loss_fn(model, torch.from_numpy(x),
                      torch.from_numpy(y.astype(np.int64)),
                      generator=torch.Generator())
    grads = torch.autograd.grad(loss, list(named.values()))
    assert drawn == ([] if compat == "reference" else [128])
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    for (name, _), g in zip(named.items(), grads):
        layer, k = name.split(".")
        ref = np.asarray(want[layer][k], np.float64)
        dev = np.abs(g.double().numpy() - ref).max()
        assert dev <= 1e-4 * max(1.0, np.abs(ref).max()), (name, dev)
