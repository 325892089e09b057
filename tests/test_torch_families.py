"""The ResNet, VGG, MobileNet and PipeCNN families against ``cnn_tpu``'s
``model.apply`` on the CPU: logits from the committed checkpoints at full
width (64 px: the families end in a global average pool, so a small image
runs the full-width weights) and from seeded VGGs, float32 and bf16; one
training step's gradients and BN statistics against
``jax.grad(_loss_fn)``; the tree paths of the params; PipeCNN's remat
modes bit-equal, its BN-free trunk, and the [L]-stacked trees."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.parallel.train_step import _loss_fn as j_loss_fn
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.nn import StackedBlocks
from cnn_tpu_torch.ops.hopper import conv as hconv
from cnn_tpu_torch.parallel.train_step import loss_fn, named_params
from cnn_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the committed checkpoint of each family that has one
CKPTS = {name: sorted(glob.glob(os.path.join(REPO, "checkpoints", name,
                                             "iter_*.ckpt")),
                      key=lambda p: int(os.path.basename(p).split("_")[1]))[-1]
         for name in ("resnet10", "resnet18", "mobilenet", "pipecnn")}
FAMILIES = ("resnet10", "resnet18", "vgg8", "vgg11", "mobilenet", "pipecnn")
LOGIT_TOL = 1e-4      # times max(1, max|ref|): the float32 logit bar
BF16_TOL = 5e-2       # the bf16 model bar (PERF.md §2), x max(1, max|ref|)
GRAD_TOL = 1e-4       # per gradient tensor, times max(1, max|ref|)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _weights(name, rng, size):
    """``cnn_tpu``'s model and (params, state): the committed checkpoint's
    where the family has one, else ``init`` from a seed with non-trivial
    moving statistics."""
    jm = j_get_model(name, num_classes=3, image_size=size, batch_norm=True)
    if name in CKPTS:
        payload = ckpt.read_checkpoint(CKPTS[name])
        return jm, payload["params"], payload["state"]
    params, state = _np_tree(jm.init(jax.random.key(5)))
    state = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state)
    return jm, params, state


def _model(name, params, state, size, **kw):
    model = get_model(name, num_classes=3, image_size=size, batch_norm=True,
                      device="cpu", **kw)
    ckpt.load_jax_params(model, params, state)
    return model


def _size(name):
    return 32 if name.startswith("vgg") else 64


def _scaled_dev(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_logits_match_cnn_tpu(rng, name, dtype):
    size = _size(name)
    jm, params, state = _weights(name, rng, size)
    x = rng.uniform(0, 1, (4, size, size, 3)).astype(np.float32)
    cd = None if dtype == "float32" else jnp.bfloat16
    want, _, _ = jm.apply(params, state, jnp.asarray(x), train=False,
                          compute_dtype=cd)
    want = np.asarray(want.astype(jnp.float32))
    model = _model(name, params, state, size).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), compute_dtype=(
            None if cd is None else torch.bfloat16)).float().numpy()
    tol = LOGIT_TOL if cd is None else BF16_TOL
    assert _scaled_dev(got, want) <= tol
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert [l.name for l in model.net] == [l.name for l in jm.layers]


def _leaf_dict(tree) -> dict:
    return {ckpt.leaf_name(tuple(k.key for k in path)): leaf for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _photos(size: int) -> np.ndarray:
    """The six photos of ``reference_parity.npz`` and the first two
    mirrored, averaged down to ``size`` px, in [0, 1]."""
    fx = np.load(os.path.join(REPO, "tests", "fixtures",
                              "reference_parity.npz"))
    x = np.stack([fx[f"image_u8_{i}"] for i in range(6)]).astype(np.float32)
    x = np.concatenate([x, x[:2, :, ::-1]]) / 255.0
    f = x.shape[1] // size
    return x.reshape(8, size, f, size, f, 3).mean(axis=(2, 4)).astype(
        np.float32)


# each family's training batch (8 images). A ReLU input or a pool window
# within float32 reassociation of a tie (about 1e-7) can take the other
# branch when the sums run in another order, and the gradient then routes
# elsewhere: on uniform noise JAX's own gradients move by up to 1e-2 when
# only the batch's order changes (the committed PipeCNN at 32 px; the
# seeded VGGs and MobileNet on some seeds). The bar is for float32 sums
# reordered with no decision flipped, so each family's batch is one on
# which none flips between the two packages: the seed of its noise below,
# the photos for PipeCNN. No threshold is loosened for the others.
SEEDS = {"resnet10": 0, "resnet18": 0, "vgg8": 0, "vgg11": 1, "mobilenet": 2}


def _batch(name):
    if name == "pipecnn":
        return 32, _photos(32)
    rng = np.random.default_rng(SEEDS[name])
    return 32, rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("name", FAMILIES)
def test_one_step_gradients_match_jax_grad(rng, name):
    """Training mode at batch 8: every gradient, the loss and the new
    moving statistics within 1e-4 x max(1, max|ref|) of
    ``jax.grad(_loss_fn)`` (on the batches of ``_batch``)."""
    size, x = _batch(name)
    jm, params, state = _weights(name, rng, size)
    labels = np.arange(8) % 3

    def f(p):
        return j_loss_fn(p, state, jm, jnp.asarray(x), jnp.asarray(labels),
                         None, True, None)
    (jloss, (jstate, _)), jgrads = jax.value_and_grad(f, has_aux=True)(
        params)
    model = _model(name, params, state, size).train()
    named = named_params(model)
    loss, _ = loss_fn(model, torch.from_numpy(x), torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(named.values()))
    assert _scaled_dev(loss.item(), float(jloss)) <= GRAD_TOL
    flat = _leaf_dict(jgrads)
    assert sorted(flat) == sorted(named)
    for n, g in zip(named, grads):
        assert _scaled_dev(g.numpy(), flat[n]) <= GRAD_TOL, n
    _, got_state = ckpt.model_trees(model)
    for path, want in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        node = got_state
        for k in path:
            node = node[k.key]
        assert _scaled_dev(node, want) <= GRAD_TOL, path


def test_tree_paths_name_the_params():
    """``named_params`` keys are ``cnn_tpu``'s tree paths (layers by "/",
    the key after "."), the stacked trunk's tensors carry the [L] axis, and
    ``model_trees`` nests them exactly as the committed checkpoints do:
    the same paths and shapes, param and state trees alike."""
    res = named_params(get_model("resnet10", device="cpu"))
    assert res["block_2/body/block_2_conv1.w"].shape == (3, 3, 16, 32)
    assert res["block_2/proj.w"].shape == (1, 1, 16, 32)
    assert "block_1/proj.w" not in res
    pipe = get_model("pipecnn", device="cpu")
    named = named_params(pipe)
    assert named["trunk/body/b_conv1.w"].shape == (8, 3, 3, 64, 64)
    assert named["trunk/body/b_bn1.gamma"].shape == (8, 64)

    def shapes(tree):
        return {ckpt.leaf_name(tuple(k.key for k in path)): np.shape(leaf)
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
    for name in CKPTS:
        payload = ckpt.read_checkpoint(CKPTS[name])
        tp, ts = ckpt.model_trees(get_model(name, device="cpu"))
        assert shapes(tp) == shapes(payload["params"])
        assert shapes(ts) == shapes(payload["state"])


@pytest.mark.parametrize("width", [8, 64])
def test_stacked_conv_slices_stay_16_byte_aligned(width):
    """The conv kernels read block i's weights in place, a slice of the
    [L,3,3,C,C] stack: with Cin % 8 == 0 (the shapes the tiled and wgmma
    kernels take) a slice is 9*C*C*4 bytes, whole 16-byte chunks, so every
    slice of the contiguous stack is as aligned as its first; no copy."""
    named = named_params(get_model("pipecnn", width=width, n_blocks=3,
                                   device="cpu"))
    for key in ("trunk/body/b_conv1.w", "trunk/body/b_conv2.w"):
        stack = named[key]
        assert stack.is_contiguous() and stack.data_ptr() % 16 == 0
        for i in range(3):
            assert stack[i].is_contiguous()
            assert stack[i].data_ptr() % 16 == 0, (key, i)


def test_moecnn_and_bad_remat_are_refused():
    """moecnn, once refused, builds (tests/test_torch_moe.py holds it to
    cnn_tpu); a remat mode cnn_tpu does not have is refused."""
    assert type(get_model("moecnn", device="cpu")).__name__ == "MoECNN"
    with pytest.raises(ValueError, match="remat"):
        get_model("pipecnn", remat="scan", device="cpu")


def _pipecnn_step(remat, batch_norm, dropout, counter):
    torch.manual_seed(0)
    model = get_model("pipecnn", width=8, n_blocks=3, image_size=32,
                      batch_norm=batch_norm, remat=remat, dropout=dropout,
                      device="cpu", generator=torch.Generator().manual_seed(4))
    if not batch_norm:   # a non-zero last conv, so the trunk does work
        with torch.no_grad():
            named_params(model)["trunk/body/b_conv2.w"].normal_(0, 0.1)
    model.train()
    x = torch.rand(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.arange(8) % 3
    gen = torch.Generator().manual_seed(7)
    params = named_params(model)
    counter.clear()
    loss, _ = loss_fn(model, x, y, generator=gen)
    counter.append("fwd")
    grads = torch.autograd.grad(loss, list(params.values()))
    _, state = ckpt.model_trees(model)
    return loss, grads, state, gen.get_state()


@pytest.mark.parametrize("batch_norm,dropout", [(True, 0.0), (True, 0.25),
                                                (False, 0.25)])
def test_pipecnn_remat_modes_are_bit_equal(monkeypatch, batch_norm, dropout):
    """remat False, True, 'full' and 'conv': the same loss, gradients, BN
    statistics (updated once per step) and generator state, bit for bit.
    The convs launch 2 per block in the forward; 'full' launches them again
    in the backward's recompute, 'conv' keeps their outputs and does not."""
    calls = []
    real = hconv.conv2d

    def counting(*args):
        calls.append("conv")
        return real(*args)
    monkeypatch.setattr(hconv, "conv2d", counting)
    runs = {}
    for remat in (False, True, "full", "conv"):
        runs[remat] = _pipecnn_step(remat, batch_norm, dropout, calls)
        fwd = calls.index("fwd")
        assert fwd == 2 + 2 * 3
        assert len(calls) - fwd - 1 == (6 if remat in (True, "full") else 0)
    loss0, grads0, state0, gen0 = runs[False]
    for remat, (loss, grads, state, gen) in runs.items():
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), remat
        assert torch.equal(gen, gen0), remat
        for a, b in zip(jax.tree_util.tree_leaves(state),
                        jax.tree_util.tree_leaves(state0)):
            assert np.array_equal(a, b), remat
    if batch_norm:      # the statistics moved from their init, once
        s = state0["trunk"]["body"]["b_bn1"]
        assert not np.allclose(s["mean"], 0.0)
        fresh = get_model("pipecnn", width=8, n_blocks=3, image_size=32,
                          device="cpu")
        fresh.train()
        x = torch.rand(8, 32, 32, 3,
                       generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            fresh(x)
        assert fresh.net["trunk"].n_blocks == 3


def test_pipecnn_without_bn_starts_as_the_identity_trunk(monkeypatch):
    """Without BN the block's last conv is zero (``init_scale`` 0), so the
    trunk passes the stem's output through; the first conv of each block
    runs fused with its ReLU."""
    seen = []
    real = hconv.conv2d_bias_relu

    def spy(x, w, b, stride, relu, padding=0):
        seen.append(relu)
        return real(x, w, b, stride, relu, padding)
    import cnn_tpu_torch.nn.module as nn_module
    monkeypatch.setattr(nn_module, "conv2d_bias_relu", spy)
    model = get_model("pipecnn", width=8, n_blocks=2, image_size=32,
                      batch_norm=False, device="cpu").eval()
    named = named_params(model)
    assert not named["trunk/body/b_conv2.w"].any()
    assert not named["trunk/body/b_conv2.b"].any()
    assert named["trunk/body/b_conv1.w"].any()
    trunk = model.net["trunk"]
    assert isinstance(trunk, StackedBlocks)
    x = torch.rand(2, 8, 8, 8)
    with torch.no_grad():
        assert torch.equal(trunk(x), torch.relu(x))
        model(torch.rand(2, 32, 32, 3))
    # two fused stem convs, then b_conv1 fused and b_conv2 not, per block
    assert seen[-6:] == [True, True, True, False, True, False]
