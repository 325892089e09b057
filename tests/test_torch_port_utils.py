"""The port's small counterparts of ``cnn_tpu``'s utilities against them on
the CPU: ``utils/flops.py``, ``core/pytree.py``, ``core/rng.py``,
``ops/preprocess.py:normalize`` / ``preprocess_batch`` and
``ops/augment.py:augment_batch_gather`` with its two helpers.

The FLOP counts and tree sizes are integers held with ``==``; the
preprocessing bit for bit (both sides round each float op once, in the same
order); the augmentation oracle's matrices and resample within 1e-5 of JAX's
on JAX's own draws (one JAX compile for the file).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.core import pytree as jpytree
from cnn_tpu.core.rng import RngStream as JRngStream
from cnn_tpu.models import get_model as jget_model
from cnn_tpu.ops import augment as jaug
from cnn_tpu.ops import preprocess as jpre
from cnn_tpu.utils import flops as jflops
from cnn_tpu_torch.core import RngStream
from cnn_tpu_torch.core import pytree
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.ops import augment as aug
from cnn_tpu_torch.ops import preprocess as pre
from cnn_tpu_torch.utils import flops
from cnn_tpu_torch.utils.checkpoint import model_trees

FAMILIES = ["alexnet", "resnet10", "resnet18", "vgg8", "vgg11", "mobilenet",
            "pipecnn", "moecnn"]


@pytest.mark.parametrize("name,kw", [(n, {}) for n in FAMILIES]
                         + [("pipecnn", {"width": 256, "n_blocks": 8})])
def test_flops_equal_cnn_tpu(name, kw):
    """Both counts, at the default 224 px; PipeCNN also at width 256, the
    model of bench.py's deep MFU figure. MoEBlock is not counted on either
    side."""
    ref = jget_model(name, num_classes=3, **kw)
    ours = get_model(name, num_classes=3, device="cpu", **kw)
    assert flops.forward_flops_per_image(ours) == \
        jflops.forward_flops_per_image(ref)
    assert flops.train_flops_per_image(ours) == \
        jflops.train_flops_per_image(ref)


@pytest.mark.parametrize("name", FAMILIES)
def test_tree_sizes_equal_cnn_tpu(name):
    """param_count and tree_bytes of the port's (params, state) trees
    against cnn_tpu's on the shapes of its init (64 px, BN on)."""
    ref = jax.eval_shape(jget_model(name, num_classes=3, image_size=64,
                                    batch_norm=True).init,
                         jax.random.key(0))
    ours = model_trees(get_model(name, num_classes=3, image_size=64,
                                 batch_norm=True, device="cpu"))
    for r, o in ((ref, ours), (ref[0], ours[0]), (ref[1], ours[1])):
        assert pytree.param_count(o) == jpytree.param_count(r)
        assert pytree.tree_bytes(o) == jpytree.tree_bytes(r)


def test_cast_floats_leaves_other_leaves_alone():
    tree = {"w": torch.ones(2, 3), "b": (np.zeros(4, np.float32),
                                         np.arange(3, dtype=np.int32)),
            "n": torch.tensor([1, 2]), "m": torch.tensor([True])}
    out = pytree.cast_floats(tree, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.bfloat16 and isinstance(out["b"], tuple)
    assert out["b"][1] is tree["b"][1] and out["n"] is tree["n"]
    assert out["m"] is tree["m"]
    assert pytree.param_count(tree) == 2 * 3 + 4 + 3 + 2 + 1
    assert pytree.tree_bytes(tree) == 6 * 4 + 4 * 4 + 3 * 4 + 2 * 8 + 1
    ref = jpytree.cast_floats({"a": jnp.ones(2), "i": jnp.arange(2)},
                              jnp.bfloat16)
    assert ref["a"].dtype == jnp.bfloat16 and ref["i"].dtype == jnp.int32


def test_rng_stream():
    """Equal arguments give equal streams; another name, step or seed
    another; the seed folds the root seed, crc32(name) & 0x7FFFFFFF and the
    step as the docstring says. JAX's keys fold the same three."""
    import hashlib
    import zlib
    s = RngStream(212, device="cpu")

    def draw(g):
        return torch.rand(4, generator=g)

    assert torch.equal(draw(s.key("conv")), draw(s.key("conv")))
    assert torch.equal(draw(s.key("conv", 0)),
                       draw(RngStream(212, device="cpu").key("conv")))
    seeds = {s.seed_of(n, k) for n in ("conv", "linear", "dropout")
             for k in (0, 1, 2)}
    assert len(seeds) == 9 and RngStream(213, "cpu").seed_of("conv") \
        not in seeds
    assert not torch.equal(draw(s.key("conv")), draw(s.key("conv", 1)))
    crc = zlib.crc32(b"linear") & 0x7FFFFFFF
    for step, folds in ((0, [212, crc]), (5, [212, crc, 5])):
        data = b"".join(v.to_bytes(8, "little", signed=True) for v in folds)
        want = int.from_bytes(hashlib.sha256(data).digest()[:8], "little") \
            & 0x7FFFFFFFFFFFFFFF
        assert s.seed_of("linear", step) == want
        assert s.key("linear", step).initial_seed() == want
    j = JRngStream(212)
    assert not np.array_equal(jax.random.key_data(j.key("linear")),
                              jax.random.key_data(j.key("linear", 5)))
    if not torch.cuda.is_available():    # device=None is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RngStream(0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocess_bit_equal_cnn_tpu(dtype):
    """Every byte, and random images, through preprocess_batch with and
    without normalize, and normalize alone with other statistics. Bit-equal
    is expected: both sides convert, divide, subtract and divide once each,
    correctly rounded in the dtype. Where cnn_tpu's bf16 would be computed
    in float32 and rounded once, 1 bf16 ulp would be its bar; none is
    needed."""
    rng = np.random.default_rng(8)
    x = np.concatenate([np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
                        .repeat(3, -1),
                        rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for with_norm in (False, True):
        want = np.asarray(jpre.preprocess_batch(jnp.asarray(x), jd, with_norm)
                          .astype(jnp.float32))
        got = pre.preprocess_batch(torch.from_numpy(x), td, with_norm)
        assert got.dtype == td
        assert np.array_equal(got.float().numpy(), want)
    f = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    stats = dict(mean=(0.1, 0.2, 0.3), std=(0.5, 0.25, 2.0))
    want = np.asarray(jpre.normalize(jnp.asarray(f).astype(jd), **stats)
                      .astype(jnp.float32))
    got = pre.normalize(torch.from_numpy(f).to(td), **stats)
    assert np.array_equal(got.float().numpy(), want)


B, S, OUT = 4, 64, 64


@jax.jit
def _jax_oracle(key, images):
    """cnn_tpu's draws, matrices and resample for each image of the batch
    at two policies (the default, and every op on), one compile."""
    keys = jax.random.split(key, B)

    def draws(k):
        k_h, k_v, k_c, k_cy, k_cx, k_r, k_ra, k_rs = jax.random.split(k, 8)
        return jnp.stack([jax.random.uniform(x) for x in (
            k_h, k_v, k_c, k_cy, k_cx, k_r, k_ra, k_rs,
            jax.random.fold_in(k_r, 1))])

    x = images.astype(jnp.float32) / 255.0
    u = jax.vmap(draws)(keys).T
    out = [u]
    for probs in ((0.5, 0.2, 0.7, 0.5), (1.0, 1.0, 1.0, 1.0)):
        mats = jax.vmap(lambda k: jaug._affine_for_sample(k, S, OUT, *probs))(
            keys)
        out += [mats, jax.vmap(lambda im, m: jaug._sample_one(im, m, OUT))(
            x, mats)]
    return out


def test_augment_gather_matches_cnn_tpu_on_its_draws():
    """affine_for_draws on JAX's nine draws against _affine_for_sample (1e-5
    x max(1, |m|); torch's sin/cos can be an ulp off XLA's), sample_affine
    on the same matrices against _sample_one (1e-5), at the default policy
    and with every op on; augment_batch_gather itself: deterministic from
    its generator, [0, 1], the matrices of its own draws."""
    images = np.random.default_rng(9).integers(0, 256, (B, S, S, 3),
                                               dtype=np.uint8)
    u, *rest = _jax_oracle(jax.random.key(4), jnp.asarray(images))
    u = torch.from_numpy(np.array(u))
    x = aug.to_unit(torch.from_numpy(images))
    for probs, mats, want in zip(((0.5, 0.2, 0.7, 0.5), (1.0, 1.0, 1.0, 1.0)),
                                 rest[0::2], rest[1::2]):
        mats, want = np.array(mats), np.asarray(want)
        got_m = aug.affine_for_draws(u, S, OUT, *probs).numpy()
        assert np.abs(got_m - mats).max() <= 1e-5 * max(1.0,
                                                        np.abs(mats).max())
        got = aug.sample_affine(x, torch.from_numpy(mats), OUT).numpy()
        assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5
    g = torch.Generator().manual_seed(3)
    a = aug.augment_batch_gather(g, torch.from_numpy(images), OUT)
    g = torch.Generator().manual_seed(3)
    u2 = aug.draw_rows(g, (9, B))
    b = aug.sample_affine(x, aug.affine_for_draws(u2, S, OUT), OUT)
    assert a.dtype == torch.float32 and a.shape == (B, OUT, OUT, 3)
    assert torch.equal(a, b) and 0.0 <= a.min() and a.max() <= 1.0
