"""cnn_tpu_torch device augmentation against cnn_tpu, on the CPU.

The rotation's plain version against ``rotate_shear_xla`` (which shares
``_rotate_core`` with the Pallas kernel), and the augment apply against
``cnn_tpu``'s helpers on the same drawn parameters: threefry and Philox
draw different numbers, so the draws are held to their ranges instead.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.ops.augment import _matmul_resample, _resample_matrix
from cnn_tpu.ops.pallas.augment import (_geometry, _shift_vectors,
                                        rotate_shear_xla)
from cnn_tpu.ops.pallas.augment import shear_bounds as j_shear_bounds
from cnn_tpu_torch.ops import augment as aug
from cnn_tpu_torch.ops.hopper import rotate_shear

# fixed angles on both sides of 45 degrees (where the first shear's content
# overflows the S window into the padding), then random ones
DEGREES = [0.0, 15.0, -15.0, 44.0, -44.0, 46.0, -46.0, 60.0, -75.0, 75.0]
EPS32 = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _theta(rng, n_random=3):
    deg = np.array(DEGREES + list(rng.uniform(-75, 75, n_random)), np.float32)
    return np.deg2rad(deg).astype(np.float32)


def _jax_shifts(theta, s, c):
    dims = _geometry(s, c)
    vecs = _shift_vectors(jnp.asarray(theta), s, c, dims["pad_l"],
                          dims["lane"])
    return [np.asarray(v).reshape(len(theta), -1) for v in vecs]


@pytest.mark.parametrize("s", [40, 64, 256])
def test_geometry_matches_jax(s):
    g = aug.geometry(s, 3)
    assert g._asdict() == _geometry(s, 3)
    assert aug.shear_bounds(s) == j_shear_bounds(s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [40, 64])
def test_rotate_core_matches_rotate_shear_xla(rng, s, dtype):
    """The three shears on the same shift vectors: bit-exact in float32 (so
    within the 1e-6 asked), and equal after casting in bf16."""
    theta = _theta(rng)
    x = rng.uniform(0, 1, (len(theta), s, s, 3)).astype(np.float32)
    want = np.asarray(rotate_shear_xla(jnp.asarray(x).astype(dtype),
                                       jnp.asarray(theta)).astype(jnp.float32))
    got = aug.rotate_core_plain(_t(x).to(getattr(torch, dtype)),
                                *map(_t, _jax_shifts(theta, s, 3)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("s", [40, 64])
def test_shift_vectors_match_jax(rng, s):
    """torch's tan/sin differ from XLA's by 1 ulp on a few percent of
    angles, so the shifts agree to 2 ulp of their largest value."""
    theta = _theta(rng, n_random=200)
    for got, want in zip(aug.shift_vectors(_t(theta), s, 3),
                         _jax_shifts(theta, s, 3)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2 * EPS32 * np.abs(want).max())


@pytest.mark.parametrize("s", [40, 64])
def test_rotate_shear_plain_vs_xla(rng, s):
    """The whole plain rotation against ``rotate_shear_xla`` from the
    angles: the 1-ulp trig differences move a shift by at most 2 ulp of
    0.7*S px (4e-6 px at S = 64), which moves a pixel by that times the
    largest step between neighbours (1 here), through three shears: 1e-5."""
    theta = _theta(rng)
    x = rng.uniform(0, 1, (len(theta), s, s, 3)).astype(np.float32)
    want = np.asarray(rotate_shear_xla(jnp.asarray(x), jnp.asarray(theta)))
    for fn in (aug.rotate_shear_plain, rotate_shear):
        got = fn(_t(x), _t(theta)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rotate_zero_angle_is_identity(rng):
    x = rng.uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    got = aug.rotate_shear_plain(_t(x), torch.zeros(2)).numpy()
    np.testing.assert_array_equal(got, x)


def test_rotate_wrapper_checks_and_takes_plain_only_on_cpu():
    with pytest.raises(ValueError):
        rotate_shear(torch.zeros(2, 8, 9, 3), torch.zeros(2))
    with pytest.raises(TypeError):
        rotate_shear(torch.zeros(2, 8, 8, 3, dtype=torch.float64),
                     torch.zeros(2))
    before = rotate_shear.launches
    with pytest.raises(ValueError):
        rotate_shear(torch.zeros(2, 8, 8, 3, device="meta"),
                     torch.zeros(2, device="meta"))
    assert rotate_shear.launches == before


def _params(rng, b, full=True):
    deg = rng.uniform(15, 75, b) * rng.choice([-1, 1], b)
    deg[: b // 3] = 0.0                        # some not rotated
    keep = rng.uniform(0.7, 0.95, b)
    keep[-1] = 1.0                             # one not cropped
    common = dict(hflip=_t(rng.uniform(size=b) < 0.5),
                  vflip=_t(rng.uniform(size=b) < 0.5),
                  keep=_t(keep.astype(np.float32)),
                  uy=_t(rng.uniform(size=b).astype(np.float32)),
                  ux=_t(rng.uniform(size=b).astype(np.float32)))
    if not full:
        return aug.FastParams(**common)
    return aug.FullParams(angle=_t(np.deg2rad(deg).astype(np.float32)),
                          **common)


def _jax_full(images, p, out_size):
    """``augment_batch``'s apply, composed from cnn_tpu's helpers."""
    x = jnp.asarray(images).astype(jnp.float32) / jnp.float32(255.0)
    s = images.shape[1]
    ang = jnp.asarray(p.angle.numpy())
    f = jnp.abs(jnp.cos(ang)) + jnp.abs(jnp.sin(ang))
    rows = []
    for i in range(images.shape[0]):
        wy0 = _resample_matrix(s, s, f[i] * s, s * (1.0 - f[i]) / 2.0,
                               bool(p.vflip[i]))
        wx0 = _resample_matrix(s, s, f[i] * s, s * (1.0 - f[i]) / 2.0,
                               bool(p.hflip[i]))
        rows.append((wy0, wx0))
    j = _matmul_resample(x, jnp.stack([r[0] for r in rows]),
                         jnp.stack([r[1] for r in rows]), jnp.float32)
    j = rotate_shear_xla(j, ang)
    span = jnp.asarray(p.keep.numpy()) * s
    wy1 = jnp.stack([_resample_matrix(
        s, out_size, span[i], float(p.uy[i]) * (s - span[i]), False,
        clamp=True) for i in range(images.shape[0])])
    wx1 = jnp.stack([_resample_matrix(
        s, out_size, span[i], float(p.ux[i]) * (s - span[i]), False,
        clamp=True) for i in range(images.shape[0])])
    return np.asarray(_matmul_resample(j, wy1, wx1, jnp.float32))


def test_apply_full_vs_cnn_tpu_helpers(rng):
    """Place, rotate, crop and resize on the same drawn parameters, 1e-5."""
    b, s, out = 6, 64, 56
    images = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    p = _params(rng, b)
    want = _jax_full(images, p, out)
    got = aug.apply_full(_t(images), p, out).numpy()
    assert got.shape == (b, out, out, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_apply_fast_vs_cnn_tpu_helpers(rng):
    b, s, out = 5, 48, 40
    images = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    p = _params(rng, b, full=False)
    keep = p.keep.numpy()
    wy = jnp.stack([_resample_matrix(
        s, out, keep[i] * s, float(p.uy[i]) * (1.0 - keep[i]) * s,
        bool(p.vflip[i]), jnp.float32(1.0 / 255.0), clamp=True)
        for i in range(b)])
    wx = jnp.stack([_resample_matrix(
        s, out, keep[i] * s, float(p.ux[i]) * (1.0 - keep[i]) * s,
        bool(p.hflip[i]), clamp=True) for i in range(b)])
    want = np.asarray(_matmul_resample(jnp.asarray(images), wy, wx,
                                       jnp.float32))
    got = aug.apply_fast(_t(images), p, out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("policy", ["full", "fast"])
def test_draws_stay_in_their_ranges(policy):
    gen = torch.Generator().manual_seed(0)
    n = 4000
    p = (aug.draw_full(gen, n) if policy == "full" else aug.draw_fast(gen, n))
    keep = p.keep.numpy()
    cropped = keep != 1.0
    assert ((keep[cropped] >= 0.7) & (keep[cropped] <= 0.95)).all()
    assert abs(cropped.mean() - 0.7) < 0.05
    assert abs(p.hflip.float().mean().item() - 0.5) < 0.05
    assert abs(p.vflip.float().mean().item() - 0.2) < 0.05
    for u in (p.uy, p.ux):
        assert ((u >= 0) & (u < 1)).all()
    if policy == "full":
        deg = np.rad2deg(np.abs(p.angle.numpy()))
        rotated = deg != 0.0
        assert ((deg[rotated] >= 15 - 1e-4) & (deg[rotated] <= 75 + 1e-4)).all()
        assert abs(rotated.mean() - 0.5) < 0.05
        assert abs((p.angle.numpy() > 0)[rotated].mean() - 0.5) < 0.05


def test_augment_batch_output(rng):
    gen = torch.Generator().manual_seed(1)
    images = _t(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    for fn in (aug.augment_batch, aug.augment_batch_fast):
        out = fn(gen, images, out_size=48)
        assert out.shape == (4, 48, 48, 3) and out.dtype == torch.float32
        assert torch.isfinite(out).all()
        assert out.min() >= -1e-6 and out.max() <= 1 + 1e-5
    p = aug.draw_full(torch.Generator().manual_seed(2), 4)
    np.testing.assert_array_equal(
        aug.apply_full(images, p, 48).numpy(),
        aug.apply_full(images, p, 48, rotate=aug.rotate_shear_plain).numpy())
    assert math.isclose(aug.to_unit(torch.tensor([255], dtype=torch.uint8))
                        .item(), 1.0)
