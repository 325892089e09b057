"""MixUp / CutMix, colour jitter, distillation and gradient accumulation
against cnn_tpu on the CPU: the applies given JAX's draws (threefry and
Philox cannot give the same bits), the distillation losses, and one train
step's gradients and BN statistics against ``jax.value_and_grad(_loss_fn)``
and ``accumulate_grads`` (AlexNet at 64 px, batch 8, random uint8 images:
no ReLU input or pool window within float32 reassociation of a tie)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.ops import augment as j_augment
from cnn_tpu.ops import losses as j_losses
from cnn_tpu.parallel import train_step as j_train_step
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.ops import augment
from cnn_tpu_torch.ops.losses import (distillation_loss,
                                      distillation_loss_from_probs)
from cnn_tpu_torch.optim import make_optimizer
from cnn_tpu_torch.parallel import create_train_state
from cnn_tpu_torch.parallel import train_step
from cnn_tpu_torch.parallel.train_step import named_params, named_state
from cnn_tpu_torch.utils.checkpoint import load_jax_params

GRAD_TOL = 1e-4


def _t(v):
    return None if v is None else torch.from_numpy(np.array(v))


def jax_mix_draw(key, b, h, w, mixup, cutmix) -> augment.MixDraw:
    """The values cnn_tpu's batch_mix draws from ``key``, as a MixDraw."""
    k_perm, k_lam, k_box, k_pick = jax.random.split(key, 4)
    k_cy, k_cx = jax.random.split(k_box)
    both = mixup > 0.0 and cutmix > 0.0
    return augment.MixDraw(
        _t(jax.random.permutation(k_perm, b)).long(),
        _t(jax.random.beta(k_lam, mixup, mixup)) if mixup else None,
        _t(jax.random.beta(k_lam, cutmix, cutmix)) if cutmix else None,
        _t(jax.random.randint(k_cy, (), 0, h)) if cutmix else None,
        _t(jax.random.randint(k_cx, (), 0, w)) if cutmix else None,
        _t(jax.random.bernoulli(k_pick)) if both else None)


def jax_jitter_draw(key, b, strength, dtype) -> augment.JitterDraw:
    k_b, k_c, k_s = jax.random.split(key, 3)
    shape = (b, 1, 1, 1)
    u = [jax.random.uniform(k_b, shape, dtype, -strength, strength),
         jax.random.uniform(k_c, shape, dtype, 1 - strength, 1 + strength),
         jax.random.uniform(k_s, shape, dtype, 1 - strength, 1 + strength)]
    return augment.JitterDraw(*(torch.from_numpy(
        np.array(v, np.float32)).to(_torch_dtype(dtype)) for v in u))


def _torch_dtype(dtype):
    return torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32


MIXES = [(0.2, 0.0), (0.0, 1.0), (0.4, 1.0)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mixup,cutmix", MIXES)
def test_batch_mix_bit_equal_given_jax_draws(rng, mixup, cutmix, seed):
    """float32 images of an odd shape: the mixed batch bit for bit, the
    permutation and lambda exactly (CutMix's from the clipped box)."""
    x = rng.uniform(0, 1, (6, 37, 29, 3)).astype(np.float32)
    key = jax.random.key(seed)
    want, w_perm, w_lam = j_augment.batch_mix(key, jnp.asarray(x), mixup,
                                              cutmix)
    d = jax_mix_draw(key, 6, 37, 29, mixup, cutmix)
    got, perm, lam = augment.apply_mix(torch.from_numpy(x), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(w_perm))
    assert lam.dtype == torch.float32 and lam.item() == float(w_lam)


@pytest.mark.parametrize("mixup,cutmix", MIXES)
def test_batch_mix_bf16_blends_in_the_images_dtype(rng, mixup, cutmix):
    x = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(7)
    want, _, w_lam = j_augment.batch_mix(
        key, jnp.asarray(x, jnp.bfloat16), mixup, cutmix)
    got, _, lam = augment.apply_mix(
        torch.from_numpy(x).bfloat16(), jax_mix_draw(key, 4, 16, 16, mixup,
                                                     cutmix))
    assert got.dtype == torch.bfloat16 and lam.item() == float(w_lam)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2 ** -8)


@pytest.mark.parametrize("strength", [0.1, 0.4])
def test_color_jitter_given_jax_draws(rng, strength):
    """float32: within 1e-6 of cnn_tpu's (the per-image mean is a float32
    sum over H*W*C in XLA's order, which PyTorch's does not repeat; the
    rest is the same elementwise arithmetic), clipped to [0, 1]."""
    x = rng.uniform(0, 1, (5, 24, 20, 3)).astype(np.float32)
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(j_augment.color_jitter(key, jnp.asarray(x),
                                                 strength))
        got = augment.apply_jitter(
            torch.from_numpy(x), jax_jitter_draw(key, 5, strength,
                                                 jnp.float32)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert got.min() >= 0.0 and got.max() <= 1.0


def test_draws_from_a_generator():
    """The port's own draws: a permutation, lambda in [0, 1] with Beta's
    mean, a box centre in the image, both alphas picking each side; the
    jitter factors in their ranges; the same generator state gives the
    same draws."""
    g = torch.Generator().manual_seed(3)
    lams, cuts = [], []
    for _ in range(400):
        d = augment.draw_mix(g, 8, 30, 20, 0.4, 1.0)
        assert sorted(d.perm.tolist()) == list(range(8))
        assert 0 <= d.cy < 30 and 0 <= d.cx < 20
        lams.append(d.lam_mixup.item())
        cuts.append(bool(d.use_cut))
    assert 0.0 <= min(lams) and max(lams) <= 1.0
    assert abs(np.mean(lams) - 0.5) < 0.05 and 0.4 < np.mean(cuts) < 0.6
    j = augment.draw_jitter(g, 64, 0.2)
    assert j.bright.shape == (64, 1, 1, 1)
    assert float(j.bright.abs().max()) <= 0.2
    assert 0.8 <= float(j.contrast.min()) and float(j.sat.max()) <= 1.2
    a = augment.draw_mix(torch.Generator().manual_seed(5), 8, 9, 9, 0.2)
    b = augment.draw_mix(torch.Generator().manual_seed(5), 8, 9, 9, 0.2)
    assert torch.equal(a.perm, b.perm) and a.lam_mixup == b.lam_mixup
    with pytest.raises(ValueError):
        augment.draw_mix(g, 8, 9, 9)


@pytest.mark.parametrize("temp", [1.0, 4.0])
def test_distillation_losses_match_cnn_tpu(rng, temp):
    s = rng.standard_normal((8, 5)).astype(np.float32) * 3
    t = rng.standard_normal((8, 5)).astype(np.float32) * 3
    want = float(j_losses.distillation_loss(jnp.asarray(s), jnp.asarray(t),
                                            temp))
    got = distillation_loss(torch.from_numpy(s), torch.from_numpy(t), temp)
    assert abs(got.item() - want) <= 1e-6 * max(1.0, abs(want))
    # an ensemble mean, one teacher's probability underflowing to 0
    p = np.array(jax.nn.softmax(jnp.asarray(t) / temp, axis=-1))
    p[0] = [1.0, 0.0, 0.0, 0.0, 0.0]
    want = float(j_losses.distillation_loss_from_probs(
        jnp.asarray(s), jnp.asarray(p), temp))
    ts = torch.from_numpy(s).requires_grad_()
    got = distillation_loss_from_probs(ts, torch.from_numpy(p), temp)
    assert np.isfinite(want)
    assert abs(got.item() - want) <= 1e-6 * max(1.0, abs(want))
    jg = jax.grad(lambda a: j_losses.distillation_loss_from_probs(
        a, jnp.asarray(p), temp))(jnp.asarray(s))
    (g,) = torch.autograd.grad(got, ts)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)


# ------------------------------------------------------ one train step ----

def _scaled_dev(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, float(np.abs(want).max())))


def _pair(seed, batch_norm=True):
    """A cnn_tpu AlexNet (64 px) with its init and the port's twin."""
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                         image_size=64)
    params, state = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.key(seed)))
    model = get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                      image_size=64, device="cpu")
    load_jax_params(model, params, state)
    return jmodel, params, state, model


def _batch(rng, n=8):
    images = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, n).astype(np.int32)
    return images, labels


def _assert_grads_and_stats(model, grads, j_grads, j_state):
    for name, g in grads.items():
        layer, key = name.split(".")
        assert _scaled_dev(g.numpy(), j_grads[layer][key]) <= GRAD_TOL, name
    for name, t in named_state(model).items():
        layer, key = name.split(".")
        assert _scaled_dev(t.numpy(), j_state[layer][key]) <= GRAD_TOL, name


def _teachers(spec):
    """cnn_tpu teachers (models, params, states) and the port's twins:
    one BN AlexNet, or a BN and a BN-free one."""
    out = [_pair(21 + i, batch_norm=(i == 0)) for i in range(spec)]
    return ([o[0] for o in out], [o[1] for o in out], [o[2] for o in out],
            [o[3] for o in out])


CASES = ["mixup", "cutmix", "mixup+cutmix", "color_jitter", "distill",
         "distill_2_teachers", "mixup+distill"]


@pytest.mark.parametrize("case", CASES)
def test_train_step_gradients_match_cnn_tpu(rng, monkeypatch, case):
    """One step's loss, gradients and new BN statistics within 1e-4 x
    max(1, max|ref|) of jax.value_and_grad(cnn_tpu's _loss_fn) given the
    same draws: the mix (the port's apply on JAX's draws), the jitter,
    and the teachers' mean tempered softmax on the mixed images."""
    jmodel, params, state, model = _pair(4)
    images, labels = _batch(rng)
    x = images.astype(np.float32) / 255.0
    key = jax.random.key(9)
    mixup = 0.3 if "mixup" in case else 0.0
    cutmix = 1.0 if "cutmix" in case else 0.0
    xt = torch.from_numpy(x)
    if case == "color_jitter":
        x = np.asarray(j_augment.color_jitter(key, jnp.asarray(x), 0.3))
        xt = augment.apply_jitter(xt, jax_jitter_draw(key, 8, 0.3,
                                                      jnp.float32))
    jx, mix = jnp.asarray(x), None
    if mixup or cutmix:
        jx, perm, lam = j_augment.batch_mix(key, jx, mixup, cutmix)
        mix = (perm, lam)
        draw = jax_mix_draw(key, 8, 64, 64, mixup, cutmix)
        monkeypatch.setattr(
            train_step, "batch_mix",
            lambda g, imgs, mixup_alpha, cutmix_alpha:
            augment.apply_mix(imgs, draw))
    dist = distill = None
    if "distill" in case:
        n = 2 if "2_teachers" in case else 1
        jt, tp, tst, tm = _teachers(n)
        dst = j_train_step.normalize_distill((jt, tp, tst, 3.0, 0.4))
        _, _, _, dist = j_train_step.mix_and_teacher_targets(
            key, jx, mixup=0.0, cutmix=0.0, distill=dst,
            t_params=[jax.tree_util.tree_map(jnp.asarray, p) for p in tp],
            t_state=[jax.tree_util.tree_map(jnp.asarray, s) for s in tst],
            compute_dtype=None)
        distill = train_step.normalize_distill((tm if n > 1 else tm[0], 3.0,
                                                0.4))

    fn = jax.jit(jax.value_and_grad(
        lambda p, s, xx, yy, m, d: j_train_step._loss_fn(
            p, s, jmodel, xx, yy, key, True, None, False, 0.0, m, d),
        has_aux=True))
    (j_loss, (j_state, j_correct)), j_grads = fn(
        params, state, jx, jnp.asarray(labels), mix, dist)

    ts = create_train_state(model, make_optimizer("sgd", 0.1))
    grads, loss, correct = train_step.accumulate_grads(
        ts, xt, torch.from_numpy(labels).long(), mixup=mixup, cutmix=cutmix,
        distill=distill)
    assert abs(loss.item() - float(j_loss)) <= GRAD_TOL * max(
        1.0, abs(float(j_loss)))
    assert int(correct) == int(j_correct)
    _assert_grads_and_stats(model, grads, j_grads, j_state)


def test_grad_accum_2_matches_cnn_tpu_and_the_mean_of_its_halves(rng):
    """grad_accum 2 against cnn_tpu's accumulate_grads: the gradients, the
    loss (mean over microbatches), correct (the sum) and the moving
    statistics (updated twice); and the gradients equal the mean of two
    one-microbatch steps on the halves, run in turn."""
    jmodel, params, state, model = _pair(6)
    images, labels = _batch(rng)
    x = images.astype(np.float32) / 255.0
    j_grads, j_state, j_loss, j_correct = jax.jit(
        lambda p, s, xx, yy: j_train_step.accumulate_grads(
            jmodel, p, s, xx, yy, jax.random.key(1), grad_accum=2))(
        params, state, jnp.asarray(x), jnp.asarray(labels))
    ts = create_train_state(model, make_optimizer("sgd", 0.1))
    xt, yt = torch.from_numpy(x), torch.from_numpy(labels).long()
    grads, loss, correct = train_step.accumulate_grads(ts, xt, yt,
                                                       grad_accum=2)
    assert abs(loss.item() - float(j_loss)) <= GRAD_TOL
    assert int(correct) == int(j_correct)
    _assert_grads_and_stats(model, grads, j_grads, j_state)

    _, _, _, twin = _pair(6)
    ts2 = create_train_state(twin, make_optimizer("sgd", 0.1))
    halves = [train_step.accumulate_grads(ts2, xt[i:i + 4], yt[i:i + 4])
              for i in (0, 4)]
    for name, g in grads.items():
        mean = (halves[0][0][name] + halves[1][0][name]) / 2
        assert torch.equal(g, mean), name
    for name, t in named_state(twin).items():
        assert torch.equal(t, named_state(model)[name]), name
    assert loss.item() == ((halves[0][1] + halves[1][1]) / 2).item()


def test_train_step_with_the_toolbox_moves_ema_and_state(rng):
    """make_train_step with MixUp, CutMix, a teacher, grad_accum 2, Adam
    with weight decay and clipping under EMA: a finite loss, the EMA
    count and the model-state average advanced, the EMA the recurrence
    over the weights after each step; ema_weights swaps the averages in
    and the live weights back."""
    from cnn_tpu_torch import optim
    _, _, _, model = _pair(8)
    _, _, _, teacher = _pair(9)
    start = {k: v.detach().clone() for k, v in named_params(model).items()}
    opt = optim.with_ema(optim.make_optimizer(
        "adam", 1e-3, weight_decay=1e-4, grad_clip=1.0), 0.9)
    ts = create_train_state(model, opt, seed=4)
    step = train_step.make_train_step(model, opt, grad_accum=2, mixup=0.2,
                                      cutmix=1.0,
                                      distill=(teacher, 2.0, 0.5))
    images, labels = _batch(rng)
    ema = {k: v.clone() for k, v in start.items()}
    for t in (1, 2):
        ts, m = step(ts, torch.from_numpy(images),
                     torch.from_numpy(labels).long())
        assert torch.isfinite(m["loss"])
        eff = min(np.float32(0.9), np.float32(1 + t) / np.float32(10 + t))
        for k, p in named_params(model).items():
            ema[k] = eff * ema[k] + (1 - eff) * p.detach()
    assert ts.step == 2 and int(ts.opt_state.count) == 2
    assert int(ts.opt_state.inner[1][0].count) == 2    # (clip, adamw)
    for name, e in ts.opt_state.ema.items():
        assert _scaled_dev(e.numpy(), ema[name].numpy()) <= 1e-6, name
    assert any(not torch.equal(m_, s)
               for m_, s in zip(ts.opt_state.mstate.values(),
                                named_state(model).values()))
    live = {k: v.detach().clone() for k, v in named_params(model).items()}
    with train_step.ema_weights(ts):
        for name, e in ts.opt_state.ema.items():
            assert torch.equal(named_params(model)[name], e)
        for name, m_ in ts.opt_state.mstate.items():
            assert torch.equal(named_state(model)[name], m_)
    for name, p in named_params(model).items():
        assert torch.equal(p, live[name]), name
