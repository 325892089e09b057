"""The cnn_tpu_torch training slice against cnn_tpu, on the CPU: optimizer
and schedules, one train step from a carried-across ``TrainState``, the
full-width gradient fixture of the reference C++, the eval step, and the
device dataset's samplers."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.optim import make_optimizer as j_make_optimizer
from cnn_tpu.optim import make_schedule as j_make_schedule
from cnn_tpu.parallel.train_step import create_train_state as j_create_state
from cnn_tpu.parallel.train_step import make_eval_step as j_make_eval_step
from cnn_tpu.parallel.train_step import make_train_step as j_make_train_step
from cnn_tpu_torch.data import DeviceDataset, make_device_train_step
from cnn_tpu_torch.data.device_dataset import epoch_indices
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch import optim
from cnn_tpu_torch.optim import make_optimizer, make_schedule, sgd
from cnn_tpu_torch.parallel import (create_train_state, make_eval_step,
                                    make_train_step)
from cnn_tpu_torch.parallel.mesh import make_mesh
from cnn_tpu_torch.parallel.train_step import named_params
from cnn_tpu_torch.utils.checkpoint import (import_reference_array,
                                            load_jax_params,
                                            load_jax_train_state)

FIXTURES = {bn: os.path.join(os.path.dirname(__file__), "fixtures", name)
            for bn, name in ((True, "grad_parity_bn.npz"),
                             (False, "grad_parity.npz"))}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scaled_dev(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("constant", 4),
                                             ("cosine", 0), ("cosine", 5),
                                             ("step", 0)])
def test_schedules_match_optax(schedule, warmup):
    want = j_make_schedule(0.05, schedule, total_steps=20, warmup_steps=warmup)
    got = make_schedule(0.05, schedule, total_steps=20, warmup_steps=warmup)
    if isinstance(want, float):
        assert got == want
        return
    for count in range(25):
        assert abs(got(count) - float(want(count))) <= 1e-6 * 0.05, count


@pytest.mark.parametrize("name,momentum,schedule", [
    ("sgd", 0.0, "constant"), ("momentum", 0.0, "cosine"),
    ("sgd", 0.5, "step"), ("momentum", 0.0, "constant")])
def test_optimizer_matches_optax_over_20_steps(rng, name, momentum, schedule):
    """The same fixed gradients through both optimizers, 20 updates: the
    params and optax's trace and count, 1e-6."""
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(20)]
    jopt = j_make_optimizer(name, 0.1, momentum, schedule, total_steps=20)
    opt = make_optimizer(name, 0.1, momentum, schedule, total_steps=20)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    state = opt.init(tp)
    for g in grads:
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        opt.update({k: torch.tensor(v) for k, v in g.items()}, state, tp)
    for k in params:
        assert _scaled_dev(tp[k].numpy(), jp[k]) <= 1e-6
    if name == "sgd" and not momentum and schedule == "constant":
        assert state == () == jstate    # the reference's plain SGD
        return
    if momentum or name == "momentum":
        for k in params:
            assert _scaled_dev(state[0].trace[k].numpy(),
                               jstate[0].trace[k]) <= 1e-6
    else:
        assert state[0] == optim.EmptyState()
    if schedule != "constant":    # optax counts only on a schedule
        assert int(state[1].count) == int(jstate[1].count) == 20
    else:
        assert state[1] == optim.EmptyState()


def test_plain_sgd_is_the_reference_update(rng):
    p = {"w": torch.tensor(rng.standard_normal(6).astype(np.float32))}
    g = {"w": torch.tensor(rng.standard_normal(6).astype(np.float32))}
    want = p["w"] - 0.01 * g["w"]
    opt = sgd(0.01)
    opt.update(g, opt.init(p), p)
    np.testing.assert_array_equal(p["w"].numpy(), want.numpy())


@pytest.mark.parametrize("flag", [dict(weight_decay=1e-4),
                                  dict(grad_clip=1.0), dict(name="adam")])
def test_optimizer_options_not_ported_raise(rng, flag):
    """Weight decay, the clip and Adam, once refused, now run: five
    updates within 1e-6 of cnn_tpu's (every branch and the state:
    tests/test_torch_optim_toolbox.py)."""
    kw = dict(name="momentum", learning_rate=0.1) | flag
    opt, jopt = make_optimizer(**kw), j_make_optimizer(**kw)
    p = rng.standard_normal((4, 3)).astype(np.float32)
    tp, jp = {"w": torch.tensor(p)}, {"w": jnp.asarray(p)}
    state, jstate = opt.init(tp), jopt.init(jp)
    for _ in range(5):
        g = rng.standard_normal(p.shape).astype(np.float32)
        opt.update({"w": torch.tensor(g)}, state, tp)
        jp, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jp)
    assert _scaled_dev(tp["w"].numpy(), jp["w"]) <= 1e-6


def _carried_step(rng, batch_norm):
    """One JAX step to fill the momentum trace, carry the state across, then
    the next step on both sides."""
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                         image_size=64)
    jopt = j_make_optimizer("momentum", 1e-2, schedule="cosine",
                            total_steps=10)
    jstep = j_make_train_step(jmodel, jopt, donate=False)
    ts = j_create_state(jmodel, jopt, jax.random.key(1))
    images = rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, 8).astype(np.int32)
    ts, _ = jstep(ts, jnp.asarray(images), jnp.asarray(labels))

    model = get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                      image_size=64, device="cpu")
    opt = make_optimizer("momentum", 1e-2, schedule="cosine", total_steps=10)
    pts = create_train_state(model, opt)
    load_jax_train_state(pts, _np(ts.params), _np(ts.state),
                         _np(ts.opt_state), int(ts.step))
    ts, jm = jstep(ts, jnp.asarray(images), jnp.asarray(labels))
    pts, m = make_train_step(model, opt)(pts, torch.from_numpy(images),
                                         torch.from_numpy(labels))
    return ts, jm, pts, m


@pytest.mark.parametrize("batch_norm", [True, False])
def test_train_step_from_carried_state_matches_jax(rng, batch_norm):
    """alexnet at 64 px, batch 8, momentum on a cosine schedule: loss,
    params after the step, BN state and momentum trace within
    1e-5 * max(1, max|ref|). Without BN the conv and ReLU run fused, the
    Function carrying the ReLU mask."""
    ts, jm, pts, m = _carried_step(rng, batch_norm)
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * max(
        1.0, abs(float(jm["loss"])))
    assert int(m["correct"]) == int(jm["correct"])
    assert pts.step == int(ts.step) and int(pts.opt_state[1].count) == int(
        ts.opt_state[1].count)
    for name, p in named_params(pts.model).items():
        layer, key = name.split(".")
        assert _scaled_dev(p.detach().numpy(), ts.params[layer][key]) <= 1e-5
        assert _scaled_dev(pts.opt_state[0].trace[name].numpy(),
                           ts.opt_state[0].trace[layer][key]) <= 1e-5, name
    for layer, st in ts.state.items():
        for key in ("mean", "var"):
            got = getattr(pts.model.net[layer], key).numpy()
            assert _scaled_dev(got, st[key]) <= 1e-5, (layer, key)


@pytest.mark.parametrize("batch_norm", [True, False])
def test_grad_parity_full_width_step(batch_norm):
    """One step at lr 1 on the reference C++'s 4-image fixture, AlexNet at
    224 px, at the bars of tests/test_grad_parity.py: logits 1e-4, loss
    1e-5, each gradient 1e-4 * max(1, max|ref|) (BN's B times the
    mean-loss gradient), moving statistics 1e-4."""
    fx = np.load(FIXTURES[batch_norm])
    model = get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                      image_size=224, device="cpu")
    p0, s0 = import_reference_array(fx["before"], model.net)
    p1, s1 = import_reference_array(fx["after_lr1"], model.net)
    load_jax_params(model, p0, s0)
    x = torch.from_numpy(fx["images_u8"])
    y = torch.from_numpy(fx["labels"].astype(np.int64))
    before = {k: v.detach().clone() for k, v in named_params(model).items()}
    logits = []
    hook = model.net.layers["linear_1"].register_forward_hook(
        lambda mod, args, out: logits.append(out.detach()))
    opt = sgd(1.0)
    ts, m = make_train_step(model, opt)(create_train_state(model, opt), x, y)
    hook.remove()
    np.testing.assert_allclose(logits[0].numpy(), fx["logits"], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(m["loss"].item(), float(fx["loss"]),
                               atol=1e-5, rtol=1e-5)
    for name, p in named_params(model).items():
        layer, key = name.split(".")
        ours = (before[name] - p.detach()).double().numpy()
        ref = np.float64(p0[layer][key]) - np.float64(p1[layer][key])
        if layer.startswith("bn"):
            ours = x.shape[0] * ours
        if batch_norm and layer.startswith("conv") and key == "b":
            # a conv bias feeding BN has an analytically zero gradient
            assert np.abs(ref).max() < 5e-4 and np.abs(ours).max() < 5e-4
            continue
        assert np.abs(ours - ref).max() <= 1e-4 * max(
            1.0, float(np.abs(ref).max())), name
    for layer, st in s1.items():
        for key in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(model.net[layer], key).numpy(), st[key], atol=1e-4,
                rtol=0)


def test_eval_step_matches_jax(rng):
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=True,
                         image_size=64)
    params, state = _np(jmodel.init(jax.random.key(4)))
    state = {k: {"mean": rng.standard_normal(v["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
             for k, v in state.items()}
    images = rng.integers(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    want = j_make_eval_step(jmodel)(params, state, jnp.asarray(images),
                                    jnp.asarray(labels))
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=64, device="cpu")
    load_jax_params(model, params, state)
    got = make_eval_step(model)(torch.from_numpy(images),
                                torch.from_numpy(labels))
    assert abs(got["loss"].item() - float(want["loss"])) <= 1e-5
    assert int(got["correct"]) == int(want["correct"])
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(want["pred"]))


@pytest.mark.parametrize("n,bs", [(10, 4), (12, 4), (7, 7)])
def test_epoch_sampler_visits_each_sample_once_per_epoch(n, bs):
    steps = 3 * n // bs + 1
    seen = torch.cat([epoch_indices(11, s, bs, n, False, "cpu")
                      for s in range(steps)]).numpy()
    for e in range(len(seen) // n):
        assert sorted(seen[e * n:(e + 1) * n]) == list(range(n))
    perms = [seen[e * n:(e + 1) * n].tolist() for e in range(len(seen) // n)]
    assert len({tuple(p) for p in perms}) > 1     # reshuffled each epoch


def test_epoch_fixed_sampler_repeats_its_permutation():
    n, bs = 9, 4
    seen = torch.cat([epoch_indices(3, s, bs, n, True, "cpu")
                      for s in range(3 * n // bs)]).numpy()
    assert sorted(seen[:n]) == list(range(n))
    np.testing.assert_array_equal(seen[:n], seen[n:2 * n])
    assert epoch_indices(3, 0, bs, n, True, "cpu").tolist() == \
        epoch_indices(3, 0, bs, n, False, "cpu").tolist()


def _tiny_dataset(rng, n=24, size=72):
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return DeviceDataset.from_arrays(images, rng.integers(0, 3, n),
                                     device="cpu")


@pytest.mark.parametrize("mode", ["local", "epoch", "epoch_fixed"])
def test_device_train_step_runs_every_sample_mode(rng, mode):
    from cnn_tpu_torch.ops.augment import augment_batch
    ds = _tiny_dataset(rng)
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=64, device="cpu",
                      generator=torch.Generator().manual_seed(2))
    opt = make_optimizer("momentum", 1e-2, schedule="cosine", total_steps=4)
    ts = create_train_state(model, opt, seed=5)
    step = make_device_train_step(
        model, opt, ds, 8, sample_mode=mode,
        augment_fn=lambda g, x: augment_batch(g, x, out_size=64))
    for _ in range(2):
        ts, m = step(ts)
        assert torch.isfinite(m["loss"]) and m["batch"] == 8
    assert ts.step == 2 and int(ts.opt_state[1].count) == 2


def test_device_train_step_without_augment_normalizes(rng):
    """augment_fn=None: the sampled uint8 batch goes through the normalize
    kernel, so the step equals make_train_step on that batch."""
    ds = _tiny_dataset(rng, size=64)
    runs = []
    for device_step in (True, False):
        model = get_model("alexnet", num_classes=3, batch_norm=True,
                          image_size=64, device="cpu")
        opt = make_optimizer("momentum", 1e-2)
        ts = create_train_state(model, opt, seed=9)
        if device_step:
            ts, m = make_device_train_step(model, opt, ds, 6)(ts)
        else:
            images, labels = ds.sample(ts.rng, 6)
            ts, m = make_train_step(model, opt)(ts, images, labels)
        runs.append((m["loss"].item(),
                     {k: v.detach().clone() for k, v in
                      named_params(model).items()}))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k])


@pytest.mark.parametrize("flag", [
    dict(grad_accum=2), dict(steps_per_call=4), dict(mixup=0.2),
    dict(cutmix=1.0), dict(distill="teacher"), dict(mesh="mesh"),
    dict(compute_dtype=torch.float16)])
def test_device_train_step_options_not_ported_raise(rng, flag):
    """float16 stays refused; grad_accum, steps_per_call, MixUp, CutMix and
    distillation, once refused, now run a step (held against cnn_tpu in
    tests/test_torch_mix_distill.py); so does a mesh, where the dataset is
    on it (another dataset's is refused; sharded runs:
    tests/test_torch_parallel.py)."""
    ds = _tiny_dataset(rng, n=4, size=64)
    model = get_model("alexnet", image_size=64, device="cpu")
    opt = make_optimizer("sgd", 0.1)
    if "compute_dtype" in flag:
        with pytest.raises(NotImplementedError):
            make_device_train_step(model, opt, ds, 2, **flag)
        return
    if "mesh" in flag:
        mesh = make_mesh(device="cpu")
        with pytest.raises(ValueError, match="same mesh"):
            make_device_train_step(model, opt, ds, 2, mesh=mesh)
        ds = DeviceDataset.from_arrays(ds.images.numpy(), ds.labels.numpy(),
                                       mesh=mesh)
        flag = dict(mesh=mesh)
    if "distill" in flag:
        flag = dict(distill=(get_model("alexnet", image_size=64,
                                       device="cpu"), 2.0, 0.5))
    ts = create_train_state(model, opt, seed=3)
    ts, m = make_device_train_step(model, opt, ds, 2, **flag)(ts)
    k = flag.get("steps_per_call", 1)
    assert ts.step == k and m["batch"] == 2 * k
    assert torch.isfinite(m["loss"]) and 0 <= int(m["correct"]) <= 2 * k
