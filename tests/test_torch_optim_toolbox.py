"""The port's optimizer toolbox against cnn_tpu's on the CPU: every branch
of ``make_optimizer`` (weight decay, the global-norm clip, Adam and AdamW,
the schedules), ``with_ema`` over each and ``with_frozen``, 20 updates on
seeded numpy gradients over a small AlexNet param tree; then the optimizer
states through the checkpoint both ways, warm start, and every committed
EMA and weight-decay checkpoint read in both packages."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu import optim as j_optim
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.parallel.train_step import create_train_state as j_create_state
from cnn_tpu.utils import checkpoint as jck
from cnn_tpu_torch import optim
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.parallel import create_train_state
from cnn_tpu_torch.parallel.train_step import named_params, named_state
from cnn_tpu_torch.utils import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
STEPS = 20

# make_optimizer's branches: (name, momentum, schedule, warmup,
# weight_decay, grad_clip)
BRANCHES = {
    "sgd": ("sgd", 0.0, "constant", 0, 0.0, 0.0),
    "sgd_cosine": ("sgd", 0.0, "cosine", 0, 0.0, 0.0),
    "momentum": ("momentum", 0.0, "constant", 0, 0.0, 0.0),
    "momentum_clip": ("momentum", 0.0, "step", 0, 0.0, 0.5),
    "momentum_decay_clip": ("momentum", 0.0, "constant", 0, 1e-2, 1.0),
    "sgd_decay_cosine": ("sgd", 0.0, "cosine", 0, 1e-2, 0.0),
    "sgd_clip": ("sgd", 0.0, "constant", 0, 0.0, 0.5),
    "adam": ("adam", 0.0, "constant", 0, 0.0, 0.0),
    "adam_cosine_clip": ("adam", 0.0, "cosine", 3, 0.0, 0.5),
    "adamw": ("adam", 0.0, "constant", 0, 1e-2, 0.0),
    "adamw_warmup_clip": ("adam", 0.0, "constant", 4, 1e-2, 1.0),
}

# the optimizer state classes, by name in either package
CLASSES = {"EmptyState", "TraceState", "ScaleByScheduleState",
           "ScaleByAdamState", "EmaState"}


def _flat(node, path=""):
    """(path, leaf) of an optimizer state in either package, the classes
    by name, dict keys sorted; None as its own leaf."""
    if node is None:
        yield path, None
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _flat(node[k], f"{path}/{k}")
    elif hasattr(node, "_fields"):
        name = type(node).__name__
        assert name in CLASSES, name
        if not node._fields:
            yield f"{path}<{name}>", ()
        for f, v in zip(node._fields, node):
            yield from _flat(v, f"{path}<{name}>.{f}")
    elif isinstance(node, tuple):
        if not node:
            yield f"{path}()", ()
        for i, v in enumerate(node):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(node)


def _assert_states_close(got, want, tol=TOL):
    """The port's state (as pickled) and cnn_tpu's: the same nesting and
    every leaf within ``tol`` x max(1, max|ref|)."""
    g = list(_flat(ck.pickled_state(got)))
    w = list(_flat(jax.tree_util.tree_map(np.asarray, want)))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if b is None or isinstance(b, tuple):
            assert a is None or isinstance(a, tuple), path
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                            b.dtype)
        b64 = b.astype(np.float64)
        dev = np.abs(a.astype(np.float64) - b64).max() if b.size else 0.0
        assert dev <= tol * max(1.0, np.abs(b64).max()), (path, dev)


def _tree():
    """A small AlexNet's param tree (cnn_tpu's init, 64 px, BN) and a fake
    model state of the same nesting."""
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=True,
                         image_size=64)
    params, state = jax.tree_util.tree_map(np.asarray,
                                           jmodel.init(jax.random.key(3)))
    return params, state


def _flat_names(tree) -> dict:
    return {f"{layer}.{k}": v for layer, leaves in tree.items()
            for k, v in leaves.items()}


def _run(rng, make, j_make, with_state=False, check=None):
    """STEPS updates of both optimizers on the same gradients (scaled so
    that a clip at 0.5-1 both holds and passes), each followed, with
    ``with_state``, by ``ema_update_state`` on the same fresh model state.
    Returns the two params and states."""
    params, state = _tree()
    opt, jopt = make(), j_make()
    # jitted, as cnn_tpu's train step runs them
    j_update = jax.jit(jopt.update)
    j_ema_state = jax.jit(j_optim.ema_update_state)
    tp = {k: torch.tensor(v) for k, v in _flat_names(params).items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ts, js = opt.init(tp), jopt.init(jp)
    if with_state:
        ts = optim.ema_update_state(
            ts, {k: torch.tensor(v) for k, v in _flat_names(state).items()})
        js = j_ema_state(js, jax.tree_util.tree_map(jnp.asarray, state))
    for i in range(STEPS):
        scale = 0.02 if i % 3 else 0.3
        grads = jax.tree_util.tree_map(
            lambda v: (rng.standard_normal(v.shape) * scale).astype(
                np.float32), params)
        jp, js = j_update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        opt.update({k: torch.tensor(v) for k, v in _flat_names(grads).items()},
                   ts, tp)
        if with_state:
            new = jax.tree_util.tree_map(
                lambda v: rng.uniform(0.5, 2.0, v.shape).astype(np.float32),
                state)
            js = j_ema_state(js, jax.tree_util.tree_map(jnp.asarray, new))
            ts = optim.ema_update_state(
                ts, {k: torch.tensor(v) for k, v in _flat_names(new).items()})
        if check is not None:
            check(tp)
    for name, p in tp.items():
        layer, key = name.split(".")
        w = np.asarray(jp[layer][key], np.float64)
        dev = np.abs(p.numpy() - w).max()
        assert dev <= TOL * max(1.0, np.abs(w).max()), (name, dev)
    return tp, ts, jp, js


def _kwargs(branch):
    name, mom, schedule, warmup, wd, clip = BRANCHES[branch]
    return dict(name=name, learning_rate=0.05, momentum=mom,
                schedule=schedule, total_steps=STEPS, warmup_steps=warmup,
                weight_decay=wd, grad_clip=clip)


@pytest.mark.parametrize("ema", [0.0, 0.9], ids=["plain", "ema"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_make_optimizer_matches_cnn_tpu_over_20_steps(rng, branch, ema):
    """Each branch, alone and under with_ema (its model-state average fed
    too): params, every trace, mu, nu, EMA leaf and count within 1e-6 x
    max(1, max|ref|), the state nested as cnn_tpu's."""
    kw = _kwargs(branch)

    def make(mod):
        opt = mod.make_optimizer(**kw)
        return mod.with_ema(opt, ema) if ema else opt
    _, ts, _, js = _run(rng, lambda: make(optim), lambda: make(j_optim),
                        with_state=bool(ema))
    _assert_states_close(ts, js)
    if ema:
        assert int(ts.count) == int(js.count) == STEPS
        assert ts.decay == float(js.decay)


@pytest.mark.parametrize("branch", ["momentum_decay_clip", "adamw"])
def test_with_frozen_matches_cnn_tpu(rng, branch):
    """with_frozen(stem prefixes) under with_ema: the frozen params stay
    bit-unchanged through every update, their slots still advance, and
    everything matches cnn_tpu's."""
    kw = _kwargs(branch)
    prefixes = ["conv_layer_1", " bn_layer_1", ""]
    params, _ = _tree()
    frozen = {k: v.copy() for k, v in _flat_names(params).items()
              if k.startswith(("conv_layer_1.", "bn_layer_1."))}

    def check(tp):
        for k, v in frozen.items():
            assert np.array_equal(tp[k].numpy(), v), k

    def make(mod):
        return mod.with_ema(mod.with_frozen(mod.make_optimizer(**kw),
                                            prefixes), 0.99)
    tp, ts, _, js = _run(rng, lambda: make(optim), lambda: make(j_optim),
                         with_state=True, check=check)
    _assert_states_close(ts, js)
    moved = [k for k in tp if k not in frozen
             and not np.array_equal(tp[k].numpy(), _flat_names(params)[k])]
    assert len(moved) == len(tp) - len(frozen)


def test_with_frozen_refuses_a_prefix_that_matches_nothing():
    p = {"conv_layer_1.w": torch.zeros(2)}
    with pytest.raises(AssertionError, match="matched no parameters"):
        optim.with_frozen(optim.make_optimizer("sgd", 0.1), ["stem"]).init(p)
    with pytest.raises(AssertionError):
        optim.with_frozen(optim.make_optimizer("sgd", 0.1), [" "])


def test_ema_rate_and_legacy_seed():
    """The effective decay min(d, (1+t)/(10+t)) and ema_seed_model_state's
    backfill of a legacy state's decay and mstate, against cnn_tpu's."""
    for t in (1, 5, 50, 5000):
        want = float(jnp.minimum(jnp.float32(0.999),
                                 (1.0 + jnp.int32(t)) / (10.0 + jnp.int32(t))))
        assert optim._ema_rate(0.999, t) == want
    legacy = optim.EmaState(inner=(), ema={"a.w": torch.ones(2)},
                            count=torch.tensor(3, dtype=torch.int32))
    state = {"bn.mean": torch.full((2,), 0.5)}
    seeded = optim.ema_seed_model_state(legacy, state, decay=0.99)
    assert seeded.decay == float(np.float32(0.99))
    assert torch.equal(seeded.mstate["bn.mean"], state["bn.mean"])
    assert seeded.mstate["bn.mean"] is not state["bn.mean"]
    again = optim.ema_seed_model_state(seeded, {"bn.mean": torch.zeros(2)})
    assert torch.equal(again.mstate["bn.mean"], state["bn.mean"])
    assert optim.ema_model_state((), "raw") == "raw"
    assert optim.ema_params(()) is None


def _port_state(optimizer_kw, ema=0.0, freeze=None, image_size=64,
                seed=5):
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=image_size, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    opt = optim.make_optimizer(**optimizer_kw)
    if freeze:
        opt = optim.with_frozen(opt, freeze)
    if ema:
        opt = optim.with_ema(opt, ema)
    return create_train_state(model, opt, seed=seed), opt


def _j_state(optimizer_kw, ema=0.0):
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=True,
                         image_size=64)
    opt = j_optim.make_optimizer(**optimizer_kw)
    if ema:
        opt = j_optim.with_ema(opt, ema)
    return j_create_state(jmodel, opt, jax.random.key(4)), opt


def _trees_equal(a, b) -> bool:
    fa, fb = list(_flat(a)), list(_flat(b))
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        (x is None and y is None) or (isinstance(x, tuple)
                                      and isinstance(y, tuple))
        or (np.asarray(x).dtype == np.asarray(y).dtype
            and np.array_equal(x, y)) for (_, x), (_, y) in zip(fa, fb))


def _fill(ts, rng):
    """Random values in every tensor of the port's optimizer state and a
    count of 7, so that a round trip has something to carry."""
    def walk(node):
        if isinstance(node, torch.Tensor):
            if node.is_floating_point():
                node.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(node.shape)).astype(np.float32)))
            else:
                node.fill_(7)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, tuple):
            for v in node:
                walk(v)
    walk(ts.opt_state)


@pytest.mark.parametrize("branch,ema", [
    ("adam", 0.0), ("adamw", 0.999), ("momentum_decay_clip", 0.99),
    ("sgd_decay_cosine", 0.0), ("adam_cosine_clip", 0.9), ("sgd", 0.999)])
def test_port_ckpt_loads_in_cnn_tpu_and_back(tmp_path, rng, branch, ema):
    """The port writes each optimizer state; cnn_tpu's load_checkpoint
    reads the same trees, nested as its own optimizer's fresh state; and
    the port reads it back equal."""
    kw = _kwargs(branch)
    ts, _ = _port_state(kw, ema)
    _fill(ts, rng)
    path = str(tmp_path / "p.ckpt")
    ck.save_checkpoint(path, ts)
    got = jck.load_checkpoint(path)
    assert _trees_equal(got.opt_state, ck.pickled_state(ts.opt_state))
    j_ts, _ = _j_state(kw, ema)
    fresh = [p for p, _ in _flat(j_ts.opt_state)]
    assert [p for p, _ in _flat(got.opt_state)] == fresh
    ts2, _ = _port_state(kw, ema, seed=9)
    ck.load_checkpoint(path, ts2)
    assert _trees_equal(ck.pickled_state(ts2.opt_state),
                        ck.pickled_state(ts.opt_state))


@pytest.mark.parametrize("branch,ema", [
    ("adam", 0.0), ("adamw", 0.999), ("momentum_decay_clip", 0.99),
    ("sgd_decay_cosine", 0.0)])
def test_cnn_tpu_ckpt_loads_in_the_port_and_back(tmp_path, branch, ema):
    """cnn_tpu's checkpoint after two updates; the port loads it (every
    tree equal) and writes it again: cnn_tpu reads the same trees."""
    kw = _kwargs(branch)
    j_ts, jopt = _j_state(kw, ema)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.1),
                                   j_ts.params)
    for _ in range(2):
        params, opt_state = jopt.update(grads, j_ts.opt_state, j_ts.params)
        opt_state = j_optim.ema_update_state(opt_state, j_ts.state)
        j_ts = j_ts._replace(params=params, opt_state=opt_state,
                             step=j_ts.step + 1)
    path = str(tmp_path / "j.ckpt")
    jck.save_checkpoint(path, j_ts)
    ts, _ = _port_state(kw, ema)
    ck.load_checkpoint(path, ts)
    want = jax.tree_util.tree_map(np.asarray, j_ts.opt_state)
    assert _trees_equal(ck.pickled_state(ts.opt_state), want)
    assert ts.step == 2
    again = str(tmp_path / "again.ckpt")
    ck.save_checkpoint(again, ts)
    assert _trees_equal(jck.load_checkpoint(again).opt_state,
                        jck.load_checkpoint(path).opt_state)


def test_a_checkpoint_of_another_optimizer_is_refused(tmp_path):
    ts, _ = _port_state(_kwargs("adam"))
    path = str(tmp_path / "a.ckpt")
    ck.save_checkpoint(path, ts)
    other, _ = _port_state(_kwargs("momentum"))
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        ck.load_checkpoint(path, other)


# every committed checkpoint whose optimizer state holds an EMA or a
# weight-decay chain: (directory, file prefix, legacy EMA)
COMMITTED = [
    ("alexnet_distill", "iter_17000_", True),
    ("resnet10_cat4_r3b", "iter_30000_", True),
    ("resnet10_cat4_transfer", "iter_12000_", True),
    ("pipecnn_w256_cat4", "iter_11000_", True),
    ("pipecnn_w256_cat4_emafix", "iter_8000_", False),
    ("pipecnn_w256_cat4_mixup", "iter_11000_", False),
    ("resnet10_cat", "iter_15000_train_0.861_", None),
]


@pytest.mark.parametrize("directory,prefix,legacy", COMMITTED,
                         ids=[c[0] for c in COMMITTED])
def test_committed_ema_and_decay_checkpoints_read_equal(directory, prefix,
                                                        legacy):
    """Read by both packages: the same params, state and optimizer trees;
    a legacy EMA state has no decay and no mstate."""
    (path,) = glob.glob(os.path.join(REPO, "checkpoints", directory,
                                     prefix + "*.ckpt"))
    got = ck.read_checkpoint(path)
    want = jck.load_checkpoint(path)
    for key in ("params", "state", "opt_state"):
        assert _trees_equal(got[key], jax.tree_util.tree_map(
            np.asarray, getattr(want, key))), key
    if legacy is None:
        # add_decayed_weights, then a momentum-free optax.sgd on a schedule
        assert [p for p, _ in _flat(got["opt_state"])] == [
            "[0]<EmptyState>", "[1][0]<EmptyState>",
            "[1][1]<ScaleByScheduleState>.count"]
        return
    assert isinstance(got["opt_state"], optim.EmaState)
    assert (got["opt_state"].mstate is None) == legacy
    assert (got["opt_state"].decay is None) == legacy


@pytest.mark.parametrize("legacy", [True, False])
def test_legacy_ema_checkpoint_resumes_seeded(tmp_path, legacy):
    """A cnn_tpu EMA state without decay and mstate (the pre-round-4
    layout) loads into an --ema 0.99 run: the decay from the run, the
    model-state average seeded from the loaded BN state, as cnn_tpu's
    train CLI seeds it."""
    kw = _kwargs("momentum")
    j_ts, _ = _j_state(kw, 0.99)
    if legacy:
        j_ts = j_ts._replace(opt_state=j_ts.opt_state._replace(
            decay=None, mstate=None))
    path = str(tmp_path / "l.ckpt")
    jck.save_checkpoint(path, j_ts)
    ts, _ = _port_state(kw, 0.99)
    ck.load_checkpoint(path, ts)
    want = j_optim.ema_seed_model_state(
        j_ts.opt_state, j_ts.state, decay=0.99)
    assert _trees_equal(ck.pickled_state(ts.opt_state),
                        jax.tree_util.tree_map(np.asarray, want))


def test_warm_start_matches_cnn_tpu(tmp_path, capsys):
    """A 3-class checkpoint warm-starts a 4-class run: the same copied and
    skipped paths as cnn_tpu's, the head kept fresh, the optimizer state
    made anew from the merged params with its EMA seeded, step and
    generator fresh."""
    src, _ = _port_state(_kwargs("momentum"), image_size=64, seed=11)
    path = str(tmp_path / "src.ckpt")
    src.step = 40
    ck.save_checkpoint(path, src)
    kw = _kwargs("adamw")
    model = get_model("alexnet", num_classes=4, batch_norm=True,
                      image_size=64, device="cpu",
                      generator=torch.Generator().manual_seed(2))
    opt = optim.with_ema(optim.make_optimizer(**kw), 0.99)
    ts = create_train_state(model, opt, seed=2)
    rng_state = ts.rng.get_state()
    head = named_params(model)["linear_1.w"].clone()
    ts, copied, skipped = ck.warm_start(ts, path, opt)

    jmodel = j_get_model("alexnet", num_classes=4, batch_norm=True,
                         image_size=64)
    jopt = j_optim.with_ema(j_optim.make_optimizer(**kw), 0.99)
    j_ts = j_create_state(jmodel, jopt, jax.random.key(2))
    j_ts, j_copied, j_skipped = jck.warm_start(j_ts, path, jopt)
    assert (copied, skipped) == (j_copied, j_skipped)
    assert skipped == ["/linear_1/w (shape (128, 3) vs (128, 4))",
                       "/linear_1/b (shape (3,) vs (4,))"]
    assert torch.equal(named_params(model)["linear_1.w"], head)
    for name, t in {**named_params(model), **named_state(model)}.items():
        if not name.startswith("linear_1"):
            layer, key = name.split(".")
            tree = j_ts.state if key in ("mean", "var") else j_ts.params
            assert np.array_equal(t.detach().numpy(), tree[layer][key]), name
    assert ts.step == 0 and torch.equal(ts.rng.get_state(), rng_state)
    assert int(ts.opt_state.count) == 0
    for name, e in ts.opt_state.ema.items():
        assert torch.equal(e, named_params(model)[name]), name
    for name, m in ts.opt_state.mstate.items():
        assert torch.equal(m, named_state(model)[name]), name
    got = ck.pickled_state(ts.opt_state)
    want = jax.tree_util.tree_map(np.asarray, j_ts.opt_state)
    assert [p for p, _ in _flat(got)] == [p for p, _ in _flat(want)]
