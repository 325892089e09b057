"""The port's data and tensor parallelism (``parallel/mesh.py``,
``parallel/collectives.py``, the sharded steps, the sharded device dataset
and the ``--multihost`` train CLI) against ``cnn_tpu`` on the CPU.

Real gloo processes run the port (``tests/fixtures/torch_rank_worker.py``,
which imports no JAX): one launch of 4 ranks and one of 2 for the whole
module, each started before the JAX references are computed here, on the
8 virtual devices of ``tests/conftest.py``. Weights and batches go to the
ranks, and results come back, through ``.npz`` files.

- A sharded step at DP4 and at DP2 x TP2, BN AlexNet (64 px) and MoECNN
  (32 px, width 16, 4 experts, balance 0.01), momentum with the gradient
  clip on: every gradient, BN statistic, momentum leaf and updated param
  within 1e-4 x max(1, max|ref|) of ``cnn_tpu``'s single-device step, the
  MoE load within 1e-6.
- ``grad_accum 2`` at DP2 against ``cnn_tpu``'s step on ``make_mesh(2,
  1)``; the eval step at DP2 on an uneven batch of 7 and on one image
  (loss, correct, pred); a TP2 ``.ckpt`` equal to the one-rank tree,
  which ``cnn_tpu`` reads; a ``'global'``-sampling device step at DP2
  (full augmentation) and a MixUp + CutMix step with ``grad_accum 2`` at
  DP2, each equal to the port's single-device step; a two-process
  ``--multihost`` train CLI run of 2 iterations.
- In this process: ``model_pspecs`` equal to ``cnn_tpu``'s for AlexNet,
  resnet10, mobilenet and MoECNN at model 2 and 4 (no compile); the
  sharded dataset's padding, its ``'local'`` sampler and its epoch
  samplers at DP4 (one rank's view each); ``check_flags`` refusing the
  later axes.
"""

import json
import os
import re
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu import optim as j_optim
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.parallel import make_mesh as j_make_mesh
from cnn_tpu.parallel.train_step import TrainState as JTrainState
from cnn_tpu.parallel.train_step import _loss_fn as j_loss_fn
from cnn_tpu.parallel.train_step import make_eval_step as j_make_eval_step
from cnn_tpu.parallel.train_step import make_train_step as j_make_train_step
from cnn_tpu.parallel.train_step import model_pspecs as j_model_pspecs
from cnn_tpu.parallel.train_step import shard_train_state as j_shard
from cnn_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from cnn_tpu_torch import optim
from cnn_tpu_torch.data.device_dataset import (DeviceDataset, call_indices,
                                               make_device_train_step,
                                               shard_sample)
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.ops.augment import augment_batch
from cnn_tpu_torch.parallel import create_train_state, model_pspecs
from cnn_tpu_torch.parallel.mesh import Mesh
from cnn_tpu_torch.parallel.train_step import (_opt_trees, make_train_step,
                                               named_params, named_state)
from cnn_tpu_torch.tools import train
from cnn_tpu_torch.utils import checkpoint as ckpt
from test_torch_data import write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "fixtures", "torch_rank_worker.py")
TOL = 1e-4            # times max(1, max|ref|)
LOAD_TOL = 1e-6
CLIP = 0.5            # below every reference step's gradient norm
LR = 0.05
ALEX = dict(num_classes=3, batch_norm=True, image_size=64)
MOE = dict(num_classes=3, width=16, n_experts=4, expert_hidden=32,
           image_size=32, balance_coeff=0.01)
MODELS = {"alex": ("alexnet", ALEX, 64), "moe": ("moecnn", MOE, 32)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _scaled(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, np.abs(want).max()))


def _flat(tree) -> dict:
    return {ckpt.leaf_name(tuple(k.key for k in path)): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _weights(key: str, seed: int):
    """``cnn_tpu``'s model of ``key`` and trees drawn by numpy in the
    shapes of its ``init``, and a batch of 8."""
    name, kw, size = MODELS[key]
    rng = np.random.default_rng(seed)
    jm = j_get_model(name, **kw)
    params, state = jax.eval_shape(jm.init, jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        params)
    state = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state)
    x = rng.uniform(0, 1, (8, size, size, 3)).astype(np.float32)
    return jm, params, state, x, (np.arange(8) % 3).astype(np.int64)


class Ranks:
    """One launch of the worker on ``world`` gloo ranks."""

    def __init__(self, tmp, world, plan, inputs):
        self.dir, self.world = str(tmp), world
        with open(os.path.join(self.dir, "plan.json"), "w") as f:
            json.dump(plan, f)
        np.savez(os.path.join(self.dir, "inputs.npz"), **inputs)
        port = _free_port()
        env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, self.dir, str(port), str(world),
             str(r)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self.outs = None

    def result(self, rank: int = 0, timeout: float = 240) -> dict:
        if self.outs is None:
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=timeout)[0])
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-3000:]
            self.outs = [dict(np.load(os.path.join(self.dir,
                                                   f"out{r}.npz")))
                         for r in range(self.world)]
        return self.outs[rank]

    def case(self, name: str, rank: int = 0) -> dict:
        out = self.result(rank)
        err = out.get(f"{name}/error")
        assert err is None, str(err)
        return {k[len(name) + 1:]: v for k, v in out.items()
                if k.startswith(name + "/")}


def _inputs(keys):
    """Each model's weights and batch, by key: ``<key>/p/<name>``,
    ``<key>/s/<name>``, ``<key>/x``, ``<key>/y``."""
    out, refs = {}, {}
    for i, key in enumerate(keys):
        jm, params, state, x, y = _weights(key, 19 + i)
        refs[key] = (jm, params, state, x, y)
        out.update({f"{key}/p/{k}": v for k, v in _flat(params).items()})
        out.update({f"{key}/s/{k}": v for k, v in _flat(state).items()})
        out[f"{key}/x"], out[f"{key}/y"] = x, y
    return out, refs


def _case(kind, name, key, data, model, **more):
    mname, kw, _ = MODELS[key]
    return {"kind": kind, "name": name, "model": mname, "kwargs": kw,
            "weights": key, "x": f"{key}/x", "y": f"{key}/y", "data": data,
            "model_parallel": model, "lr": LR, "clip": CLIP, **more}


@pytest.fixture(scope="module")
def refs():
    return _inputs(("alex", "moe"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory, refs):
    plan = [{"kind": "mesh", "name": "mesh"}]
    for key in ("alex", "moe"):
        plan.append(_case("step", f"{key}_dp4", key, 4, 1))
        plan.append(_case("step", f"{key}_dp2tp2", key, 2, 2))
    return Ranks(tmp_path_factory.mktemp("world4"), 4, plan, refs[0])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("animals"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory, refs, dataset):
    tmp = tmp_path_factory.mktemp("world2")
    inputs = dict(refs[0])
    rng = np.random.default_rng(5)
    inputs["ds/images"] = rng.integers(0, 256, (16, 72, 72, 3), np.uint8)
    inputs["ds/labels"] = rng.integers(0, 3, 16)
    for key in ("alex", "moe"):   # an uneven eval batch (3 + 4 rows)
        inputs[f"{key}/x7"] = inputs[f"{key}/x"][:7]
        inputs[f"{key}/y7"] = inputs[f"{key}/y"][:7]
    # a batch below the data axis: each rank runs it whole
    inputs["moe/x1"], inputs["moe/y1"] = (inputs["moe/x"][:1],
                                          inputs["moe/y"][:1])
    cli = ["--dataset-path", dataset, "--checkpoint-dir", str(tmp / "cli"),
           "--image-size", "64", "--train-batch-size", "8",
           "--valid-batch-size", "8", "--total-iters", "2",
           "--valid-iters", "2", "--save-iters", "2", "--augment", "false",
           "--batch-norm", "true", "--optimizer", "momentum",
           "--learning-rate", "1.5e-2", "--backend", "python",
           "--num-workers", "2", "--multihost", "true",
           "--coordinator", f"localhost:{_free_port()}",
           "--num-processes", "2", "--process-id", "{rank}"]
    plan = [
        _case("step", "alex_accum", "alex", 2, 1, grad_accum=2),
        _case("eval", "alex_eval", "alex", 2, 1, x="alex/x7", y="alex/y7"),
        _case("eval", "moe_eval", "moe", 2, 1, x="moe/x7", y="moe/y7"),
        _case("eval", "moe1_eval", "moe", 2, 1, x="moe/x1", y="moe/y1"),
        _case("mix", "mix", "alex", 2, 1),
        _case("device_global", "global", "alex", 2, 1, images="ds/images",
              labels="ds/labels", batch=8, augment=64),
        _case("ckpt", "ckpt", "alex", 1, 2, path=str(tmp / "tp2.ckpt")),
        {"kind": "cli", "name": "cli", "argv": cli},
    ]
    ranks = Ranks(tmp, 2, plan, inputs)
    ranks.tmp, ranks.inputs = tmp, inputs
    return ranks


def _j_opt(grad_clip=CLIP):
    return j_optim.make_optimizer("momentum", LR, 0.9, grad_clip=grad_clip)


def _j_state(jm, params, state, opt):
    return JTrainState(params, state, j_optim.ema_update_state(
        opt.init(params), state), jnp.zeros((), jnp.int32),
        jax.random.key(0))


def _j_trace(opt_state) -> dict:
    """The momentum tree of a ``cnn_tpu`` optimizer state."""
    if hasattr(opt_state, "trace"):
        return _flat(opt_state.trace)
    for v in opt_state if isinstance(opt_state, tuple) else ():
        got = _j_trace(v)
        if got:
            return got
    return {}


@pytest.fixture(scope="module")
def single(refs):
    """``cnn_tpu``'s single-device gradients and step of each model."""
    out = {}
    for key, (jm, params, state, x, y) in refs[1].items():
        (loss, (new_state, _)), grads = jax.jit(
            jax.value_and_grad(j_loss_fn, has_aux=True),
            static_argnums=(2, 6, 7))(params, state, jm, jnp.asarray(x),
                                      jnp.asarray(y), jax.random.key(0),
                                      True, None)
        opt = _j_opt()
        jts, m = j_make_train_step(jm, opt, donate=False)(
            _j_state(jm, params, state, opt), jnp.asarray(x), jnp.asarray(y))
        norm = np.sqrt(sum(float(jnp.sum(g * g))
                           for g in jax.tree_util.tree_leaves(grads)))
        assert norm > CLIP, (key, norm)    # the clip acts
        out[key] = dict(grads=_flat(grads), loss=float(loss),
                        params=_flat(jts.params), state=_flat(jts.state),
                        trace=_j_trace(jts.opt_state), step_loss=float(
                            m["loss"]))
    return out


def _check_step(got: dict, want: dict, what: str, grads: bool = True):
    names = sorted(k[len("param/"):] for k in got if k.startswith("param/"))
    assert names == sorted(want["params"]), what
    for name in names:
        if grads:
            assert _scaled(got[f"grad/{name}"], want["grads"][name]) <= TOL, \
                (what, "grad", name)
        assert _scaled(got[f"param/{name}"], want["params"][name]) <= TOL, \
            (what, "param", name)
        assert _scaled(got[f"opt0/{name}"], want["trace"][name]) <= TOL, \
            (what, "momentum", name)
    states = sorted(k[len("state/"):] for k in got if k.startswith("state/"))
    assert states == sorted(want["state"]), what
    for name in states:
        bar = LOAD_TOL if name.endswith(".load") else TOL
        assert _scaled(got[f"state/{name}"], want["state"][name]) <= bar, \
            (what, "state", name)


@pytest.mark.parametrize("key,case,shards", [
    ("alex", "dp4", []),
    ("alex", "dp2tp2", ["conv_layer_3.w", "conv_layer_4.w", "linear_1.w"]),
    ("moe", "dp4", []),
    ("moe", "dp2tp2", ["linear_1.w"])])
def test_sharded_step_matches_cnn_tpu(world4, single, key, case, shards):
    """One sharded step (clip on) against ``cnn_tpu``'s single-device
    step: gradients, BN statistics (and MoE's load, aux_loss), momentum
    and params; the loss the same on every rank."""
    got = world4.case(f"{key}_{case}")
    assert sorted(got["shards"].tolist()) == shards
    _check_step(got, single[key], f"{key} {case}")
    assert abs(float(got["grad_loss"]) - single[key]["loss"]) <= TOL
    assert abs(float(got["loss"]) - single[key]["step_loss"]) <= TOL
    for r in range(1, 4):
        assert float(world4.case(f"{key}_{case}", r)["loss"]) == float(
            got["loss"])


def test_make_mesh_shapes_and_asserts(world4):
    """As ``tests/test_parallel.py``'s: 'the rest' on the data axis, a
    2 x 2 mesh, and an assertion where the mesh needs more devices."""
    got = world4.case("mesh")
    assert got["shape"].tolist() == [4, 1]
    assert got["shape_2x2"].tolist() == [2, 2]
    assert str(got["too_big"]) == "AssertionError: need 8 devices, have 4"


def test_grad_accum_matches_cnn_tpu_mesh_step(world2, refs):
    """``grad_accum 2`` at DP2 against ``cnn_tpu``'s ``make_train_step(
    mesh=make_mesh(2, 1), grad_accum=2)`` (microbatch k a slice of each
    shard): params, BN statistics and momentum."""
    jm, params, state, x, y = refs[1]["alex"]
    mesh = j_make_mesh(2, 1)
    opt = _j_opt()
    jts = j_shard(_j_state(jm, params, state, opt), mesh, jm)
    jts, m = j_make_train_step(jm, opt, mesh=mesh, donate=False,
                               grad_accum=2)(jts, jnp.asarray(x),
                                             jnp.asarray(y))
    want = dict(params=_flat(jts.params), state=_flat(jts.state),
                trace=_j_trace(jts.opt_state))
    got = world2.case("alex_accum")
    _check_step(got, want, "grad accum 2", grads=False)
    assert abs(float(got["loss"]) - float(m["loss"])) <= TOL


@pytest.mark.parametrize("case,key,n", [("alex_eval", "alex", 7),
                                        ("moe_eval", "moe", 7),
                                        ("moe1_eval", "moe", 1)])
def test_eval_step_matches_cnn_tpu(world2, refs, case, key, n):
    """The eval step at DP2 on a batch of 7 (3 and 4 rows), and on one
    image (each rank runs it whole): the loss, ``correct`` and every
    prediction equal to ``cnn_tpu``'s unsharded eval step (MoECNN's
    capacity from the global batch)."""
    jm, params, state, x, y = refs[1][key]
    want = j_make_eval_step(jm)(params, state, jnp.asarray(x[:n]),
                                jnp.asarray(y[:n]))
    got = world2.case(case)
    assert abs(float(got["loss"]) - float(want["loss"])) <= TOL
    assert int(got["correct"]) == int(want["correct"])
    assert got["pred"].tolist() == np.asarray(want["pred"]).tolist()


def _port_model(inputs, key):
    name, kw, _ = MODELS[key]
    model = get_model(name, device="cpu", **kw)
    ckpt.load_jax_params(model, _nest(inputs, f"{key}/p"),
                         _nest(inputs, f"{key}/s"))
    return model


def _nest(inputs, prefix):
    tree = {}
    for k, v in inputs.items():
        if k.startswith(prefix + "/"):
            path = ckpt.leaf_path(k[len(prefix) + 1:])
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = v
    return tree


def test_device_global_step_matches_single_device(world2):
    """A ``'global'``-sampling device-dataset step at DP2 with the full
    augmentation (each rank drawing the global batch's parameters) against
    the port's single-device step on the same seed: params, BN statistics
    and momentum within 1e-5 x max(1, max|ref|)."""
    inputs = world2.inputs
    model = _port_model(inputs, "alex")
    opt = optim.make_optimizer("momentum", LR, 0.9, grad_clip=CLIP)
    ts = create_train_state(model, opt, seed=0)
    ds = DeviceDataset.from_arrays(inputs["ds/images"], inputs["ds/labels"],
                                   device="cpu")
    step = make_device_train_step(
        model, opt, ds, 8,
        augment_fn=lambda g, im: augment_batch(g, im, out_size=64))
    ts, m = step(ts)
    got = world2.case("global")
    for name, t in named_params(model).items():
        assert _scaled(got[f"param/{name}"], t.detach()) <= 1e-5, name
    for name, t in named_state(model).items():
        assert _scaled(got[f"state/{name}"], t) <= 1e-5, name
    for name, t in next(_opt_trees(ts.opt_state)).items():
        assert _scaled(got[f"opt0/{name}"], t) <= 1e-5, name
    assert abs(float(got["loss"]) - float(m["loss"])) <= 1e-5


def test_mixed_accumulated_step_matches_single_device(world2):
    """MixUp and CutMix with ``grad_accum 2`` at DP2 against the port's
    single-device step on the same seed, its batch in the sharded step's
    microbatch order (microbatch k: slice k of each rank's rows, rows 0, 1,
    4, 5 then 2, 3, 6, 7), so each microbatch's partners are drawn over
    the same global microbatch, gathered from both ranks: params, BN
    statistics and momentum within 1e-4 x max(1, max|ref|), the bar of
    every sharded step here."""
    inputs = world2.inputs
    model = _port_model(inputs, "alex")
    opt = optim.make_optimizer("momentum", LR, 0.9, grad_clip=CLIP)
    ts = create_train_state(model, opt, seed=0)
    order = [0, 1, 4, 5, 2, 3, 6, 7]
    ts, m = make_train_step(model, opt, mixup=0.2, cutmix=1.0,
                            grad_accum=2)(
        ts, torch.from_numpy(inputs["alex/x"][order]),
        torch.from_numpy(inputs["alex/y"][order]))
    got = world2.case("mix")
    for name, t in named_params(model).items():
        assert _scaled(got[f"param/{name}"], t.detach()) <= TOL, name
    for name, t in named_state(model).items():
        assert _scaled(got[f"state/{name}"], t) <= TOL, name
    for name, t in next(_opt_trees(ts.opt_state)).items():
        assert _scaled(got[f"opt0/{name}"], t) <= TOL, name
    assert abs(float(got["loss"]) - float(m["loss"])) <= TOL


def test_tp2_checkpoint_is_the_one_rank_tree(world2):
    """Process 0 writes the TP2 state gathered: the same tree as a
    one-rank run's ``.ckpt`` after the same step (values within 1e-5 x
    max(1, max|ref|)), and ``cnn_tpu`` reads it."""
    inputs = world2.inputs
    got_case = world2.case("ckpt")
    assert sorted(got_case["shards"].tolist()) == [
        "conv_layer_3.w", "conv_layer_4.w", "linear_1.w"]
    model = _port_model(inputs, "alex")
    opt = optim.make_optimizer("momentum", LR, 0.9, grad_clip=CLIP)
    ts = create_train_state(model, opt, seed=0)
    ts, _ = make_train_step(model, opt)(ts, torch.from_numpy(
        inputs["alex/x"]), torch.from_numpy(inputs["alex/y"]))
    one = str(world2.tmp / "one.ckpt")
    ckpt.save_checkpoint(one, ts)
    got, want = (ckpt.read_checkpoint(p) for p in
                 (str(world2.tmp / "tp2.ckpt"), one))

    def leaves(node, path=""):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from leaves(node[k], f"{path}/{k}")
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                yield from leaves(v, f"{path}/{type(node).__name__}{i}")
        elif node is not None:
            yield path, np.asarray(node)

    g = dict(leaves({k: got[k] for k in ("params", "state", "opt_state")}))
    w = dict(leaves({k: want[k] for k in ("params", "state", "opt_state")}))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert _scaled(g[k], w[k]) <= 1e-5, k
    assert got["step"] == want["step"] == 1
    jts = j_load_checkpoint(str(world2.tmp / "tp2.ckpt"))
    assert _flat(jts.params).keys() == _flat(got["params"]).keys()


def test_multihost_cli_two_processes(world2):
    """``--multihost`` with two processes on a DP2 mesh: both print the
    same loss lines, process 0 alone writes the checkpoint, process 1
    keeps ``history.p1.jsonl``, and both run the final test."""
    outs = []
    for r in range(2):
        got = world2.case("cli", r)
        assert int(got["rc"]) == 0
        outs.append(str(got["stdout"]))
    for r, out in enumerate(outs):
        assert f"multihost: process {r}/2" in out
        assert "mesh: {'data': 2, 'model': 1}" in out
        assert "training done!" in out and "Test===>" in out
    lines = [[ln for ln in re.split(r"[\r\n]", out)
              if ln.startswith(("Train===>", "Valid===>", "Test===>"))]
             for out in outs]
    strip = [[re.sub(r"\[[\d.]+ img/s\]", "", ln) for ln in ls]
             for ls in lines]
    assert strip[0] == strip[1] and strip[0]
    assert "weights have been saved to" in outs[0]
    assert "weights have been saved to" not in outs[1]
    cli = world2.tmp / "cli"
    assert len(list(cli.glob("*.ckpt"))) == 1
    assert (cli / "history.jsonl").exists()
    assert (cli / "history.p1.jsonl").exists()


# ------------------------------------------------------- in this process --

@pytest.mark.parametrize("name,kw", [
    ("alexnet", dict(image_size=64)), ("resnet10", dict(image_size=64)),
    ("mobilenet", dict(image_size=64)), ("moecnn", dict(image_size=32))])
@pytest.mark.parametrize("model_dim", [2, 4])
def test_model_pspecs_equal_cnn_tpu(name, kw, model_dim):
    """The port's ``model_pspecs`` against ``cnn_tpu``'s on a mesh of that
    'model' size (its shape only: nothing compiles), nested resnet10
    blocks included."""
    mesh = types.SimpleNamespace(shape={"data": 1, "model": model_dim},
                                 axis_names=("data", "model"))
    want = {layer: {k: tuple(v) for k, v in ps.items()} for layer, ps in
            j_model_pspecs(j_get_model(name, num_classes=3, **kw),
                           mesh).items()}
    got = model_pspecs(get_model(name, num_classes=3, device="cpu", **kw),
                       mesh)
    assert got == want and want


def _fake(d, size=4):
    """Rank ``d``'s view of a DP``size`` mesh, without a process group."""
    return Mesh({"data": size, "model": 1}, d)


def _id_dataset(n, mesh):
    imgs = np.tile(np.arange(n, dtype=np.uint8)[:, None, None, None],
                   (1, 8, 8, 3))
    return DeviceDataset.from_arrays(imgs, np.arange(n) % 3, mesh=mesh)


def test_sharded_dataset_pads_13_rows_over_4_shards():
    """13 rows over 4 shards: 16 rows, the last 3 re-listing rows 0-2;
    each rank holds its 4."""
    got = []
    for d in range(4):
        ds = _id_dataset(13, _fake(d))
        assert (ds.n, ds.n_real, ds.n_local) == (16, 13, 4)
        assert ds.images.shape[0] == ds.labels.shape[0] == 4
        got += ds.images[:, 0, 0, 0].tolist()
    assert got == list(range(13)) + [0, 1, 2]


def test_local_sampler_keeps_pairs_and_shard_rows():
    """'local' sampling at DP4 of 40 rows, batch 32: every rank draws the
    same [4, 8] indices and keeps its row; each image keeps its label and
    comes from its rank's shard; the shards' rows differ."""
    rows = []
    for d in range(4):
        ds = _id_dataset(40, _fake(d))
        g = torch.Generator().manual_seed(0)
        x, y = shard_sample(ds, "local", g, 32)
        ids = x[:, 0, 0, 0].long()
        assert x.shape[0] == 8 and torch.equal(ids % 3, y)
        assert ((ids >= d * 10) & (ids < (d + 1) * 10)).all(), (d, ids)
        rows.append(ids)
    assert len({tuple(r.tolist()) for r in rows}) == 4


@pytest.mark.parametrize("n,bs,steps", [(40, 16, 5), (38, 8, 20)])
def test_epoch_sampler_per_shard(n, bs, steps):
    """The epoch sampler at DP4: each shard walks its own permutation of
    its rows. Divisible (40 rows): each shard sees each of its rows once
    an epoch, and the shards together every row once. Padded (38 rows, 2
    pad rows): every real row at least once an epoch, no pad row, and the
    pad slots' rows vary from epoch to epoch."""
    per = bs // 4
    ids = []
    for d in range(4):
        ds = _id_dataset(n, _fake(d))
        real = (ds.n_real - 3 * ds.n_local) if d == 3 else ds.n_local
        idx = call_indices(9, 0, steps, per, ds.n_local, False, "cpu",
                           shard=d, real=real)
        ids.append(ds.images[idx.reshape(-1), 0, 0, 0].long().reshape(-1))
    per_shard = torch.stack(ids)                  # [4, steps * per]
    for d in range(4):                            # each shard its own rows
        assert ((per_shard[d] >= 10 * d)
                & (per_shard[d] < min(10 * d + 10, n))).all(), d
    dup_rows = []
    for e in range(per_shard.shape[1] // 10):     # local epochs of 10
        epoch = per_shard[:, e * 10:(e + 1) * 10]
        if n == 40:
            for d in range(4):
                assert sorted(epoch[d].tolist()) == list(range(10 * d,
                                                               10 * d + 10))
            assert sorted(epoch.reshape(-1).tolist()) == list(range(40))
        else:
            assert set(range(n)) <= set(epoch.reshape(-1).tolist())
            counts = np.bincount(epoch.reshape(-1).numpy(), minlength=n)
            dup_rows.append(tuple(np.nonzero(counts > 1)[0]))
    if n != 40:
        assert len(set(dup_rows)) > 1, dup_rows


@pytest.mark.parametrize("flag,item", [("--pipeline-stages", "10c"),
                                       ("--spatial-parallel", "10b"),
                                       ("--expert-parallel", "10b")])
def test_check_flags_refuses_the_later_axes(tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=f"{flag}.*item {item}"):
        train.main(["--checkpoint-dir", str(tmp_path), flag, "2"],
                   device="cpu")
