"""The port's pipeline parallelism (``parallel/pipeline.py``: GPipe, 1F1B
and interleaved 1F1B over a ``'stage'`` axis, Megatron's pair inside the
trunk over ``'model'``, the pipelined eval, the placement, the CLI's
``--pipeline-stages`` and ``tools/multihost_pp_smoke.py``) against
``cnn_tpu`` on the CPU.

Real gloo processes run the port (``tests/fixtures/torch_rank_worker.py``,
which imports no JAX): one launch of 4 ranks for the steps, and the two
processes of the train CLI, each started before the JAX references are
computed here, on the 8 virtual devices of ``tests/conftest.py``. PipeCNN
at width 8, 4 blocks, 32 px, batch 8, BN, momentum with the clip on.

- DP2 x PP2 at M = 2: GPipe, 1F1B and interleaved 1F1B (V = 2) against
  ``cnn_tpu``'s GPipe ``make_pp_train_step`` on a ``('data', 'stage')``
  2 x 2 mesh (its own tests hold its schedules equal); DP1 x PP2 x TP2
  GPipe against its 3-axis step: every param, BN statistic and momentum
  leaf (after one step from zero, the clipped gradient) within 1e-4 x
  max(1, max|ref|); the loss the same on every rank. The stage hops of
  each schedule.
- ``make_pp_eval_step`` at DP2 x PP2 with ``tta='flips'`` on a ragged
  batch of 7 and on one image (and on the V = 2 placement): loss,
  ``correct`` and every prediction equal to ``cnn_tpu``'s.
- The toolbox at DP1 x PP2 x TP2, M = 1, against the port's own
  single-process step, as ``cnn_tpu``'s ``tests/test_pp_compose.py``
  holds its own: ``grad_accum 2``, MixUp + CutMix, one teacher, EMA +
  freeze, and the device dataset with the full augmentation at
  ``steps_per_call 2``.
- The epoch sampler on the pipeline mesh: each data shard's rows once an
  epoch, the stages of a shard alike.
- The ``.ckpt`` process 0 writes at V = 1 and V = 2: the canonical tree,
  which ``cnn_tpu`` reads.
- ``pp_decompose``'s and the schedule checks' messages, equal to
  ``cnn_tpu``'s; ``multihost_pp_smoke`` as 4 processes.
- The train CLI as two processes (``--pipeline-stages 2 --data-parallel 1
  --microbatches 2 --pipeline-schedule 1f1b``) resuming one ``cnn_tpu``
  ``.ckpt`` for 2 iterations, against ``cnn_tpu``'s CLI on the same argv:
  the same lines, ``pipeline mesh:`` among them, and the iter_4 trees
  within 1e-4.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from cnn_tpu import optim as j_optim
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.parallel import make_pp_eval_step as j_make_pp_eval_step
from cnn_tpu.parallel import make_pp_train_step as j_make_pp_train_step
from cnn_tpu.parallel import pp_decompose as j_pp_decompose
from cnn_tpu.parallel import shard_pp_train_state as j_shard_pp
from cnn_tpu.parallel.pipeline import trunk_tp_pspecs as j_trunk_tp_pspecs
from cnn_tpu.parallel.train_step import TrainState as JTrainState
from cnn_tpu.tools import train as j_train
from cnn_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from cnn_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from cnn_tpu_torch import optim
from cnn_tpu_torch.data.device_dataset import (DeviceDataset,
                                               make_device_train_step)
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.ops.augment import augment_batch
from cnn_tpu_torch.parallel import (create_train_state, make_pp_train_step,
                                    make_train_step, pp_decompose)
from cnn_tpu_torch.parallel.mesh import Mesh
from cnn_tpu_torch.parallel.pipeline import trunk_tp_pspecs
from cnn_tpu_torch.parallel.train_step import (_opt_trees, named_params,
                                               named_state)
from cnn_tpu_torch.utils import checkpoint as ckpt
from test_torch_data import write_dataset
from test_torch_parallel import Ranks, _flat, _free_port, _j_trace, _scaled
from test_torch_toolbox_cli import _assert_ckpts_close
from test_torch_train_cli import _one

TOL = 1e-4            # times max(1, max|ref|)
CLIP = 0.2            # below the reference step's gradient norm (0.43)
LR = 0.05
PIPE = dict(num_classes=3, width=8, n_blocks=4, image_size=32)
# the toolbox cases: their options, against the port's single-process step
TOOLBOX = {"tb_accum": dict(grad_accum=2),
           "tb_mix": dict(mixup=0.2, cutmix=1.0),
           "tb_distill": dict(teacher=True),
           "tb_ema_freeze": dict(ema=0.9, freeze=["stem_conv1"]),
           "tb_device": dict(images="ds/images", labels="ds/labels",
                             batch=8, augment=32, spc=2)}


def _inputs():
    """``cnn_tpu``'s PipeCNN, trees drawn by numpy in the shapes of its
    ``init``, and a batch of 8: the worker's inputs and the references'."""
    rng = np.random.default_rng(29)
    jm = j_get_model("pipecnn", **PIPE)
    params, state = jax.eval_shape(jm.init, jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        params)
    state = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state)
    x = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    y = (np.arange(8) % 3).astype(np.int64)
    out = {f"pp/p/{k}": v for k, v in _flat(params).items()}
    out.update({f"pp/s/{k}": v for k, v in _flat(state).items()})
    out["pp/x"], out["pp/y"] = x, y
    out["pp/x7"], out["pp/y7"] = x[:7], y[:7]
    out["pp/x1"], out["pp/y1"] = x[:1], y[:1]
    out["ds/images"] = rng.integers(0, 256, (16, 40, 40, 3), np.uint8)
    out["ds/labels"] = rng.integers(0, 3, 16)
    return out, (jm, params, state, x, y)


def _case(kind, name, data, stages, **more):
    return {"kind": kind, "name": name, "model": "pipecnn", "kwargs": PIPE,
            "weights": "pp", "x": "pp/x", "y": "pp/y", "data": data,
            "stages": stages, "lr": LR, "clip": CLIP, **more}


@pytest.fixture(scope="module")
def refs():
    return _inputs()


@pytest.fixture(scope="module")
def world4(tmp_path_factory, refs):
    tmp = tmp_path_factory.mktemp("pp4")
    plan = [
        _case("pp_step", "gpipe", 2, 2, M=2, path=str(tmp / "v1.ckpt")),
        _case("pp_step", "1f1b", 2, 2, M=2, schedule="1f1b"),
        _case("pp_step", "inter", 2, 2, M=2, schedule="1f1b", V=2,
              path=str(tmp / "v2.ckpt")),
        _case("pp_step", "tp", 1, 2, M=2, model_parallel=2),
        _case("pp_eval", "eval7", 2, 2, x="pp/x7", y="pp/y7", tta="flips"),
        _case("pp_eval", "eval1", 2, 2, x="pp/x1", y="pp/y1", tta="flips"),
        _case("pp_eval", "eval7_v2", 2, 2, x="pp/x7", y="pp/y7",
              tta="flips", V=2),
        {"kind": "pp_epoch", "name": "epoch", "data": 2, "stages": 2,
         "n": 32, "batch": 8},
        {"kind": "pp_smoke", "name": "smoke"},
    ]
    plan += [_case("pp_step", name, 1, 2, M=1, model_parallel=2, **kw)
             for name, kw in TOOLBOX.items()]
    ranks = Ranks(tmp, 4, plan, refs[0])
    ranks.tmp = tmp
    return ranks


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("animals"))


# the CLI runs: PipeCNN at the test's size, resumed at iteration 2
CLI = ["--name", "pipecnn", "--width", "8", "--n-blocks", "4",
       "--image-size", "32", "--train-batch-size", "8",
       "--valid-batch-size", "8", "--total-iters", "4", "--valid-iters", "2",
       "--save-iters", "2", "--augment", "false", "--batch-norm", "true",
       "--optimizer", "momentum", "--learning-rate", "1.5e-2",
       "--backend", "python", "--num-workers", "2",
       "--pipeline-stages", "2", "--data-parallel", "1",
       "--microbatches", "2", "--pipeline-schedule", "1f1b"]


@pytest.fixture(scope="module")
def cli_start(tmp_path_factory, refs):
    """A ``cnn_tpu`` ``.ckpt`` of the test's PipeCNN at step 2 (momentum
    at zero), which both CLIs resume."""
    jm, params, state, _, _ = refs[1]
    opt = j_optim.make_optimizer("momentum", 1.5e-2, 0.9)
    ts = JTrainState(params, state, j_optim.ema_update_state(
        opt.init(params), state), jnp.asarray(2, jnp.int32),
        jax.random.key(212))
    path = str(tmp_path_factory.mktemp("start") / "iter_2_start.ckpt")
    j_save_checkpoint(path, ts)
    return path


@pytest.fixture(scope="module")
def world2(tmp_path_factory, dataset, cli_start, world4):
    tmp = tmp_path_factory.mktemp("pp2")
    argv = ["--dataset-path", dataset, "--checkpoint-dir", str(tmp / "t"),
            *CLI, "--resume", cli_start, "--multihost", "true",
            "--coordinator", f"localhost:{_free_port()}",
            "--num-processes", "2", "--process-id", "{rank}"]
    ranks = Ranks(tmp, 2, [{"kind": "cli", "name": "cli", "argv": argv}],
                  {"unused": np.zeros(1)})
    ranks.tmp = tmp
    return ranks


def _j_opt():
    return j_optim.make_optimizer("momentum", LR, 0.9, grad_clip=CLIP)


def _j_state(params, state, opt):
    return JTrainState(params, state, j_optim.ema_update_state(
        opt.init(params), state), jnp.zeros((), jnp.int32),
        jax.random.key(0))


def _j_mesh(shape, axes):
    return JMesh(np.asarray(jax.devices()[:4]).reshape(shape), axes)


@pytest.fixture(scope="module")
def jax_steps(refs, world4):
    """``cnn_tpu``'s GPipe step at M = 2 on the 2 x 2 ``('data',
    'stage')`` mesh and on the 1 x 2 x 2 ``('data', 'stage', 'model')``
    mesh: the trees after one step and the loss."""
    jm, params, state, x, y = refs[1]
    out = {}
    for tag, shape, axes in (("dp2pp2", (2, 2), ("data", "stage")),
                             ("pp2tp2", (1, 2, 2),
                              ("data", "stage", "model"))):
        mesh = _j_mesh(shape, axes)
        opt = _j_opt()
        jts = j_shard_pp(_j_state(params, state, opt), mesh, jm)
        jts, m = j_make_pp_train_step(jm, opt, mesh, n_microbatches=2,
                                      donate=False)(
            jts, jnp.asarray(x), jnp.asarray(y.astype(np.int32)))
        out[tag] = dict(params=_flat(jts.params), state=_flat(jts.state),
                        trace=_j_trace(jts.opt_state), loss=float(m["loss"]))
    return out


def _check(got: dict, want: dict, what: str):
    names = sorted(k[len("param/"):] for k in got if k.startswith("param/"))
    assert names == sorted(want["params"]), what
    for name in names:
        assert _scaled(got[f"param/{name}"], want["params"][name]) <= TOL, \
            (what, "param", name)
        assert _scaled(got[f"opt0/{name}"], want["trace"][name]) <= TOL, \
            (what, "momentum", name)
    states = sorted(k[len("state/"):] for k in got if k.startswith("state/"))
    assert states == sorted(want["state"]), what
    for name in states:
        assert _scaled(got[f"state/{name}"], want["state"][name]) <= TOL, \
            (what, "state", name)


STAGED = sorted(f"trunk/body/{layer}.{key}" for layer, keys in (
    ("b_conv1", "wb"), ("b_bn1", ("gamma", "beta", "mean", "var")),
    ("b_conv2", "wb"), ("b_bn2", ("gamma", "beta", "mean", "var")))
    for key in keys)


@pytest.mark.parametrize("case,ref,hops", [
    # GPipe: M + S - 2 hops each way; 1F1B: 2 (C - 1) + 2 (M V - S (V - 1))
    ("gpipe", "dp2pp2", 4), ("1f1b", "dp2pp2", 6), ("inter", "dp2pp2", 10),
    ("tp", "pp2tp2", 4)])
def test_pipelined_step_matches_cnn_tpu(world4, jax_steps, refs, case, ref,
                                        hops):
    """One pipelined step against ``cnn_tpu``'s GPipe step on a mesh of the
    same shape: params, BN statistics and momentum (the clipped gradient)
    within 1e-4 x max(1, max|ref|), the loss too and the same on every
    rank; the trunk's params and statistics are the staged leaves; the
    stage hops as the schedule counts them."""
    jm, params, state, x, y = refs[1]
    grads = jax.grad(lambda p: j_loss(jm, p, state, x, y))(params)
    norm = np.sqrt(sum(float(jnp.sum(g * g))
                       for g in jax.tree_util.tree_leaves(grads)))
    assert norm > CLIP, norm        # the clip acts
    got = world4.case(case)
    assert got["shards"].tolist() == STAGED
    _check(got, jax_steps[ref], case)
    assert _scaled(got["loss"], jax_steps[ref]["loss"]) <= TOL
    assert int(got["hops"]) == hops
    for r in range(1, 4):
        assert float(world4.case(case, r)["loss"]) == float(got["loss"])


def j_loss(jm, params, state, x, y):
    from cnn_tpu.parallel.train_step import _loss_fn
    return _loss_fn(params, state, jm, jnp.asarray(x),
                    jnp.asarray(y.astype(np.int32)), jax.random.key(0),
                    True, None)[0]


@pytest.mark.parametrize("case,n", [("eval7", 7), ("eval1", 1),
                                    ("eval7_v2", 7)])
def test_pipelined_eval_matches_cnn_tpu(world4, refs, case, n):
    """The pipelined eval at DP2 x PP2 with four TTA views on a batch of 7
    (padded to 8) and on one image (padded to 2), and on the interleaved
    placement: loss within 1e-4 x max(1, |ref|), ``correct`` and every
    prediction equal to ``cnn_tpu``'s ``make_pp_eval_step``, on every
    rank."""
    jm, params, state, x, y = refs[1]
    want = j_make_pp_eval_step(jm, _j_mesh((2, 2), ("data", "stage")),
                               tta="flips")(
        params, state, jnp.asarray(x[:n]), jnp.asarray(y[:n].astype(
            np.int32)))
    for r in range(4):
        got = world4.case(case, r)
        assert _scaled(got["loss"], float(want["loss"])) <= TOL, r
        assert int(got["correct"]) == int(want["correct"])
        assert got["pred"].tolist() == np.asarray(want["pred"]).tolist()


def _single(name, inputs):
    """The port's single-process step with the toolbox case's options,
    from the same weights and seed."""
    kw = TOOLBOX[name]
    model = get_model("pipecnn", device="cpu", **PIPE)
    ckpt.load_jax_params(model, _nest(inputs, "pp/p"), _nest(inputs,
                                                              "pp/s"))
    opt = optim.make_optimizer("momentum", LR, 0.9, grad_clip=CLIP)
    if kw.get("freeze"):
        opt = optim.with_frozen(opt, kw["freeze"])
    if kw.get("ema"):
        opt = optim.with_ema(opt, kw["ema"])
    ts = create_train_state(model, opt, seed=0)
    more = {k: kw[k] for k in ("grad_accum", "mixup", "cutmix") if k in kw}
    if kw.get("teacher"):
        teacher = get_model("pipecnn", device="cpu", **PIPE)
        ckpt.load_jax_params(teacher, _nest(inputs, "pp/p"),
                             _nest(inputs, "pp/s"))
        more["distill"] = (teacher, 2.0, 0.5)
    if kw.get("images"):
        ds = DeviceDataset.from_arrays(inputs[kw["images"]],
                                       inputs[kw["labels"]], device="cpu")
        ts, m = make_device_train_step(
            model, opt, ds, kw["batch"], steps_per_call=kw["spc"],
            augment_fn=lambda g, im: augment_batch(g, im, out_size=32))(ts)
    else:
        ts, m = make_train_step(model, opt, **more)(
            ts, torch.from_numpy(inputs["pp/x"]),
            torch.from_numpy(inputs["pp/y"]))
    return ts, m


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


@pytest.mark.parametrize("name", sorted(TOOLBOX))
def test_toolbox_matches_single_process_step(world4, refs, name):
    """Each toolbox option on the pipeline (DP1 x PP2 x TP2, one
    microbatch) against the port's single-process step with the same
    option, weights and seed: every param, BN statistic and optimizer
    leaf (momentum; EMA weights and EMA'd statistics) within 1e-4 x
    max(1, max|ref|), and the loss."""
    ts, m = _single(name, refs[0])
    got = world4.case(name)
    for key, t in named_params(ts.model).items():
        assert _scaled(got[f"param/{key}"], t.detach()) <= TOL, key
    for key, t in named_state(ts.model).items():
        assert _scaled(got[f"state/{key}"], t) <= TOL, key
    for i, tree in enumerate(_opt_trees(ts.opt_state)):
        for key, t in tree.items():
            assert _scaled(got[f"opt{i}/{key}"], t) <= TOL, (i, key)
    assert _scaled(got["loss"], m["loss"]) <= TOL


def test_epoch_sampler_on_the_pipeline_mesh(world4):
    """The epoch sampler at DP2 x PP2 (32 rows, batch 8): one epoch gives
    each data shard each of its rows exactly once, the two stages of a
    shard the same rows in the same order, and the shards every row."""
    seen = [world4.case("epoch", r)["seen"].tolist() for r in range(4)]
    local = [world4.case("epoch", r)["local"].tolist() for r in range(4)]
    assert seen[0] == seen[1] and seen[2] == seen[3]
    for r in range(4):
        assert sorted(seen[r]) == sorted(local[r])
    assert sorted(seen[0] + seen[2]) == list(range(32))


@pytest.mark.parametrize("case,tag", [("gpipe", "v1"), ("inter", "v2")])
def test_checkpoint_is_the_canonical_tree(world4, jax_steps, case, tag):
    """The ``.ckpt`` process 0 writes from the pipelined state, with one
    chunk a stage and with two interleaved: the canonical ``[L]`` tree,
    every leaf equal to the ranks' gathered tree and within 1e-4 x
    max(1, max|ref|) of ``cnn_tpu``'s step, and ``cnn_tpu`` reads it with
    the one-rank shapes."""
    got = world4.case(case)
    path = str(world4.tmp / f"{tag}.ckpt")
    tree = ckpt.read_checkpoint(path)
    flat = {f"param/{k}": v for k, v in _flat(tree["params"]).items()}
    flat.update({f"state/{k}": v for k, v in _flat(tree["state"]).items()})
    for k, v in flat.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    want = jax_steps["dp2pp2"]
    for name, v in _flat(tree["params"]).items():
        assert _scaled(v, want["params"][name]) <= TOL, name
    assert tree["step"] == 1
    jts = j_load_checkpoint(path)
    for name, v in _flat(jts.params).items():
        assert v.shape == want["params"][name].shape, name


def test_pp_decompose_and_schedule_checks_match_cnn_tpu():
    """``pp_decompose``'s refusals and the schedule's build-time checks,
    with ``cnn_tpu``'s messages (no process group, nothing compiles)."""
    def both(port_fn, jax_fn):
        errors = []
        for fn in (port_fn, jax_fn):
            with pytest.raises((AssertionError, ValueError)) as e:
                fn()
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1]

    for name, kw in (("alexnet", dict(image_size=64)),
                     ("resnet10", dict(image_size=32))):
        both(lambda: pp_decompose(get_model(name, device="cpu", **kw)),
             lambda: j_pp_decompose(j_get_model(name, **kw)))
    mesh = Mesh({"data": 1, "stage": 2})
    j_mesh = _j_mesh((2, 2), ("data", "stage"))
    for kw, jkw in ((dict(virtual_stages=2), dict(virtual_stages=2)),
                    (dict(schedule="zb"), dict(schedule="zb")),
                    (dict(schedule="1f1b", virtual_stages=3),
                     dict(schedule="1f1b", virtual_stages=3)),
                    (dict(schedule="1f1b", virtual_stages=2,
                          n_microbatches=3),
                     dict(schedule="1f1b", virtual_stages=2,
                          n_microbatches=3))):
        m = kw.pop("n_microbatches", 2)
        both(lambda: make_pp_train_step(
                 get_model("pipecnn", device="cpu", **PIPE),
                 optim.sgd(0.1), mesh, n_microbatches=m, **kw),
             lambda: j_make_pp_train_step(
                 j_get_model("pipecnn", **PIPE), j_optim.sgd(0.1), j_mesh,
                 n_microbatches=jkw.pop("n_microbatches", 2), **jkw))
    odd = dict(PIPE, n_blocks=3)
    both(lambda: make_pp_train_step(get_model("pipecnn", device="cpu",
                                              **odd), optim.sgd(0.1), mesh,
                                    n_microbatches=2),
         lambda: j_make_pp_train_step(j_get_model("pipecnn", **odd),
                                      j_optim.sgd(0.1), j_mesh,
                                      n_microbatches=2))


@pytest.mark.parametrize("width", [8, 16])
def test_trunk_tp_pspecs_equal_cnn_tpu(width):
    """The TP trunk's per-leaf specs, as ``cnn_tpu``'s (each spec as a
    tuple), with BN and with a Dropout between the pair."""
    kw = dict(PIPE, width=width, dropout=0.25)
    want = tuple({layer: {k: tuple(v) for k, v in leaves.items()}
                  for layer, leaves in tree["body"].items()}
                 for tree in j_trunk_tp_pspecs(
                     j_pp_decompose(j_get_model("pipecnn", **kw))[1]))
    got = tuple(tree["body"] for tree in trunk_tp_pspecs(
        pp_decompose(get_model("pipecnn", device="cpu", **kw))[1]))
    assert got == want


def test_multihost_pp_smoke_four_processes(world4):
    """``tools/multihost_pp_smoke.py`` on the four ranks (DP2 x PP2, and
    DP1 x PP2 x TP2): its four OK lines on every process, the same losses
    on all, 1F1B's equal to GPipe's."""
    losses = set()
    for r in range(4):
        got = world4.case("smoke", r)
        assert int(got["rc"]) == 0
        out = str(got["stdout"])
        for line in ("PP OK", "PP-1F1B OK", "PP3 OK", "EPOCH OK"):
            assert line in out, (r, out)
        losses.add(tuple(ln.split("loss=")[1].split()[0]
                         for ln in out.splitlines() if "loss=" in ln))
    assert len(losses) == 1
    (pp, f1b, _), = losses
    assert pp == f1b


def _lines(out: str) -> list:
    keep = ("pipeline mesh:", "Train===>", "Valid===>", "Test===>",
            "resumed from")
    return [re.sub(r"\[[\d.]+ img/s\]", "", ln).strip()
            for ln in re.split(r"[\r\n]", out) if ln.startswith(keep)]


def test_train_cli_pipeline_matches_cnn_tpu_cli(world2, dataset, cli_start,
                                                tmp_path, capsys):
    """``--pipeline-stages 2 --data-parallel 1 --microbatches 2
    --pipeline-schedule 1f1b`` as two processes against ``cnn_tpu``'s CLI
    on the same argv (one process, 8 virtual devices): the same lines on
    both ranks and in ``cnn_tpu``'s, ``pipeline mesh: {'data': 1,
    'stage': 2} (microbatches 2, schedule 1f1b)`` among them; process 0
    alone writes the iter_4 checkpoint, within 1e-4 x max(1, max|ref|) of
    ``cnn_tpu``'s in every leaf."""
    capsys.readouterr()
    assert j_train.main(["--dataset-path", dataset, "--checkpoint-dir",
                         str(tmp_path / "j"), *CLI, "--resume",
                         cli_start]) == 0
    want = _lines(capsys.readouterr().out)
    assert "pipeline mesh: {'data': 1, 'stage': 2} (microbatches 2, " \
        "schedule 1f1b)" in want
    for r in range(2):
        got = world2.case("cli", r)
        assert int(got["rc"]) == 0
        out = str(got["stdout"])
        assert _lines(out) == want, r
        assert ("weights have been saved to" in out) == (r == 0)
    _assert_ckpts_close(_one(str(world2.tmp / "t" / "iter_4_*.ckpt")),
                        _one(str(tmp_path / "j" / "iter_4_*.ckpt")))


def test_unpipelined_meshes_keep_their_shape():
    """A mesh without ``'stage'`` prints as before; a pipeline mesh shows
    ``'stage'``, and ``'model'`` only above 1 (``cnn_tpu``'s meshes)."""
    assert Mesh({"data": 2, "model": 1}).shape == {"data": 2, "model": 1}
    assert Mesh({"data": 1, "stage": 2}).shape == {"data": 1, "stage": 2}
    assert Mesh({"data": 1, "stage": 2, "model": 2}).shape == {
        "data": 1, "stage": 2, "model": 2}
    mesh = Mesh({"data": 2, "stage": 2, "model": 2}, rank=5)
    assert [mesh.index(a) for a in ("data", "stage", "model")] == [1, 0, 1]
