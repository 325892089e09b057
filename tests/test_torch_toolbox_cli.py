"""The training toolbox through the CLIs, the port's against cnn_tpu's on
one argv, on the CPU: the train CLI resuming a checkpoint cnn_tpu's CLI
wrote with ``--ema``, Adam with weight decay, ``--grad-accum`` and a
teacher, and a warm start with frozen layers; evaluate and ``infer
--use-ema`` on the committed EMA checkpoint and on a small one with an
EMA'd BN state written by cnn_tpu."""

import glob
import os

import jax
import numpy as np
import pytest

from cnn_tpu import optim as j_optim
from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.parallel.train_step import create_train_state as j_create_state
from cnn_tpu.tools import evaluate as j_evaluate
from cnn_tpu.tools import infer as j_infer
from cnn_tpu.tools import train as j_train
from cnn_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from cnn_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from cnn_tpu_torch.tools import evaluate, infer, train
from cnn_tpu_torch.utils.checkpoint import (parse_checkpoint_name,
                                            read_checkpoint)
from test_torch_data import write_dataset
from test_torch_evaluate_cli import _parse as parse_metrics
from test_torch_evaluate_cli import ppm_dataset  # noqa: F401 (a fixture)
from test_torch_infer_cli import _parse as parse_rows
from test_torch_infer_cli import photo_paths  # noqa: F401 (a fixture)
from test_torch_optim_toolbox import _flat
from test_torch_train_cli import BASE, _one

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMA = os.path.join(REPO, "checkpoints", "alexnet_distill",
                   "iter_17000_train_0.992_valid_0.930.ckpt")
# the bar of PERF.md section 2's row "the port's CLI against cnn_tpu's"
CLI_TOL = 1e-4
# the lines both train CLIs print alike
SAME = ("Valid===>", "Test===>", "weight EMA:", "frozen param prefixes:",
        "warm start from", "distilling from", "resumed from")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("animals"))


@pytest.fixture(scope="module")
def base_ckpt(dataset, tmp_path_factory):
    """cnn_tpu's CLI, iterations 1-2 at the base flags (momentum, cosine),
    its iter_2 checkpoint."""
    ck = tmp_path_factory.mktemp("base")
    assert j_train.main(_args(dataset, ck, "--total-iters", "2")) == 0
    return _one(str(ck / "iter_2_*.ckpt"))


def _args(dataset, ckdir, *more):
    return ["--dataset-path", dataset, "--checkpoint-dir", str(ckdir),
            *BASE, *more]


def _lines(out: str) -> list:
    return [l.strip() for l in out.splitlines() if l.startswith(SAME)]


def _assert_ckpts_close(got_path, want_path):
    """Two iter_4 checkpoints: the same name and step; params, state and
    every optimizer leaf (traces, moments, EMA, counts) within
    CLI_TOL x max(1, max|ref|), nested alike."""
    assert parse_checkpoint_name(os.path.basename(got_path)) == \
        parse_checkpoint_name(os.path.basename(want_path))
    got = read_checkpoint(got_path)
    want = j_load_checkpoint(want_path)
    assert got["step"] == int(want.step)
    for key in ("params", "state", "opt_state"):
        g = list(_flat(got[key]))
        w = list(_flat(jax.tree_util.tree_map(np.asarray,
                                              getattr(want, key))))
        assert [p for p, _ in g] == [p for p, _ in w], key
        for (path, a), (_, b) in zip(g, w):
            if b is None or isinstance(b, tuple):
                continue
            b = np.asarray(b, np.float64)
            d = np.abs(np.asarray(a, np.float64) - b).max()
            assert d <= CLI_TOL * max(1.0, np.abs(b).max()), (key, path, d)


def _both(dataset, tmp_path, capsys, argv):
    """``argv`` (after the base flags) through cnn_tpu's CLI, then the
    port's; returns their outputs and iter_4 checkpoints."""
    capsys.readouterr()
    assert j_train.main(_args(dataset, tmp_path / "j", *argv)) == 0
    want = capsys.readouterr().out
    assert train.main(_args(dataset, tmp_path / "t", *argv),
                      device="cpu") == 0
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert "training done!" in got and "Test===>" in got
    end = argv[argv.index("--total-iters") + 1]
    return (got, _one(str(tmp_path / "t" / f"iter_{end}_*.ckpt")),
            _one(str(tmp_path / "j" / f"iter_{end}_*.ckpt")))


@pytest.mark.parametrize("flags", [
    ("--ema", "0.99"),
    ("--optimizer", "adam", "--weight-decay", "1e-4", "--grad-clip", "0.5",
     "--batch-norm", "false"),
    ("--weight-decay", "1e-3", "--grad-clip", "1.0", "--ema", "0.9")],
    ids=["ema", "adamw_clip", "momentum_decay_clip_ema"])
def test_resumed_toolbox_run_matches_cnn_tpu_cli(dataset, tmp_path, capsys,
                                                 flags):
    """cnn_tpu's CLI trains iterations 1-2 with the flags and saves; each
    CLI resumes that checkpoint to iteration 4 with them: the same printed
    lines (validation and the test on the EMA weights), the iter_4
    checkpoints within the CLI bar, optimizer state and EMA included.
    Adam runs without BN: a conv bias before BN has a gradient of zero
    plus float32 noise, which Adam's ``mu / sqrt(nu)`` scales up to a step
    of about the rate in the noise's sign, different in each package."""
    assert j_train.main(_args(dataset, tmp_path / "j0", "--total-iters",
                              "2", *flags)) == 0
    start = _one(str(tmp_path / "j0" / "iter_2_*.ckpt"))
    out, got, want = _both(dataset, tmp_path, capsys,
                           ["--total-iters", "4", "--resume", start, *flags])
    assert f"resumed from {start} at step 2" in out
    _assert_ckpts_close(got, want)


@pytest.mark.parametrize("flags", [
    ("--grad-accum", "2"),
    ("--distill-from", "BASE", "--distill-model", "alexnet",
     "--distill-temp", "3.0", "--distill-alpha", "0.4"),
    ("--distill-from", "BASE,BASE", "--distill-temp", "2.0")],
    ids=["grad_accum_2", "distill", "distill_2_teachers"])
def test_grad_accum_and_distill_match_cnn_tpu_cli(dataset, base_ckpt,
                                                  tmp_path, capsys, flags):
    """Both CLIs resume cnn_tpu's base checkpoint to iteration 4 with
    gradient accumulation, or with teachers (the base checkpoint, read
    as a BN AlexNet): the same lines, the iter_4 checkpoints within the
    CLI bar."""
    flags = [f.replace("BASE", base_ckpt) for f in flags]
    _, got, want = _both(dataset, tmp_path, capsys,
                         ["--total-iters", "4", "--resume", base_ckpt,
                          *flags])
    _assert_ckpts_close(got, want)


def test_warm_start_with_frozen_layers_matches_cnn_tpu_cli(
        dataset, base_ckpt, tmp_path, capsys):
    """A fresh run warm-started from cnn_tpu's base checkpoint with
    conv_layer_1 and bn_layer_1 frozen, under EMA, 2 iterations: the same
    lines ("warm start from ...: 26 tensors copied"), the checkpoints
    within the CLI bar, the frozen layers bit-unchanged."""
    flags = ["--total-iters", "2", "--init-from", base_ckpt, "--freeze",
             "conv_layer_1,bn_layer_1", "--ema", "0.9"]
    out, got, want = _both(dataset, tmp_path, capsys, flags)
    assert f"warm start from {base_ckpt}: 26 tensors copied" in out
    _assert_ckpts_close(got, want)
    src, new = read_checkpoint(base_ckpt), read_checkpoint(got)
    for layer in ("conv_layer_1", "bn_layer_1"):
        for key, v in src["params"][layer].items():
            assert np.array_equal(new["params"][layer][key], v), (layer, key)
    assert not np.array_equal(new["params"]["conv_layer_2"]["w"],
                              src["params"]["conv_layer_2"]["w"])


@pytest.fixture(scope="module")
def small_ema_ckpt(tmp_path_factory):
    """A 64 px BN AlexNet checkpoint written by cnn_tpu under with_ema: its
    EMA weights and EMA'd BN state moved away from the raw ones."""
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=True,
                         image_size=64)
    opt = j_optim.with_ema(j_optim.make_optimizer("momentum", 0.01), 0.99)
    ts = j_create_state(jmodel, opt, jax.random.key(13))
    rng = np.random.default_rng(13)
    ema = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        ts.opt_state.ema)
    mstate = jax.tree_util.tree_map(
        lambda s: rng.uniform(0.2, 1.5, s.shape).astype(np.float32),
        ts.opt_state.mstate)
    ts = ts._replace(opt_state=ts.opt_state._replace(ema=ema, mstate=mstate))
    path = str(tmp_path_factory.mktemp("ema") / "small_ema.ckpt")
    j_save_checkpoint(path, ts)
    return path


@pytest.mark.parametrize("which", ["committed", "small"])
def test_evaluate_cli_reports_the_ema_weights_like_cnn_tpu(
        ppm_dataset, small_ema_ckpt, capsys, which):  # noqa: F811
    """The committed legacy EMA checkpoint (no EMA'd BN state: the raw
    one) at 224 px and the small one (its EMA'd BN state) at 64 px: the
    same lines, "evaluating the EMA-averaged weights" among them, the
    loss within its last printed place."""
    path, size = ((EMA, "224") if which == "committed"
                  else (small_ema_ckpt, "64"))
    argv = ["--dataset-path", ppm_dataset, "--image-size", size,
            "--valid-batch-size", "8", "--backend", "python",
            "--num-workers", "2", "--resume", path, "--split", "both"]
    capsys.readouterr()
    assert j_evaluate.main(argv) == 0
    want = parse_metrics(capsys.readouterr().out)
    assert evaluate.main(argv, device="cpu") == 0
    got = parse_metrics(capsys.readouterr().out)
    assert f"{path}: evaluating the EMA-averaged weights" in got[1]
    assert got[1] == want[1] and len(got[0]) == len(want[0]) == 2
    for g, w in zip(got[0], want[0]):
        assert g[0] == w[0] and g[2] == w[2]
        assert abs(g[1] - w[1]) <= 1e-3 + 1e-9


@pytest.mark.parametrize("which", ["committed", "small"])
def test_infer_use_ema_matches_cnn_tpu(photo_paths, small_ema_ckpt, capsys,
                                       which):  # noqa: F811
    """``--use-ema`` through both CLIs on the six photos: the same classes
    and probabilities within 1e-5; they differ from the raw weights'."""
    path, size = ((EMA, "224") if which == "committed"
                  else (small_ema_ckpt, "64"))
    argv = ["--checkpoint", path, "--batch-norm", "--image-size", size,
            *photo_paths[:6]]
    rows = {}
    for use_ema in (True, False):
        a = argv + (["--use-ema"] if use_ema else [])
        capsys.readouterr()
        assert j_infer.main(a) == 0
        want, _ = parse_rows(capsys.readouterr().out)
        assert infer.main(a, device="cpu") == 0
        got, _ = parse_rows(capsys.readouterr().out)
        assert [r[:2] for r in got] == [r[:2] for r in want]
        assert len(got) == 6
        for g, w in zip(got, want):
            assert abs(g[2] - w[2]) <= 1e-5
        rows[use_ema] = got
    assert [r[2] for r in rows[True]] != [r[2] for r in rows[False]]


def test_infer_use_ema_without_ema_exits_as_cnn_tpu(photo_paths):  # noqa: F811
    ckpt = glob.glob(os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                                  "iter_5000_*.ckpt"))[0]
    argv = ["--checkpoint", ckpt, "--batch-norm", "--use-ema",
            photo_paths[0]]
    with pytest.raises(ValueError, match="has no EMA state") as want:
        j_infer.main(argv)
    with pytest.raises(ValueError, match="has no EMA state") as got:
        infer.main(argv, device="cpu")
    assert str(got.value) == str(want.value)
