"""The port's train CLI against cnn_tpu's, on the CPU: both resume the same
cnn_tpu checkpoint on the same host-loader stream and must land on the same
weights; the device-dataset modes, preemption and ``--resume auto``, the
flags not ported yet, the toolbox's flags once refused, and
``--profile-dir``."""

import glob
import os
import signal
import socket

import numpy as np
import pytest
import torch

from cnn_tpu.tools import train as j_train
from cnn_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from cnn_tpu_torch.ops.hopper import _build
from cnn_tpu_torch.tools import train
from cnn_tpu_torch.utils.checkpoint import (parse_checkpoint_name,
                                            read_checkpoint)
from cnn_tpu_torch.utils.history import read_history
from cnn_tpu_torch.utils.profiling import StepTimer, device_memory_stats
from test_torch_data import write_dataset

BASE = ["--image-size", "64", "--train-batch-size", "8",
        "--valid-batch-size", "8", "--valid-iters", "2", "--save-iters", "2",
        "--augment", "false", "--batch-norm", "true",
        "--optimizer", "momentum", "--lr-schedule", "cosine",
        "--learning-rate", "1.5e-2", "--backend", "python",
        "--num-workers", "2"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("animals"))


def _args(dataset, ckdir, *more):
    return ["--dataset-path", dataset, "--checkpoint-dir", str(ckdir),
            *BASE, *more]


def _one(pattern):
    found = glob.glob(pattern)
    assert len(found) == 1, (pattern, found)
    return found[0]


def test_resumed_run_matches_cnn_tpu_cli(dataset, tmp_path, capsys):
    """cnn_tpu trains iterations 1-2 and saves; then each CLI resumes that
    checkpoint to iteration 4 on the same loader stream. The two iter_4
    checkpoints: every param and BN statistic within 1e-4 x max(1, max|ref|),
    and the same accuracies in the name."""
    assert j_train.main(_args(dataset, tmp_path / "j0",
                              "--total-iters", "2")) == 0
    start = _one(str(tmp_path / "j0" / "iter_2_*.ckpt"))
    more = ("--total-iters", "4", "--resume", start)
    assert j_train.main(_args(dataset, tmp_path / "j", *more)) == 0
    capsys.readouterr()
    assert train.main(_args(dataset, tmp_path / "t", *more),
                      device="cpu") == 0
    out = capsys.readouterr().out
    assert f"resumed from {start} at step 2" in out
    assert "training done!" in out and "confusion matrix" in out

    want_path = _one(str(tmp_path / "j" / "iter_4_*.ckpt"))
    got_path = _one(str(tmp_path / "t" / "iter_4_*.ckpt"))
    assert parse_checkpoint_name(os.path.basename(got_path)) == \
        parse_checkpoint_name(os.path.basename(want_path))
    want = j_load_checkpoint(want_path)
    got = read_checkpoint(got_path)
    assert got["step"] == int(want.step) == 4
    for tree, ref in (("params", want.params), ("state", want.state)):
        for layer, leaves in ref.items():
            for key, w in leaves.items():
                w = np.asarray(w, np.float64)
                d = np.abs(got[tree][layer][key] - w).max()
                assert d <= 1e-4 * max(1.0, np.abs(w).max()), \
                    (tree, layer, key, d)
    trace = got["opt_state"][0].trace
    for layer, leaves in want.opt_state[0].trace.items():
        for key, w in leaves.items():
            w = np.asarray(w, np.float64)
            assert np.abs(trace[layer][key] - w).max() <= \
                1e-4 * max(1.0, np.abs(w).max()), (layer, key)
    assert int(got["opt_state"][1].count) == int(want.opt_state[1].count) == 4
    hist = read_history(str(tmp_path / "t" / "history.jsonl"))
    assert [h["step"] for h in hist] == [4]


@pytest.mark.parametrize("mode,dtype", [("fast", "float32"),
                                        ("full", "bfloat16")])
def test_device_dataset_modes_run(dataset, tmp_path, capsys, mode, dtype):
    rc = train.main(_args(dataset, tmp_path, "--total-iters", "4",
                          "--device-dataset", "true", "--augment", "true",
                          "--augment-mode", mode, "--canvas-size", "72",
                          "--compute-dtype", dtype),
                    device="cpu")
    out = capsys.readouterr().out
    assert rc == 0
    assert "training done!" in out and "confusion matrix" in out
    names = sorted(os.path.basename(p) for p in
                   glob.glob(str(tmp_path / "*.ckpt")))
    assert [parse_checkpoint_name(n)[0] for n in names] == [2, 4]
    assert len(read_history(str(tmp_path / "history.jsonl"))) == 2


def test_host_loader_with_device_augment_runs(dataset, tmp_path, capsys):
    rc = train.main(_args(dataset, tmp_path, "--total-iters", "2",
                          "--augment", "true", "--device-augment", "true",
                          "--augment-mode", "fast", "--canvas-size", "72"),
                    device="cpu")
    assert rc == 0 and "training done!" in capsys.readouterr().out


def test_preemption_checkpoints_and_resume_auto_continues(dataset, tmp_path,
                                                          capsys,
                                                          monkeypatch):
    real = train.make_train_step

    def preempting(*args, **kwargs):
        step = real(*args, **kwargs)
        calls = []

        def wrapped(ts, images, labels):
            calls.append(1)
            if len(calls) == 3:
                os.kill(os.getpid(), signal.SIGUSR1)
            return step(ts, images, labels)
        return wrapped

    monkeypatch.setattr(train, "make_train_step", preempting)
    before = signal.getsignal(signal.SIGUSR1)
    assert train.main(_args(dataset, tmp_path, "--total-iters", "6"),
                      device="cpu") == 0
    assert signal.getsignal(signal.SIGUSR1) is before
    out = capsys.readouterr().out
    assert "preemption signal: checkpointed step 3" in out
    assert "Test===>" not in out
    path = str(tmp_path / "preempt_iter_3.ckpt")
    assert read_checkpoint(path)["step"] == 3
    monkeypatch.setattr(train, "make_train_step", real)
    assert train.main(_args(dataset, tmp_path, "--total-iters", "6",
                            "--resume", "auto"), device="cpu") == 0
    out = capsys.readouterr().out
    assert f"resumed from {path} at step 3" in out
    assert "Test===>" in out
    assert [h["step"] for h in read_history(
        str(tmp_path / "history.jsonl"))] == [2, 4, 6]


def _metric_lines(out: str) -> list:
    return [l.strip() for l in out.splitlines()
            if l.startswith(("Valid===>", "Test===>"))]


def test_resumed_run_with_tta_matches_cnn_tpu_cli(dataset, tmp_path, capsys):
    """``--tta hflip`` on the train CLI's validation and final test: both
    CLIs resume one cnn_tpu checkpoint to iteration 4 and report the same
    valid and test lines; the logged valid loss within 1e-4."""
    assert j_train.main(_args(dataset, tmp_path / "j0",
                              "--total-iters", "2")) == 0
    start = _one(str(tmp_path / "j0" / "iter_2_*.ckpt"))
    more = ("--total-iters", "4", "--resume", start, "--tta", "hflip")
    capsys.readouterr()
    assert j_train.main(_args(dataset, tmp_path / "j", *more)) == 0
    want = capsys.readouterr().out
    assert train.main(_args(dataset, tmp_path / "t", *more),
                      device="cpu") == 0
    got = capsys.readouterr().out
    assert _metric_lines(got) == _metric_lines(want)
    assert len(_metric_lines(got)) == 2
    (w,) = read_history(str(tmp_path / "j" / "history.jsonl"))
    (g,) = read_history(str(tmp_path / "t" / "history.jsonl"))
    assert abs(g["valid_loss"] - w["valid_loss"]) <= 1e-4
    assert g["valid_accuracy"] == w["valid_accuracy"]


@pytest.mark.parametrize("more", [("--dropout", "0.25"),
                                  ("--dropout", "0.5", "--tta", "flips",
                                   "--device-dataset", "true")])
def test_dropout_and_tta_flags_run(dataset, tmp_path, capsys, more):
    rc = train.main(_args(dataset, tmp_path, "--total-iters", "2", *more),
                    device="cpu")
    out = capsys.readouterr().out
    assert rc == 0 and "training done!" in out and "Test===>" in out


UNPORTED = [
    ("--multihost", "true"), ("--pipeline-stages", "2"),
    ("--model-parallel", "2"), ("--spatial-parallel", "2"),
    ("--expert-parallel", "2"), ("--data-parallel", "2"),
    ("--compile-cache", "cc"), ("--init-from", "x.ckpt"),
    ("--freeze", "conv_layer_1"), ("--ema", "0.99"),
    ("--distill-from", "t.ckpt"), ("--mixup", "0.2"), ("--cutmix", "0.2"),
    ("--grad-accum", "2"), ("--steps-per-call", "2"),
    ("--color-jitter", "0.1"), ("--space-to-depth", "true"),
    ("--moe-balance", "0.01"), ("--name", "moecnn"),
]
# the flags of the training toolbox, once refused and now run: the
# flags each needs beside it, and the line it prints
TOOLBOX = {
    "--init-from": ((), "warm start from"),
    "--freeze": (("--init-from", "x.ckpt"), "frozen param prefixes: "),
    "--ema": ((), "weight EMA: decay 0.99"),
    "--distill-from": (("--distill-model", "alexnet"),
                       "distilling from 1 teacher(s)"),
    "--mixup": ((), ""), "--cutmix": ((), ""), "--grad-accum": ((), ""),
    "--steps-per-call": (("--device-dataset", "true"), ""),
    "--color-jitter": (("--device-dataset", "true", "--augment", "true",
                        "--augment-mode", "fast", "--canvas-size", "72"),
                       "+ color jitter 0.1"),
    # MoECNN and AlexNet's space-to-depth convs, once refused
    "--space-to-depth": ((), ""),
    "--moe-balance": (("--name", "moecnn"), "MoE load [moe]: "),
    "--name": ((), "MoE load [moe]: "),
    # the kernel library's build root, once refused (on the CPU nothing
    # is built, and the CLI prints no library line)
    "--compile-cache": ((), ""),
}
# the mesh flags, once refused: --multihost runs a one-process job, and a
# mesh of more devices than the ranks fails cnn_tpu's assertion (two
# ranks and four: tests/test_torch_parallel.py)
MESH = {"--multihost": "multihost: process 0/1",
        "--pipeline-stages": "need 2 devices, have 1",
        # 1 device: cnn_tpu's (devices, model, spatial, expert) assertion
        "--model-parallel": r"\(1, 2, 1, 1\)",
        "--spatial-parallel": r"\(1, 1, 2, 1\)",
        "--expert-parallel": r"\(1, 1, 1, 2\)",
        "--data-parallel": "need 2 devices, have 1"}
WARM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "alexnet_bn_device",
    "iter_5000_train_0.986_valid_0.917.ckpt")


def _teacher(path):
    """A seeded BN AlexNet at 64 px written as a .ckpt, a teacher."""
    from cnn_tpu_torch.models import get_model
    from cnn_tpu_torch.optim import make_optimizer
    from cnn_tpu_torch.parallel import create_train_state
    from cnn_tpu_torch.utils.checkpoint import save_checkpoint
    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=64, device="cpu")
    save_checkpoint(path, create_train_state(model,
                                             make_optimizer("sgd", 0.1)))
    return path


@pytest.mark.parametrize("flag,value", UNPORTED)
def test_unported_flag_raises_naming_it(dataset, tmp_path, capsys,
                                        monkeypatch, flag, value):
    """--multihost runs two iterations as a one-process job, and
    --pipeline-stages, --model-parallel, --spatial-parallel,
    --expert-parallel and --data-parallel 2 on one rank fail cnn_tpu's
    assertion that the mesh has its devices (the pipeline on two ranks
    and four: tests/test_torch_pipeline.py); the toolbox's flags,
    --space-to-depth, --moe-balance, --name moecnn and --compile-cache,
    once refused, now run two iterations (against cnn_tpu's CLI:
    tests/test_torch_toolbox_cli.py, tests/test_torch_moe.py and
    tests/test_torch_s2d.py); --compile-cache makes its directory and
    moves the kernel library's build root under it."""
    if flag == "--multihost":
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        assert train.main(_args(
            dataset, tmp_path / "ck", "--total-iters", "2", flag, value,
            "--coordinator", f"localhost:{port}", "--num-processes", "1",
            "--process-id", "0"), device="cpu") == 0
        out = capsys.readouterr().out
        assert MESH[flag] in out and "training done!" in out
        assert not torch.distributed.is_initialized()
        return
    if flag in MESH:
        with pytest.raises(AssertionError, match=MESH[flag]):
            train.main(["--checkpoint-dir", str(tmp_path), flag, value],
                       device="cpu")
        return
    if flag not in TOOLBOX:
        with pytest.raises(NotImplementedError, match=flag):
            train.main(["--checkpoint-dir", str(tmp_path), flag, value],
                       device="cpu")
        return
    more, line = TOOLBOX[flag]
    subst = {"x.ckpt": WARM, "t.ckpt": str(tmp_path / "t.ckpt"),
             "cc": str(tmp_path / "cc")}
    if flag == "--distill-from":
        _teacher(subst["t.ckpt"])
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    argv = [subst.get(a, a) for a in (flag, value, *more)]
    assert train.main(_args(dataset, tmp_path / "ck", "--total-iters", "2",
                            *argv), device="cpu") == 0
    out = capsys.readouterr().out
    assert line in out and "training done!" in out and "Test===>" in out
    if flag == "--compile-cache":
        assert _build.library_path().is_relative_to(tmp_path / "cc")
        assert _build._lib is None and "kernel library" not in out


@pytest.mark.parametrize("argv,name", [
    (["--augment", "true"], "augment"),
    (["--backend", "native"], "native"),
    (["--optimizer", "adam"], "adam"),
    (["--weight-decay", "1e-4"], "weight_decay"),
    (["--grad-clip", "1.0"], "grad_clip")])
def test_unported_options_raise(dataset, tmp_path, capsys, argv, name):
    """The options once refused now train: ``--backend native`` (with
    ``--cache false``, where the native engine resizes each host batch,
    here through the resize kernel's plain version) lands bit for bit on
    the weights of the Python path's run; the host augmentation, Adam,
    weight decay and the clip train (the host augmentation against
    cnn_tpu's CLI: tests/test_torch_host_augment.py)."""
    if name == "native":
        trees = []
        for backend in ("native", "python"):
            assert train.main(_args(dataset, tmp_path / backend,
                                    "--total-iters", "2", "--cache", "false",
                                    "--backend", backend),
                              device="cpu") == 0
            assert "training done!" in capsys.readouterr().out
            ck = read_checkpoint(_one(str(tmp_path / backend
                                          / "iter_2_*.ckpt")))
            trees.append((ck["params"], ck["state"]))
        for tree in (0, 1):
            native, python = trees[0][tree], trees[1][tree]
            assert set(native) == set(python)
            for layer, leaves in native.items():
                for key, w in leaves.items():
                    assert np.array_equal(w, python[layer][key]), (layer, key)
        return
    assert train.main(_args(dataset, tmp_path, "--total-iters", "2", *argv),
                      device="cpu") == 0
    if name == "augment":
        assert "training done!" in capsys.readouterr().out
        return
    ck = read_checkpoint(_one(str(tmp_path / "iter_2_*.ckpt")))
    kinds = [type(st).__name__ for st in ck["opt_state"]]
    assert kinds == {"adam": ["ScaleByAdamState", "ScaleByScheduleState"],
                     "weight_decay": ["EmptyState", "tuple"],
                     "grad_clip": ["EmptyState", "tuple"]}[name]
    assert "training done!" in capsys.readouterr().out


def test_color_jitter_without_device_augment_exits(dataset, tmp_path):
    with pytest.raises(SystemExit, match="--color-jitter is applied by"):
        train.main(_args(dataset, tmp_path, "--total-iters", "2",
                         "--color-jitter", "0.1"), device="cpu")


def test_profile_dir_writes_a_trace(dataset, tmp_path, capsys):
    prof = tmp_path / "prof"
    assert train.main(_args(dataset, tmp_path / "ck", "--total-iters", "2",
                            "--profile-dir", str(prof)), device="cpu") == 0
    assert os.path.getsize(prof / "trace.json") > 0


def test_profiling_helpers():
    timer = StepTimer()
    timer.tick(8)
    timer.tick(8)
    assert timer.images == 16 and timer.steps == 2
    assert timer.images_per_sec > 0 and timer.ms_per_step > 0
    assert device_memory_stats("cpu") == {}


def test_cadence_must_align(dataset, tmp_path):
    with pytest.raises(AssertionError, match="--save-iters 3"):
        train.main(_args(dataset, tmp_path, "--total-iters", "2",
                         "--save-iters", "3"), device="cpu")


def test_best_checkpoint_is_reloaded_for_the_test(dataset, tmp_path, capsys):
    """The best checkpoint the run reloads for its test is the one saved."""
    assert train.main(_args(dataset, tmp_path, "--total-iters", "2"),
                      device="cpu") == 0
    out = capsys.readouterr().out
    best = out.split("best checkpoint: ")[1].split(" ")[0]
    payload = read_checkpoint(best)
    assert payload["step"] == 2 and payload["format_version"] == 1
    assert set(payload["params"]) == {
        "bn_layer_1", "bn_layer_2", "bn_layer_3", "bn_layer_4",
        "conv_layer_1", "conv_layer_2", "conv_layer_3", "conv_layer_4",
        "linear_1"}
