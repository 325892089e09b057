"""The CLIs on the ResNet, MobileNet and PipeCNN families against
``cnn_tpu``'s, on the CPU: the train CLI resumes a copy of a committed
family ``.ckpt`` for 2 iterations in both packages and must land on the
same params, BN statistics and momentum trace (PipeCNN's [L]-stacked trees
among them), and the checkpoint it writes reads back and loads in
``cnn_tpu``; infer ``--model`` and evaluate ``--name`` / ``--ensemble``
print what ``cnn_tpu``'s print on one argv."""

import glob
import os
import shutil

import numpy as np
import pytest

from cnn_tpu.tools import evaluate as j_evaluate
from cnn_tpu.tools import infer as j_infer
from cnn_tpu.tools import train as j_train
from cnn_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.optim import make_optimizer
from cnn_tpu_torch.parallel import create_train_state
from cnn_tpu_torch.tools import evaluate, infer, train
from cnn_tpu_torch.utils.checkpoint import (load_checkpoint, model_trees,
                                            read_checkpoint)
from test_torch_data import write_dataset
from test_torch_evaluate_cli import _parse as parse_metrics
from test_torch_evaluate_cli import ppm_dataset  # noqa: F401
from test_torch_infer_cli import _parse as parse_infer
from test_torch_infer_cli import photo_paths  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {"resnet10": "iter_15000_train_0.997_valid_0.970.ckpt",
         "mobilenet": "iter_5000_train_0.993_valid_0.973.ckpt",
         "pipecnn": "iter_11000_train_0.999_valid_0.900.ckpt"}
TOL = 1e-4            # times max(1, max|ref|)
BASE = ["--image-size", "64", "--train-batch-size", "8",
        "--valid-batch-size", "8", "--valid-iters", "2", "--save-iters", "2",
        "--augment", "false", "--batch-norm", "true",
        "--optimizer", "momentum", "--lr-schedule", "cosine",
        "--learning-rate", "1.5e-2", "--backend", "python",
        "--num-workers", "2"]


def _ckpt(name):
    return os.path.join(REPO, "checkpoints", name, CKPTS[name])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("animals"))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _close(got_tree, want_tree, what):
    for path, w in _leaves(want_tree):
        w = np.asarray(w, np.float64)
        d = np.abs(np.asarray(_at(got_tree, path), np.float64) - w).max()
        assert d <= TOL * max(1.0, np.abs(w).max()), (what, path, d)


# The committed PipeCNN is resumed by neither test CLI: on its batches one
# float32 sum order against another moves JAX's own gradients by up to 5%
# (its BN's one-pass variance, E[x^2] - E[x]^2, cancels on channels whose
# mean dwarfs their spread), so no float32 port can meet 1e-4 there. The
# PipeCNN run resumes a checkpoint cnn_tpu's CLI writes from a seed; the
# committed one round-trips in ``test_committed_pipecnn_round_trips``.
FAMILY_RUNS = {
    "resnet10": [],
    "pipecnn": ["--width", "16", "--n-blocks", "3"],
}


@pytest.mark.parametrize("name", ["resnet10", "pipecnn"])
def test_train_cli_resumes_a_family_checkpoint_as_cnn_tpu(dataset, tmp_path,
                                                           capsys, name):
    """Both CLIs resume one checkpoint (step s: a copy of the committed
    resnet10 one; a 16-wide, 3-block PipeCNN that cnn_tpu's CLI trained 2
    iterations from a seed) to s + 2: every param, BN statistic and trace
    within 1e-4 x max(1, max|ref|), the same update count and checkpoint
    name; the port's checkpoint reads back into a fresh train state equal
    to what it wrote, and loads in ``cnn_tpu``."""
    family = ["--name", name, *FAMILY_RUNS[name]]
    if name == "resnet10":
        start = tmp_path / CKPTS[name]
        shutil.copy(_ckpt(name), start)
    else:
        assert j_train.main(["--dataset-path", dataset, *BASE, *family,
                             "--total-iters", "2", "--checkpoint-dir",
                             str(tmp_path / "j0")]) == 0
        (start,) = glob.glob(str(tmp_path / "j0" / "iter_2_*.ckpt"))
    step = int(read_checkpoint(str(start))["step"])
    argv = ["--dataset-path", dataset, *BASE, *family,
            "--total-iters", str(step + 2), "--resume", str(start)]
    assert j_train.main(argv + ["--checkpoint-dir", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    assert train.main(argv + ["--checkpoint-dir", str(tmp_path / "t")],
                      device="cpu") == 0
    out = capsys.readouterr().out
    assert f"resumed from {start} at step {step}" in out
    assert "training done!" in out
    (want_path,) = glob.glob(str(tmp_path / "j" / f"iter_{step + 2}_*.ckpt"))
    (got_path,) = glob.glob(str(tmp_path / "t" / f"iter_{step + 2}_*.ckpt"))
    assert os.path.basename(got_path) == os.path.basename(want_path)
    want = j_load_checkpoint(want_path)
    got = read_checkpoint(got_path)
    _close(got["params"], want.params, "params")
    _close(got["state"], want.state, "state")
    _close(got["opt_state"][0].trace, want.opt_state[0].trace, "trace")
    assert int(got["opt_state"][1].count) == int(want.opt_state[1].count) \
        == step + 2
    # the port's checkpoint, read back into a fresh train state
    model = get_model(name, num_classes=3, image_size=64, batch_norm=True,
                      device="cpu", **({"width": 16, "n_blocks": 3}
                                       if name == "pipecnn" else {}))
    ts = load_checkpoint(got_path, create_train_state(
        model, make_optimizer("momentum", 1.5e-2, schedule="cosine",
                              total_steps=step + 2)))
    params, state = model_trees(ts.model)
    for a, b in ((params, got["params"]), (state, got["state"])):
        for path, v in _leaves(b):
            assert np.array_equal(_at(a, path), v), path
    back = j_load_checkpoint(got_path)
    assert int(back.step) == step + 2
    _close(back.params, got["params"], "params in cnn_tpu")


def test_committed_pipecnn_round_trips(tmp_path):
    """The committed PipeCNN checkpoint through the port's train state and
    ``save_checkpoint``: its [L]-stacked params, BN state and trace, the
    count and the step come back equal, read by the port and by
    ``cnn_tpu``."""
    from cnn_tpu_torch.utils.checkpoint import save_checkpoint
    model = get_model("pipecnn", num_classes=3, device="cpu")
    ts = load_checkpoint(_ckpt("pipecnn"), create_train_state(
        model, make_optimizer("momentum", 1.5e-2, schedule="cosine",
                              total_steps=20000)))
    assert ts.step == 11000
    out = str(tmp_path / "again.ckpt")
    save_checkpoint(out, ts)
    src = read_checkpoint(_ckpt("pipecnn"))
    got = read_checkpoint(out)
    back = j_load_checkpoint(out)
    assert np.asarray(src["params"]["trunk"]["body"]["b_conv1"]["w"]).shape \
        == (8, 3, 3, 64, 64)
    for tree, jtree, key in ((got["params"], back.params, "params"),
                             (got["state"], back.state, "state"),
                             (got["opt_state"][0].trace,
                              back.opt_state[0].trace, None)):
        ref = src[key] if key else src["opt_state"][0].trace
        assert sorted(p for p, _ in _leaves(tree)) == \
            sorted(p for p, _ in _leaves(ref))
        for path, v in _leaves(ref):
            assert np.array_equal(_at(tree, path), v), path
            assert np.array_equal(np.asarray(_at(jtree, path)), v), path
    assert int(got["opt_state"][1].count) == int(back.opt_state[1].count) \
        == 11000 == int(back.step)


@pytest.mark.parametrize("name", ["resnet10", "mobilenet"])
def test_infer_cli_on_a_family_matches_cnn_tpu(photo_paths, capsys, name):
    argv = ["--checkpoint", _ckpt(name), "--model", name, "--batch-norm",
            "--image-size", "64", *photo_paths[:6]]
    capsys.readouterr()
    assert j_infer.main(argv) == 0
    want, want_other = parse_infer(capsys.readouterr().out)
    assert infer.main(argv, device="cpu") == 0
    got, got_other = parse_infer(capsys.readouterr().out)
    assert len(got) == 6 and [r[:2] for r in got] == [r[:2] for r in want]
    assert all(abs(g[2] - w[2]) <= 1e-5 for g, w in zip(got, want))
    assert got_other == want_other


@pytest.mark.parametrize("name", ["resnet10", "mobilenet"])
def test_evaluate_cli_on_a_family_matches_cnn_tpu(ppm_dataset, capsys,  # noqa: F811
                                                  name):
    """``--name`` on one checkpoint (resnet10), an ensemble of two families
    with a shaped member (mobilenet): the same lines (confusion matrices
    among them), the printed loss within 1e-3 and the accuracies equal."""
    more = (["--resume", _ckpt(name), "--name", name] if name == "resnet10"
            else ["--ensemble", f"{name}@width=1.0:{_ckpt(name)},"
                                f"resnet10:{_ckpt('resnet10')}"])
    argv = ["--dataset-path", ppm_dataset, "--image-size", "64",
            "--valid-batch-size", "8", "--backend", "python",
            "--num-workers", "2", "--split", "both", *more]
    capsys.readouterr()
    assert j_evaluate.main(argv) == 0
    want = parse_metrics(capsys.readouterr().out)
    assert evaluate.main(argv, device="cpu") == 0
    got = parse_metrics(capsys.readouterr().out)
    assert got[1] == want[1]
    assert len(got[0]) == len(want[0]) == 2
    for g, w in zip(got[0], want[0]):
        assert g[0] == w[0] and g[2] == w[2]
        assert abs(g[1] - w[1]) <= 1e-3 + 1e-9
