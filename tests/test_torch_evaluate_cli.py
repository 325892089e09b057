"""The evaluate CLI and the eval steps behind it against cnn_tpu's on the
CPU: test-time augmentation and ensembles in ``make_eval_step`` and
``make_ensemble_eval_step``, then both CLIs on one argv over a synthetic
PPM dataset and the committed BN checkpoints (224 px)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_tpu.models import get_model as j_get_model
from cnn_tpu.parallel import make_ensemble_eval_step as j_make_ensemble
from cnn_tpu.parallel import make_eval_step as j_make_eval_step
from cnn_tpu.tools import evaluate as j_evaluate
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.ops.hopper import _build
from cnn_tpu_torch.parallel import make_ensemble_eval_step, make_eval_step
from cnn_tpu_torch.tools import evaluate
from cnn_tpu_torch.utils.checkpoint import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = os.path.join(REPO, "checkpoints", "alexnet_bn_device")
BEST = os.path.join(CKPTS, "iter_12000_train_0.997_valid_0.937.ckpt")
EARLY = os.path.join(CKPTS, "iter_5000_train_0.986_valid_0.917.ckpt")
EMA = os.path.join(REPO, "checkpoints", "alexnet_distill",
                   "iter_17000_train_0.992_valid_0.930.ckpt")
METRIC = re.compile(r"^(Valid|Test)===> \[loss ([\d.]+)\] \[Accuracy ([\d.]+)\]$")


def _pair(rng, seed, batch_norm=True):
    jmodel = j_get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                         image_size=64)
    params, state = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.key(seed)))
    state = {k: {"mean": rng.standard_normal(v["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
             for k, v in state.items()}
    model = get_model("alexnet", num_classes=3, batch_norm=batch_norm,
                      image_size=64, device="cpu")
    load_jax_params(model, params, state)
    return jmodel, params, state, model


def _same_metrics(got, want):
    assert abs(got["loss"].item() - float(want["loss"])) <= 1e-5
    assert int(got["correct"]) == int(want["correct"])
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(want["pred"]))


@pytest.mark.parametrize("tta", ["", "hflip", "flips"])
def test_eval_step_tta_matches_cnn_tpu(rng, tta):
    jmodel, params, state, model = _pair(rng, 4)
    images = rng.integers(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    want = j_make_eval_step(jmodel, tta=tta)(params, state,
                                             jnp.asarray(images),
                                             jnp.asarray(labels))
    got = make_eval_step(model, tta=tta)(torch.from_numpy(images),
                                         torch.from_numpy(labels))
    _same_metrics(got, want)


@pytest.mark.parametrize("tta", ["", "flips"])
def test_ensemble_eval_step_matches_cnn_tpu(rng, tta):
    """A BN member and one without BN: probabilities averaged over every
    (model, view) pair."""
    a, b = _pair(rng, 5, True), _pair(rng, 6, False)
    images = rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, 5).astype(np.int32)
    want = j_make_ensemble([a[0], b[0]], tta=tta)(
        [a[1], b[1]], [a[2], b[2]], jnp.asarray(images), jnp.asarray(labels))
    got = make_ensemble_eval_step([a[3], b[3]], tta=tta)(
        torch.from_numpy(images), torch.from_numpy(labels))
    _same_metrics(got, want)


@pytest.fixture(scope="module")
def ppm_dataset(tmp_path_factory):
    """30 PPM images a class at 240 x 260: colour blocks, the class's
    channel raised, plus noise."""
    root = tmp_path_factory.mktemp("ppm")
    rng = np.random.default_rng(3)
    for c, cat in enumerate(("dog", "panda", "bird")):
        os.makedirs(root / cat)
        for i in range(30):
            lo = rng.integers(0, 160, (30, 33, 3))
            lo[..., c] += 90
            img = np.kron(lo, np.ones((8, 8, 1)))[:240, :260] * 0.75
            img = (img + rng.integers(0, 64, img.shape)).astype(np.uint8)
            (root / cat / f"{i}.ppm").write_bytes(
                b"P6\n260 240\n255\n" + img[:, :, ::-1].tobytes())
    return str(root)


def _parse(out: str):
    """The metric lines as (split, loss, accuracy), every other line."""
    metrics, other = [], []
    for line in out.splitlines():
        m = METRIC.match(line)
        if m:
            metrics.append((m.group(1), float(m.group(2)), m.group(3)))
        elif not line.startswith("[ WARN"):
            other.append(line)
    return metrics, other


@pytest.mark.parametrize("more", [
    ("--resume", BEST, "--split", "both"),
    ("--resume", BEST, "--split", "test", "--tta", "hflip"),
    ("--resume", EARLY, "--split", "valid", "--tta", "flips"),
    ("--ensemble", f"alexnet:{BEST},alexnet:{EARLY}", "--tta", "hflip")])
def test_evaluate_cli_matches_cnn_tpu(ppm_dataset, capsys, more):
    """One argv through both CLIs: the same lines (the confusion matrices
    among them), the printed loss within 1e-3 (its last printed place) and
    the accuracies equal."""
    argv = ["--dataset-path", ppm_dataset, "--image-size", "224",
            "--valid-batch-size", "4", "--backend", "python",
            "--num-workers", "2", *more]
    capsys.readouterr()
    assert j_evaluate.main(argv) == 0
    want = _parse(capsys.readouterr().out)
    assert evaluate.main(argv, device="cpu") == 0
    got = _parse(capsys.readouterr().out)
    assert got[1] == want[1]
    assert len(got[0]) == len(want[0]) >= 1
    for g, w in zip(got[0], want[0]):
        assert g[0] == w[0] and g[2] == w[2]
        assert abs(g[1] - w[1]) <= 1e-3 + 1e-9


def test_evaluate_cli_loss_matches_cnn_tpu_within_1e5(ppm_dataset,
                                                      monkeypatch):
    """The mean loss itself, not its printed rounding: both CLIs' evaluate
    loops report the loss within 1e-5 on ``--split both --tta flips``."""
    seen = {"j": [], "t": []}
    import cnn_tpu.tools.train as j_train
    import cnn_tpu_torch.tools.evaluate as t_eval
    real_j, real_t = j_train.evaluate, t_eval.evaluate

    def spy_j(*args, **kwargs):
        out = real_j(*args, **kwargs)
        seen["j"].append(out)
        return out

    def spy_t(*args, **kwargs):
        out = real_t(*args, **kwargs)
        seen["t"].append(out)
        return out
    monkeypatch.setattr(j_train, "evaluate", spy_j)
    monkeypatch.setattr(t_eval, "evaluate", spy_t)
    argv = ["--dataset-path", ppm_dataset, "--image-size", "224",
            "--valid-batch-size", "8", "--backend", "python",
            "--resume", BEST, "--tta", "flips"]
    assert j_evaluate.main(argv) == 0
    assert evaluate.main(argv, device="cpu") == 0
    assert len(seen["t"]) == len(seen["j"]) == 2
    for (gl, ga), (wl, wa) in zip(seen["t"], seen["j"]):
        assert abs(gl - wl) <= 1e-5 and ga == wa


def test_evaluate_cli_refusals(ppm_dataset, capsys, tmp_path, monkeypatch):
    base = ["--dataset-path", ppm_dataset, "--image-size", "224"]
    assert evaluate.main(["--resume", "/nonexistent.ckpt"], device="cpu") == 2
    # an EMA checkpoint, once refused, is evaluated on its EMA weights
    # (against cnn_tpu's: tests/test_torch_toolbox_cli.py)
    capsys.readouterr()
    assert evaluate.main(base + ["--resume", EMA, "--split", "test"],
                         device="cpu") == 0
    out = capsys.readouterr().out
    assert f"{EMA}: evaluating the EMA-averaged weights" in out
    assert "Test===>" in out
    # moecnn, once refused, builds (tests/test_torch_moe.py evaluates the
    # committed one): an AlexNet checkpoint does not fit it
    with pytest.raises(KeyError, match="stem_conv1"):
        evaluate.main(base + ["--ensemble", f"moecnn:{BEST}"], device="cpu")
    # --compile-cache, once refused, moves the kernel library's build root
    # under its directory (on the CPU nothing is built)
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    cache = tmp_path / "cc"
    assert evaluate.main(base + ["--resume", BEST, "--split", "valid",
                                 "--compile-cache", str(cache)],
                         device="cpu") == 0
    assert _build.library_path().is_relative_to(cache)
    assert _build._lib is None
