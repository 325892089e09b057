"""The leftover tools against ``cnn_tpu``'s on the CPU: ``convert`` (the
committed BN AlexNet ``.model`` to ``.ckpt`` and back, and an EMA
``.ckpt`` to ``.model``), ``plot_history`` and the plot CLI's ASCII
curves (matplotlib kept out of both, as on the card), ``make_gif``'s
frames, and ``imdecode`` against ``cv2.imdecode``."""

import glob
import json
import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from cnn_tpu.tools import convert as j_convert
from cnn_tpu.tools import make_gif as j_make_gif
from cnn_tpu.tools import plot as j_plot
from cnn_tpu.utils import history as j_history
from cnn_tpu_torch.data.image import imdecode
from cnn_tpu_torch.tools import convert, make_gif, plot
from cnn_tpu_torch.utils import checkpoint as ckpt
from cnn_tpu_torch.utils import history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "checkpoints", "alexnet_bn_device",
                     "iter_12000_train_0.997_valid_0.937.model")
EMA_CKPT = glob.glob(os.path.join(REPO, "checkpoints", "alexnet_distill",
                                  "iter_*.ckpt"))[0]
FIXTURE = os.path.join(REPO, "tests", "fixtures", "reference_parity.npz")


def _same_tree(a, b):
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)):
        return (type(a).__name__ == type(b).__name__ and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_convert_model_to_ckpt_and_back_matches_cnn_tpu(tmp_path, capsys):
    """``.model`` -> ``.ckpt``: the same params, state, empty optimizer
    state, step and key as ``cnn_tpu``'s; ``.ckpt`` -> ``.model``: the
    bytes ``cnn_tpu`` writes, which are the original file's; the same
    printed lines."""
    mine, theirs = str(tmp_path / "p.ckpt"), str(tmp_path / "j.ckpt")
    argv = ["--batch-norm", "true"]
    capsys.readouterr()
    assert j_convert.main([MODEL, theirs, *argv]) == 0
    j_out = capsys.readouterr().out.replace(theirs, "OUT")
    assert convert.main([MODEL, mine, *argv], device="cpu") == 0
    assert capsys.readouterr().out.replace(mine, "OUT") == j_out
    a, b = ckpt.read_checkpoint(mine), ckpt.read_checkpoint(theirs)
    for key in ("params", "state", "opt_state", "step", "rng",
                "format_version"):
        assert _same_tree(a[key], b[key]), key
    back_mine, back_theirs = str(tmp_path / "p.model"), str(
        tmp_path / "j.model")
    assert convert.main([mine, back_mine, *argv], device="cpu") == 0
    assert j_convert.main([theirs, back_theirs, *argv]) == 0
    with open(back_mine, "rb") as f, open(back_theirs, "rb") as g, \
            open(MODEL, "rb") as h:
        data = f.read()
        assert data == g.read() == h.read()


def test_convert_use_ema_matches_cnn_tpu(tmp_path):
    """``--use-ema`` on an EMA run's ``.ckpt``: byte-identical ``.model``
    files; on a run without EMA both exit with the same message."""
    mine, theirs = str(tmp_path / "p.model"), str(tmp_path / "j.model")
    argv = ["--batch-norm", "true", "--use-ema"]
    assert convert.main([EMA_CKPT, mine, *argv], device="cpu") == 0
    assert j_convert.main([EMA_CKPT, theirs, *argv]) == 0
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    plain = MODEL.replace(".model", ".ckpt")
    with pytest.raises(SystemExit) as got:
        convert.main([plain, mine, *argv], device="cpu")
    with pytest.raises(SystemExit) as want:
        j_convert.main([plain, theirs, *argv])
    assert str(got.value) == str(want.value)


def _history(path, n=150):
    rng = np.random.default_rng(4)
    with open(path, "w") as f:
        for i in range(n):
            row = {"step": 10 * i, "loss": float(2.0 / (1 + i) + rng.uniform(
                0, 0.05)), "accuracy": float(min(1.0, i / 100))}
            if i % 10 == 0:
                row["valid_loss"] = float(1.5 / (1 + i))
            f.write(json.dumps(row) + "\n")


def test_plot_history_ascii_matches_cnn_tpu(tmp_path, monkeypatch, capsys):
    """Without matplotlib (the card's machine has none) both plotters fall
    to ASCII curves: the same text, through ``plot_history`` (150 points,
    downsampled to 72 columns; a key with no data) and through the plot
    CLIs."""
    path = str(tmp_path / "history.jsonl")
    _history(path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    keys = ("loss", "accuracy", "valid_loss", "missing")
    got = history.plot_history(path, keys=keys)
    assert got == j_history.plot_history(path, keys=keys)
    assert "(no data)" in got and got.count("*") > 0
    assert history.read_history(path) == j_history.read_history(path)
    capsys.readouterr()
    assert plot.main([path]) == 0
    mine = capsys.readouterr().out
    assert j_plot.main([path]) == 0
    assert mine == capsys.readouterr().out


def test_make_gif_frames_match_cnn_tpu(tmp_path, capsys):
    """The Grad-CAM-like frames of a directory (PNG and JPEG) resized to
    64: the same frame count, every decoded frame equal to those of
    ``cnn_tpu``'s GIF, the same printed line; a directory without frames
    returns 1 in both."""
    frames = tmp_path / "frames"
    frames.mkdir()
    fx = np.load(FIXTURE)
    for i in range(6):
        img = fx[f"image_u8_{i}"]
        cv2.imwrite(str(frames / f"{i}.{'png' if i % 3 else 'jpg'}"), img)
    mine, theirs = str(tmp_path / "p.gif"), str(tmp_path / "j.gif")
    capsys.readouterr()
    assert make_gif.main([str(frames), mine, "--size", "64"]) == 0
    line = capsys.readouterr().out
    assert j_make_gif.main([str(frames), theirs, "--size", "64"]) == 0
    assert capsys.readouterr().out.replace(theirs, mine) == line

    def decoded(path):
        with Image.open(path) as im:
            out = []
            for k in range(im.n_frames):
                im.seek(k)
                out.append(np.asarray(im.convert("RGB")))
            return out

    a, b = decoded(mine), decoded(theirs)
    assert len(a) == len(b) == 6
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    with Image.open(mine) as im:
        assert im.info["duration"] == 500 and im.info["loop"] == 0
    empty = tmp_path / "empty"
    empty.mkdir()
    assert make_gif.main([str(empty), mine]) == 1
    assert j_make_gif.main([str(empty), theirs]) == 1


@pytest.mark.parametrize("ext", [".png", ".jpg", ".ppm", ".bmp"])
def test_imdecode_matches_cv2(ext):
    """``imdecode`` of encoded bytes equals ``cv2.imdecode``'s colour
    image; bytes that do not decode give None in both."""
    img = np.load(FIXTURE)["image_u8_1"]
    data = cv2.imencode(ext, img)[1].tobytes()
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert np.array_equal(imdecode(data), want)
    assert imdecode(data[:40]) is None
    assert cv2.imdecode(np.frombuffer(data[:40], np.uint8),
                        cv2.IMREAD_COLOR) is None
