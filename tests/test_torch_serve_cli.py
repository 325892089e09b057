"""The serving CLI (``cnn_tpu_torch/tools/serve.py``) and the artifact
export CLI against ``cnn_tpu``'s on the CPU: the six fixture photos written
as PPM, served at 64 px by the committed ResNet10 through the same argv in
the stdin, ``--stream`` and ``--int8`` modes; ``export_artifact`` then
``serve --artifact``; the TCP server end to end on port 0."""

import glob
import io
import os
import socket
import struct
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import cv2
import numpy as np
import pytest

from cnn_tpu.tools import serve as j_serve
from cnn_tpu_torch.data.image import resize
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.serving import InferenceEngine
from cnn_tpu_torch.tools import export_artifact, serve
from cnn_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = sorted(glob.glob(os.path.join(REPO, "checkpoints", "resnet10",
                                     "iter_*.ckpt")),
              key=lambda p: int(os.path.basename(p).split("_")[1]))[-1]
FIXTURE = os.path.join(REPO, "tests", "fixtures", "reference_parity.npz")
ARGV = ["--checkpoint", CKPT, "--model", "resnet10", "--image-size", "64",
        "--max-batch", "8"]
PROB_TOL = 2e-6    # printed to 6 places: the two float32 sums may round apart


def _ppm(img_bgr: np.ndarray) -> bytes:
    h, w, _ = img_bgr.shape
    return (f"P6\n{w} {h}\n255\n".encode()
            + np.ascontiguousarray(img_bgr[:, :, ::-1]).tobytes())


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    root = tmp_path_factory.mktemp("photos")
    fx = np.load(FIXTURE)
    imgs = [fx[f"image_u8_{i}"] for i in range(6)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(root / f"{i}.ppm"))
        with open(paths[-1], "wb") as f:
            f.write(_ppm(img))
    return paths, imgs


def _rows(out: str):
    rows = []
    for line in out.splitlines():
        parts = line.split("\t")
        if len(parts) == 3 and parts[1] != "ERROR":
            rows.append((parts[0], parts[1], float(parts[2])))
        elif line.strip():
            rows.append(tuple(parts))
    return rows


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if len(g) == 3 and isinstance(g[2], float):
            assert g[:2] == w[:2] and abs(g[2] - w[2]) <= PROB_TOL, (g, w)
        else:
            assert g == w


def _run(main, argv, stdin: str, capsys, **kw):
    capsys.readouterr()
    with mock.patch.object(sys, "stdin", io.StringIO(stdin)):
        assert main(argv, **kw) == 0
    return _rows(capsys.readouterr().out)


@pytest.mark.parametrize("mode", [[], ["--stream"], ["--int8"]])
def test_serve_cli_matches_cnn_tpu(photos, capsys, mode):
    """Paths on stdin (and one that does not decode) through both CLIs:
    the same lines, each probability within 2e-6 (printed to 6 places)."""
    paths, _ = photos
    stdin = "\n".join(paths + ["/nonexistent/x.jpg"]) + "\n"
    want = _run(j_serve.main, ARGV + mode, stdin, capsys)
    got = _run(serve.main, ARGV + mode, stdin, capsys, device="cpu")
    assert ("/nonexistent/x.jpg", "ERROR", "unreadable") in got
    assert sum(len(r) == 3 and isinstance(r[2], float) for r in got) == 6
    _same_rows(got, want)


@pytest.mark.parametrize("int8", [False, True])
def test_export_artifact_then_serve_it(tmp_path, photos, capsys, int8):
    """``export_artifact`` prints ``cnn_tpu``'s line; ``serve --artifact``
    then prints exactly what ``serve`` prints from the checkpoint (int8:
    calibrated on the same images in the same order)."""
    paths, _ = photos
    out = str(tmp_path / "r10.ctsa")
    argv = [CKPT, out, "--name", "resnet10", "--image-size", "64"]
    if int8:
        argv += ["--int8", *paths]
    capsys.readouterr()
    assert export_artifact.main(argv, device="cpu") == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"exported {CKPT} -> {out} (")
    assert line.endswith(f"MB, platforms=['cuda', 'cpu'], int8={int8})")
    stdin = "\n".join(paths) + "\n"
    want = _run(serve.main, ARGV + (["--int8"] if int8 else []), stdin,
                capsys, device="cpu")
    got = _run(serve.main, ["--artifact", out, "--max-batch", "8"], stdin,
               capsys, device="cpu")
    assert got == want
    with pytest.raises(SystemExit):
        serve.main(["--artifact", out, "--int8", *paths], device="cpu")


def _frame(conn, payload: bytes) -> None:
    conn.sendall(struct.pack(">I", len(payload)) + payload)


def _reply(conn) -> str:
    head = b""
    while len(head) < 4:
        head += conn.recv(4 - len(head))
    (n,) = struct.unpack(">I", head)
    body = b""
    while len(body) < n:
        body += conn.recv(n - len(body))
    return body.decode()


def test_tcp_server_end_to_end(photos):
    """``serve_tcp`` on port 0: four concurrent clients send the photos as
    PPM and PNG frames; each reply equals ``predict``'s line for the
    image; an undecodable frame gets ``ERROR\\tundecodable`` and the
    connection goes on; an oversized length gets ``ERROR\\tframe too
    large`` and the connection closes."""
    _, imgs = photos
    payload = ckpt.read_checkpoint(CKPT)
    model = get_model("resnet10", num_classes=3, image_size=64,
                      batch_norm=True, device="cpu")
    ckpt.load_jax_params(model, payload["params"], payload["state"])
    engine = InferenceEngine(model, buckets=(1, 8), device="cpu")
    cats = ["dog", "panda", "bird"]
    labels, probs = engine.predict(np.stack([resize(i, (64, 64))
                                             for i in imgs]))
    want = [f"{cats[l]}\t{p[l]:.6f}" for l, p in zip(labels, probs)]
    ready, stop, port = threading.Event(), threading.Event(), []
    server = threading.Thread(target=serve.serve_tcp, args=(
        engine, 0, 64, cats, 8, 2.0), kwargs=dict(
        ready_event=ready, stop_event=stop, port_out=port), daemon=True)
    server.start()
    assert ready.wait(60)

    def client(k):
        with socket.create_connection(("127.0.0.1", port[0]),
                                      timeout=60) as conn:
            out = []
            for i, img in enumerate(imgs):
                enc = (_ppm(img) if (i + k) % 2 else
                       cv2.imencode(".png", img)[1].tobytes())
                _frame(conn, enc)
                out.append(_reply(conn))
            _frame(conn, b"not an image")
            out.append(_reply(conn))
            conn.sendall(struct.pack(">I", serve.MAX_FRAME_BYTES + 1))
            out.append(_reply(conn))
            assert conn.recv(1) == b""          # the server hung up
            return out

    try:
        with ThreadPoolExecutor(4) as pool:
            results = list(pool.map(client, range(4)))
    finally:
        stop.set()
        server.join(10)
    assert not server.is_alive()
    for out in results:
        assert out == want + ["ERROR\tundecodable", "ERROR\tframe too large"]
