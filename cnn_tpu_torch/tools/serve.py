"""Serving CLI, counterpart of ``cnn_tpu/tools/serve.py``: stream image
paths (stdin or args) through ``serving.InferenceEngine``, either in
pipelined streaming mode (``--stream``, ``predict_stream``) or through the
micro-batching ``BatchingServer`` (default), printing one
``path<TAB>label<TAB>prob`` line per request.

``--listen PORT`` runs a TCP server instead: each connection sends any
number of length-prefixed encoded images (4-byte big-endian length, then
JPEG / PNG / PPM bytes) and receives a length-prefixed ``category\\tprob``
line per image (``ERROR\\t...`` for a frame too large, bytes that do not
decode, or an engine failure). Concurrent connections share the engine
through one micro-batching server.

``--int8`` serves the post-training-quantized graph (``quant.py``),
calibrated on the request images (under ``--listen``, on the image paths
given as arguments). ``--artifact`` serves a file of
``cnn_tpu_torch.tools.export_artifact`` instead of a checkpoint.

It runs on the GPU; ``main(argv, device="cpu")`` runs on the CPU.

Usage:
    python -m cnn_tpu_torch.tools.serve img1.jpg img2.jpg ...
    find dir/ -name '*.jpg' | python -m cnn_tpu_torch.tools.serve --checkpoint ck
    python -m cnn_tpu_torch.tools.serve --listen 7070 &
    python -m cnn_tpu_torch.tools.serve --artifact model.ctsa img1.jpg
"""

from __future__ import annotations

import argparse
import socket
import struct
import sys
import threading

import numpy as np

from cnn_tpu_torch import default_device
from cnn_tpu_torch.data.image import imdecode, imread, resize
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.serving import BatchingServer, InferenceEngine
from cnn_tpu_torch.tools.infer import DEFAULT_CKPT, load_params

MAX_FRAME_BYTES = 64 << 20   # reject absurd length headers up front


def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
    chunks, got = [], 0
    while got < n:
        chunk = conn.recv(n - got)
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _reply(conn: socket.socket, payload: bytes) -> None:
    conn.sendall(struct.pack(">I", len(payload)) + payload)


def _client_loop(conn: socket.socket, srv: BatchingServer, size: int,
                 categories: list[str]) -> None:
    with conn:
        while True:
            header = _recv_exact(conn, 4)
            if header is None:
                return
            (length,) = struct.unpack(">I", header)
            if length > MAX_FRAME_BYTES:
                # no way to resynchronize without draining `length` bytes:
                # report and drop the connection
                _reply(conn, b"ERROR\tframe too large")
                return
            payload = _recv_exact(conn, length)
            if payload is None:
                return
            img = imdecode(payload)
            if img is None:
                _reply(conn, b"ERROR\tundecodable")
                continue
            try:
                # a wedged engine must not leave the client hung forever
                # without a framed reply
                label, probs = srv.submit(
                    resize(img, (size, size))).result(timeout=120.0)
                reply = f"{categories[label]}\t{probs[label]:.6f}".encode()
            except Exception as e:  # engine failure / timeout / stopping:
                # the client still gets a framed reply, not an EOF
                reply = f"ERROR\t{type(e).__name__}".encode()
            _reply(conn, reply)


def serve_tcp(engine: InferenceEngine, port: int, size: int,
              categories: list[str], max_batch: int,
              batch_timeout_ms: float, ready_event=None,
              stop_event=None, port_out: list | None = None) -> None:
    """Accept loop: one thread per connection, all feeding one
    micro-batching server (requests from concurrent clients batch into
    single engine calls). ``port`` 0 lets the OS pick; the bound port goes
    into ``port_out``. Returns once ``stop_event`` is set."""
    with BatchingServer(engine, max_batch=max_batch,
                        batch_timeout_ms=batch_timeout_ms) as srv, \
            socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", port))
        sock.listen()
        sock.settimeout(0.2)
        if port_out is not None:
            port_out.append(sock.getsockname()[1])
        if ready_event is not None:
            ready_event.set()
        print(f"serving on 127.0.0.1:{sock.getsockname()[1]}", flush=True)
        while stop_event is None or not stop_event.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            threading.Thread(target=_client_loop,
                             args=(conn, srv, size, categories),
                             daemon=True).start()


def _read(path: str, size: int):
    try:
        img = imread(path)
    except IOError:
        return None
    return resize(img, (size, size))


def main(argv=None, *, device=None):
    """Runs the CLI on ``device`` (default: the GPU); returns 0."""
    ap = argparse.ArgumentParser(description="cnn_tpu_torch serving")
    ap.add_argument("images", nargs="*",
                    help="image paths ('-' or empty: read paths from stdin)")
    ap.add_argument("--checkpoint", default=DEFAULT_CKPT)
    ap.add_argument("--categories", default="dog,panda,bird")
    ap.add_argument("--model", default="alexnet")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch-norm", action="store_true")
    ap.add_argument("--stream", action="store_true",
                    help="pipelined single-request streaming instead of "
                         "micro-batching")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--batch-timeout-ms", type=float, default=2.0)
    ap.add_argument("--int8", action="store_true",
                    help="serve the post-training-quantized graph (BN "
                         "folded, s8 x s8 -> s32 products); the request "
                         "images themselves calibrate activation scales")
    ap.add_argument("--listen", type=int, default=0,
                    help="run a TCP server on this port (length-prefixed "
                         "encoded images in, category\\tprob out)")
    ap.add_argument("--artifact", default=None,
                    help="serve an exported artifact "
                         "(cnn_tpu_torch.tools.export_artifact) instead of a "
                         "checkpoint: no model code or weights needed")
    args = ap.parse_args(argv)
    dev = default_device(device)
    categories = args.categories.split(",")
    buckets = (1,) if args.stream else (1, 8, args.max_batch)

    artifact = None
    if args.artifact:
        from cnn_tpu_torch.export import ServingArtifact
        artifact = ServingArtifact.load(args.artifact, device=dev)
        if artifact.meta.get("class_names"):
            categories = artifact.meta["class_names"]
        args.image_size = artifact.image_size
        if args.int8:
            ap.error("--int8 with --artifact: quantization is decided at "
                     "export time (the artifact may already be int8)")
    else:
        model = get_model(args.model, num_classes=len(categories),
                          image_size=args.image_size,
                          batch_norm=args.batch_norm, device=dev)
        load_params(args.checkpoint, model)

    if args.listen:
        if artifact is not None:
            engine = InferenceEngine.from_artifact(artifact, buckets=buckets)
            serve_tcp(engine, args.listen, args.image_size, categories,
                      args.max_batch, args.batch_timeout_ms)
            return 0
        int8_calib = None
        if args.int8:
            # a server has no request images up front: calibrate from the
            # image paths given on the command line
            calib_imgs = [_read(p, args.image_size) for p in args.images]
            calib_imgs = [im for im in calib_imgs if im is not None]
            if not calib_imgs:
                ap.error("--listen with --int8 needs calibration image "
                         "paths as positional arguments")
            int8_calib = np.stack(calib_imgs[:64])
        engine = InferenceEngine(model, buckets=buckets, device=dev,
                                 int8_calib=int8_calib)
        serve_tcp(engine, args.listen, args.image_size, categories,
                  args.max_batch, args.batch_timeout_ms)
        return 0

    paths = args.images
    if not paths or paths == ["-"]:
        paths = [line.strip() for line in sys.stdin if line.strip()]
    loaded = [(p, _read(p, args.image_size)) for p in paths]
    for p, img in loaded:
        if img is None:
            print(f"{p}\tERROR\tunreadable", flush=True)
    loaded = [(p, img) for p, img in loaded if img is not None]

    if artifact is not None:
        engine = InferenceEngine.from_artifact(artifact, buckets=buckets)
    else:
        int8_calib = None
        if args.int8:
            if not loaded:
                # never serve float32 silently when int8 was asked for
                ap.error("--int8 needs at least one readable image to "
                         "calibrate activation scales")
            int8_calib = np.stack([img for _, img in loaded[:64]])
        engine = InferenceEngine(model, buckets=buckets, device=dev,
                                 int8_calib=int8_calib)

    def emit(path, label, probs):
        print(f"{path}\t{categories[label]}\t{probs[label]:.6f}", flush=True)

    if args.stream:
        engine.warmup()
        results = engine.predict_stream((img for _, img in loaded))
        for (path, _), (label, probs) in zip(loaded, results):
            emit(path, label, probs)
    else:
        with BatchingServer(engine, max_batch=args.max_batch,
                            batch_timeout_ms=args.batch_timeout_ms) as srv:
            futs = [(path, srv.submit(img)) for path, img in loaded]
            for path, fut in futs:
                label, probs = fut.result()
                emit(path, label, probs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
