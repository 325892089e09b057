"""Inference engine, counterpart of ``cnn_tpu/serving.py``.

Requests of any batch size are padded up to the nearest of a few static
bucket sizes and run as one batch; a request larger than the top bucket
streams in top-bucket chunks, with the remainder in the smallest bucket that
holds it. Each bucket call runs, on the engine's device: the uint8 normalize
kernel, the model (conv and max-pool kernels), then an f32 softmax and
argmax. Weights stay on the device.

Usage:
    engine = InferenceEngine(model, buckets=(1, 8, 64))
    engine.warmup()
    labels, probs = engine.predict(images_uint8)   # [N,H,W,3] uint8
"""

from __future__ import annotations

import bisect
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from cnn_tpu_torch import default_device
from cnn_tpu_torch.ops.hopper.normalize import uint8_normalize


class InferenceEngine:
    def __init__(self, model, buckets=(1, 8, 64), device=None):
        self.device = default_device(device)
        self.model = model.to(self.device).eval()
        self.buckets = tuple(sorted(buckets))
        size = model.image_size
        self.image_shape = (size, size, 3)

    def warmup(self) -> None:
        """Runs one throwaway batch, which builds the kernels on first use."""
        self.predict(np.zeros((1, *self.image_shape), np.uint8))

    def predict(self, images_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """[N,H,W,3] uint8 -> (labels [N] int64, probs [N,C] f32)."""
        images_u8 = np.asarray(images_u8)
        if images_u8.dtype != np.uint8 or images_u8.ndim != 4 \
                or images_u8.shape[1:] != self.image_shape \
                or images_u8.shape[0] < 1:
            raise ValueError(f"expects [N,{','.join(map(str, self.image_shape))}]"
                             f" uint8 with N >= 1, got {images_u8.dtype} "
                             f"{images_u8.shape}")
        n = images_u8.shape[0]
        labels_out, probs_out = [], []
        pos = 0
        top = self.buckets[-1]
        while n - pos > top:                  # stream full top-sized chunks
            l, p = self._run(top, images_u8[pos:pos + top])
            labels_out.append(l)
            probs_out.append(p)
            pos += top
        rem = n - pos                         # remainder -> smallest bucket >= rem
        l, p = self._run(self.buckets[bisect.bisect_left(self.buckets, rem)],
                         images_u8[pos:])
        labels_out.append(l)
        probs_out.append(p)
        return np.concatenate(labels_out), np.concatenate(probs_out)

    def _run(self, bucket: int, chunk: np.ndarray):
        rem = chunk.shape[0]
        batch = np.zeros((bucket, *self.image_shape), np.uint8)
        batch[:rem] = chunk
        with torch.inference_mode():
            x = uint8_normalize(torch.from_numpy(batch).to(self.device))
            logits = self.model(x)
            probs = torch.softmax(logits.float(), dim=-1)
            labels = torch.argmax(probs, dim=-1)
            return labels[:rem].cpu().numpy(), probs[:rem].cpu().numpy()


class BatchingServer:
    """Dynamic micro-batching on top of an ``InferenceEngine``.

    Callers ``submit(image)`` from any thread and get a ``Future``; one
    worker thread drains the queue, groups up to ``max_batch`` requests that
    arrive within ``batch_timeout_ms`` of the first, runs one engine call,
    and resolves each future.

    Usage:
        with BatchingServer(engine, batch_timeout_ms=2.0) as srv:
            fut = srv.submit(image_u8)          # [H,W,3] uint8
            label, probs = fut.result()
    """

    _STOP = object()

    def __init__(self, engine: InferenceEngine, max_batch: int | None = None,
                 batch_timeout_ms: float = 2.0):
        self.engine = engine
        self.max_batch = max_batch or engine.buckets[-1]
        self.timeout = batch_timeout_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None

    def start(self) -> "BatchingServer":
        if self._worker is not None:
            raise RuntimeError("already started")
        self.engine.warmup()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        return self

    def stop(self) -> None:
        if self._worker is not None:
            self._q.put(self._STOP)
            self._worker.join()
            self._worker = None

    __enter__ = start

    def __exit__(self, *exc):
        self.stop()

    def submit(self, image_u8: np.ndarray) -> Future:
        if self._worker is None:
            raise RuntimeError("server not started")
        fut: Future = Future()
        self._q.put((image_u8, fut))
        return fut

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            batch = [item]
            deadline = time.monotonic() + self.timeout
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                try:
                    nxt = self._q.get(timeout=max(remaining, 0.0))
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch) -> None:
        try:
            # stack inside the try: one malformed submit fails its window's
            # futures instead of killing the worker (which would hang them all)
            imgs = np.stack([b[0] for b in batch])
            labels, probs = self.engine.predict(imgs)
        except Exception as e:                      # surface, don't hang
            for _, fut in batch:
                fut.set_exception(e)
            return
        for i, (_, fut) in enumerate(batch):
            fut.set_result((int(labels[i]), probs[i]))
