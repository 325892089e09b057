"""Inference engine, counterpart of ``cnn_tpu/serving.py``.

Requests of any batch size are padded up to the nearest of a few static
bucket sizes and run as one batch; a request larger than the top bucket
streams in top-bucket chunks, with the remainder in the smallest bucket that
holds it. Each bucket call runs, on the engine's device: the uint8 normalize
kernel (to float32), the model (conv and max-pool kernels) in the engine's
``compute_dtype`` (float32 by default; bf16 casts at each conv and the
linear layer), then an f32 softmax and argmax. Weights stay on the device,
in float32.

A request is padded with zero images at the end, as ``cnn_tpu`` pads it:
MoECNN's expert capacity depends on the bucket's batch, so its results
depend on the bucket and on that padding (``nn/moe.py``).

``warmup()`` makes every bucket ready, as ``cnn_tpu``'s compiles one
executable per bucket. On a CUDA device it captures one CUDA graph per
bucket (largest first, one memory pool shared by all), from a static uint8
input to static probs and labels, so that a bucket call is a copy in, one
replay and a copy out. On the CPU, which the caller has to ask for, every
call runs eagerly and warmup runs each bucket once.

The same buckets and graphs serve a folded model (``quant.fold_batchnorm``,
passed as the model), the int8 graph (``int8_calib=``: BN folded, every
conv and the dense head s8 x s8 -> s32, ``quant.py``) and a loaded serving
artifact (``from_artifact``, ``export.py``). ``predict_stream`` pipelines
single-image requests through the smallest bucket's graph.

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
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from cnn_tpu_torch import default_device
from cnn_tpu_torch.ops.hopper import add_counters, counted_capture
from cnn_tpu_torch.ops.hopper.normalize import uint8_normalize


@dataclass
class BucketGraph:
    """One bucket's CUDA graph and the buffers it reads and writes."""
    graph: torch.cuda.CUDAGraph
    host: torch.Tensor      # pinned uint8 staging, [bucket,H,W,3]
    images: torch.Tensor    # the graph's uint8 input on the device
    probs: torch.Tensor     # its outputs
    labels: torch.Tensor
    launches: dict          # the kernel counters one replay moves
    stale: int = 0          # rows of ``host`` holding an earlier request


def bucket_forward(model, images: torch.Tensor, compute_dtype=None):
    """One bucket's work: uint8 [B,H,W,3] -> (labels [B], probs [B,C] f32)
    through the normalize kernel, ``model`` (in ``compute_dtype``) and a
    float32 softmax; what a serving artifact exports (``export.py``)."""
    logits = model(uint8_normalize(images), compute_dtype=compute_dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.argmax(probs, dim=-1), probs


def _host_labels(labels: torch.Tensor) -> np.ndarray:
    """A bucket's labels copied out as numpy int32, the dtype of
    ``cnn_tpu``'s ``jnp.argmax``; the graphs keep their int64 argmax."""
    return labels.cpu().numpy().astype(np.int32)


@dataclass
class StreamSlot:
    """One in-flight request of ``predict_stream``: its pinned input and
    outputs and the event after its outputs' copy."""
    host: torch.Tensor
    probs: torch.Tensor
    labels: torch.Tensor
    done: torch.cuda.Event


class InferenceEngine:
    def __init__(self, model, buckets=(1, 8, 64), device=None,
                 compute_dtype=None, int8_calib=None):
        """``int8_calib``: a [N,H,W,3] uint8 batch of representative images
        switches the engine to the post-training-quantized graph
        (``quant.py``): BatchNorm folded away, every conv and the dense
        head s8 x s8 -> s32 with calibrated activation scales; it is
        quantized once, here, on the engine's device (``compute_dtype``
        then has no effect). A folded model (``quant.fold_batchnorm``) is
        served by passing it as ``model``."""
        self.device = default_device(device)
        self.compute_dtype = compute_dtype
        self._artifact = None
        model = model.to(self.device).eval()
        if int8_calib is not None:
            from cnn_tpu_torch.quant import QuantizedModel, quantize_int8
            model = QuantizedModel(*quantize_int8(model, int8_calib))
        self.model = model
        self._setup(buckets, model.image_size)

    @classmethod
    def from_artifact(cls, artifact, buckets=(1, 8, 64)) -> "InferenceEngine":
        """Serve a loaded ``export.ServingArtifact``: the program and its
        weights come out of the file, no model class is built; the engine
        adds the buckets, one CUDA graph per bucket around the program,
        streaming and micro-batching, on the artifact's device."""
        eng = cls.__new__(cls)
        eng.device = artifact.device
        eng.compute_dtype = None
        eng._artifact = artifact
        eng.model = artifact          # only .image_size is read
        eng._setup(buckets, artifact.image_size)
        return eng

    def _setup(self, buckets, size: int) -> None:
        self.buckets = tuple(sorted(buckets))
        self.image_shape = (size, size, 3)
        # bucket -> its BucketGraph on CUDA, None on the CPU
        self._ready: dict[int, BucketGraph | None] = {}
        # graphs share static buffers: one bucket call at a time
        self._lock = threading.Lock()
        self._pool = None

    @property
    def ready_buckets(self) -> tuple[int, ...]:
        return tuple(sorted(self._ready))

    def warmup(self) -> None:
        """Makes every bucket ready that is not, largest first, and runs it
        once: on CUDA it captures the bucket's graph and replays it; on the
        CPU it runs the bucket eagerly. Call it before the first request on
        CUDA, and before other threads use the device: a capture refuses
        unsafe CUDA calls from any thread while it runs."""
        for b in sorted(self.buckets, reverse=True):
            if b in self._ready:
                continue
            with self._lock:
                self._ready[b] = (self._capture(b) if self.device.type == "cuda"
                                  else None)
            self._run(b, np.zeros((b, *self.image_shape), np.uint8))

    def _forward(self, images: torch.Tensor):
        """uint8 [B,H,W,3] on the device -> (probs [B,C] f32, labels [B])."""
        if self._artifact is not None:
            labels, probs = self._artifact(images)
            return probs, labels
        labels, probs = bucket_forward(self.model, images, self.compute_dtype)
        return probs, labels

    def _capture(self, bucket: int) -> BucketGraph:
        """One eager pass on a side stream, then the capture. The capture's
        own kernel calls count nothing; ``launches`` is what a replay adds."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        shape = (bucket, *self.image_shape)
        images = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        host = torch.zeros(shape, dtype=torch.uint8, pin_memory=True)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.no_grad():
            self._forward(images)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.no_grad(), torch.cuda.graph(graph, pool=self._pool):
                return self._forward(images)

        (probs, labels), launches = counted_capture(capture)
        return BucketGraph(graph, host, images, probs, labels, launches)

    def predict(self, images_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """[N,H,W,3] uint8 -> (labels [N] int32, probs [N,C] f32)."""
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

    def predict_stream(self, images_iter, depth: int = 8):
        """Pipelined request stream, as ``cnn_tpu``'s: each image runs alone
        in the smallest configured bucket, its outputs copied back
        asynchronously, and a result is read only once ``depth`` requests
        are in flight. Yields ``(label int, probs [C])`` in submission
        order, bit for bit what ``predict`` gives each image.

        On CUDA each request takes a slot of a ring of ``depth``: a pinned
        input staging buffer, pinned outputs and an event. Every replay of
        the bucket's graph overwrites the same static outputs, so each
        request's are copied into its own slot (non-blocking, on the
        stream, before the next replay) and the event marks them copied. A
        slot is taken again only after its request was yielded, past its
        event, so its staging is never rewritten before its upload ran."""
        b = self.buckets[0]
        if self.device.type != "cuda":
            for img in images_iter:
                labels, probs = self._run_eager(b, np.asarray(img)[None])
                yield int(labels[0]), probs[0]
            return
        if b not in self._ready:
            raise RuntimeError(f"bucket {b} has no CUDA graph: call "
                               "warmup() before the first request")
        g = self._ready[b]
        slots = [StreamSlot(torch.zeros(g.host.shape, dtype=torch.uint8,
                                        pin_memory=True),
                            torch.empty(g.probs.shape, dtype=g.probs.dtype,
                                        pin_memory=True),
                            torch.empty(g.labels.shape, dtype=g.labels.dtype,
                                        pin_memory=True),
                            torch.cuda.Event())
                 for _ in range(depth)]
        inflight: deque = deque()

        def drain_one():
            slot = inflight.popleft()
            slot.done.synchronize()
            return int(slot.labels[0]), slot.probs[0].numpy().copy()

        for j, img in enumerate(images_iter):
            slot = slots[j % depth]
            slot.host.numpy()[0] = img
            with self._lock:
                g.images.copy_(slot.host, non_blocking=True)
                g.graph.replay()
                add_counters(g.launches)
                slot.probs.copy_(g.probs, non_blocking=True)
                slot.labels.copy_(g.labels, non_blocking=True)
                slot.done.record()
            inflight.append(slot)
            if len(inflight) >= depth:
                yield drain_one()
        while inflight:
            yield drain_one()

    def _run(self, bucket: int, chunk: np.ndarray):
        if self.device.type != "cuda":
            return self._run_eager(bucket, chunk)
        if bucket not in self._ready:
            raise RuntimeError(f"bucket {bucket} has no CUDA graph: call "
                               "warmup() before the first request")
        rem = chunk.shape[0]
        with self._lock:
            g = self._ready[bucket]
            staging = g.host.numpy()
            staging[:rem] = chunk
            if g.stale > rem:                 # zero the padding
                staging[rem:g.stale] = 0
            g.stale = rem
            g.images.copy_(g.host, non_blocking=True)
            g.graph.replay()
            add_counters(g.launches)
            return (_host_labels(g.labels[:rem]),
                    g.probs[:rem].cpu().numpy())

    def _run_eager(self, bucket: int, chunk: np.ndarray):
        rem = chunk.shape[0]
        batch = np.zeros((bucket, *self.image_shape), np.uint8)
        batch[:rem] = chunk
        with torch.inference_mode():
            probs, labels = self._forward(torch.from_numpy(batch).to(self.device))
            return _host_labels(labels[:rem]), probs[:rem].cpu().numpy()


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
