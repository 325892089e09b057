"""Host data loader: decode -> augment -> resize -> uint8 NHWC batches,
counterpart of ``cnn_tpu/data/loader.py``.

The same loader as ``cnn_tpu``'s: a producer thread assembles batches
(decode through a worker pool) into a bounded queue; ``generate_batch`` is
the infinite epoch-wrapping stream, ``__iter__`` one sequential epoch for
eval loops; the epoch order is a numpy permutation of ``seed + epoch``
(``compat_fixed_epoch_shuffle=True``: of ``seed``, every epoch, the
reference's quirk). ``augment=True`` runs ``data/augment.py``'s
``ImageAugmentor`` on each decoded image before the resize, drawing from
``np.random.default_rng((seed, epoch, position))``, so the batches do not
depend on the threads' order. ``cache=True`` keeps each image in RAM once
decoded: resized without augmentation, the original with it (the ops act
on the full-resolution image). It yields the same uint8 [B,H,W,3] batches
and int32 labels as ``cnn_tpu``'s Python path, decoding and resizing with
``data/image.py`` (bit-equal to cv2) and warping with
``data/augment.py:warp_affine`` (bit-equal to cv2 5.0's) in place of cv2.

``backend='native'`` is ``cnn_tpu``'s native engine (``data/native.py``):
without ``augment`` and without ``cache`` (where ``cnn_tpu`` uses it), the
pool decodes a batch and one ``NativeLoader.resize`` call resizes it, one
kernel launch a batch on the card (the plain version with
``device='cpu'``); the bytes are those of the Python path.
``backend='auto'`` is ``'native'`` on a CUDA device and ``'python'`` on the
CPU, by the ``device`` the caller passes (None: the card,
``cnn_tpu_torch.default_device``); ``'python'`` needs no device.

No CUDA graph is captured while a native loader's producer thread runs:
the train CLI's host loaders live only where no device-dataset graph is
captured, and the evaluate CLI captures none.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np

from cnn_tpu_torch import default_device
from cnn_tpu_torch.data.augment import ImageAugmentor
from cnn_tpu_torch.data.dataset import Sample
from cnn_tpu_torch.data.image import imread, resize

_PRODUCER_ERROR = object()  # queue sentinel: producer thread died


class DataLoader:
    def __init__(self, samples: Sequence[Sample], batch_size: int = 4,
                 augment: bool = False, shuffle: bool = True,
                 image_size: int = 224, seed: int = 212,
                 num_workers: int = 2, prefetch: int = 4,
                 compat_fixed_epoch_shuffle: bool = False,
                 backend: str = "python", cache: bool = False,
                 device=None):
        assert batch_size >= 1
        if backend not in ("python", "native", "auto"):
            raise ValueError(f"unknown loader backend '{backend}'")
        self.samples = list(samples)
        self.batch_size = batch_size
        self.augment = augment
        self.shuffle = shuffle
        self.image_size = image_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.compat_fixed_epoch_shuffle = compat_fixed_epoch_shuffle
        self.augmentor = ImageAugmentor(seed=seed)
        # decode-once RAM cache (decode dominates host time): resized
        # images without augmentation (epochs then become memcpy), the
        # decoded originals with it
        self.cache = cache
        self._cached: dict[str, np.ndarray] = {}
        self._native = None
        if backend != "python":
            dev = default_device(device)
            if backend == "native" or dev.type == "cuda":
                from cnn_tpu_torch.data.native import NativeLoader
                self._native = NativeLoader(image_size, dev)
        # where cnn_tpu's loader takes its native engine
        self._native_batch = (self._native is not None and not augment
                              and not cache)
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def batches_per_epoch(self) -> int:
        """Batches yielded by one ``__iter__`` epoch (ceil division — the
        final partial batch is yielded too)."""
        return -(-len(self.samples) // self.batch_size)

    # ------------------------------------------------------------ internals

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.samples))
        s = self.seed if self.compat_fixed_epoch_shuffle else self.seed + epoch
        return np.random.default_rng(s).permutation(len(self.samples))

    def _load_one(self, path: str, label: int, epoch: int, pos: int):
        if self._native_batch:
            return imread(path), label    # resized with its batch
        size = (self.image_size, self.image_size)
        cache_resized = self.cache and not self.augment
        img = self._cached.get(path) if self.cache else None
        if img is None:
            img = imread(path)
            if cache_resized:
                img = resize(img, size)
            if self.cache:
                img.flags.writeable = False  # shared across epochs
                self._cached[path] = img
        if cache_resized:
            return img, label
        if self.augment:
            rng = np.random.default_rng((self.seed, epoch, pos))
            img = self.augmentor(img, rng)
        return np.ascontiguousarray(resize(img, size)), label

    def _assemble(self, pool, idxs, epoch: int):
        """Decode one batch through the worker pool: (uint8 stack, labels)."""
        futs = [pool.submit(self._load_one, *self.samples[i], epoch, int(i))
                for i in idxs]
        imgs, labels = zip(*[f.result() for f in futs])
        labels = np.asarray(labels, np.int32)
        if self._native_batch:
            return self._native.resize(imgs), labels
        return np.stack(imgs), labels

    def _producer(self, stop: threading.Event, q: queue.Queue):
        # ``stop``/``q`` are THIS producer's own bindings: a zombie thread
        # from a timed-out close() can never be revived by a later
        # _ensure_started() (which makes fresh ones), nor write into the
        # new producer's queue
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            self._produce_loop(pool, stop, q)
        except BaseException as e:  # surface errors to the consumer — a
            # silently-dead producer would hang generate_batch forever
            self._error = e
            while not stop.is_set():
                try:
                    q.put(_PRODUCER_ERROR, timeout=0.5)
                    break       # never drop the sentinel on a full queue
                except queue.Full:
                    continue
        finally:
            pool.shutdown(wait=False)

    def _produce_loop(self, pool, stop: threading.Event, q: queue.Queue):
        epoch = 0
        while not stop.is_set():
            order = self._epoch_order(epoch)
            for start in range(0, len(order) - self.batch_size + 1,
                               self.batch_size):
                batch = self._assemble(pool,
                                       order[start:start + self.batch_size],
                                       epoch)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            epoch += 1

    def _ensure_started(self):
        if self._thread is not None and self._thread.is_alive():
            return
        assert self.batch_size <= len(self.samples), (
            f"batch_size {self.batch_size} > dataset size "
            f"{len(self.samples)} — the infinite stream would yield no "
            "batches and hang (epoch iteration via __iter__ still works)")
        self._queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._error = None
        self._thread = threading.Thread(
            target=self._producer, args=(self._stop, self._queue), daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public API

    def generate_batch(self) -> tuple[np.ndarray, np.ndarray]:
        """Next (uint8 [B,H,W,C] batch, int32 [B] labels); infinite stream
        (epoch-wrapping), like the reference's ``generate_batch``."""
        self._ensure_started()
        while True:
            try:
                item = self._queue.get(timeout=1.0)
            except queue.Empty:
                # even if the error sentinel were lost, a dead producer
                # must raise, not hang the train loop
                if self._error is not None:
                    raise RuntimeError("data producer failed") from self._error
                if not self._thread.is_alive():
                    raise RuntimeError("data producer died without error")
                continue
            if item is _PRODUCER_ERROR:
                raise RuntimeError("data producer failed") from self._error
            return item

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """One epoch, sequentially (no background thread) — for eval loops."""
        order = self._epoch_order(0)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            for start in range(0, len(order), self.batch_size):
                yield self._assemble(pool, order[start:start + self.batch_size],
                                     0)
        finally:
            pool.shutdown(wait=False)

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            if not self._thread.is_alive():
                self._thread = None
            # else: keep the handle — _ensure_started() replaces queue and
            # stop event, so the stuck producer stays orphaned and harmless

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
