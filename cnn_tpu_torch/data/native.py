"""The native loader, counterpart of ``cnn_tpu/data/native.py``.

``cnn_tpu``'s native loader is a C++ engine (``csrc/dataloader.cpp``):
``cv::imread`` and ``cv::resize`` in a thread pool behind ``ctypes``. The
port's engine does the same two steps in two places:

- it decodes in a thread pool with ``data/image.py:imread`` (bit-equal to
  ``cv2.imread``; binary PPM in numpy, the rest through PIL);
- it resizes the whole batch with one launch of the hand-written CUDA
  kernel ``csrc/resize.cu`` (``ops/hopper/resize.py``), cv2's fixed-point
  INTER_LINEAR, bit-equal to ``cv2.resize`` of each image.

On the card a batch is packed into a pinned staging buffer, copied to the
card in one copy, resized and copied back, all on a CUDA stream of the
loader's own; its buffers are kept and grown, never freed between batches.
``device='cpu'`` resizes with the kernel's plain version
(``resize_batch_plain``); ``device=None`` is the card
(``cnn_tpu_torch.default_device``: it raises where there is none).

``load(path)`` and ``load_batch(paths, num_threads)`` return what
``cnn_tpu``'s do: uint8 BGR [s, s, 3] / [n, s, s, 3] numpy arrays, or None
when an image does not decode. ``resize(images)`` resizes decoded images
(the host loader's batches, ``data/loader.py``). A loader may be called
from several threads at once: the decode runs in parallel, the resize one
batch at a time.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from cnn_tpu_torch import default_device
from cnn_tpu_torch.data.image import imread
from cnn_tpu_torch.ops.hopper.resize import (pack_into, pack_layout,
                                             resize_linear_u8, unpack)


def _try_imread(path: str):
    try:
        return imread(path)
    except IOError:
        return None


class NativeLoader:
    """Decode + bilinear-resize images to ``image_size`` x ``image_size``
    x 3 uint8 BGR: the decode on the host, the resize in one kernel launch
    a batch."""

    def __init__(self, image_size: int, device=None):
        self.image_size = image_size
        self.device = default_device(device)
        self._lock = threading.Lock()
        self._stream = None
        self._staging = None     # pinned uint8: the packed batch
        self._packed = None      # its copy on the card
        self._out = None         # uint8 [cap, s, s, 3] on the card
        self._out_host = None    # and its pinned copy

    def load(self, path: str) -> np.ndarray | None:
        batch = self.load_batch([path], num_threads=1)
        return None if batch is None else batch[0]

    def load_batch(self, paths: Sequence[str],
                   num_threads: int = 4) -> np.ndarray | None:
        workers = max(1, min(num_threads, len(paths)))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            images = list(pool.map(_try_imread, paths))
        if any(img is None for img in images):
            return None
        return self.resize(images)

    def resize(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """uint8 [n, s, s, 3]: the decoded HWC uint8 ``images``, each
        resized as ``cv2.resize(img, (s, s))``, in one launch."""
        s = self.image_size
        if not images:
            return np.empty((0, s, s, 3), np.uint8)
        layout = pack_layout([img.shape for img in images], s)
        if self.device.type == "cpu":
            buf = torch.empty(layout.nbytes, dtype=torch.uint8)
            return resize_linear_u8(pack_into(buf, images, layout)).numpy()
        with self._lock:
            return self._resize_on_card(images, layout)

    @staticmethod
    def _grown(buf, need: int, make):
        """``buf``, or a new one from ``make(capacity)`` where it holds less
        than ``need`` (half as much again, so that growth is rare)."""
        if buf is not None and buf.shape[0] >= need:
            return buf
        return make(max(need, 3 * (0 if buf is None else buf.shape[0]) // 2))

    def _resize_on_card(self, images, layout) -> np.ndarray:
        n, s = layout.n, layout.size
        dev = self.device
        with torch.cuda.device(dev):
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(self._stream):
                self._staging = self._grown(
                    self._staging, layout.nbytes,
                    lambda c: torch.empty(c, dtype=torch.uint8,
                                          pin_memory=True))
                self._packed = self._grown(
                    self._packed, layout.nbytes,
                    lambda c: torch.empty(c, dtype=torch.uint8, device=dev))
                self._out = self._grown(
                    self._out, n, lambda c: torch.empty(
                        (c, s, s, 3), dtype=torch.uint8, device=dev))
                self._out_host = self._grown(
                    self._out_host, n, lambda c: torch.empty(
                        (c, s, s, 3), dtype=torch.uint8, pin_memory=True))
                pack_into(self._staging, images, layout)
                nb = layout.nbytes
                self._packed[:nb].copy_(self._staging[:nb], non_blocking=True)
                out = resize_linear_u8(unpack(self._packed, layout),
                                       out=self._out[:n])
                self._out_host[:n].copy_(out, non_blocking=True)
                self._stream.synchronize()
        return self._out_host[:n].numpy().copy()
